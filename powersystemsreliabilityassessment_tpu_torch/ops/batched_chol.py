"""Batched Cholesky factorization and solve of many small SPD systems (K2).

Port of ``powersystemsreliabilityassessment_tpu/ops/batched_chol.py``
(``cholesky_bm`` / ``cho_solve_bm``). The TPU kernels work in a
batch-minor layout (128 systems on the vector lanes); the port keeps the
natural batch-major layout, [B, m, m] and [B, m], so
``to_batch_minor`` / ``from_batch_minor`` are not ported.

``cholesky`` and ``cho_solve`` are the wrappers: on a CUDA tensor they
launch the hand-written kernels of ``csrc/batched_chol.cu`` (or raise);
on a CPU tensor they run ``cholesky_plain`` / ``cho_solve_plain``, the
same algorithm in plain PyTorch. ``launches`` counts kernel launches.
``launch_shape`` lays out a K2a launch: warps a system, systems a block
and the shared bytes the kernel expects.
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build

LANES = 128   # the reference kernels' lane tile; kept for API parity
# Per-lane pivot floor (reference ops/batched_chol.py:41): matrices here
# are equilibrated to a unit diagonal, so a smaller pivot means f32
# cancellation destroyed positive definiteness; flooring bounds the
# factor and leaves the lane to the caller's quality guard.
PIVOT_FLOOR = 1e-6
# Largest system the kernels take (three row slots of a warp, csrc/).
MAX_M = 72

# K2a's launch shape (csrc/batched_chol.cu): a system runs on a "lane" of
# 1, 2 or 4 warps, at most MAX_WARPS_PER_BLOCK warps a block; shared
# memory per lane is chol_lane_words(m, warps) float32 words. On an
# NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_k2_bench.py): 256 lanes
# of m = 62 took 0.0373 / 0.0238 / 0.0194 ms on 1 / 2 / 4 warps, 2,048
# of m = 56 0.0489 / 0.0559 / 0.0757 ms.
WARPS_PER_LANE = (1, 2, 4)
MAX_WARPS_PER_BLOCK = 8
SMEM_PER_BLOCK = 232448       # the H100's opt-in shared memory a block
SCHEDULERS_PER_SM = 4
WARPS_PER_SCHEDULER = 2       # at most, from the warps a lane takes
PANEL_COLS = 4                # pivots a panel, columns an update round

launches = {"cholesky": 0, "cho_solve": 0}


def cholesky_plain(M: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch batched Cholesky, [B, m, m] -> lower L [B, m, m].

    The reference kernel's right-looking algorithm step for step
    (``_chol_kernel``): at step k, inv = rsqrt(max(a_kk, PIVOT_FLOOR)),
    the trailing square takes a_ij -= (a_ik inv)(a_kj inv), and column k
    becomes L's column. No failure status: a non-positive pivot is
    floored, exactly as ``batched_chol.py:74`` does.
    """
    a = M.clone()
    m = a.shape[-1]
    for k in range(m):
        inv = torch.rsqrt(torch.clamp_min(a[:, k, k], PIVOT_FLOOR))
        ck = a[:, k:, k] * inv[:, None]
        rk = a[:, k, k + 1:] * inv[:, None]
        a[:, k + 1:, k + 1:] -= ck[:, 1:, None] * rk[:, None, :]
        a[:, k:, k] = ck
    return torch.tril(a)


def cho_solve_plain(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch solve of L L' x = r per lane; L [B, m, m], r [B, m].
    Forward then back substitution (reference ``_solve_kernel``)."""
    y = r.clone()
    m = r.shape[-1]
    for i in range(m):
        s = (L[:, i, :i] * y[:, :i]).sum(-1)
        y[:, i] = (y[:, i] - s) / L[:, i, i]
    for i in range(m - 1, -1, -1):
        s = (L[:, i + 1:, i] * y[:, i + 1:]).sum(-1)
        y[:, i] = (y[:, i] - s) / L[:, i, i]
    return y


def row_offset(i: int) -> int:
    """Offset (float32 words) of row i of K2a's triangle in a lane's
    shared memory (``chol_row_off`` in csrc/batched_chol.cu): rows in
    groups of 8, each row of group k = i // 8 taking 8k + 12 words, the
    8 rows of a group 2k + 3 (odd) 16-byte units apart."""
    k, r = i >> 3, i & 7
    return 4 * (8 * k * (k + 2) + r * (2 * k + 3))


def row_words(i: int) -> int:
    """Words row i may use: its i + 1 entries and the spare room a
    4-column update round past its diagonal writes."""
    return 8 * (i >> 3) + 12


def lane_words(m: int, warps: int) -> int:
    """Float32 words of one K2a lane's shared memory (``chol_lane_words``
    in csrc/batched_chol.cu): a panel buffer of m float4 per warp, then
    the triangle's whole groups of 8 rows."""
    k = (m + 7) >> 3
    return 4 * warps * m + 32 * k * (k + 2)


def launch_shape(batch: int, m: int, n_sms: int,
                 warps_per_lane: int | None = None) -> tuple:
    """``(warps per lane, lanes per block, dynamic shared bytes)`` of a
    K2a launch of ``batch`` m x m systems on a card of ``n_sms`` SMs.

    A lane runs on the most warps (1, 2, 4) that still leave each of the
    SMs' schedulers at most two warps and give each warp at least two of
    the first panel's 4-column update rounds; so one warp once the batch
    fills the card (2,048 lanes: ~15.5 warps an SM, one wave) and more
    where it leaves schedulers idle (four at 256 lanes). Lanes a block:
    as many as still leave every SM a block, within MAX_WARPS_PER_BLOCK
    warps. ``warps_per_lane`` overrides the first choice."""
    _check_m(m)
    if warps_per_lane is None:
        warps_per_lane = max(
            w for w in WARPS_PER_LANE
            if w == 1 or (w * batch <= WARPS_PER_SCHEDULER
                          * SCHEDULERS_PER_SM * n_sms
                          and m >= PANEL_COLS * (2 * w + 1)))
    if warps_per_lane not in WARPS_PER_LANE:
        raise ValueError(f"K2a takes {WARPS_PER_LANE} warps a lane, got "
                         f"{warps_per_lane}")
    lpb = max(1, min(MAX_WARPS_PER_BLOCK // warps_per_lane,
                     batch // max(n_sms, 1)))
    return warps_per_lane, lpb, 4 * lpb * lane_words(m, warps_per_lane)


def _check_m(m: int) -> None:
    if not 1 <= m <= MAX_M:
        raise ValueError(f"batched_chol kernels take 1 <= m <= {MAX_M}, "
                         f"got {m}")


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky [B, m, m] -> L (lower, zeros above). Mirrors
    reference ``ops/batched_chol.py::cholesky_bm`` in batch-major layout.
    CUDA: the K2a kernel in :func:`launch_shape`'s layout; CPU:
    :func:`cholesky_plain`. Only M's lower triangle is read on the card,
    as M is symmetric."""
    if M.device.type == "cpu":
        return cholesky_plain(M)
    B, m = M.shape[0], M.shape[-1]
    _check_m(m)
    cuda_build.check_operand(M, "M", (B, m, m))
    wpl, lpb, smem = launch_shape(
        B, m, torch.cuda.get_device_properties(M.device).multi_processor_count)
    L = torch.empty_like(M)
    err = cuda_build.library().psra_cholesky(
        M.data_ptr(), L.data_ptr(), B, m, wpl, lpb, smem,
        cuda_build.stream_handle(M))
    cuda_build.check_launch(err, "cholesky")
    launches["cholesky"] += 1
    return L


def cho_solve(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve L L' x = r per lane; L [B, m, m], r [B, m]. Mirrors
    reference ``ops/batched_chol.py::cho_solve_bm`` in batch-major
    layout. CUDA: the K2b kernel; CPU: :func:`cho_solve_plain`."""
    if L.device.type == "cpu" and r.device.type == "cpu":
        return cho_solve_plain(L, r)
    B, m = r.shape
    _check_m(m)
    cuda_build.check_operand(L, "L", (B, m, m))
    cuda_build.check_operand(r, "r", (B, m))
    if L.device != r.device:
        raise ValueError("cho_solve: L and r are on different devices")
    x = torch.empty_like(r)
    err = cuda_build.library().psra_cho_solve(
        L.data_ptr(), r.data_ptr(), x.data_ptr(), B, m,
        cuda_build.stream_handle(r))
    cuda_build.check_launch(err, "cho_solve")
    launches["cho_solve"] += 1
    return x
