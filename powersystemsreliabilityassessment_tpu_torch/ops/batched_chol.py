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
# Largest system the kernels take (shared-memory arrays in csrc/).
MAX_M = 72

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


def _check_m(m: int) -> None:
    if m > MAX_M:
        raise ValueError(f"batched_chol kernels take m <= {MAX_M}, got {m}")


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky [B, m, m] -> L (lower, zeros above). Mirrors
    reference ``ops/batched_chol.py::cholesky_bm`` in batch-major layout.
    CUDA: the K2a kernel; CPU: :func:`cholesky_plain`."""
    if M.device.type == "cpu":
        return cholesky_plain(M)
    B, m = M.shape[0], M.shape[-1]
    _check_m(m)
    cuda_build.check_operand(M, "M", (B, m, m))
    L = torch.empty_like(M)
    err = cuda_build.library().psra_cholesky(
        M.data_ptr(), L.data_ptr(), B, m, cuda_build.stream_handle(M))
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
