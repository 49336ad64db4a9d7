"""The whole tier-1 certificate in one kernel (K5).

Port of ``powersystemsreliabilityassessment_tpu/ops/certify_kernel.py``
(``certify_states_fused``): a drop-in for ``dcopf.certify_states`` with
no shed hint, full-batch repair and the rank-2 Woodbury check, computed
per state lane by the kernel of ``csrc/certify_kernel.cu`` (copper
deficit, load-proportional candidate, locally balanced dispatch, the
LODF rank-1 check, ``repair_iters`` repair steps, rank-2 Woodbury).

``certify_states_fused`` is the wrapper: on CUDA tensors it launches the
kernel (or raises); on CPU tensors it runs the plain version, which is
the port's own ``dcopf.certify_states(..., woodbury_k=2)``: the kernel
mirrors that function statement for statement (float32 sums in another
order are the only intended difference). ``launches`` counts kernel
launches.

The first pass runs one thread per state lane (a few where the batch is
small) and lists the lanes whose first check fails; a second kernel
repairs the listed lanes, 32 at a time a block (the source's note).
``launch_shape`` sizes the first pass's blocks and chooses what both
keep in shared memory, in the layout the kernels mirror.

``network_buffers`` packs a ``System`` for this kernel and for K4
(``ops/fused_sampler_cert.py``): one float32 buffer (PTDF transposed,
LODF, the transfer matrix, unit capacities, ratings, ratings + 1e-4)
and one int32 buffer (each unit's and load's bus, and per-bus CSR lists
of units and loads: the one-hot incidence matrices as indices). It runs
on the device and never waits for it.
"""
from __future__ import annotations

import functools

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build

# The longest lane vector the kernels take (a 128-bit mask of units or
# of branches).
MAX_DIM = 128
STAGE_PTDF, STAGE_LODF, STAGE_TRANSFER = 1, 2, 4

# The thread-a-lane launch shape of K4 and K5: state lanes a block, a
# multiple of a warp and at most MAX_LANES; threads a lane (the split), a
# power of two up to MAX_SPLIT, with lanes x split <= MAX_THREADS. A
# batch splits its lanes until it gives each SM at least THREADS_PER_SM
# threads, two warps a scheduler: the fastest split of 8,192 K4 lanes on
# an H100 (scripts/torch_k4_bench.py --split; PERF.md §6).
WARP = 32
MAX_LANES = 128
MAX_SPLIT = 8
MAX_THREADS = 256
THREADS_PER_SM = 256
SMEM_PER_BLOCK = 232448          # the H100's 227 KB a block
# K5's plan (csrc/certify_kernel.cu): split and lanes a block in the
# stage bits from SPLIT_SHIFT and LANES_SHIFT; lanes a repair round
# takes; branches a flow chunk carries. LODF and the transfer matrix are
# staged while the first pass's block stays within STAGE_BUDGET, so that
# two blocks share an SM; else they are read through L2. (Measured on an
# H100: staging both beats five blocks an SM without them at 262,144
# RTS-24 lanes, and leaving them in L2 beats one block an SM at 8,192
# RTS-96 lanes; PERF.md §6.)
SPLIT_SHIFT = 8
LANES_SHIFT = 12
REPAIR_SLOTS = 32
CHUNK = 8
STAGE_BUDGET = SMEM_PER_BLOCK // 2

launches = {"certify_states_fused": 0}


def _csr(onehot: torch.Tensor, bus: torch.Tensor):
    """Per-bus lists of the columns of a one-hot [nb, n] matrix: row
    pointers [nb + 1] and column indices [n], ascending in each bus."""
    counts = onehot.sum(1).to(torch.int64)
    ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return ptr, torch.argsort(bus, stable=True)


def network_buffers(sys, extras=()) -> tuple[torch.Tensor, torch.Tensor]:
    """(float32 buffer, int32 buffer) of ``sys`` in the layout of
    csrc/cert_common.cuh ``net_unpack``; ``extras`` (float tensors) are
    appended to the float buffer in order."""
    gen_bus = sys.gen_bus_onehot.argmax(0)
    load_bus = sys.load_onehot.argmax(0)
    rate = sys.br_rate
    floats = torch.cat([
        sys.ptdf.T.reshape(-1), sys.lodf.reshape(-1),
        sys.br_transfer.reshape(-1), sys.gen_pmax, rate, rate + 1e-4,
        *(e.reshape(-1) for e in extras)]).to(torch.float32).contiguous()
    ints = torch.cat([gen_bus, load_bus,
                      *_csr(sys.gen_bus_onehot, gen_bus),
                      *_csr(sys.load_onehot, load_bus)])
    return floats, ints.to(torch.int32).contiguous()


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def lanes_and_split(batch: int, n_sms: int, lanes: int | None = None,
                    split: int | None = None) -> tuple[int, int]:
    """(state lanes a block, threads a lane) of a thread-a-lane kernel
    (K4, K5). Threads a lane: the largest power of two, up to MAX_SPLIT,
    that the batch needs to give each of the ``n_sms`` SMs THREADS_PER_SM
    threads (262,144 lanes: 1; 8,192: 4). Lanes a block: as many warps as
    still give each SM a block, at most MAX_LANES and MAX_THREADS /
    split, at least one warp (262,144: 128; 8,192: 32). ``lanes`` and
    ``split`` override the choices, and are checked."""
    if split is None:
        split = 1
        while 2 * split <= MAX_SPLIT and \
                2 * split * batch <= THREADS_PER_SM * n_sms:
            split *= 2
    elif split not in (1, 2, 4, 8):
        raise ValueError(f"threads a lane must be 1, 2, 4 or 8, got {split}")
    if lanes is None:
        lanes = max(WARP, min(MAX_LANES, MAX_THREADS // split,
                              batch // max(n_sms, 1) // WARP * WARP))
    elif lanes % WARP or not WARP <= lanes <= MAX_LANES \
            or lanes * split > MAX_THREADS:
        raise ValueError(f"lanes per block must be a multiple of {WARP} "
                         f"up to {MAX_LANES} and {MAX_THREADS} threads, "
                         f"got {lanes} x {split}")
    return lanes, split


def layout_words(ng: int, nd: int, nl: int, nb: int, lanes: int) -> dict:
    """Words of each part of K5's shared layouts at ``lanes`` lanes a
    block (csrc/certify_kernel.cu ``cert_*_words``): the small vectors,
    PTDF with rows padded to CHUNK, LODF and the transfer matrix (each,
    where staged), then the first pass's tile of lanes (bus injections,
    load row at an odd stride, the exchange region of the state bytes and
    then the dispatch at an odd stride) or the repair's REPAIR_SLOTS
    slots (dispatch, shed, load, flows, LODF column, bus vector, two rows
    of eight partial sums; each slot's stride padded by up to 31 words
    against bank conflicts)."""
    ls, ds = nd | 1, ng | 1
    lane = nb + ls + max((ng + nl + 3) // 4, ds)
    return dict(small=_round4(6 * ng + 2 * nd + 2 * nl + 2 * nb + 2),
                ptdf=nb * ((nl + CHUNK - 1) // CHUNK * CHUNK),
                square=_round4(nl * nl), tile=lanes * lane,
                repair=REPAIR_SLOTS * (ng + 2 * nd + 2 * nl + nb + 16 + 31),
                lane=lane, load_stride=ls, disp_stride=ds)


def first_pass_smem(ng: int, nd: int, nl: int, nb: int, lanes: int,
                    stage: int) -> int:
    """Dynamic shared bytes of K5's first pass at ``lanes`` lanes a block
    with the matrices ``stage`` flags (``cert_smem_bytes``)."""
    w = layout_words(ng, nd, nl, nb, lanes)
    staged = sum(bool(stage & bit) for bit in (STAGE_LODF, STAGE_TRANSFER))
    return 4 * (w["small"] + w["ptdf"] + staged * w["square"] + w["tile"])


def launch_shape(ng: int, nd: int, nl: int, nb: int, batch: int,
                 n_sms: int, lanes: int | None = None,
                 split: int | None = None) -> tuple[int, int, int]:
    """``(lanes per block, stage bits, dynamic shared bytes)`` of a K5
    first-pass launch, in the layout of csrc/certify_kernel.cu
    (:func:`layout_words`): the lanes and the split of
    :func:`lanes_and_split`, fewer lanes where the widest systems (every
    dimension near 128) would not fit a block's 227 KB, then LODF and
    the transfer matrix, in that order, while the block stays within
    STAGE_BUDGET (two blocks an SM) and the repair kernel's within 227 KB
    (else they are read through L2). The
    stage bits carry the split and the lanes a block; the kernel refuses
    any other shared size. The repair kernel stages the same matrices
    (:func:`repair_smem`)."""
    lanes, split = lanes_and_split(batch, n_sms, lanes, split)
    while first_pass_smem(ng, nd, nl, nb, lanes, 0) > SMEM_PER_BLOCK \
            and lanes > WARP:
        lanes -= WARP
    stage = STAGE_PTDF | (split.bit_length() - 1) << SPLIT_SHIFT \
        | (lanes // WARP - 1) << LANES_SHIFT
    if max(first_pass_smem(ng, nd, nl, nb, lanes, stage),
           repair_smem(ng, nd, nl, nb, stage)) > SMEM_PER_BLOCK:
        raise ValueError("certify_states_fused: dimensions above "
                         f"{MAX_DIM} do not fit the kernel")
    for bit in (STAGE_LODF, STAGE_TRANSFER):
        if first_pass_smem(ng, nd, nl, nb, lanes, stage | bit) \
                <= STAGE_BUDGET and \
                repair_smem(ng, nd, nl, nb, stage | bit) <= SMEM_PER_BLOCK:
            stage |= bit
    return lanes, stage, first_pass_smem(ng, nd, nl, nb, lanes, stage)


def repair_smem(ng: int, nd: int, nl: int, nb: int, stage: int) -> int:
    """Dynamic shared bytes of K5's repair kernel for ``stage``: the
    staged matrices and the REPAIR_SLOTS slots (``cert_repair_smem_bytes``)."""
    w = layout_words(ng, nd, nl, nb, WARP)
    staged = sum(bool(stage & bit) for bit in (STAGE_LODF, STAGE_TRANSFER))
    return 4 * (w["small"] + w["ptdf"] + staged * w["square"] + w["repair"])


def check_dims(sys, name: str) -> None:
    if max(sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus) > MAX_DIM:
        raise ValueError(f"{name}: the kernel takes systems with every "
                         f"dimension <= {MAX_DIM}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def certify_states_fused(sys, comp_down: torch.Tensor,
                         load_pu: torch.Tensor, repair_iters: int = 3):
    """Drop-in fused version of ``dcopf.certify_states`` (no shed hint,
    full-batch repair, ``woodbury_k=2``); mirrors reference
    ``ops/certify_kernel.py::certify_states_fused``. ``comp_down`` [B,
    n_comp] bool, ``load_pu`` [B, n_load]. Returns a ``Certificate``.
    CUDA: the K5 kernel; CPU: ``dcopf.certify_states``."""
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf

    if comp_down.device.type == "cpu" and load_pu.device.type == "cpu":
        return dcopf.certify_states(sys, comp_down, load_pu,
                                    repair_iters=repair_iters, woodbury_k=2)
    return dcopf.Certificate(*launch(sys, comp_down, load_pu, repair_iters,
                                     kernel_operands(sys)))


def kernel_operands(sys):
    """(float buffer, int buffer) of the K5 kernel for ``sys``: the
    network buffers followed by the units' total capacity. The launch
    shape, which depends on the batch, is chosen at each launch."""
    check_dims(sys, "certify_states_fused")
    pmax = sys.gen_pmax.to(torch.float32)
    return network_buffers(sys, extras=(pmax.sum(),))


def launch(sys, comp_down, load_pu, repair_iters: int, operands):
    """One K5 launch on prepared ``kernel_operands``; returns
    (certified, deficit, shed, dispatch)."""
    B, ng, nd = comp_down.shape[0], sys.n_gen, sys.n_load
    if comp_down.dtype != torch.bool or not comp_down.is_cuda \
            or tuple(comp_down.shape) != (B, sys.n_comp):
        raise ValueError("certify_states_fused: comp_down must be a bool "
                         f"CUDA tensor [B, {sys.n_comp}]")
    if repair_iters < 0:
        raise ValueError("certify_states_fused: repair_iters must be >= 0")
    down = comp_down.contiguous()
    load = load_pu.to(torch.float32).contiguous()
    cuda_build.check_operand(load, "load_pu", (B, nd))
    fbuf, ibuf = operands
    if not (fbuf.device == ibuf.device == down.device == load.device):
        raise ValueError("certify_states_fused: system and states are on "
                         "different devices")
    _, stage, smem = launch_shape(ng, nd, sys.n_branch, sys.n_bus, B,
                                  sm_count(down.device))
    # The repair's list: its count, then up to every row.
    work = torch.empty(B + 1, dtype=torch.int32, device=down.device)
    cert = torch.empty(B, dtype=torch.bool, device=down.device)
    deficit = torch.empty(B, dtype=torch.float32, device=down.device)
    shed = torch.empty((B, nd), dtype=torch.float32, device=down.device)
    disp = torch.empty((B, ng), dtype=torch.float32, device=down.device)
    err = cuda_build.library().psra_certify(
        down.data_ptr(), load.data_ptr(), fbuf.data_ptr(), ibuf.data_ptr(),
        B, ng, nd, sys.n_branch, sys.n_bus, int(repair_iters), stage, smem,
        work.data_ptr(), cert.data_ptr(), deficit.data_ptr(), shed.data_ptr(),
        disp.data_ptr(), cuda_build.stream_handle(down))
    cuda_build.check_launch(err, "certify_states_fused")
    launches["certify_states_fused"] += 1
    return cert, deficit, shed, disp
