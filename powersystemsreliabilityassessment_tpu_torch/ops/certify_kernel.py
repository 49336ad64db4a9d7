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

``network_buffers`` packs a ``System`` for this kernel and for K4
(``ops/fused_sampler_cert.py``): one float32 buffer (PTDF transposed,
LODF, the transfer matrix, unit capacities, ratings, ratings + 1e-4)
and one int32 buffer (each unit's and load's bus, and per-bus CSR lists
of units and loads: the one-hot incidence matrices as indices). It runs
on the device and never waits for it.
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build

# State lanes per block (one warp each; csrc/cert_common.cuh CERT_WARPS)
# and the longest lane vector the kernels take (32 threads x 4 slots).
WARPS = 8
MAX_DIM = 128
# Shared memory a block may take for staged matrices and scratch: half
# of the H100's 227 KB per block, so two blocks share an SM. Matrices
# that do not fit are read through L2.
SMEM_BUDGET = 113 * 1024
STAGE_PTDF, STAGE_LODF, STAGE_TRANSFER = 1, 2, 4

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


def scratch_floats(sys) -> int:
    """Per-warp scratch floats of csrc/cert_common.cuh ``cert_scratch``."""
    return sys.n_gen + sys.n_load + 2 * sys.n_bus + 2 * sys.n_branch


def stage_plan(sys, per_warp_floats: int, mats: int) -> tuple[int, int]:
    """(stage bits, shared bytes): the matrices of ``mats`` (STAGE_*
    bits), in the order PTDF, LODF, transfer, that fit SMEM_BUDGET beside
    the warps' scratch."""
    nl, nb = sys.n_branch, sys.n_bus
    used = 4 * WARPS * per_warp_floats
    stage = 0
    for bit, size in ((STAGE_PTDF, nb * nl), (STAGE_LODF, nl * nl),
                      (STAGE_TRANSFER, nl * nl)):
        if mats & bit and used + 4 * size <= SMEM_BUDGET:
            stage |= bit
            used += 4 * size
    return stage, used


def check_dims(sys, name: str) -> None:
    if max(sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus) > MAX_DIM:
        raise ValueError(f"{name}: the kernel takes systems with every "
                         f"dimension <= {MAX_DIM}")


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
    """(float buffer, int buffer, stage bits, shared bytes) of the K5
    kernel for ``sys``."""
    check_dims(sys, "certify_states_fused")
    fbuf, ibuf = network_buffers(sys)
    stage, smem = stage_plan(sys, scratch_floats(sys),
                             STAGE_PTDF | STAGE_LODF | STAGE_TRANSFER)
    return fbuf, ibuf, stage, smem


def launch(sys, comp_down, load_pu, repair_iters: int, operands):
    """One K5 launch on prepared ``kernel_operands``; returns
    (certified, deficit, shed, dispatch)."""
    B, ng, nd = comp_down.shape[0], sys.n_gen, sys.n_load
    if comp_down.dtype != torch.bool or not comp_down.is_cuda \
            or tuple(comp_down.shape) != (B, sys.n_comp):
        raise ValueError("certify_states_fused: comp_down must be a bool "
                         f"CUDA tensor [B, {sys.n_comp}]")
    down = comp_down.contiguous()
    load = load_pu.to(torch.float32).contiguous()
    cuda_build.check_operand(load, "load_pu", (B, nd))
    fbuf, ibuf, stage, smem = operands
    if not (fbuf.device == ibuf.device == down.device == load.device):
        raise ValueError("certify_states_fused: system and states are on "
                         "different devices")
    cert = torch.empty(B, dtype=torch.bool, device=down.device)
    deficit = torch.empty(B, dtype=torch.float32, device=down.device)
    shed = torch.empty((B, nd), dtype=torch.float32, device=down.device)
    disp = torch.empty((B, ng), dtype=torch.float32, device=down.device)
    err = cuda_build.library().psra_certify(
        down.data_ptr(), load.data_ptr(), fbuf.data_ptr(), ibuf.data_ptr(),
        B, ng, nd, sys.n_branch, sys.n_bus, int(repair_iters), stage, smem,
        cert.data_ptr(), deficit.data_ptr(), shed.data_ptr(),
        disp.data_ptr(), cuda_build.stream_handle(down))
    cuda_build.check_launch(err, "certify_states_fused")
    launches["certify_states_fused"] += 1
    return cert, deficit, shed, disp
