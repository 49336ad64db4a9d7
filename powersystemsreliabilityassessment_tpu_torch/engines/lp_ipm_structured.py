"""Structured batched LP solver: fused iterations + A-free polish.

Port of ``powersystemsreliabilityassessment_tpu/engines/lp_ipm_structured.py``.
The Mehrotra loop runs in the fused K1 kernel (``ops/ipm_fused.py``) on
CUDA, or its plain PyTorch version on the CPU, as
``lp_ipm_batched.lp_kernels`` routes it; the polish is the shared
``lp_ipm_batched.polish_box_lp`` with every A-product computed from the
shared LP structure instead of a materialized [B, m, n] tensor.
"""
from __future__ import annotations

from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_batched import (
    LPBatchSolution, lp_kernels, polish_box_lp)
# The structured A-products live beside the K1 kernel, whose plain
# version uses them too.
from powersystemsreliabilityassessment_tpu_torch.ops.ipm_fused import (  # noqa: F401
    LPStructure, mtv, mv, normal_matrix)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)


def polish_structured(st: LPStructure, state, colscale, br_up, c, b, l, u,
                      cfg: IPMConfig = IPMConfig()) -> LPBatchSolution:
    """``polish_box_lp`` of an iteration ``state`` (the six outputs of
    ``ops/ipm_fused.fused_ipm_iterations``) with every A-product taken
    from the shared structure; the polish half of reference
    ``engines/lp_ipm_structured.py::solve_box_lp_structured``."""
    return polish_box_lp(
        state, c, b, l, u, cfg,
        mv_fn=lambda v: mv(st, colscale, br_up, v),
        mtv_fn=lambda yy: mtv(st, colscale, br_up, yy),
        gram_fn=lambda w: normal_matrix(st, colscale * colscale * w, br_up))


def solve_box_lp_structured(st: LPStructure, colscale, br_up, c, b, l, u,
                            cfg: IPMConfig = IPMConfig()) -> LPBatchSolution:
    """Solve a batch of structured DC-OPF LPs min c'x, Ax = b, l <= x <= u;
    mirrors reference
    ``engines/lp_ipm_structured.py::solve_box_lp_structured``. All inputs
    are float32 tensors on one device, batch-major."""
    state = lp_kernels(c.device, st.m).iterate(
        st, colscale, br_up, c, b, l, u, cfg)
    return polish_structured(st, state, colscale, br_up, c, b, l, u, cfg)
