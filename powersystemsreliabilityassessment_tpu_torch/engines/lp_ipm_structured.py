"""Structured batched LP solver: fused iterations + A-free polish.

Port of ``powersystemsreliabilityassessment_tpu/engines/lp_ipm_structured.py``.
The Mehrotra loop runs in the fused K1 kernel (``ops/ipm_fused.py``) on
CUDA, or its plain PyTorch version on the CPU, as
``lp_ipm_batched.lp_kernels`` routes it; the polish is the shared
``lp_ipm_batched.polish_box_lp`` with every A-product computed from the
shared LP structure instead of a materialized [B, m, n] tensor.

Unlike the reference, the solve ends with a warm-started rescue of the
batch's worst lanes (:func:`_warm_rescue`): the float32 K1 and its plain
version freeze off the optimum on some ill-conditioned lanes, where the
reference kernel's rounding lands within 2.2e-3 p.u.
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_batched import (
    LPBatchSolution, _merge_lanes, _quality, lp_kernels, polish_box_lp)
# The structured A-products live beside the K1 kernel, whose plain
# version uses them too.
from powersystemsreliabilityassessment_tpu_torch.ops.ipm_fused import (  # noqa: F401
    LPStructure, mtv, mv, normal_matrix)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)
from powersystemsreliabilityassessment_tpu_torch.utils.profiling import (
    count, span, traced)

# Lanes of each solve that the warm rescue solves again: the worst by
# quality score after the polish. On the 29 hard SEQ lanes of
# tests/golden/seq_hard_lanes.npz (RTS-24, the plain K1 on the CPU), the
# rescue of the 16 worst leaves 0 lanes more than 5e-3 p.u. from float64
# HiGHS and 0 past the evaluator's 5e-3 guard, against 6 and 15 without
# it; more iterations of the cold K1 change nothing there (the lanes are
# frozen). 0 turns the rescue off.
RESCUE_LANES = 16


def _past(score: torch.Tensor, tol: float) -> int:
    return int((score > tol).sum())


@traced("lp.polish")
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
    ``engines/lp_ipm_structured.py::solve_box_lp_structured``, then runs
    :func:`_warm_rescue` on the ``RESCUE_LANES`` worst lanes. All inputs
    are float32 tensors on one device, batch-major."""
    lanes = (colscale, br_up, c, b, l, u)
    iterate = lp_kernels(c.device, st.m).iterate
    with span("lp.k1"):
        state = iterate(st, *lanes, cfg)
    sol = polish_structured(st, state, *lanes, cfg)
    k = min(RESCUE_LANES, c.shape[0])
    return _warm_rescue(st, iterate, lanes, cfg, sol, k) if k > 0 else sol


@traced("lp.rescue")
def _warm_rescue(st: LPStructure, iterate, lanes, cfg: IPMConfig,
                 sol: LPBatchSolution, k: int) -> LPBatchSolution:
    """Solve the ``k`` lanes of worst quality score (primal residual +
    2 n gap, the evaluator's guard score) again with K1 started warm: one
    pass for each float of ``cfg.rescue_stages``, the first from the
    polished x clamped that fraction of the box width inside, each later
    one from the previous pass's best iterate clamped its own fraction
    inside (None stages are skipped), then one polish. A lane takes the
    result through :func:`lp_ipm_batched._merge_lanes` only where its
    first-pass score exceeded ``cfg.escalate_tol``, so a lane that passed
    the guard keeps its bits. Constant shapes and no host read: the step
    stays free of device syncs. The counter ``lp.rescue_demand`` takes
    the lanes whose first-pass score exceeds ``cfg.escalate_tol``, of
    which the rescue takes at most ``k``."""
    quality = _quality(sol)
    count("lp.rescue_demand", quality, cfg.escalate_tol, reduce=_past)
    idx = torch.topk(quality, k).indices
    sub = tuple(t[idx] for t in lanes)
    l, u = sub[4], sub[5]
    width = u - l
    x0, state = sol.x[idx], None
    for frac in cfg.rescue_stages:
        if frac is None:
            continue
        start = torch.clamp(x0, l + frac * width, u - frac * width)
        with span("lp.k1"):
            state = iterate(st, *sub, cfg, x_init=start)
        x0 = state[5]
    if state is None:
        return sol
    old = LPBatchSolution(*(t[idx] for t in sol))
    new = _merge_lanes(polish_structured(st, state, *sub, cfg), old)
    take = quality[idx] > cfg.escalate_tol
    kept = LPBatchSolution(*(
        torch.where(take[:, None] if a.dim() == 2 else take, a, o)
        for a, o in zip(new, old)))
    return LPBatchSolution(*(t.index_copy(0, idx, v)
                             for t, v in zip(sol, kept)))
