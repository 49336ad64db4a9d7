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

Between K1's launches the solve is two fixed-shape chains of small
operations (:func:`_polish_and_pick`, :func:`_merge_rescued`), and
``dcopf._finalize`` a third. On the card, for a buffer of at most
``GRAPH_MAX_LANES`` lanes, :func:`lp_chain` runs them as CUDA graphs
(``runtime/graphs.py``) and K1 stays an eager launch; elsewhere they run
as plain calls. Both give the same operations in the same order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_batched import (
    _PALLAS_MAX_M, LPBatchSolution, _merge_lanes, _quality, lp_kernels,
    polish_box_lp)
from powersystemsreliabilityassessment_tpu_torch.ops import batched_chol
# The structured A-products live beside the K1 kernel, whose plain
# version uses them too.
from powersystemsreliabilityassessment_tpu_torch.ops.ipm_fused import (  # noqa: F401
    LPStructure, mtv, mv, normal_matrix)
from powersystemsreliabilityassessment_tpu_torch.runtime import graphs
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

# Largest LP buffer whose small-op chains run as CUDA graphs: past it the
# card's time for a call exceeds the host's eager time, so a graph buys
# nothing, and the private pool of the polish's [B, 62, 62]
# intermediates grows with B. One RTS-24 call of ``dcopf.evaluate_states``
# on stressed states, NVIDIA H100 80GB HBM3 at 700 W, medians of 20 (ms;
# scripts/torch_lp_graph_sweep.py):
#
#   lanes    eager host   device busy   graphed host   graphed wall
#   1,024        22.8          5.6           2.3             6.9
#   4,096        18.1          8.1           2.6             9.6
#   8,192        20.6         13.3           2.9            14.9
#   16,384       23.5         22.9           3.1            24.6
#   65,536       63.9         81.4             -               -
GRAPH_MAX_LANES = 16384
# Chains kept (a study uses one solve chain and one finalize chain per
# buffer size; a grow-and-redo adds a size).
GRAPH_CHAINS = 8
_chains = graphs.ChainCache(GRAPH_CHAINS)


def lp_chain(key: tuple, device, m: int, lanes: int, keep):
    """The graph chain of ``key`` for an LP buffer of ``lanes`` lanes and
    ``m`` rows on ``device``, or ``graphs.EAGER``: a chain only on a CUDA
    device, at m <= 72 (the structured route), at most
    ``GRAPH_MAX_LANES`` lanes and while no capture is under way. ``keep``
    holds what ``key`` names by identity."""
    dev = torch.device(device)
    if (dev.type != "cuda" or m > _PALLAS_MAX_M or lanes > GRAPH_MAX_LANES
            or torch.cuda.is_current_stream_capturing()):
        return graphs.EAGER
    return _chains.get((key, dev, lanes), lambda: graphs.Chain(
        dev, "lp", keep, (batched_chol.launches,)))


class _Pick(NamedTuple):
    """The rescue's lanes, chosen after the first polish."""
    quality: torch.Tensor   # [B] every lane's quality score
    idx: torch.Tensor       # [k] the worst lanes
    lanes: tuple            # their (colscale, br_up, c, b, l, u)
    start: torch.Tensor     # [k, n] the first warm pass's start point


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
    are float32 tensors on one device, batch-major. K1 runs first, then
    the segment :func:`_polish_and_pick` (a CUDA graph where
    :func:`lp_chain` gives one)."""
    lanes = (colscale, br_up, c, b, l, u)
    iterate = lp_kernels(c.device, st.m).iterate
    fracs = [f for f in cfg.rescue_stages if f is not None]
    k = min(RESCUE_LANES, c.shape[0]) if fracs else 0
    chain = lp_chain(("solve", id(st), cfg, k), c.device, st.m, c.shape[0],
                     st)
    with span("lp.k1"):
        state = iterate(st, *lanes, cfg)
    out = chain.run("polish", functools.partial(
        _polish_and_pick, st, cfg, k, fracs[0] if k else None),
        *state, *lanes)
    sol = LPBatchSolution(*out[:4])
    if k == 0:
        return LPBatchSolution(*map(chain.fresh, sol))
    pick = _Pick(out[4], out[5], out[6:12], out[12])
    return _warm_rescue(st, iterate, cfg, chain, sol, pick)


def _polish_and_pick(st: LPStructure, cfg: IPMConfig, k: int, frac,
                     *tensors) -> tuple:
    """The polish of K1's state (``tensors``: its six outputs, then the
    six lane inputs), then, for a rescue of ``k`` lanes, every lane's
    quality score, the ``k`` worst lanes, their inputs and their first
    warm start: the polished x clamped ``frac`` of the box width inside.
    Returns the solution's four fields, then (k > 0) those."""
    state, lanes = tensors[:6], tensors[6:]
    sol = polish_structured(st, state, *lanes, cfg)
    if k == 0:
        return tuple(sol)
    quality = _quality(sol)
    idx = torch.topk(quality, k).indices
    sub = tuple(t[idx] for t in lanes)
    l, u = sub[4], sub[5]
    width = u - l
    start = torch.clamp(sol.x[idx], l + frac * width, u - frac * width)
    return (*sol, quality, idx, *sub, start)


@traced("lp.rescue")
def _warm_rescue(st: LPStructure, iterate, cfg: IPMConfig, chain,
                 sol: LPBatchSolution, pick: _Pick) -> LPBatchSolution:
    """Solve the lanes of ``pick`` (the worst by quality score: primal
    residual + 2 n gap, the evaluator's guard score) again with K1
    started warm: one pass for each float of ``cfg.rescue_stages``, the
    first from ``pick.start``, each later one from the previous pass's
    best iterate clamped its own fraction of the box width inside (None
    stages are skipped), then the segment :func:`_merge_rescued` (a CUDA
    graph where ``chain`` is one). Constant shapes and no host read: the
    step stays free of device syncs. The counter ``lp.rescue_demand``
    takes the lanes whose first-pass score exceeds ``cfg.escalate_tol``,
    of which the rescue takes at most ``RESCUE_LANES``."""
    count("lp.rescue_demand", pick.quality, cfg.escalate_tol, reduce=_past,
          copy=chain.graphed)
    # K1's inputs are copies a later replay leaves alone (the benchmark's
    # K1 recorder keeps them).
    sub = tuple(map(chain.fresh, pick.lanes))
    start = chain.fresh(pick.start)
    l, u = sub[4], sub[5]
    width = u - l
    for i, frac in enumerate(f for f in cfg.rescue_stages if f is not None):
        if i:
            start = torch.clamp(state[5], l + frac * width, u - frac * width)
        with span("lp.k1"):
            state = iterate(st, *sub, cfg, x_init=start)
    out = chain.run("rescue", functools.partial(_merge_rescued, st, cfg),
                    *state, *pick.lanes, pick.quality, pick.idx, *sol)
    return LPBatchSolution(*map(chain.fresh, out))


def _merge_rescued(st: LPStructure, cfg: IPMConfig, *tensors) -> tuple:
    """The rescue's polish of K1's last state over the picked lanes,
    merged lane by lane with the first pass
    (:func:`lp_ipm_batched._merge_lanes`), written back into the buffer's
    solution only where the lane's first-pass score exceeded
    ``cfg.escalate_tol``, so a lane that passed the guard keeps its bits.
    ``tensors``: K1's six outputs, the picked lanes' six inputs, every
    lane's quality score, the picked indices, the first pass's four
    fields."""
    state, sub = tensors[:6], tensors[6:12]
    quality, idx = tensors[12], tensors[13]
    sol = tensors[14:]
    old = LPBatchSolution(*(t[idx] for t in sol))
    new = _merge_lanes(polish_structured(st, state, *sub, cfg), old)
    take = quality[idx] > cfg.escalate_tol
    kept = (torch.where(take[:, None] if a.dim() == 2 else take, a, o)
            for a, o in zip(new, old))
    return tuple(t.index_copy(0, idx, v) for t, v in zip(sol, kept))
