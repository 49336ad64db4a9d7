"""PyTorch port: the rescue of every LP lane past the quality guard on the
blocked-Cholesky route (72 < m <= 336), on the CPU.

* RTS-96 (m = 191): sixteen lanes of a seeded stressed draw, ten of which
  the blocked pass leaves past ``escalate_tol``, go through
  ``dcopf.evaluate_states`` with the spans and counters on, one of the
  ten marked as
  padding (``valid`` False). Every real lane past the tolerance before the
  rescue ends under it (or the evaluator's guard flags it); every lane
  under it agrees with float64 HiGHS within 5e-3 p.u.; the lanes that
  passed the guard and the padding lane keep their bits; the counters
  ``lp.rescue_demand`` / ``lp.rescue_lanes`` and the spans
  ``psra.lp.pass`` / ``psra.lp.rescue`` are kept.
* m = 62 and case300s's m = 792: ``solve_box_lp_ops`` gives the bits it
  gave before the route's rescue was added (``DIGESTS``, recorded from
  that code with one intra-op thread: ``python -m
  tests.test_torch_blocked_rescue`` prints them anew).
* ``rescue_size``'s rounding.
"""
import hashlib

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.utils import profiling
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

TOL = IPMConfig().escalate_tol        # 5e-3, the evaluator's guard too
# Lanes of the seed-7 draw below: ten that the blocked pass leaves past
# the tolerance, then six it solves.
HARD = [0, 89, 136, 138, 145, 172, 177, 230, 240, 244]
SOUND = [8, 23, 25, 38, 71, 96]
PADDING = 9                           # HARD[-1]'s slot, marked not valid

DIGESTS = {
    "case300s": "790882b2d24e4eb9253c0a0e257ad647df773bc558b4d2153f5359ae64fcc53d",
    "rts24": "8f8f6a03ce03c6c12be64650a7e913edd78121a3188d29cc0e911ac0969583c7",
}


def _draw(case, sys_, n, seed, boost, load_lo):
    """``n`` states at ``boost`` x unavailability (pinned units up) and
    loads at a uniform share in [``load_lo``, 1] of the peak."""
    rng = np.random.default_rng(seed)
    q = twostate.unavailability(case)
    down = rng.uniform(size=(n, sys_.n_comp)) < boost * q[None, :]
    down[:, sys_.always_up_nsq.numpy()] = False
    share = rng.uniform(load_lo, 1.0, (n, 1))
    load = sys_.load_pd[None, :] * torch.as_tensor(share, dtype=torch.float32)
    return torch.as_tensor(down), load


def _lp(sys_, down, load):
    up = 1.0 - down.to(torch.float32)
    ng, nl = sys_.n_gen, sys_.n_branch
    return up[:, :ng], up[:, ng:ng + nl].contiguous(), load


@pytest.fixture(scope="module")
def rescued():
    """The sixteen RTS-96 lanes through ``evaluate_states`` with the
    spans and counters on (as under a profiler, whose own record of the
    plain kernels' many small operations would take minutes here): the
    pass before the rescue, the solution after it, the evaluator's
    result, the counters and the lanes' LPs."""
    case = cases.rts96()
    sys_ = build_system(case, device="cpu")
    down, load = _draw(case, sys_, 256, seed=7, boost=4.0, load_lo=0.7)
    lanes = HARD + SOUND
    down, load = down[lanes], load[lanes]
    valid = torch.ones(len(lanes), dtype=torch.bool)
    valid[PADDING] = False
    seen = {}
    orig = lp_ipm_batched._rescue_flagged

    def spy(c, b, l, u, ops, cfg, sol, valid):
        seen["first"] = sol
        seen["after"] = orig(c, b, l, u, ops, cfg, sol, valid)
        return seen["after"]

    on = profiling._profiler_enabled
    lp_ipm_batched._rescue_flagged = spy
    profiling._profiler_enabled = lambda: True
    profiling.reset_counters()
    try:
        res = dcopf.evaluate_states(sys_, down, load, woodbury_k=4,
                                    valid=valid)
        totals = profiling.counters()
    finally:
        lp_ipm_batched._rescue_flagged = orig
        profiling._profiler_enabled = on
        profiling.reset_counters()
    g, br, ld = _lp(sys_, down, load)
    lp = dcopf.build_state_lp(sys_, g, br, ld, CompatFlags(),
                              IPMConfig().theta_max)
    return dict(sys=sys_, valid=valid, res=res, totals=totals, lp=lp,
                **seen)


def _highs(lp, lane):
    c, A, b, l, u = (np.asarray(t[lane], np.float64) for t in lp)
    r = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(l, u)), method="highs")
    assert r.status == 0, r.message
    return r.fun


def test_every_flagged_lane_ends_under_the_guard(rescued):
    q0 = lp_ipm_batched._quality(rescued["first"])
    q1 = lp_ipm_batched._quality(rescued["after"])
    flagged = (q0 > TOL) & rescued["valid"]
    assert int(flagged.sum()) >= 8, q0
    # A lane the ladder could not clear stays past the tolerance, and the
    # evaluator's guard then flags it; here the ladder clears them all.
    left = flagged & (q1 > TOL)
    assert bool((rescued["res"].primal_residual[left] > TOL).all())
    assert not bool(left.any()), q1[flagged]


def test_trusted_lanes_agree_with_highs(rescued):
    sol = rescued["after"]
    q1 = lp_ipm_batched._quality(sol)
    trusted = torch.nonzero(q1 <= TOL).flatten().tolist()
    assert len(trusted) >= 15
    for lane in trusted:
        assert abs(float(sol.objective[lane])
                   - _highs(rescued["lp"], lane)) <= TOL, lane


def test_clean_and_padding_lanes_keep_their_bits(rescued):
    first, after = rescued["first"], rescued["after"]
    q0 = lp_ipm_batched._quality(first)
    keep = (q0 <= TOL) | ~rescued["valid"]
    assert bool(keep[PADDING]) and q0[PADDING] > TOL
    for a, b in zip(after, first):
        assert torch.equal(a[keep], b[keep])


def test_counters_and_spans(rescued):
    q0 = lp_ipm_batched._quality(rescued["first"])
    demand = int(((q0 > TOL) & rescued["valid"]).sum())
    t = rescued["totals"]
    assert t["lp.rescue_demand"] == demand
    assert t["lp.rescue_lanes"] == lp_ipm_batched.rescue_size(demand, 16) \
        == 16
    assert t["lp.guard_fallback"] == 0
    assert t["span_ns.lp.pass"] > 0 and t["span_ns.lp.rescue"] > 0
    assert t["host_ns.lp"] >= t["span_ns.lp.pass"] + t["span_ns.lp.rescue"]


def test_spans_open_ranges_under_a_profiler():
    """The spans are ranges of a trace: ``psra.lp.pass`` around the
    rescue's gate on one clean lane (which runs no ladder) under a
    profiler."""
    profiling.reset_counters()
    x = torch.zeros(1, 4)
    sol = lp_ipm_batched.LPBatchSolution(
        x, torch.zeros(1), torch.zeros(1), torch.zeros(1))
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.span("lp.pass"):
                got = lp_ipm_batched._rescue_flagged(
                    x, None, None, None, None, IPMConfig(), sol, None)
        totals = profiling.counters()
    finally:
        profiling.reset_counters()
    assert got is sol
    assert totals["lp.rescue_demand"] == totals["lp.rescue_lanes"] == 0
    names = {e.name for e in prof.events()}
    assert {"psra.lp.pass", "psra.lp.wait"} <= names


@pytest.mark.parametrize("n_past,B,want", [
    (0, 4096, 0), (1, 4096, 32), (32, 4096, 32), (33, 4096, 64),
    (100, 4096, 128), (3000, 4096, 4096), (10, 16, 16), (16, 16, 16)])
def test_rescue_size_rounds_up_to_few_shapes(n_past, B, want):
    assert lp_ipm_batched.rescue_size(n_past, B) == want


def _solve(name):
    """``solve_box_lp_ops`` at m = 62 (RTS-24, the dense operator, plain
    K2) or m = 792 (case300s, the structured operator: block-Schur pass,
    rescue ladder and escalation, four iterations a solve so that the
    ladder's gates open)."""
    case = getattr(cases, name)()
    sys_ = build_system(case, device="cpu")
    if name == "rts24":
        down, load = _draw(case, sys_, 32, seed=11, boost=4.0, load_lo=0.8)
        c, A, b, l, u = dcopf.build_state_lp(sys_, *_lp(sys_, down, load),
                                             CompatFlags(), 6.0)
        ops, cfg = lp_ipm_batched.dense_linops(A), IPMConfig()
    else:
        down, load = _draw(case, sys_, 4, seed=12, boost=8.0, load_lo=0.9)
        g, br, ld = _lp(sys_, down, load)
        c, b, l, u, cs = dcopf.build_state_lp_vectors(sys_, g, br, ld,
                                                      CompatFlags(), 6.0)
        ops = dcopf.make_dc_linops(sys_, cs[:, :sys_.n_gen], br)
        cfg = IPMConfig(iterations=4, rescue_iterations=4)
    assert b.shape[1] == {"rts24": 62, "case300s": 792}[name]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the digests' thread count
    try:
        sol = lp_ipm_batched.solve_box_lp_ops(c, b, l, u, ops, cfg)
    finally:
        torch.set_num_threads(threads)
    h = hashlib.sha256()
    for t in sol:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_other_routes_keep_their_bits(name):
    assert _solve(name) == DIGESTS[name]


if __name__ == "__main__":
    for name in sorted(DIGESTS):
        print(f'    "{name}": "{_solve(name)}",')
