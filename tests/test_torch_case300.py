"""PyTorch port: the large-m LP path (m > 336) on ``case300s`` (300 buses,
396 units, 492 branches; LP m = 792, n = 1,392) against the JAX package
and float64 HiGHS on the CPU.

* ``case300s`` arrays equal to the reference's.
* ``make_dc_linops``: ``mv``, ``mtv``, ``gram``, ``take`` and one
  ``schur_factor`` + ``schur_solve`` pass against the reference's on the
  same seeded numpy inputs (3 lanes).
* ``ops/xla_chol.py``: ``factor`` (one block; the reference's L^-1 is
  padded to its 128-wide panels), ``solve`` and ``inv_spd_equilibrated``
  against the reference's.
* ``blocked_chol.explicit_spd_inv`` (the plain K2a / K3 underneath)
  against a float64 inverse at nb = 300 and at a width with a remainder
  panel.
* ``solve_box_lp_ops`` with the default ``IPMConfig`` on the 4 deep
  contingencies of tests/test_case300.py: DNS within 1.5 MW of HiGHS
  (that test's bound) and every quality score under the evaluator's 5e-3
  guard; without the rescue ladder the same lanes miss by tens of MW.
* The same with ``restart_compact=2`` (more hard lanes than the rescue
  holds), in both packages: each lane within 1.5 MW or past the guard,
  and the port solves at least the lanes the reference solves.
* ``_merge_lanes`` keeps the better lane.
* ``evaluate_states(case300s)`` on seeded states against the reference's
  ``evaluate_states``: DNS and failure flags.

Module-scoped fixtures build each system and LP batch once.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import (
    dcopf as ref_dcopf, lp_ipm_batched as ref_lp)
from powersystemsreliabilityassessment_tpu.ops import xla_chol as ref_xla
from powersystemsreliabilityassessment_tpu.utils.config import (
    IPMConfig as RefIPMConfig)

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched)
from powersystemsreliabilityassessment_tpu_torch.ops import (
    blocked_chol, xla_chol)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig)
from test_torch_gpu import concentrated_300

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

# tests/test_case300.py's bound on the deep lanes against HiGHS.
ORACLE_TOL_MW = 1.5
GUARD = 5e-3    # the evaluator's lane-quality guard (dcopf._finalize)


@pytest.fixture(scope="module")
def systems():
    ref_sys = ref_build_system(ref_cases.case300s())
    return ref_sys, from_reference(ref_sys, device="cpu")


@pytest.fixture(scope="module")
def deep_lps(systems):
    """tests/test_case300.py's 4 deep contingencies: the port's LP
    vectors, the structured operator and the float64 HiGHS DNS of the
    same float32-built LPs."""
    _, sys_ = systems
    ng, nd = sys_.n_gen, sys_.n_load
    states = concentrated_300(cases.case300s(), 4)
    up = torch.as_tensor(1.0 - states)
    gen_up, br_up = up[:, :ng], up[:, ng:].contiguous()
    load = sys_.load_pd[None, :].expand(4, nd)
    c, A, b, l, u = dcopf.build_state_lp(sys_, gen_up, br_up, load,
                                         CompatFlags(), 6.0)
    refs = []
    for i in range(4):
        f = lambda t: t[i].double().numpy()
        r = linprog(f(c), A_eq=f(A), b_eq=f(b), bounds=list(zip(f(l), f(u))),
                    method="highs")
        assert r.status == 0, r.message
        refs.append(float(r.x[ng:ng + nd].sum()) * sys_.base_mva)
    *_, cs = dcopf.build_state_lp_vectors(sys_, gen_up, br_up, load,
                                          CompatFlags(), 6.0)
    ops = dcopf.make_dc_linops(sys_, cs[:, :ng], br_up)
    return c, b, l, u, ops, np.asarray(refs)


def _dns(sol, sys_):
    ng, nd = sys_.n_gen, sys_.n_load
    return sol.x[:, ng:ng + nd].sum(1).numpy() * sys_.base_mva


def _quality(sol):
    return (sol.primal_residual + 2 * sol.x.shape[1] * sol.duality_gap
            ).numpy()


def test_case300s_arrays_match_reference():
    a, b = ref_cases.case300s(), cases.case300s()
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert (b.n_bus, b.n_gen, b.n_branch) == (300, 396, 492)


def _operator_inputs(sys_, n=3, seed=11):
    """Seeded states (one concentrated, two with scattered outages) and
    operator inputs as numpy float32."""
    rng = np.random.default_rng(seed)
    ng, nl = sys_.n_gen, sys_.n_branch
    states = concentrated_300(cases.case300s(), n)
    states[1:, ng + rng.integers(0, nl, 6)] = 1.0
    gen_col = (1.0 - states[:, :ng]) * (sys_.gen_pmax.numpy() > 0)
    br_up = (1.0 - states[:, ng:]).astype(np.float32)
    m, nv = sys_.n_bus + nl, ng + sys_.n_load + nl + sys_.n_bus
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(gen_col=f32(gen_col), br_up=br_up,
                v=f32(rng.normal(size=(n, nv))),
                y=f32(rng.normal(size=(n, m))),
                w=f32(rng.uniform(0.1, 10.0, size=(n, nv))),
                r=f32(rng.normal(size=(n, m))))


def _both_linops(systems, inp):
    ref_sys, sys_ = systems
    ref = ref_dcopf.make_dc_linops(ref_sys, jnp.asarray(inp["gen_col"]),
                                   jnp.asarray(inp["br_up"]))
    got = dcopf.make_dc_linops(sys_, torch.as_tensor(inp["gen_col"]),
                               torch.as_tensor(inp["br_up"]))
    return ref, got


def test_dc_linops_products_match_reference(systems):
    inp = _operator_inputs(systems[1])
    ref, got = _both_linops(systems, inp)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    # float32 sums of O(1)-O(10) terms in another order (the reference
    # test's tolerances against the materialized tensor).
    for name, key, tol in (("mv", "v", 2e-5), ("mtv", "y", 2e-5),
                           ("gram", "w", 1e-4)):
        np.testing.assert_allclose(
            getattr(got, name)(t[key]).numpy(),
            np.asarray(getattr(ref, name)(j[key])), rtol=tol, atol=tol,
            err_msg=name)
    np.testing.assert_allclose(got.normal(t["w"]).numpy(),
                               np.asarray(ref.normal(j["w"])), rtol=1e-4,
                               atol=1e-4)
    sub = got.take(torch.tensor([2, 0]))
    np.testing.assert_array_equal(sub.mv(t["v"][[2, 0]]).numpy(),
                                  got.mv(t["v"]).numpy()[[2, 0]])


def test_schur_factor_and_solve_match_reference(systems):
    inp = _operator_inputs(systems[1])
    ref, got = _both_linops(systems, inp)
    w, r = inp["w"], inp["r"]
    ridge, delta = 0.0, 1e-7
    F_ref = ref.schur_factor(jnp.asarray(w), ridge, delta)
    F = got.schur_factor(torch.as_tensor(w), ridge, delta)
    # The factor's pieces: alpha, dphi, K and S are the same float32
    # products; K^-1 and S^-1 are explicit inverses through different
    # routes (the port: explicit_spd_inv on the plain K2a / K3; the
    # reference on the CPU: xla_chol.factor), so they agree to the
    # inverses' float32 rounding, ~cond eps relative to their scale.
    for name, a, b in zip(("alpha", "dphi", "K", "Kinv", "S", "Sinv"),
                          F_ref, F):
        a, b = np.asarray(a, np.float64), b.double().numpy()
        scale = np.abs(a).max()
        tol = 1e-5 if name in ("alpha", "dphi", "K", "S") else 2e-3
        assert np.abs(a - b).max() <= tol * scale, name
    y_ref = np.asarray(ref.schur_solve(F_ref, jnp.asarray(r)), np.float64)
    y = got.schur_solve(F, torch.as_tensor(r)).double().numpy()
    assert np.abs(y - y_ref).max() <= 2e-3 * np.abs(y_ref).max()
    # Refined against the matrix-free operator (lp_ipm_batched's
    # _schur_solvers), the solve lands within cond(N) eps_f32 of a
    # float64 solve of A diag(w) A' y = r (cond ~1e5 here), as the
    # reference's refined solve does, and next to it.
    nfactor, nsolve = lp_ipm_batched._schur_solvers(
        got.mv, got.mtv, got.schur_factor, got.schur_solve, delta)
    yr = nsolve(nfactor(torch.as_tensor(w)), torch.as_tensor(r)).double()
    rf, rs = ref_lp._schur_solvers(ref.mv, ref.mtv, ref.schur_factor,
                                   ref.schur_solve, np.float32(delta))
    yr_ref = torch.as_tensor(np.asarray(
        rs(rf(jnp.asarray(w)), jnp.asarray(r)), np.float64))
    N = got.gram(torch.as_tensor(w)).double()
    y64 = torch.linalg.solve(N, torch.as_tensor(r).double()[:, :, None])
    scale = y64[:, :, 0].abs().amax(1)
    bound = torch.linalg.cond(N) * 2.0 ** -24
    err = (yr - y64[:, :, 0]).abs().amax(1) / scale
    assert bool((err <= bound).all()), (err, bound)
    assert bool(((yr - yr_ref).abs().amax(1) / scale <= bound).all())


def _spd64(n, m, seed, spread=0.05):
    """Equilibrated float64 SPD matrices G G' (G [m, 2m], columns scaled
    by uniform(spread, 1); cond ~1e2-1e3) and float32 copies."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, m, 2 * m)) * rng.uniform(spread, 1.0,
                                                      size=(n, 1, 2 * m))
    M = G @ G.transpose(0, 2, 1)
    s = 1.0 / np.sqrt(np.einsum("bii->bi", M))
    M = M * s[:, :, None] * s[:, None, :]
    return M, M.astype(np.float32)


@pytest.mark.parametrize("m", [300, 792])
def test_xla_chol_matches_reference(m):
    M64, M = _spd64(2, m, seed=m)
    r = np.random.default_rng(3).normal(size=(2, m)).astype(np.float32)
    Linv_ref, m_ref = ref_xla.factor(jnp.asarray(M))
    x_ref = np.asarray(ref_xla.solve((Linv_ref, m_ref), jnp.asarray(r)))
    x64 = np.linalg.solve(M64, r.astype(np.float64)[:, :, None])[:, :, 0]
    scale = np.abs(x64).max()
    Linv = xla_chol.factor(torch.as_tensor(M))
    x = xla_chol.solve(Linv, torch.as_tensor(r)).double().numpy()
    # The reference pads m to its 128-wide panels with an identity
    # corner, so its L^-1's leading [m, m] block is the port's. An
    # explicit triangular inverse amplifies float32 rounding by ~cond(L)
    # = sqrt(cond(M)) ~ 1e2 here, relative to its largest entry, and the
    # two factor in different orders (one block against the panels).
    Linv_ref = np.asarray(Linv_ref)
    np.testing.assert_allclose(Linv.numpy(), Linv_ref[:, :m, :m], rtol=0,
                               atol=1e-2 * np.abs(Linv_ref).max())
    # Explicit-inverse solves land within ~cond eps of the float64
    # solve, as the reference's does.
    assert np.abs(x - x64).max() <= 2e-3 * scale
    assert np.abs(x - x_ref).max() <= 4e-3 * scale
    inv64 = np.linalg.inv(M64 + 1e-6 * np.eye(m))
    inv_ref = np.asarray(ref_xla.inv_spd_equilibrated(jnp.asarray(M), 1e-6))
    inv = xla_chol.inv_spd_equilibrated(torch.as_tensor(M), 1e-6).numpy()
    s = np.abs(inv64).max()
    assert np.abs(inv - inv64).max() <= 2e-3 * s
    assert np.abs(inv - inv_ref).max() <= 4e-3 * s


def test_xla_chol_gives_nan_for_a_lane_that_is_not_positive_definite():
    _, M = _spd64(2, 300, seed=5)
    M[1, 0, 0] = -1.0
    Linv = xla_chol.factor(torch.as_tensor(M))
    assert bool(torch.isfinite(Linv[0]).all())
    assert bool(torch.isnan(Linv[1]).all())


@pytest.mark.parametrize("m", [300, 130])
def test_explicit_spd_inv_matches_float64(m):
    # 300 = 5 x 56 + 20 (the case300s K and S); 130 = 56 + 56 + 18.
    M64, M = _spd64(3, m, seed=7, spread=0.2)
    before = dict(blocked_chol.launches)
    inv = blocked_chol.explicit_spd_inv(torch.as_tensor(M)).double().numpy()
    assert blocked_chol.launches == before       # CPU: the plain versions
    inv64 = np.linalg.inv(M64)
    # The panel lift (LIFT 1e-5 relative) and float32 rounding: the
    # callers refine against the true operator; here ~cond * 1e-5.
    cond = np.linalg.cond(M64)
    err = np.abs(inv - inv64).max(axis=(1, 2)) / np.abs(inv64).max(
        axis=(1, 2))
    assert (err <= np.maximum(1e-4, 1e-5 * cond)).all(), (err, cond)


def test_deep_lanes_match_highs_with_the_rescue_ladder(deep_lps, systems):
    c, b, l, u, ops, refs = deep_lps
    sol = lp_ipm_batched.solve_box_lp_ops(c, b, l, u, ops, IPMConfig())
    err = np.abs(_dns(sol, systems[1]) - refs)
    assert err.max() < ORACLE_TOL_MW, (err, refs)
    assert _quality(sol).max() < GUARD
    assert refs.min() > 600.0      # transmission-limited deep shed


def test_deep_lanes_need_the_rescue_ladder(deep_lps, systems):
    # The bulk pass alone (no restart, compaction or escalation) sends
    # every deep lane past the guard, tens of MW from the optimum.
    c, b, l, u, ops, refs = deep_lps
    cfg = IPMConfig(restarts=0, escalate_passes=0, restart_compact=0)
    sol = lp_ipm_batched.solve_box_lp_ops(c, b, l, u, ops, cfg)
    assert (_quality(sol) > GUARD).all()
    assert (np.abs(_dns(sol, systems[1]) - refs) > 10.0).all()


def test_deep_lanes_past_restart_compact_are_solved_or_flagged(deep_lps,
                                                               systems):
    # More hard lanes (4) than the rescue's sub-buffer (2): the lanes
    # left out get only the full-buffer escalation. The reference ends
    # the same way on these lanes (ROADMAP.md, "Faults in the
    # reference"): lane 1 (806 MW) stays tens of MW off, past the guard.
    # What the evaluator needs holds: a lane is within the oracle bound
    # or past the guard, which bounds it; and the port solves at least
    # the lanes the reference solves.
    ref_sys, sys_ = systems
    c, b, l, u, ops, refs = deep_lps
    sol = lp_ipm_batched.solve_box_lp_ops(c, b, l, u, ops,
                                          IPMConfig(restart_compact=2))
    err = np.abs(_dns(sol, sys_) - refs)
    q = _quality(sol)
    assert ((err < ORACLE_TOL_MW) | (q > GUARD)).all(), (err, q)
    assert (err < ORACLE_TOL_MW).sum() >= 3
    ng, nd = sys_.n_gen, sys_.n_load
    states = concentrated_300(cases.case300s(), 4)
    up = torch.as_tensor(1.0 - states)
    *_, cs = dcopf.build_state_lp_vectors(
        sys_, up[:, :ng], up[:, ng:].contiguous(),
        sys_.load_pd[None, :].expand(4, nd), CompatFlags(), 6.0)
    rops = ref_dcopf.make_dc_linops(ref_sys, jnp.asarray(cs[:, :ng].numpy()),
                                    jnp.asarray(1.0 - states[:, ng:]))
    rsol = ref_lp.solve_box_lp_ops(
        *(jnp.asarray(t.numpy()) for t in (c, b, l, u)), rops,
        RefIPMConfig(restart_compact=2))
    rerr = np.abs(np.asarray(rsol.x[:, ng:ng + nd].sum(1)) * sys_.base_mva
                  - refs)
    rq = np.asarray(rsol.primal_residual
                    + 2 * c.shape[1] * rsol.duality_gap)
    assert ((rerr < ORACLE_TOL_MW) | (rq > GUARD)).all(), (rerr, rq)
    assert (err < ORACLE_TOL_MW).sum() >= (rerr < ORACLE_TOL_MW).sum(), (
        err, rerr)


def _sol(obj, rp, gap, n=4):
    B = len(obj)
    x = torch.arange(B, dtype=torch.float32)[:, None].expand(B, n)
    return lp_ipm_batched.LPBatchSolution(
        x=x, objective=torch.tensor(obj), primal_residual=torch.tensor(rp),
        duality_gap=torch.tensor(gap))


def test_merge_lanes_keeps_the_better_lane():
    # Lane 0: new has the lower objective, both clean -> new. Lane 1: new
    # is infeasible (rp past 3e-4) -> old. Lane 2: new's gap bound 2 n
    # gap is past 1e-3 (suboptimal, the cold-basin case) -> old. Lane 3:
    # old is infeasible, new clean but a higher objective -> new.
    new = _sol([1.0, 0.5, 0.5, 2.0], [0.0, 1e-2, 0.0, 0.0],
               [0.0, 0.0, 1e-3, 0.0])
    old = _sol([2.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 1e-2],
               [0.0, 0.0, 0.0, 0.0])
    old = old._replace(x=old.x + 10.0)
    got = lp_ipm_batched._merge_lanes(new, old)
    take_new = np.array([True, False, False, True])
    want = np.where(take_new, new.objective.numpy(), old.objective.numpy())
    np.testing.assert_array_equal(got.objective.numpy(), want)
    np.testing.assert_array_equal(
        got.x.numpy(), np.where(take_new[:, None], new.x.numpy(),
                                old.x.numpy()))


def test_evaluate_states_matches_reference(systems):
    ref_sys, sys_ = systems
    case = cases.case300s()
    rng = np.random.default_rng(300)
    down = np.zeros((4, case.n_comp), np.float32)
    down[:2] = concentrated_300(case, 2)
    for i in (2, 3):        # scattered outages: mostly no shed
        down[i, rng.choice(case.n_gen, 6, replace=False)] = 1.0
        down[i, case.n_gen + rng.choice(case.n_branch, 3,
                                        replace=False)] = 1.0
    load = np.tile(sys_.load_pd.numpy()[None], (4, 1))
    ref = ref_dcopf.evaluate_states(ref_sys, jnp.asarray(down),
                                    jnp.asarray(load))
    got = dcopf.evaluate_states(sys_, torch.as_tensor(down),
                                torch.as_tensor(load))
    np.testing.assert_allclose(got.dns_mw.numpy(), np.asarray(ref.dns_mw),
                               rtol=0, atol=ORACLE_TOL_MW)
    np.testing.assert_array_equal(got.failure.numpy(),
                                  np.asarray(ref.failure))
    assert (got.primal_residual.numpy() < GUARD).all()
    assert got.dns_mw.numpy()[:2].min() > 600.0
