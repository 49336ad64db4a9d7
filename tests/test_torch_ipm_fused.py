"""PyTorch port: the K1 fused IPM (``ops/ipm_fused.py``) and the structured
LP solver (``engines/lp_ipm_structured.py``).

The plain PyTorch K1 is held against the reference Pallas kernel
``fused_ipm_iterations``, run in interpret mode on the CPU (as
tests/test_ipm_fused.py runs it), on B = 128 stressed RTS-24 lanes: tightly
after 2 iterations, and after the full 16 plus the polish on the LP
objective within 1e-3 p.u. (0.1 MW, tests/test_ipm_fused.py's bound). The
CUDA kernel is held against the plain version on the card in
tests/test_torch_gpu.py.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import (
    dcopf as ref_dcopf, lp_ipm_structured as ref_structured)
from powersystemsreliabilityassessment_tpu.ops import ipm_fused as ref_fused
from powersystemsreliabilityassessment_tpu.utils.config import (
    CompatFlags as RefCompat, IPMConfig as RefIPM)

from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched, lp_ipm_structured)
from powersystemsreliabilityassessment_tpu_torch.ops import (
    blocked_chol, ipm_fused)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

B = 128


@pytest.fixture(scope="module")
def setup():
    """tests/test_ipm_fused.py's lanes: 3x unavailability, a single line
    outage on every third lane, peak load."""
    ref_sys = ref_build_system(ref_cases.rts24())
    sys_ = from_reference(ref_sys, device="cpu")
    ng, nl, nc = ref_sys.n_gen, ref_sys.n_branch, ref_sys.n_comp
    rng = np.random.default_rng(11)
    down = rng.uniform(size=(B, nc)) < 3 * np.asarray(ref_sys.unavail)[None]
    down[:, 14] = False
    down[np.arange(0, B, 3),
         ng + rng.integers(0, nl, len(range(0, B, 3)))] = True
    gu = (1.0 - down[:, :ng]).astype(np.float32)
    bu = (1.0 - down[:, ng:]).astype(np.float32)
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (B, 1))
    ref_vec = ref_dcopf.build_state_lp_vectors(
        ref_sys, jnp.asarray(gu), jnp.asarray(bu), jnp.asarray(load),
        RefCompat(), RefIPM().theta_max)
    vec = dcopf.build_state_lp_vectors(
        sys_, torch.as_tensor(gu), torch.as_tensor(bu),
        torch.as_tensor(load), CompatFlags(), IPMConfig().theta_max)
    return ref_sys, sys_, bu, ref_vec, vec


def _np(t):
    return np.array(t)


def test_lp_vectors_match_reference(setup):
    _, _, _, ref_vec, vec = setup
    for r, g in zip(ref_vec, vec):
        np.testing.assert_array_equal(_np(r), g.numpy())


def test_materialized_lp_matches_reference(setup):
    # The port builds the whole batch at once; the reference one state
    # at a time under vmap (dcopf.py:1243-1246).
    ref_sys, sys_, bu, _, _ = setup
    rng = np.random.default_rng(4)
    gu = (rng.uniform(size=(8, 33)) > 0.1).astype(np.float32)
    load = np.tile(_np(ref_sys.load_pd)[None], (8, 1))
    ref = jax.vmap(lambda g, b_, ld: ref_dcopf.build_state_lp(
        ref_sys, g, b_, ld, RefCompat(), 6.0))(
        jnp.asarray(gu), jnp.asarray(bu[:8]), jnp.asarray(load))
    got = dcopf.build_state_lp(sys_, torch.as_tensor(gu),
                               torch.as_tensor(bu[:8]),
                               torch.as_tensor(load), CompatFlags(), 6.0)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_np(r), g.numpy())


def test_structure_matches_reference(setup):
    ref_sys, sys_, _, _, _ = setup
    ref_st, st = ref_fused.build_structure(ref_sys), \
        ipm_fused.build_structure(sys_)
    np.testing.assert_array_equal(_np(ref_st.a0_bal), st.a0_bal.numpy())
    np.testing.assert_array_equal(_np(ref_st.minc_ref), st.minc_ref.numpy())
    np.testing.assert_array_equal(_np(ref_st.inv_b)[:, 0], st.inv_b.numpy())
    assert (st.n, st.m) == (ref_st.n, ref_st.m) == (112, 62)


def test_structured_products_match_reference(setup):
    ref_sys, sys_, bu, ref_vec, vec = setup
    ref_st, st = ref_fused.build_structure(ref_sys), \
        ipm_fused.build_structure(sys_)
    rng = np.random.default_rng(5)
    v = rng.normal(size=(B, 112)).astype(np.float32)
    y = rng.normal(size=(B, 62)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(B, 112)).astype(np.float32)
    cs, rcs = vec[4], ref_vec[4]
    bt, bj = torch.as_tensor(bu), jnp.asarray(bu)
    # float32 sums of O(1) terms in another order: 2e-5, as
    # tests/test_ipm_fused.py holds the same products.
    pairs = [
        (ref_structured.mv(ref_st, rcs, bj, jnp.asarray(v)),
         lp_ipm_structured.mv(st, cs, bt, torch.as_tensor(v))),
        (ref_structured.mtv(ref_st, rcs, bj, jnp.asarray(y)),
         lp_ipm_structured.mtv(st, cs, bt, torch.as_tensor(y))),
        (ref_structured.normal_matrix(ref_st, rcs * rcs * jnp.asarray(w), bj),
         lp_ipm_structured.normal_matrix(st, cs * cs * torch.as_tensor(w),
                                         bt)),
    ]
    for r, g in pairs:
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=0, atol=2e-5)


def test_plain_k1_matches_reference_after_two_iterations(setup):
    ref_sys, sys_, bu, ref_vec, vec = setup
    c, b, l, u, cs = vec
    rc, rb, rl, ru, rcs = ref_vec
    ref = ref_fused.fused_ipm_iterations(
        ref_fused.build_structure(ref_sys), rcs, jnp.asarray(bu), rc, rb,
        rl, ru, RefIPM(iterations=2))
    got = ipm_fused.fused_ipm_iterations_plain(
        ipm_fused.build_structure(sys_), cs, torch.as_tensor(bu), c, b, l,
        u, IPMConfig(iterations=2))
    # (x, y, zl, zu, best_score, best_x). Two Newton steps from the same
    # start: only float32 rounding separates them (the reference solves
    # through 8x8 block inverses, the port by plain substitution), held
    # relative to each quantity's scale.
    for name, r, g in zip(("x", "y", "zl", "zu", "best_score", "best_x"),
                          ref, got):
        r, g = _np(r), g.numpy()
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g / scale, r / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_plain_solver_matches_reference_full_iterations(setup):
    ref_sys, sys_, bu, ref_vec, vec = setup
    c, b, l, u, cs = vec
    rc, rb, rl, ru, rcs = ref_vec
    ref = ref_structured.solve_box_lp_structured(
        ref_fused.build_structure(ref_sys), rcs, jnp.asarray(bu), rc, rb,
        rl, ru, RefIPM())
    got = lp_ipm_structured.solve_box_lp_structured(
        ipm_fused.build_structure(sys_), cs, torch.as_tensor(bu), c, b, l,
        u, IPMConfig())
    np.testing.assert_allclose(got.objective.numpy(), _np(ref.objective),
                               rtol=0, atol=1e-3)
    assert float(got.primal_residual.max()) < 2e-3
    assert float(got.objective.max()) > 1.0      # lanes that really shed
    assert bool((got.x >= l - 1e-5).all()) and bool((got.x <= u + 1e-5).all())


@pytest.mark.parametrize("m, route", [
    (1, "STRUCTURED"), (62, "STRUCTURED"), (72, "STRUCTURED"),
    (73, "BLOCKED"), (191, "BLOCKED"), (336, "BLOCKED"),
    (337, "LARGE"), (792, "LARGE")])
def test_lp_route_table(m, route):
    got = lp_ipm_batched.lp_route(m)
    assert got is getattr(lp_ipm_batched, route)
    # Graphs only where K1 leaves the host to pace the step; tier 1.5
    # and a SEQ block cap only past the blocked factor's range.
    assert got.graphs == (route == "STRUCTURED")
    assert got.island_pf == (route == "LARGE")
    assert (got.seq_block_lanes is None) == (route != "LARGE")
    assert got.rescue == {"STRUCTURED": "warm", "BLOCKED": "flagged",
                          "LARGE": "ladder"}[route]


@pytest.mark.parametrize("dev, m, factor, solve, iterate", [
    ("cpu", 62, None, None, ipm_fused.fused_ipm_iterations_plain),
    ("cuda", 62, None, None, ipm_fused.fused_ipm_iterations),
    # 72 < m <= 336: the blocked Cholesky on both devices (its K2 and K3
    # wrappers pick kernel or plain version by the tensor's device).
    ("cpu", 73, blocked_chol.blocked_cholesky,
     blocked_chol.blocked_cho_solve, None),
    ("cuda", 73, blocked_chol.blocked_cholesky,
     blocked_chol.blocked_cho_solve, None),
    ("cuda", 336, blocked_chol.blocked_cholesky,
     blocked_chol.blocked_cho_solve, None),
    # m > 336: the dense xla_chol factor with refinement, any device (the
    # block-Schur bulk pass of solve_box_lp_ops runs K2a / K3 instead).
    ("cpu", 337, lp_ipm_batched._large_factor, lp_ipm_batched._large_solve,
     None),
    ("cuda", 337, lp_ipm_batched._large_factor,
     lp_ipm_batched._large_solve, None),
])
def test_lp_route_kernels(dev, m, factor, solve, iterate):
    k = lp_ipm_batched.lp_route(m).kernels(torch.device(dev))
    assert k.iterate is iterate
    if factor is not None:
        assert k.factor is factor and k.solve is solve


def test_lp_route_kernels_are_read_at_each_call(monkeypatch):
    # The benchmark's K1 recorder swaps the CUDA entry after import.
    swapped = lp_ipm_batched._DIRECT_KERNELS["cuda"]._replace(iterate=len)
    monkeypatch.setitem(lp_ipm_batched._DIRECT_KERNELS, "cuda", swapped)
    assert lp_ipm_batched.lp_route(62).kernels("cuda") is swapped
    with pytest.raises(NotImplementedError):
        lp_ipm_batched.lp_route(62).kernels(torch.device("meta"))


def _hard_lanes():
    """The structure and structured LP inputs of the 29 hard SEQ LP lanes
    of RTS-24 in tests/golden/seq_hard_lanes.npz, with their lane ids."""
    d = np.load(pathlib.Path(__file__).parent / "golden"
                / "seq_hard_lanes.npz")
    sys_ = from_reference(ref_build_system(ref_cases.rts24()), device="cpu")
    up = 1.0 - torch.as_tensor(d["down"]).float()
    c, b, l, u, cs = dcopf.build_state_lp_vectors(
        sys_, up[:, :33], up[:, 33:].contiguous(), torch.as_tensor(d["load"]),
        CompatFlags(), IPMConfig().theta_max)
    return (ipm_fused.build_structure(sys_),
            (cs, up[:, 33:].contiguous(), c, b, l, u), d["lane"])


def _highs_objectives(st, args):
    """Float64 HiGHS optima of the structured LP lanes ``args``."""
    cs, bu, c, b, l, u = args
    eye = torch.eye(st.n)
    out = []
    for i in range(c.shape[0]):
        A = ipm_fused.mv(st, cs[i].expand(st.n, -1), bu[i].expand(st.n, -1),
                         eye).T
        f = lambda t: t.double().numpy()
        r = linprog(f(c[i]), A_eq=f(A), b_eq=f(b[i]),
                    bounds=list(zip(f(l[i]), f(u[i]))), method="highs")
        assert r.status == 0
        out.append(r.fun)
    return np.asarray(out)


def test_plain_k1_on_hard_seq_lanes_is_optimal_or_flagged():
    """29 hard SEQ LP lanes of RTS-24 (tests/golden/seq_hard_lanes.npz,
    written by scripts/torch_seq_lane_faults.py --golden: the outage
    states and hourly loads of the lanes of chip_smoke.py seq's 4,096-lane
    buffer, drawn on the card at seed 11, where K1 and the plain version
    part by more than 1e-3 p.u. on the card, or where the plain version
    ends more than 5e-3 p.u. from the optimum on the CPU). The plain
    version and the reference kernel part at the fourth Mehrotra
    iteration, once the barrier weights make the normal matrix
    ill-conditioned, and which lanes then stall depends on the float32
    rounding order (PERF.md §6): after K1 and the polish alone, 6 of the
    29 lanes end more than 5e-3 p.u. off the float64 HiGHS optimum and
    15 fail the evaluator's 5e-3 quality guard. The solver's warm rescue
    of the worst lanes (``lp_ipm_structured._warm_rescue``) brings every
    lane within 5e-3 of the optimum and past none of the guard."""
    st, args, lanes = _hard_lanes()
    sol = lp_ipm_structured.solve_box_lp_structured(st, *args, IPMConfig())
    quality = (sol.primal_residual + 2 * st.n * sol.duality_gap).numpy()
    err = np.abs(sol.objective.double().numpy() - _highs_objectives(st, args))
    assert (err <= 5e-3).all(), dict(zip(lanes[err > 5e-3], err[err > 5e-3]))
    assert (quality <= 5e-3).all(), lanes[quality > 5e-3]


def test_plain_k1_from_the_box_midpoint_is_the_default_start(setup):
    ref_sys, sys_, bu, _, vec = setup
    c, b, l, u, cs = vec
    st = ipm_fused.build_structure(sys_)
    args = (st, cs, torch.as_tensor(bu), c, b, l, u, IPMConfig())
    cold = ipm_fused.fused_ipm_iterations_plain(*args)
    mid = ipm_fused.fused_ipm_iterations_plain(*args, 0.5 * (l + u))
    wrapper = ipm_fused.fused_ipm_iterations(*args, x_init=0.5 * (l + u))
    for a, m, w in zip(cold, mid, wrapper):
        assert torch.equal(a, m) and torch.equal(a, w)


def test_plain_k1_from_a_start_point_starts_there(setup):
    # One iteration from an interior start: the first best iterate is the
    # start itself, and the step moves from it, not from the midpoint.
    _, sys_, bu, _, vec = setup
    c, b, l, u, cs = vec
    st = ipm_fused.build_structure(sys_)
    start = l + 0.3 * (u - l)
    x, _, _, _, score, best_x = ipm_fused.fused_ipm_iterations_plain(
        st, cs, torch.as_tensor(bu), c, b, l, u, IPMConfig(iterations=1),
        start)
    assert torch.equal(best_x, start)
    assert bool(torch.isfinite(score).all())
    cold = ipm_fused.fused_ipm_iterations_plain(
        st, cs, torch.as_tensor(bu), c, b, l, u, IPMConfig(iterations=1))[0]
    assert float((x - cold).abs().max()) > 1e-3


def test_rescue_keeps_the_bits_of_lanes_that_pass_the_guard(setup,
                                                            monkeypatch):
    # A clean RTS-24 buffer (64 states at the outage rates, peak load):
    # every lane passes the guard after the polish, so the warm rescue
    # still runs on its 16 lanes but writes nothing back.
    ref_sys, sys_, _, _, _ = setup
    rng = np.random.default_rng(5)
    down = rng.uniform(size=(64, 71)) < np.asarray(ref_sys.unavail)[None]
    down[:, 14] = False
    up = 1.0 - torch.as_tensor(down).float()
    bu = up[:, 33:].contiguous()
    c, b, l, u, cs = dcopf.build_state_lp_vectors(
        sys_, up[:, :33], bu, sys_.load_pd[None].expand(64, -1),
        CompatFlags(), IPMConfig().theta_max)
    st = ipm_fused.build_structure(sys_)
    args = (st, cs, bu, c, b, l, u, IPMConfig())
    calls = []
    rescue = lp_ipm_structured._warm_rescue
    monkeypatch.setattr(lp_ipm_structured, "_warm_rescue",
                        lambda *a: calls.append(a[-1].idx.numel())
                        or rescue(*a))
    with_rescue = lp_ipm_structured.solve_box_lp_structured(*args)
    assert calls == [lp_ipm_structured.RESCUE_LANES]
    monkeypatch.setattr(lp_ipm_structured, "RESCUE_LANES", 0)
    without = lp_ipm_structured.solve_box_lp_structured(*args)
    assert len(calls) == 1
    q = without.primal_residual + 2 * st.n * without.duality_gap
    assert bool((q <= IPMConfig().escalate_tol).all())
    for a, w in zip(with_rescue, without):
        assert torch.equal(a, w)


def test_rescue_writes_back_only_flagged_lanes():
    # The hard lanes: lanes past the guard after the polish take the
    # rescue's result, lanes within it keep their bits, and the rescue
    # touches at most RESCUE_LANES lanes.
    st, args, _ = _hard_lanes()
    cfg = IPMConfig()
    on = lp_ipm_structured.solve_box_lp_structured(st, *args, cfg)
    saved = lp_ipm_structured.RESCUE_LANES
    try:
        lp_ipm_structured.RESCUE_LANES = 0
        off = lp_ipm_structured.solve_box_lp_structured(st, *args, cfg)
    finally:
        lp_ipm_structured.RESCUE_LANES = saved
    q_off = (off.primal_residual + 2 * st.n * off.duality_gap)
    flagged = q_off > cfg.escalate_tol
    changed = (on.x != off.x).any(1)
    assert int(flagged.sum()) == 15
    assert not bool((changed & ~flagged).any())
    assert int(changed.sum()) <= saved
    assert bool(changed[flagged].all())


@pytest.mark.parametrize("rescue_lanes", [16, 4])
def test_lp_counters_on_the_hard_lanes(rescue_lanes, monkeypatch):
    """The screened evaluator's LP counters under a profiler, on the 29
    hard SEQ lanes in a 40-lane buffer (11 padding lanes, copies of the
    first), against counts made here from the solver's own pieces:
    ``lp.real_lanes`` the LP queue clamped to the buffer,
    ``lp.rescue_demand`` the buffer lanes past ``escalate_tol`` after
    K1 and the polish, ``lp.guard_fallback`` the real lanes that
    ``_finalize``'s 5e-3 guard sends back to the certificate's bound. The
    padding lanes are hard too and take some of the rescue's lanes, so
    real lanes stay past the guard at either rescue size."""
    from powersystemsreliabilityassessment_tpu_torch.utils import profiling
    monkeypatch.setattr(lp_ipm_structured, "RESCUE_LANES", rescue_lanes)
    d = np.load(pathlib.Path(__file__).parent / "golden"
                / "seq_hard_lanes.npz")
    sys_ = from_reference(ref_build_system(ref_cases.rts24()), device="cpu")
    down = torch.as_tensor(d["down"])
    load = torch.as_tensor(d["load"])
    max_lp, cfg = 40, IPMConfig()
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        dcopf.evaluate_states_screened(sys_, down, load, max_lp,
                                       CompatFlags(), cfg)
    got = profiling.counters()
    profiling.reset_counters()

    pre = dcopf.certify_states(sys_, down, load)
    need = ~(pre.certified & (pre.deficit <= 0))
    real = int(need.sum())
    # The buffer: the needy lanes in order, then the rest, then padding.
    order = [i for i in range(len(need)) if need[i]] + \
        [i for i in range(len(need)) if not need[i]]
    buf = torch.tensor(order[:max_lp] + [0] * (max_lp - len(order)))
    valid = torch.arange(max_lp) < real
    shed, pg, quality = dcopf._solve_batch(sys_, down[buf], load[buf],
                                           CompatFlags(), cfg)
    cert = dcopf.certify_states(sys_, down[buf], load[buf], shed_hint=shed)
    guard = ~cert.certified & ~(quality <= 5e-3)
    monkeypatch.setattr(lp_ipm_structured, "RESCUE_LANES", 0)
    first = dcopf._solve_batch(sys_, down[buf], load[buf], CompatFlags(),
                               cfg)[2]

    assert got["lp.buffer_lanes"] == max_lp
    assert got["lp.real_lanes"] == min(real, max_lp) == 29
    assert got["lp.rescue_demand"] == int((first > cfg.escalate_tol).sum())
    assert got["lp.guard_fallback"] == int((guard & valid).sum())
    # Lanes on both sides of the guard, padding lanes past it uncounted.
    assert 0 < got["lp.guard_fallback"] < real
    assert bool(guard[~valid].any())
