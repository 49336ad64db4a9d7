"""PyTorch port: the generic batched LP solver
(``engines/lp_ipm_batched.py::solve_box_lp_batched``) and the DC-OPF
evaluators (``engines/dcopf.py``) on the cases of the reference's
tests/test_lp_dcopf.py, against float64 oracles on the CPU.

Two oracles judge every case: scipy's HiGHS and the reference package's
C++ float64 interior-point solver (``native.solve_box_lp_f64``, whose
loader imports only ctypes and numpy). The reference's single-LP solver
(``engines/lp_ipm.py``) is not ported, so its cases run through
``solve_box_lp_batched`` at B = 1; they also run at 72 < m <= 336, where
the solver takes the blocked Cholesky (the plain K2 and K3 here).
Tolerances are the reference test's unless stated; a DNS is in MW and
held after the evaluator's 0.1 MW noise floor.

The ``slow`` test evaluates all 2,486 RTS-24 states with at most two
outages and holds each against HiGHS, as scripts/parity_n2_exhaustive.py
does for the reference (results/n2_exhaustive_parity.json).
"""
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from powersystemsreliabilityassessment_tpu import native
from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.sampling import enumeration
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMPAT = CompatFlags()
IPM = IPMConfig()
NG = 33
# The two float64 oracles agree on these LPs to far below the float32
# solver's error (tests/test_native.py: 1e-7 on random LPs).
ORACLES_AGREE = 1e-6
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the C++ oracle's loader builds it "
                                      "with g++ when the library is stale")


@pytest.fixture(scope="module", autouse=True)
def private_oracle_build(tmp_path_factory):
    """Build the C++ oracle into this module's own temporary directory:
    tests/test_native.py may build native/libboxlp.so in another worker
    at the same moment, and a half-written library cannot be loaded."""
    saved = native._SO, native._lib
    if native._lib is None and shutil.which("g++") is not None:
        native._SO = str(tmp_path_factory.mktemp("native") / "libboxlp.so")
    yield
    native._SO, native._lib = saved


@pytest.fixture(scope="module")
def sys24():
    return from_reference(ref_build_system(ref_cases.rts24()), device="cpu")


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _highs(c, A, b, l, u):
    r = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(l, u)), method="highs")
    assert r.status == 0, r.message
    return r.fun


def _random_lps(rng, B, m, n):
    """Feasible random box LPs (reference test_random_lps_vs_scipy):
    b = A x0 for an interior x0, box [0, 1]."""
    A = rng.normal(size=(B, m, n))
    b = np.einsum("bmn,bn->bm", A, rng.uniform(0.2, 0.8, (B, n)))
    c = rng.normal(size=(B, n))
    return c, A, b, np.zeros((B, n)), np.ones((B, n))


def _solve(c, A, b, l, u, cfg=IPM):
    return lp_ipm_batched.solve_box_lp_batched(
        *(_t(v) for v in (c, A, b, l, u)), cfg)


def _state_lp(sys_, down, load):
    """float64 numpy (c, A, b, l, u) of each state's LP as the port
    builds it (float32), for the oracles."""
    up = 1.0 - _t(down)
    lp = dcopf.build_state_lp(sys_, up[:, :sys_.n_gen],
                              up[:, sys_.n_gen:].contiguous(), _t(load),
                              COMPAT, IPM.theta_max)
    return [t.double().numpy() for t in lp]


def _oracle_dns(sys_, down, load, native_too=True):
    """[B] float64 optimal DNS in MW after the noise floor, from HiGHS;
    the C++ oracle must agree with it on every lane."""
    lp = _state_lp(sys_, down, load)
    out = []
    for i in range(lp[0].shape[0]):
        lane = [v[i] for v in lp]
        fun = _highs(*lane)
        if native_too:
            _, obj = native.solve_box_lp_f64(*lane)
            assert obj == pytest.approx(fun, abs=ORACLES_AGREE), i
        out.append(fun * sys_.base_mva)
    out = np.asarray(out)
    return np.where(out < COMPAT.dns_noise_floor_mw, 0.0, out)


def _peak(sys_, B):
    return np.tile(sys_.load_pd.numpy()[None, :], (B, 1))


def _random_states(seed, B, scale=1.0):
    rng = np.random.default_rng(seed)
    u = twostate.unavailability(cases.rts24())
    down = rng.uniform(size=(B, 71)) < scale * u[None, :]
    down[:, 14] = False          # the pinned synchronous condenser
    return down


def _evaluate(sys_, down, load, how, compat=COMPAT):
    if how == "full":
        return dcopf.evaluate_states(sys_, _t(down, torch.bool), _t(load),
                                     compat, IPM)
    res, n_over = dcopf.evaluate_states_screened(
        sys_, _t(down, torch.bool), _t(load), down.shape[0], compat, IPM)
    assert int(n_over) == 0
    return res


# -- the generic box-LP solver ---------------------------------------------

@needs_gxx
@pytest.mark.parametrize("m,n", [(6, 16), (80, 160)])
def test_random_lps_vs_oracles(m, n):
    # m = 6 takes the direct batched Cholesky, m = 80 the blocked one
    # (two panels). Each LP alone (B = 1) and all ten as one batch.
    c, A, b, l, u = _random_lps(np.random.default_rng(7), 10, m, n)
    batch = _solve(c, A, b, l, u)
    for i in range(10):
        ref = _highs(c[i], A[i], b[i], l[i], u[i])
        _, obj = native.solve_box_lp_f64(c[i], A[i], b[i], l[i], u[i])
        assert obj == pytest.approx(ref, abs=ORACLES_AGREE)
        one = _solve(c[i:i + 1], A[i:i + 1], b[i:i + 1], l[i:i + 1],
                     u[i:i + 1])
        for sol in (one, batch):
            j = 0 if sol is one else i
            assert float(sol.primal_residual[j]) < 2e-3
            assert float(sol.objective[j]) == pytest.approx(ref, abs=2e-2)


@pytest.mark.parametrize("m,n", [(4, 10), (80, 160)])
def test_batch_matches_single(m, n):
    rng = np.random.default_rng(1)
    c, A, b, l, u = _random_lps(rng, 5, m, n)
    out = _solve(c, A, b, l, u)
    for i in range(5):
        one = _solve(c[i:i + 1], A[i:i + 1], b[i:i + 1], l[i:i + 1],
                     u[i:i + 1])
        assert float(out.objective[i]) == pytest.approx(
            float(one.objective[0]), abs=5e-3)


@needs_gxx
def test_state_lps_vs_oracles(sys24):
    # The materialized RTS-24 LPs of random states through the generic
    # solver (the route the evaluator takes at 72 < m <= 336, here at
    # m = 62): objectives within 1e-3 p.u. (0.1 MW) of both oracles on
    # every lane whose quality passes the evaluator's 5e-3 guard.
    down = _random_states(11, 16, scale=3.0)
    lp = _state_lp(sys24, down, _peak(sys24, 16))
    sol = _solve(*lp)
    q = (sol.primal_residual + 2 * lp[0].shape[1] * sol.duality_gap).numpy()
    assert (q <= 5e-3).sum() >= 14
    for i in np.flatnonzero(q <= 5e-3):
        lane = [v[i] for v in lp]
        ref = _highs(*lane)
        _, obj = native.solve_box_lp_f64(*lane)
        assert obj == pytest.approx(ref, abs=ORACLES_AGREE)
        assert float(sol.objective[i]) == pytest.approx(ref, abs=1e-3), i


# -- the DC-OPF evaluators ---------------------------------------------------

@pytest.mark.parametrize("how", ["full", "screened"])
def test_intact_system_no_shed(sys24, how):
    res = _evaluate(sys24, np.zeros((1, 71), bool), _peak(sys24, 1), how)
    assert float(res.dns_mw[0]) == 0.0
    assert not bool(res.failure[0])


@pytest.mark.parametrize("how", ["full", "screened"])
def test_total_blackout(sys24, how):
    down = np.zeros((1, 71), bool)
    down[0, :NG] = True
    res = _evaluate(sys24, down, _peak(sys24, 1), how)
    assert float(res.dns_mw[0]) == pytest.approx(2850.0, abs=0.5)
    assert bool(res.failure[0])


@needs_gxx
@pytest.mark.parametrize("how", ["full", "screened"])
def test_capacity_deficit_equals_copper_sheet(sys24, how):
    # Both 400 MW units out at peak: 3405 - 800 = 2605 < 2850 -> 245 MW.
    down = np.zeros((1, 71), bool)
    down[0, 22] = down[0, 23] = True
    load = _peak(sys24, 1)
    res = _evaluate(sys24, down, load, how)
    assert float(res.dns_mw[0]) == pytest.approx(245.0, abs=0.05)
    assert float(res.nodal_mw.sum()) == pytest.approx(245.0, abs=0.1)
    assert _oracle_dns(sys24, down, load)[0] == pytest.approx(245.0,
                                                              abs=1e-4)
    bound = dcopf.copper_sheet_bound(sys24, _t(down, torch.bool), _t(load))
    assert float(bound[0]) == pytest.approx(245.0, abs=1e-3)


@pytest.mark.parametrize("how", ["full", "screened"])
def test_islanding_line_7_8(sys24, how):
    # Line 11 (7-8) out islands bus 7: 300 MW of generation against
    # 125 MW of load, so nothing is shed at peak.
    down = np.zeros((1, 71), bool)
    down[0, NG + 10] = True
    res = _evaluate(sys24, down, _peak(sys24, 1), how)
    assert float(res.dns_mw[0]) == 0.0


@pytest.mark.parametrize("how", ["full", "screened"])
def test_scaled_load_seq_style(sys24, how):
    # Half load, one U400 out: plenty of margin, no shed.
    down = np.zeros((1, 71), bool)
    down[0, 22] = True
    res = _evaluate(sys24, down, 0.5 * _peak(sys24, 1), how)
    assert float(res.dns_mw[0]) == 0.0


@needs_gxx
def test_n1_lines_vs_oracles(sys24):
    # Every single-branch outage at peak (the reference spot-checks every
    # seventh): within 0.5 MW of both oracles.
    B = 38
    down = np.zeros((B, 71), bool)
    down[np.arange(B), NG + np.arange(B)] = True
    load = _peak(sys24, B)
    res = _evaluate(sys24, down, load, "full")
    np.testing.assert_allclose(res.dns_mw.double().numpy(),
                               _oracle_dns(sys24, down, load), rtol=0,
                               atol=0.5)


@needs_gxx
def test_random_states_vs_oracles(sys24):
    B = 24
    down = _random_states(11, B)
    load = _peak(sys24, B)
    res = _evaluate(sys24, down, load, "full")
    dns = res.dns_mw.double().numpy()
    np.testing.assert_allclose(dns, _oracle_dns(sys24, down, load), rtol=0,
                               atol=0.6)
    # The LP's shed never beats the copper-sheet bound.
    bound = dcopf.copper_sheet_bound(sys24, _t(down, torch.bool), _t(load))
    assert (dns >= bound.double().numpy() - 0.2).all()


@needs_gxx
def test_stressed_states_vs_oracles(sys24):
    # At 3x unavailability most lanes shed, many behind congested lines:
    # every lane within 0.05 MW of the oracles (the golden replay's
    # ORACLE_TOL_MW), or past the guard and then at most the optimum
    # (the evaluator keeps the certificate's lower bound).
    B = 48
    down = _random_states(21, B, scale=3.0)
    load = _peak(sys24, B)
    res = _evaluate(sys24, down, load, "full")
    dns = res.dns_mw.double().numpy()
    opt = _oracle_dns(sys24, down, load)
    assert (opt > 0).sum() >= B // 2
    kept = res.primal_residual.numpy() <= 5e-3
    np.testing.assert_allclose(dns[kept], opt[kept], rtol=0, atol=0.05)
    assert (dns[~kept] <= opt[~kept] + 0.05).all()


def test_screened_matches_full(sys24):
    B = 32
    down = _random_states(5, B)
    load = _peak(sys24, B)
    full = _evaluate(sys24, down, load, "full")
    scr = _evaluate(sys24, down, load, "screened")
    np.testing.assert_allclose(scr.dns_mw.numpy(), full.dns_mw.numpy(),
                               rtol=0, atol=0.5)
    assert bool((scr.failure == full.failure).all())


def test_screened_order_invariance(sys24):
    # The reference permutes its LP lanes under early_exit (not ported);
    # here the states themselves are permuted: the results must follow
    # them lane for lane.
    B = 64
    down = _random_states(9, B, scale=2.0)
    load = _peak(sys24, B)
    perm = np.random.default_rng(3).permutation(B)
    base = _evaluate(sys24, down, load, "screened")
    moved = _evaluate(sys24, down[perm], load[perm], "screened")
    np.testing.assert_allclose(moved.dns_mw.numpy(),
                               base.dns_mw.numpy()[perm], rtol=0, atol=1e-4)
    np.testing.assert_allclose(moved.nodal_mw.numpy(),
                               base.nodal_mw.numpy()[perm], rtol=0,
                               atol=1e-4)
    assert bool((moved.failure == base.failure[perm]).all())


# -- island blackout and the nodal modes -----------------------------------

@pytest.mark.parametrize("how", ["full", "screened"])
def test_compat_flag_sheds_island(sys24, how):
    import dataclasses
    compat_ib = dataclasses.replace(COMPAT, island_blackout=True)
    down = np.zeros((2, 71), bool)
    down[0, NG + 10] = True   # line 7-8 out: bus 7 islands
    load = _peak(sys24, 2)
    res = _evaluate(sys24, down, load, how, compat_ib)
    # The islanded bus-7 load (125 MW) is shed.
    assert float(res.dns_mw[0]) == pytest.approx(125.0, abs=1.0)
    assert float(res.nodal_mw[0, 6]) == pytest.approx(125.0, abs=1.0)
    assert float(res.dns_mw[1]) == 0.0
    # Default physics: no shed.
    assert float(_evaluate(sys24, down, load, how).dns_mw[0]) == 0.0


def test_connectivity(sys24):
    br_up = torch.ones((2, 38))
    br_up[1, 10] = 0.0
    reach = dcopf.connected_to_ref(sys24, br_up)
    assert bool(reach[0].all())
    assert not bool(reach[1, 6])       # bus 7 cut off
    assert bool(reach[1, [0, 1, 2, 7, 23]].all())


def test_totals_match_lp_mode(sys24):
    B = 32
    down = _t(_random_states(17, B), torch.bool)
    load = _t(_peak(sys24, B))
    lp, over1 = dcopf.evaluate_states_screened(sys24, down, load, B, COMPAT,
                                               IPM, "lp")
    fast, over2 = dcopf.evaluate_states_screened(sys24, down, load, B,
                                                 COMPAT, IPM, "proportional")
    assert int(over1) == 0 and int(over2) == 0
    # Totals and flags agree; only the nodal split may differ.
    np.testing.assert_allclose(fast.dns_mw.numpy(), lp.dns_mw.numpy(),
                               rtol=0, atol=0.5)
    assert bool((fast.failure == lp.failure).all())
    np.testing.assert_allclose(fast.nodal_mw.sum(1).numpy(),
                               lp.nodal_mw.sum(1).numpy(), rtol=0, atol=0.5)


@needs_gxx
def test_nan_lane_degrades_not_propagates(sys24):
    # Branches 6 and 26 out: a double-line islanding state whose float32
    # iterate can blow up. The lane must end finite, at the optimum or
    # at the certificate's lower bound below it.
    down = np.zeros((1, 71), bool)
    down[0, NG + 6] = down[0, NG + 26] = True
    load = _peak(sys24, 1)
    dns = float(_evaluate(sys24, down, load, "full").dns_mw[0])
    assert np.isfinite(dns)
    assert dns <= _oracle_dns(sys24, down, load)[0] + 0.05


# -- every state with at most two outages ----------------------------------

# scripts/parity_n2_exhaustive.py's worst error for the reference on the
# TPU (results/n2_exhaustive_parity.json). The port on the CPU measured
# 0.000809 MW (mean 1.04e-6; 106 LP lanes, none past the guard).
N2_MAX_ERR_MW = 0.000925


@pytest.mark.slow
def test_every_n2_state_vs_highs(sys24):
    ref = json.loads((ROOT / "results" / "n2_exhaustive_parity.json")
                     .read_text())
    free = enumeration.free_components(sys24.unavail.double().numpy(),
                                       sys24.always_up_nsq.numpy())
    rows = [np.zeros((1, 71), bool)]
    for j, combos in enumeration._combo_chunks(len(free), 2, 1 << 20):
        blk = np.zeros((combos.shape[0], 71), bool)
        blk[np.repeat(np.arange(combos.shape[0]), j),
            free[combos].ravel()] = True
        rows.append(blk)
    down = np.concatenate(rows)
    n = down.shape[0]
    assert n == ref["n_states"] == 2486
    load = _peak(sys24, n)
    res, n_over = dcopf.evaluate_states_screened(
        sys24, _t(down, torch.bool), _t(load), max(n // 4, 64), COMPAT, IPM,
        "lp")
    assert int(n_over) == 0
    dns = res.dns_mw.double().numpy()
    opt = _oracle_dns(sys24, down, load, native_too=False)
    assert int((opt > 1e-4).sum()) == ref["shed_states_f64"]
    assert np.abs(dns - opt).max() <= N2_MAX_ERR_MW
