"""PyTorch port: the HL2 sequential (SEQ) slice on the CPU.

Against the JAX package, on the same inputs:

* the load profile, the two-state model functions, the calnlc event
  count, ``default_num_draws``, the copper-sheet helpers, the baseline
  line and ``AnnualStats``: equal (float64 host code) or within 1e-6;
* the chronological sampler's construction fed with the reference's own
  uniforms (drawn with ``jax.random`` exactly as reference
  ``sample_timeline`` / ``sample_timeline_from_state`` draw them): equal
  to the reference's timeline on every (component, hour). A continuous
  timeline may differ only at an hour that sits within one float32 ulp
  of one of the port's event boundaries (the two libraries' log and
  cumsum may round one ulp apart); quantized timelines are required
  bit-equal;
* one year block (2 years x 2,016 hours, an LP buffer of 96 lanes),
  timelines from reference ``sample_timeline``: the port's
  ``evaluate_years`` against reference ``_years_eval`` on the same keys.
  Per-year ENS within 0.05 MW x the year's loss hours, DLC / NLC / PLC /
  component counts / overflow equal, nodal sums within 0.05 MW x the
  year's loss hours on every bus.

The port's own stream and study loop: the steady-state fraction, the
interval semantics and the round / ceil dwell laws, the stationary
marginal at every hour, the flat block against year by year, the
estimate against the LP buffer (grow, redo, promote), the host policy
of the redo loop on a scripted step, resume against an uninterrupted run
for SEQ and NSQ, the Checkpointer round trip, and the exports.

The program's spans and counters (``utils/profiling.py``) on a small
step under ``torch.profiler``: every span of the step with its nesting,
the loop's batch indices, the same bits as without a profiler, and
nothing kept and no ``record_function`` made without one.
"""
import csv
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import (
    cases as ref_cases, load_profile as ref_lp)
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import (
    copper_sheet as ref_cs, dcopf as ref_dcopf)
from powersystemsreliabilityassessment_tpu.models import (
    twostate as ref_twostate)
from powersystemsreliabilityassessment_tpu.parallel import (
    accumulators as ref_acc)
from powersystemsreliabilityassessment_tpu.sampling import (
    chronological as ref_chrono)
from powersystemsreliabilityassessment_tpu.studies import hl2_seq as ref_seq
from powersystemsreliabilityassessment_tpu.utils import report as ref_report
from powersystemsreliabilityassessment_tpu.utils.config import (
    CompatFlags as RefCompat, IPMConfig as RefIPM)

from powersystemsreliabilityassessment_tpu_torch.core import (
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    copper_sheet, dcopf, lp_ipm_batched, lp_ipm_structured)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.parallel import accumulators
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.runtime.host_loop import (
    double_buffered_loop)
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl2_nsq, hl2_seq)
from powersystemsreliabilityassessment_tpu_torch.ops import blocked_chol
from powersystemsreliabilityassessment_tpu_torch.utils import (
    profiling, report)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ENS_TOL_MW = 0.05        # per loss hour: the reference's oracle tolerance
# A kept LP lane against float64 HiGHS (tests/test_torch_rts96.py's
# oracle bound), and the evaluator's quality guard (engines/dcopf.py).
ORACLE_TOL_MW = 0.15
LP_GUARD = 5e-3


@pytest.fixture(scope="module")
def ref_sys():
    return ref_build_system(ref_cases.rts24())


@pytest.fixture(scope="module")
def port_sys(ref_sys):
    return from_reference(ref_sys, device="cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


# -- host-side modules against the reference ------------------------------

@pytest.mark.parametrize("mode", ["reference", "calendar"])
def test_load_profile_matches_reference(mode):
    for hours in (8736, 2016, 100):
        np.testing.assert_array_equal(
            load_profile.load_factors(hours, mode),
            ref_lp.load_factors(hours, mode))
    bus_pd = ref_cases.rts24().bus_pd
    for a, b in zip(load_profile.hourly_bus_loads(bus_pd, 8736,
                                                  weekday_mode=mode),
                    ref_lp.hourly_bus_loads(bus_pd, 8736,
                                            weekday_mode=mode)):
        np.testing.assert_array_equal(a, b)
    f = load_profile.load_factors(8736, mode)
    np.testing.assert_array_equal(load_profile.weekly_peaks(f),
                                  ref_lp.weekly_peaks(f))
    with pytest.raises(ValueError):
        load_profile.load_factors(10, "lunar")


def test_twostate_functions_match_reference():
    case = cases.rts24()
    mt = twostate.mean_times(case)
    for dt in (1.0, 0.5):
        for a, b in zip(twostate.transition_probs(mt[:, 0], mt[:, 1], dt),
                        ref_twostate.transition_probs(mt[:, 0], mt[:, 1],
                                                      dt)):
            np.testing.assert_array_equal(a, b)
    for p0 in (0.0, 0.3):
        np.testing.assert_array_equal(
            twostate.availability_evolution(450.0, 50.0, 500, 1.0, p0),
            ref_twostate.availability_evolution(450.0, 50.0, 500, 1.0, p0))
    np.testing.assert_array_equal(
        twostate.steady_state_unavailability(mt[:, 0], mt[:, 1]),
        ref_twostate.steady_state_unavailability(mt[:, 0], mt[:, 1]))
    rng = np.random.default_rng(1)
    up, dn = rng.exponential(400, 300), rng.exponential(40, 300)
    assert twostate.estimate_rates(up, dn) == \
        ref_twostate.estimate_rates(up, dn)
    np.testing.assert_array_equal(twostate.running_lambda_estimate(up),
                                  ref_twostate.running_lambda_estimate(up))


def test_count_curtailment_events_matches_reference():
    rng = np.random.default_rng(4)
    flags = rng.uniform(size=(64, 300)) < 0.1
    flags[:8, 0] = True                    # years that start failed
    flags[8:12] = True                     # failed all year: one event
    flags[12:16] = False
    got = copper_sheet.count_curtailment_events(torch.as_tensor(flags))
    want = np.asarray(ref_cs.count_curtailment_events(jnp.asarray(flags)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[8:12] == 1).all() and (got[12:16] == 0).all()
    # calnlc.m:22-34 by hand: 1 1 0 1 0 0 1 -> three events.
    one = torch.tensor([1, 1, 0, 1, 0, 0, 1], dtype=torch.bool)
    assert int(copper_sheet.count_curtailment_events(one)) == 3


def test_capacity_series_and_deficit_match_reference():
    rng = np.random.default_rng(5)
    down = rng.uniform(size=(3, 33, 200)) < 0.08
    cap = ref_cases.rts24().gen_pmax.astype(np.float32)
    got = copper_sheet.capacity_series_from_down(_t(down), _t(cap))
    want = ref_cs.capacity_series_from_down(jnp.asarray(down),
                                            jnp.asarray(cap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    load = (2850.0 * load_profile.load_factors(200)).astype(np.float32)
    for a, b in zip(copper_sheet.hourly_deficit(got, _t(load)),
                    ref_cs.hourly_deficit(want, jnp.asarray(load))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-3)


def test_default_num_draws_matches_reference():
    mt = twostate.mean_times(cases.rts24())
    for hours in (8736, 2016, 336):
        assert chronological.default_num_draws(mt[:, 0], mt[:, 1], hours) \
            == ref_chrono.default_num_draws(mt[:, 0], mt[:, 1], hours)
    assert chronological.default_num_draws(mt[:, 0], mt[:, 1], 8736) == 59


def test_baseline_and_copper_sheet_bound_match_reference(ref_sys, port_sys,
                                                         capsys):
    got, want = dcopf.print_baseline(port_sys), ref_dcopf.baseline_report(
        ref_sys)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert "baseline: intact capacity 3405 MW" in capsys.readouterr().out
    rng = np.random.default_rng(6)
    down = rng.uniform(size=(256, 71)) < 0.15
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (256, 1))
    np.testing.assert_allclose(
        dcopf.copper_sheet_bound(port_sys, _t(down), _t(load)).numpy(),
        np.asarray(ref_dcopf.copper_sheet_bound(
            ref_sys, jnp.asarray(down), jnp.asarray(load))), atol=1e-3)


def _annual_updates(rng, n_batches=3, years=4):
    for _ in range(n_batches):
        yield (rng.uniform(0, 500, years), rng.uniform(0, 1e-3, years),
               rng.integers(0, 3, years).astype(float),
               rng.integers(0, 20, years).astype(float),
               rng.uniform(0, 0.1, years), rng.uniform(0, 50, 24),
               rng.integers(0, 30, 71).astype(float),
               float(rng.integers(1, 40)))


def test_annual_stats_match_reference_and_round_trip(tmp_path):
    s, s_ref = accumulators.AnnualStats(), ref_acc.AnnualStats()
    assert s.cov == s_ref.cov == math.inf           # no year yet
    for u in _annual_updates(np.random.default_rng(7)):
        s.update_years(*u)
        s_ref.update_years(*u)
    for attr in ("years", "eens", "cov"):
        assert getattr(s, attr) == getattr(s_ref, attr), attr
    np.testing.assert_array_equal(s.nodal_eens(), s_ref.nodal_eens())
    np.testing.assert_array_equal(s.component_importance(),
                                  s_ref.component_importance())
    ck = Checkpointer(str(tmp_path / "a.json"))
    ck.save({"stats": s.state()})
    back = accumulators.AnnualStats.from_state(ck.restore()["stats"])
    assert back.ens == s.ens and back.cov == s.cov
    np.testing.assert_array_equal(back.nodal_eens(), s.nodal_eens())
    # From plain lists too (a JSON dump without the array tags).
    listed = json.loads(json.dumps(
        {k: (v.tolist() if isinstance(v, np.ndarray) else v)
         for k, v in s.state().items()}))
    again = accumulators.AnnualStats.from_state(listed)
    np.testing.assert_array_equal(again.component_importance(),
                                  s.component_importance())


@pytest.mark.parametrize("ens", [[5.0], [0.0, 0.0, 0.0], [7.0, 7.0]])
def test_annual_stats_cov_is_inf_where_the_reference_says(ens):
    # One year, a zero mean, or no spread: convergence cannot be shown.
    s, s_ref = accumulators.AnnualStats(), ref_acc.AnnualStats()
    z = np.zeros(len(ens))
    for acc in (s, s_ref):
        acc.update_years(ens, z, z, z, z, np.zeros(24), np.zeros(71), 0.0)
    assert s.cov == s_ref.cov == math.inf


def test_running_stats_state_round_trip(tmp_path):
    rng = np.random.default_rng(9)
    s = accumulators.RunningStats()
    for _ in range(3):
        s.update(accumulators.BatchMoments(
            n=512.0, sum_dns=rng.uniform(0, 50), sum_dns_sq=rng.uniform(
                0, 900), sum_flag=30.0, sum_nodal=rng.uniform(0, 5, 24),
            sum_comp_fail=rng.uniform(0, 9, 71), sum_flag_raw=30.0))
    ck = Checkpointer(str(tmp_path / "r.json"))
    ck.save({"stats": s.state()})
    back = accumulators.RunningStats.from_state(ck.restore()["stats"])
    assert (back.n, back.edns, back.beta, back.plc) == \
        (s.n, s.edns, s.beta, s.plc)
    np.testing.assert_array_equal(back.nodal_eens(), s.nodal_eens())
    np.testing.assert_array_equal(back.component_importance(),
                                  s.component_importance())


# -- the sampler's construction against the reference ---------------------

def _ref_uniforms(key, n, k):
    """The two uniform draws of reference sample_timeline /
    sample_timeline_from_state, in their order."""
    ka, kb = jax.random.split(key)
    return (jax.random.uniform(ka, (n, k), minval=1e-12, maxval=1.0),
            jax.random.uniform(kb, (n, k), minval=1e-12, maxval=1.0))


def _assert_equal_but_at_ulp_edges(got, want, bounds, limit):
    """``got`` == ``want`` except where some event boundary of the port's
    row lies within one float32 ulp of the hour (``bounds`` [n, 2K]);
    at most ``limit`` such entries."""
    bad = np.argwhere(got != want)
    assert len(bad) <= limit, len(bad)
    for c, h in bad:
        ulp = np.spacing(np.float32(h))
        assert np.abs(bounds[c] - np.float32(h)).min() <= ulp, (c, h)


def _port_bounds(d_first, d_second):
    k = d_first.shape[-1]
    return torch.cumsum(torch.stack([d_first, d_second], -1).reshape(
        -1, 2 * k), -1).numpy()


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeline_construction_matches_reference(ref_sys, seed, quantize):
    hours, n = 8736, ref_sys.n_comp
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    key = jax.random.key(seed)
    uu, ud = _ref_uniforms(key, n, k)
    want = np.asarray(ref_chrono.sample_timeline(
        key, ref_sys.mttf, ref_sys.mttr, hours, k, quantize=quantize))
    mttf, mttr = _t(ref_sys.mttf), _t(ref_sys.mttr)
    got = chronological.timeline_from_uniforms(
        _t(uu), _t(ud), mttf, mttr, hours, quantize).numpy()
    assert got.shape == want.shape == (n, hours) and want.any()
    if quantize:
        # Integer boundaries below 2^24: float32 sums are exact.
        np.testing.assert_array_equal(got, want)
    else:
        _assert_equal_but_at_ulp_edges(
            got, want, _port_bounds(-mttf[:, None] * torch.log(_t(uu)),
                                    -mttr[:, None] * torch.log(_t(ud))),
            limit=4)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_from_state_construction_matches_reference(ref_sys, seed,
                                                   antithetic):
    hours, n = 8736, ref_sys.n_comp
    k = 59
    key = jax.random.key(seed)
    down0 = np.random.default_rng(seed).uniform(size=n) < 0.3
    ua, ub = _ref_uniforms(key, n, k)
    want = np.asarray(ref_chrono.sample_timeline_from_state(
        key, jnp.asarray(down0), ref_sys.mttf, ref_sys.mttr, hours, k,
        antithetic=antithetic))
    mttf, mttr = _t(ref_sys.mttf), _t(ref_sys.mttr)
    d0 = torch.as_tensor(down0)
    got = chronological.timeline_from_state_uniforms(
        _t(ua), _t(ub), d0, mttf, mttr, hours, antithetic).numpy()
    assert (got[:, 0] == down0).all()
    pa, pb = _t(ua), _t(ub)
    if antithetic:
        pa, pb = (torch.clamp_min(1.0 - pa, 1e-12),
                  torch.clamp_min(1.0 - pb, 1e-12))
    m1, m2 = torch.where(d0, mttr, mttf), torch.where(d0, mttf, mttr)
    _assert_equal_but_at_ulp_edges(
        got, want, _port_bounds(-m1[:, None] * torch.log(pa),
                                -m2[:, None] * torch.log(pb)), limit=4)


# -- one year block against reference _years_eval -------------------------

@pytest.mark.parametrize("seed,load_scale", [(3, 1.0), (7, 1.0), (5, 1.1)])
def test_year_block_matches_reference(ref_sys, port_sys, seed, load_scale):
    years, hours, max_lp = 2, 2016, 96
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    fac = (load_profile.load_factors(hours) * load_scale).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), years)
    want = [np.asarray(a, np.float64) for a in ref_seq._years_eval(
        ref_sys, RefCompat(), RefIPM(), jnp.asarray(fac), hours, k, max_lp,
        None, "lp", keys)]
    down = np.asarray(jax.vmap(lambda kk: ref_chrono.sample_timeline(
        kk, ref_sys.mttf, ref_sys.mttr, hours, k))(keys))
    load = hl2_seq.year_block_load(port_sys, fac, years)
    got = [a.numpy().astype(np.float64) for a in hl2_seq.evaluate_years(
        port_sys, CompatFlags(), IPMConfig(), load, _t(down),
        max_lp)]
    ens, plc, nlc, dlc, edns, nodal, comp_fail, loss, n_over, n_inf = got
    w_ens, w_plc, w_nlc, w_dlc, _, w_nodal, w_comp, w_loss, w_over, _ = want
    assert w_dlc.sum() > 0                     # the block sheds
    np.testing.assert_array_equal(dlc, w_dlc)
    np.testing.assert_array_equal(nlc, w_nlc)
    np.testing.assert_array_equal(plc, w_plc)
    np.testing.assert_array_equal(loss, w_loss)
    np.testing.assert_array_equal(comp_fail, w_comp)
    assert n_over == w_over == 0 and n_inf == 0
    tol = ENS_TOL_MW * np.maximum(w_dlc, 1.0)
    assert (np.abs(ens - w_ens) <= tol).all()
    assert (np.abs(nodal - w_nodal) <= tol[:, None]).all()
    np.testing.assert_allclose(edns, ens / hours, rtol=1e-6)


class _Captured(Exception):
    pass


def _ref_maint_down(monkeypatch, hours):
    """The ``maint_down`` reference ``run_seq_study`` hands its step with
    ``scheduled_maintenance=True`` (captured, the study stopped there)."""
    seen = {}

    def capture(*args, **kw):
        seen["md"] = args[9]
        raise _Captured

    monkeypatch.setattr(ref_seq, "make_seq_batch_step", capture)
    with pytest.raises(_Captured):
        ref_seq.run_seq_study(ref_cases.rts24(), hours=hours, log_every=0,
                              scheduled_maintenance=True)
    return seen["md"]


@pytest.mark.parametrize("hours", [8736, 2016])
def test_maintenance_schedule_matches_reference(monkeypatch, hours):
    want = _ref_maint_down(monkeypatch, hours)
    got = hl2_seq.maintenance_down(cases.rts24(), hours)
    assert got.shape == want.shape == (hours, 71) and want.any()
    np.testing.assert_array_equal(got, want)
    assert not got[:, 33:].any()          # branches are never maintained
    weeks = np.round(cases.rts24().gen_maint_weeks).astype(int)
    if hours == 8736:
        np.testing.assert_array_equal(got[:, :33].sum(0), 168 * weeks)


def _guard_judged(ref_sys, flat, load, i, dns_p, q_p, dns_r, q_r):
    """Hour ``i``, where the two packages' DNS part: at least one side's
    LP lane is past the evaluator's quality guard, which then keeps the
    certificate's lower bound (ROADMAP.md Queue 3 A: the float32 IPMs'
    outcome on a hard lane moves with rounding). The flagged side must
    stay at or below the float64 HiGHS optimum, a kept side within the
    oracle tolerance of it."""
    from scipy.optimize import linprog
    up = 1.0 - flat[i].astype(np.float32)
    ng = ref_sys.n_gen
    lp = ref_dcopf.build_state_lp(ref_sys, jnp.asarray(up[:ng]),
                                  jnp.asarray(up[ng:]), jnp.asarray(load[i]),
                                  RefCompat(), RefIPM().theta_max)
    c, A, b, lo, hi = (np.asarray(t, np.float64) for t in lp)
    r = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(lo, hi)), method="highs")
    assert r.status == 0, r.message
    oracle = r.fun * ref_sys.base_mva
    assert q_p > LP_GUARD or q_r > LP_GUARD, (i, q_p, q_r)
    for dns, q in ((dns_p, q_p), (dns_r, q_r)):
        if q > LP_GUARD:
            assert dns <= oracle + ORACLE_TOL_MW, (i, dns, oracle)
        else:
            assert abs(dns - oracle) <= ORACLE_TOL_MW, (i, dns, oracle)


@pytest.mark.parametrize("seed", [3, 8])
def test_year_block_with_maintenance_matches_reference(ref_sys, port_sys,
                                                       monkeypatch, seed):
    years, hours, max_lp = 2, 2016, 96
    maint = _ref_maint_down(monkeypatch, hours)
    monkeypatch.undo()
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    fac = load_profile.load_factors(hours).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), years)
    want = [np.asarray(a, np.float64) for a in ref_seq._years_eval(
        ref_sys, RefCompat(), RefIPM(), jnp.asarray(fac), hours, k, max_lp,
        jnp.asarray(maint), "lp", keys)]
    down = np.asarray(jax.vmap(lambda kk: ref_chrono.sample_timeline(
        kk, ref_sys.mttf, ref_sys.mttr, hours, k))(keys))
    load = hl2_seq.year_block_load(port_sys, fac, years)
    md = _t(hl2_seq.maintenance_down(cases.rts24(), hours))
    got = [a.numpy().astype(np.float64) for a in hl2_seq.evaluate_years(
        port_sys, CompatFlags(), IPMConfig(), load, _t(down), max_lp,
        maint_down=md)]
    plain = hl2_seq.evaluate_years(port_sys, CompatFlags(), IPMConfig(),
                                   load, _t(down), max_lp)
    # The hours of the block, as both evaluators see them.
    flat = (np.swapaxes(down, 1, 2) | maint[None]).reshape(years * hours, -1)
    repair = max(4096, years * hours // 16)
    res_p, _ = dcopf.evaluate_states_screened(
        port_sys, _t(flat), load, max_lp, CompatFlags(), IPMConfig(), "lp",
        repair_buffer=repair)
    res_r, _ = ref_dcopf.evaluate_states_screened(
        ref_sys, jnp.asarray(flat), jnp.asarray(load.numpy()), max_lp,
        RefCompat(), RefIPM(), "lp", repair_buffer=repair,
        pf_buffer=ref_dcopf.default_pf_buffer(ref_sys, years * hours))
    dns_p, dns_r = res_p.dns_mw.numpy(), np.asarray(res_r.dns_mw)
    q_p, q_r = res_p.primal_residual.numpy(), np.asarray(
        res_r.primal_residual)
    apart = np.abs(dns_p - dns_r) > ORACLE_TOL_MW
    for i in np.flatnonzero(apart):
        _guard_judged(ref_sys, flat, load.numpy(), i, dns_p[i], q_p[i],
                      dns_r[i], q_r[i])
    ens, plc, nlc, dlc, edns, nodal, comp_fail, loss, n_over, n_inf = got
    w_ens, w_plc, w_nlc, w_dlc, _, w_nodal, w_comp, w_loss, w_over, _ = want
    # Each year's indices follow from its hours; the guard-judged hours
    # are the only ones allowed to move them.
    thr = CompatFlags().seq_curtail_threshold_mw
    flag_p = (dns_p > thr).reshape(years, hours)
    flag_r = (dns_r > thr).reshape(years, hours)
    np.testing.assert_array_equal(dlc, flag_p.sum(1))
    np.testing.assert_array_equal(w_dlc, flag_r.sum(1))
    same = ~apart.reshape(years, hours)
    np.testing.assert_array_equal(flag_p[same], flag_r[same])
    # Maintenance adds loss hours.
    assert w_dlc.sum() > float(plain[3].sum())
    np.testing.assert_array_equal(loss, dlc)
    np.testing.assert_allclose(plc, dlc / hours, rtol=1e-6)
    down_h = flat.reshape(years, hours, -1).astype(np.float64)
    np.testing.assert_array_equal(
        comp_fail - w_comp, np.einsum("yh,yhc->yc",
                                      flag_p.astype(float)
                                      - flag_r.astype(float), down_h))
    if not apart.any():
        np.testing.assert_array_equal(nlc, w_nlc)
        np.testing.assert_array_equal(plc, w_plc)
    moved = np.abs(dns_p - dns_r).reshape(years, hours)
    moved = np.where(same, 0.0, moved).sum(1)
    tol = ORACLE_TOL_MW * np.maximum(w_dlc, 1.0) + moved
    assert n_over == w_over == 0 and n_inf == 0
    assert (np.abs(ens - w_ens) <= tol).all()
    assert (np.abs(nodal - w_nodal) <= tol[:, None]).all()


def test_maintenance_block_keeps_the_reference_lp_value(ref_sys, port_sys,
                                                       monkeypatch):
    """The seed-8 block of the test above: with the LP tier's warm rescue
    off, the port's lane on one outage state and load (hours 2384 and
    2387-2389) stalls past the 5e-3 quality guard and keeps the
    certificate's 0 MW where the reference keeps 10.03 MW (HiGHS 9.92),
    an hour ``_guard_judged`` excuses. With the rescue (the default) the
    port keeps the reference's LP value there within ORACLE_TOL_MW, and
    the float64 optimum within it too."""
    from scipy.optimize import linprog
    years, hours, max_lp = 2, 2016, 96
    maint = _ref_maint_down(monkeypatch, hours)
    monkeypatch.undo()
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    keys = jax.random.split(jax.random.key(8), years)
    down = np.asarray(jax.vmap(lambda kk: ref_chrono.sample_timeline(
        kk, ref_sys.mttf, ref_sys.mttr, hours, k))(keys))
    load = hl2_seq.year_block_load(
        port_sys, load_profile.load_factors(hours).astype(np.float32), years)
    flat = (np.swapaxes(down, 1, 2) | maint[None]).reshape(years * hours, -1)

    def port(rescue):
        monkeypatch.setattr(lp_ipm_structured, "RESCUE_LANES", rescue)
        return dcopf.evaluate_states_screened(
            port_sys, _t(flat), load, max_lp, CompatFlags(), IPMConfig(),
            "lp", repair_buffer=max(4096, years * hours // 16))[0]

    default = lp_ipm_structured.RESCUE_LANES
    off = port(0)
    on = port(default)
    excused = np.flatnonzero(off.primal_residual.numpy() > LP_GUARD)
    assert len(excused) >= 1
    assert float(off.dns_mw[excused].max()) == 0.0
    ref = ref_dcopf.evaluate_states(
        ref_sys, jnp.asarray(flat[excused]),
        jnp.asarray(load.numpy()[excused]), RefCompat(), RefIPM())
    got = on.dns_mw.numpy()[excused]
    assert (on.primal_residual.numpy()[excused] <= LP_GUARD).all()
    np.testing.assert_allclose(got, np.asarray(ref.dns_mw), rtol=0,
                               atol=ORACLE_TOL_MW)
    assert got.min() > 9.0
    up = 1.0 - flat[excused[0]].astype(np.float32)
    lp = ref_dcopf.build_state_lp(
        ref_sys, jnp.asarray(up[:ref_sys.n_gen]),
        jnp.asarray(up[ref_sys.n_gen:]), jnp.asarray(load.numpy()[excused[0]]),
        RefCompat(), RefIPM().theta_max)
    c, A, b, lo, hi = (np.asarray(t, np.float64) for t in lp)
    r = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(lo, hi)), method="highs")
    assert r.status == 0, r.message
    assert abs(got[0] - r.fun * ref_sys.base_mva) <= ORACLE_TOL_MW


def test_study_with_maintenance_runs():
    res = hl2_seq.run_seq_study(
        cases.rts24(), MCSConfig(max_years=4, cov_threshold=0.0, seed=2),
        device="cpu", years_per_device=2, hours=504,
        scheduled_maintenance=True, log_every=0)
    plain = hl2_seq.run_seq_study(
        cases.rts24(), MCSConfig(max_years=4, cov_threshold=0.0, seed=2),
        device="cpu", years_per_device=2, hours=504, log_every=0)
    assert res.years == 4 and np.isfinite(res.eens_mwh_yr)
    assert res.eens_mwh_yr >= plain.eens_mwh_yr
    assert res.overflow_hours == 0


# -- the port's own stream --------------------------------------------------

def test_steady_state_fraction():
    mttf, mttr = torch.tensor([450.0, 1100.0]), torch.tensor([50.0, 150.0])
    k = chronological.default_num_draws(mttf.numpy(), mttr.numpy(), 8736)
    gen = torch.Generator().manual_seed(3)
    down = chronological.sample_timeline_batch(gen, mttf, mttr, 8736, k, 60)
    frac = down.float().mean((0, 2)).numpy()
    np.testing.assert_allclose(frac, [50 / 500, 150 / 1250], atol=0.02)


def test_interval_semantics_and_quantization():
    # Up 3 then down 2 -> hours 0-2 UP, 3-4 DOWN; boundaries 3, 5, 10, 12
    # (a boundary equal to an hour counts, as in seq_mcsampling.m:366-387).
    got = chronological._down_from_durations(
        torch.tensor([[3.0, 5.0]]), torch.tensor([[2.0, 2.0]]), 14)
    assert got[0].int().tolist() == [0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 1, 1,
                                     0, 0]
    # round(TTF), ceil(TTR): uniforms whose dwells are 2.4 h (up: 2) and
    # 0.3 h (down: 1), repeated.
    m = torch.tensor([10.0])
    uu = torch.exp(torch.tensor([[-0.24] * 4]))
    ud = torch.exp(torch.tensor([[-0.03] * 4]))
    got = chronological.timeline_from_uniforms(uu, ud, m, m, 12)
    assert got[0].int().tolist() == [0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1]
    cont = chronological.timeline_from_uniforms(uu, ud, m, m, 12,
                                                quantize=False)
    # Continuous: boundaries 2.4, 2.7, 5.1, 5.4, ...: hour 3 is up.
    assert cont[0, :6].int().tolist() == [0, 0, 0, 0, 0, 0]


def _runs(rows, value):
    """Lengths of interior runs of ``value`` (both ends inside)."""
    out = []
    for row in rows:
        d = np.diff(np.r_[False, row == value, False].astype(int))
        starts, ends = np.where(d == 1)[0], np.where(d == -1)[0]
        keep = (starts > 0) & (ends < len(row))
        out.extend((ends - starts)[keep].tolist())
    return np.asarray(out)


def test_dwell_laws_round_and_ceil():
    # Repairs are ceil(Exp(MTTR)) (seq_mcsampling.m:376): P(L = 1) =
    # 1 - exp(-1/m), E[L] = 1 / (1 - exp(-1/m)). Up-times are
    # round(Exp(MTTF)); a nonzero one has the same mean law.
    mttf, mttr = 400.0, 40.0
    k = chronological.default_num_draws(np.array([mttf]), np.array([mttr]),
                                        8736)
    gen = torch.Generator().manual_seed(7)
    down = chronological.sample_timeline_batch(
        gen, torch.tensor([mttf]), torch.tensor([mttr]), 8736, k,
        400)[:, 0].numpy()
    for value, m in ((True, mttr), (False, mttf)):
        lengths = _runs(down, value)
        assert len(lengths) > 2000
        assert lengths.mean() == pytest.approx(
            1.0 / (1.0 - np.exp(-1.0 / m)), rel=0.05)
    lengths = _runs(down, True)
    assert np.mean(lengths == 1) == pytest.approx(
        1.0 - np.exp(-1.0 / mttr), abs=0.01)


def test_stationary_marginal_at_every_hour():
    mttf = torch.tensor([450.0, 1100.0, 9000.0])
    mttr = torch.tensor([50.0, 150.0, 20.0])
    u = (mttr / (mttf + mttr)).numpy().astype(np.float64)
    n, hours = 4000, 240
    gen = torch.Generator().manual_seed(11)
    down = chronological.sample_timeline_stationary(
        gen, mttf, mttr, hours, 12, batch=(n,))
    frac = down.double().mean(0).numpy()                  # [3, hours]
    se = np.sqrt(u * (1 - u) / n)
    # Every hour (hour 0 included) within 5 sigma of U, and the hour
    # average within 5 sigma of its own (correlated, so looser) spread.
    assert (np.abs(frac - u[:, None]) <= 5 * se[:, None]).all()
    assert (np.abs(frac[:, 0] - u) <= 5 * se).all()
    np.testing.assert_allclose(frac.mean(1), u, atol=float(5 * se.max()))
    # From a state: hour 0 is that state.
    d0 = torch.tensor([True, False, True])
    got = chronological.sample_timeline_from_state(gen, d0, mttf, mttr,
                                                   hours, 12)
    assert got[:, 0].tolist() == d0.tolist()


def test_flat_block_equals_per_year(port_sys):
    hours, years = 336, 3
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    fac = (load_profile.load_factors(hours) * 1.2).astype(np.float32)
    down = hl2_seq.sample_years(torch.Generator().manual_seed(17), port_sys,
                                years, hours, k)
    flat = hl2_seq.evaluate_years(
        port_sys, CompatFlags(), IPMConfig(),
        hl2_seq.year_block_load(port_sys, fac, years), down, years * 96)
    load1 = hl2_seq.year_block_load(port_sys, fac, 1)
    assert flat[3].sum() > 0
    for y in range(years):
        one = hl2_seq.evaluate_years(port_sys, CompatFlags(), IPMConfig(),
                                     load1, down[y:y + 1], 96)
        assert float(flat[0][y]) == pytest.approx(float(one[0][0]),
                                                  abs=0.02)   # ENS, MWh
        for i in (1, 2, 3):                                  # PLC NLC DLC
            assert float(flat[i][y]) == float(one[i][0])
        np.testing.assert_array_equal(flat[6][y].numpy(), one[6][0].numpy())


def test_sample_years_draws_do_not_depend_on_the_buffer(port_sys):
    g = lambda: hl2_nsq.batch_generator(5, 3, "cpu")
    a = hl2_seq.sample_years(g(), port_sys, 2, 168, 20)
    b = hl2_seq.sample_years(g(), port_sys, 2, 168, 20)
    assert torch.equal(a, b) and a.shape == (2, 71, 168)
    s = hl2_seq.sample_years(g(), port_sys, 2, 168, 20, stationary=True)
    assert s.shape == a.shape and not torch.equal(s, a)


# -- the study loop -----------------------------------------------------------

SMALL = dict(device="cpu", years_per_device=2, hours=168, load_scale=1.3,
             log_every=0)


def test_lp_buffer_redo_and_promotion_keep_the_estimate(capsys):
    # A one-lane-a-year base buffer overflows: batches are redone at
    # twice the size with the same draws, three in a row promote the
    # size, and a batch in flight at the promotion is redone from its
    # own size. The estimate equals a run that never overflowed.
    cfg = MCSConfig(max_years=10, cov_threshold=0.0, seed=6)
    small = hl2_seq.run_seq_study(cases.rts24(), cfg, max_lp=1, **SMALL)
    logs = capsys.readouterr().out
    assert "transient" in logs and "promoting" in logs
    big = hl2_seq.run_seq_study(cases.rts24(), cfg, max_lp=168, **SMALL)
    assert "transient" not in capsys.readouterr().out
    assert small.years == big.years == 10
    assert small.overflow_hours == big.overflow_hours == 0
    assert small.eens_mwh_yr == pytest.approx(big.eens_mwh_yr, rel=1e-6)
    assert small.lole_hr_yr == big.lole_hr_yr > 0
    assert small.lolf_occ_yr == big.lolf_occ_yr
    np.testing.assert_allclose(small.annual_ens, big.annual_ens, rtol=1e-6)


class _ScriptedStep:
    """Stands in for make_seq_batch_step: batch i needs ``need[i]`` LP
    lanes a year, overflows below that, and reports ENS = i for each of
    its years. Records (batch, size) of every dispatch."""

    def __init__(self, need, years):
        self.need, self.years, self.calls = need, years, []

    def make(self, sys, years, compat, ipm, hours, n_draws, max_lp,
             factors, nodal_mode="lp", stationary=False, cv_arrays=None,
             maint_down=None, mesh=None):
        def step(i):
            self.calls.append((i, max_lp))
            over = max(self.need.get(i, 0) - max_lp, 0) * self.years
            f = lambda v: torch.full((self.years,), float(v))
            return (f(i), f(0), f(1), f(1), f(0), torch.zeros(sys.n_bus),
                    torch.zeros(sys.n_comp), torch.tensor(1.0),
                    torch.tensor(over), torch.tensor(0))
        return step


def _scripted_study(monkeypatch, need, batches, cap=None, max_lp=4,
                    checkpointer=None, checkpoint_every=20):
    script = _ScriptedStep(need, years=2)
    monkeypatch.setattr(hl2_seq, "make_seq_batch_step", script.make)
    monkeypatch.setattr(hl2_seq, "batch_generator", lambda s, i, d, r=0: i)
    if cap is not None:
        monkeypatch.setattr(hl2_seq, "seq_lp_cap", lambda m, h, y: cap)
    res = hl2_seq.run_seq_study(
        cases.rts24(), MCSConfig(max_years=2 * batches, cov_threshold=0.0),
        device="cpu", years_per_device=2, max_lp=max_lp, hours=168,
        log_every=0, checkpointer=checkpointer,
        checkpoint_every=checkpoint_every)
    # Every batch is folded once, in order.
    assert res.annual_ens == [float(i) for i in range(batches)
                              for _ in range(2)]
    return res, script.calls


def test_three_redos_promote_and_in_flight_batch_keeps_its_size(
        monkeypatch, capsys):
    # Batches 0-3 need 8 lanes a year against a base of 4. Batch 3 is
    # dispatched at 4 before batch 2's consume promotes the base to 8; it
    # overflows and is redone at 2 x 4 = 8 (its own size), not at 16.
    res, calls = _scripted_study(monkeypatch, {i: 8 for i in range(4)}, 6)
    assert "promoting max_lp 8/yr" in capsys.readouterr().out
    assert calls == [(0, 4), (1, 4), (0, 8), (1, 4), (2, 4), (1, 8),
                     (2, 4), (3, 4), (2, 8), (3, 4), (4, 8), (3, 8),
                     (4, 8), (5, 8)]
    assert res.overflow_hours == 0


def test_in_flight_batch_at_the_promoted_cap_is_still_redone(monkeypatch):
    # The same, with the cap at the promoted size: batch 3's own buffer
    # (4) is below the cap, so it is redone, not degraded to bounds.
    res, calls = _scripted_study(monkeypatch, {i: 8 for i in range(4)}, 5,
                                 cap=8)
    assert (3, 8) in calls and res.overflow_hours == 0


def test_at_cap_batch_is_folded_and_resets_the_redo_count(monkeypatch,
                                                          capsys):
    # Batches 0-1 are redone at 8; batch 2 needs 16 against a cap of 8
    # and is folded with its overflow counted, which breaks the run of
    # redos; batches 3-4 are redone again. No promotion: three
    # consecutive successful redos never happened.
    need = {0: 8, 1: 8, 2: 16, 3: 8, 4: 8}
    res, calls = _scripted_study(monkeypatch, need, 5, cap=8)
    out = capsys.readouterr().out
    assert "at its cap" in out and "promoting" not in out
    assert res.overflow_hours == (16 - 8) * 2
    assert calls.count((2, 8)) == 1 and (5, 8) not in calls
    # A fourth redo after the cap makes three in a row: promoted.
    res, calls = _scripted_study(monkeypatch, {**need, 5: 8}, 8,
                                 cap=8)
    assert "promoting max_lp 8/yr" in capsys.readouterr().out
    assert calls[-1] == (7, 8)


def test_seq_resume_equals_uninterrupted_run(tmp_path, monkeypatch):
    # The first leg promotes max_lp 1 -> 2 and checkpoints it; the second
    # leg must start its base step at the promoted size.
    cfg = lambda y: MCSConfig(max_years=y, cov_threshold=0.0, seed=6)
    full = hl2_seq.run_seq_study(cases.rts24(), cfg(10), max_lp=1, **SMALL)
    ck = Checkpointer(str(tmp_path / "seq.ckpt"))
    hl2_seq.run_seq_study(cases.rts24(), cfg(6), max_lp=1, checkpointer=ck,
                          checkpoint_every=1, **SMALL)
    saved = ck.restore()
    assert saved["batch_idx"] == 3 and saved["max_lp"] == 2
    sizes = []
    make = hl2_seq.make_seq_batch_step

    def recording(*a, **k):
        sizes.append(a[6])
        return make(*a, **k)

    monkeypatch.setattr(hl2_seq, "make_seq_batch_step", recording)
    resumed = hl2_seq.run_seq_study(cases.rts24(), cfg(10), max_lp=1,
                                    checkpointer=ck, checkpoint_every=1,
                                    **SMALL)
    assert sizes[0] == 2
    assert resumed.years == full.years == 10
    assert resumed.annual_ens == full.annual_ens
    assert resumed.eens_history == full.eens_history
    assert resumed.lole_hr_yr == full.lole_hr_yr
    assert resumed.lolf_occ_yr == full.lolf_occ_yr
    np.testing.assert_array_equal(resumed.nodal_eens_mwh_yr,
                                  full.nodal_eens_mwh_yr)
    np.testing.assert_array_equal(resumed.comp_importance,
                                  full.comp_importance)
    assert ck.restore()["batch_idx"] == 5


def test_nsq_resume_equals_uninterrupted_run(tmp_path, capsys):
    cfg = lambda n: MCSConfig(batch_size=512, max_samples=n, seed=13)
    full = hl2_nsq.run_nsq_study(cases.rts24(), cfg(2048), device="cpu",
                                 log_every=0, max_lp=16)
    assert "growing max_lp" in capsys.readouterr().out
    ck = Checkpointer(str(tmp_path / "nsq.ckpt"))
    hl2_nsq.run_nsq_study(cases.rts24(), cfg(1024), device="cpu",
                          log_every=0, max_lp=16, checkpointer=ck,
                          checkpoint_every=1)
    saved = ck.restore()
    assert saved["batch_idx"] == 2 and saved["max_lp"] > 16
    capsys.readouterr()
    resumed = hl2_nsq.run_nsq_study(cases.rts24(), cfg(2048), device="cpu",
                                    log_every=0, max_lp=16, checkpointer=ck,
                                    checkpoint_every=1)
    assert resumed.samples == full.samples == 2048
    assert resumed.edns_mw == full.edns_mw and resumed.plc == full.plc
    assert resumed.beta == full.beta
    assert resumed.beta_history == full.beta_history
    np.testing.assert_array_equal(resumed.nodal_eens_mwh_yr,
                                  full.nodal_eens_mwh_yr)
    assert ck.restore()["batch_idx"] == 4


def test_checkpointer_round_trip(tmp_path):
    path = tmp_path / "sub" / "state.json"
    ck = Checkpointer(str(path))
    assert ck.restore() is None
    state = {"stats": {"n": 3.0, "v": np.arange(4.0), "none": None},
             "hist": [1.5, math.inf], "batch_idx": 7,
             "nested": {"a": [np.float32(2.5), np.int64(3)]}}
    ck.save(state)
    got = ck.restore()
    assert got["batch_idx"] == 7 and got["hist"] == [1.5, math.inf]
    np.testing.assert_array_equal(got["stats"]["v"], np.arange(4.0))
    assert got["stats"]["v"].dtype == np.float64
    assert got["stats"]["none"] is None and got["nested"]["a"] == [2.5, 3.0]
    ck.save({"batch_idx": 8})                 # replaced whole, atomically
    assert ck.restore() == {"batch_idx": 8}
    assert sorted(p.name for p in path.parent.iterdir()) == ["state.json"]
    ck.clear()
    assert ck.restore() is None and not path.exists()


def _seq_result():
    rng = np.random.default_rng(12)
    return hl2_seq.SEQResult(
        eens_mwh_yr=1225.0, lole_hr_yr=9.5, lolf_occ_yr=1.9, plc=0.0011,
        edns_mw=0.14, cov=0.0498, years=32, converged=True,
        nodal_eens_mwh_yr=rng.uniform(0, 80, 24),
        comp_importance=rng.uniform(0, 0.2, 71), eens_history=[1.0, 2.0],
        cov_history=[0.5, 0.3], overflow_hours=0,
        annual_ens=rng.uniform(0, 900, 32).tolist())


def test_export_study_writes_the_reference_schema(tmp_path):
    res = _seq_result()
    report.export_study(res, str(tmp_path / "port"), "seq",
                        make_plots=False)
    ref_report.export_study(res, str(tmp_path / "ref"), "seq",
                            make_plots=False)
    for name in ("seq_nodal_results.csv", "seq_results.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "ref" / name).read_text(), name
    with open(tmp_path / "port" / "seq_nodal_results.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["BusID", "EENS_MWh_yr"] and len(rows) == 25
    ref_fields = {f.name for f in dataclasses.fields(ref_seq.SEQResult)}
    data = json.loads((tmp_path / "port" / "seq_results.json").read_text())
    assert set(data) == ref_fields
    from scipy.io import loadmat
    mat = loadmat(str(tmp_path / "port" / "seq_reliability_results.mat"))
    assert mat["eens_mwh_yr"].item() == 1225.0
    assert mat["nodal_eens_mwh_yr"].size == 24
    assert report.top_components(res.comp_importance, 33, 3) == \
        ref_report.top_components(res.comp_importance, 33, 3)
    assert [report.component_label(i, 33) for i in (0, 32, 33, 70)] == \
        ["Gen 1", "Gen 33", "Line 1", "Line 38"]
    # make_plots=True (the default) writes the same three exports and no
    # figure, as the reference's export_study does.
    report.export_study(res, str(tmp_path / "p2"), "seq", make_plots=True)
    assert sorted(f.name for f in (tmp_path / "p2").iterdir()) == [
        "seq_nodal_results.csv", "seq_reliability_results.mat",
        "seq_results.json"]


def test_seq_options_not_ported_raise():
    # Maintenance and the control variate are both ported; together they
    # raise ValueError, as in the reference (maintenance breaks the
    # stationarity the control variate's means need), and a bad sampling
    # mode raises.
    case = cases.rts24()
    with pytest.raises(ValueError, match="stationar"):
        hl2_seq.run_seq_study(case, device="cpu",
                              scheduled_maintenance=True,
                              control_variate=True)
    with pytest.raises(ValueError, match="sampling"):
        hl2_seq.run_seq_study(case, device="cpu", sampling="lhs")
    assert hl2_seq.seq_lp_cap(62, 8736, 16) == \
        ref_seq.seq_lp_cap(62, 8736, 16) == 8736
    # Past m = 336 the port's envelope is 4,096 LP lanes a block, sized
    # on the H100 (ROADMAP.md Queue 3); the reference's is 4,096 / Y^2
    # lanes a year.
    assert hl2_seq.seq_lp_cap(792, 8736, 4) == 1024
    assert ref_seq.seq_lp_cap(792, 8736, 4) == 256


def test_stationary_study_runs(capsys):
    res = hl2_seq.run_seq_study(
        cases.rts24(), MCSConfig(max_years=4, cov_threshold=0.0, seed=2),
        device="cpu", years_per_device=2, hours=168, load_scale=1.3,
        sampling="stationary", log_every=1)
    out = capsys.readouterr().out
    assert "baseline:" in out and "year     4" in out
    assert res.years == 4 and np.isfinite(res.eens_mwh_yr)
    assert res.nodal_eens_mwh_yr.shape == (24,)
    assert res.comp_importance.shape in ((71,), (0,))
    assert json.dumps(res.to_dict())
    # The per-year DLC and NLC (for LOLE's and LOLF's standard errors)
    # stay out of the exported schema.
    assert len(res.annual_dlc) == len(res.annual_nlc) == 4
    assert np.mean(res.annual_dlc) == res.lole_hr_yr
    assert np.mean(res.annual_nlc) == res.lolf_occ_yr
    assert "annual_dlc" not in res.to_dict()


# -- the program's spans and counters (utils/profiling.py) -------------------

# The spans of one RTS-24 SEQ batch run through the host loop; the other
# spans of the table are emitted by the NSQ step, tier 1.5, the larger-m
# LP paths and the card's event wait (below and in test_torch_cli.py).
SEQ_SPANS = {"loop.dispatch", "loop.consume", "sampling.years",
             "tier1.certify", "loop.compact", "lp.build", "lp.k1",
             "lp.polish", "lp.rescue", "lp.finalize", "loop.scatter",
             "loop.reduce"}
SPAN_YEARS, SPAN_HOURS, SPAN_LP = 2, 168, 24


def _seq_batches(port_sys, batches=1):
    """``batches`` batches of a 2-year, 168-hour step (24 LP lanes a
    year) through the host loop, as the study runs them; the host's
    copies by batch index."""
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], SPAN_HOURS)
    fac = torch.as_tensor(load_profile.load_factors(SPAN_HOURS) * 1.3,
                          dtype=torch.float32)
    step = hl2_seq.make_seq_batch_step(
        port_sys, SPAN_YEARS, CompatFlags(), IPMConfig(), SPAN_HOURS, k,
        SPAN_LP, fac)
    got = {}

    def dispatch(i):
        out = step(hl2_nsq.batch_generator(5, i, port_sys.device))
        return i, hl2_nsq.fetch_async(hl2_seq._pack(out))

    def consume(dispatched, next_idx):
        got[dispatched[0]] = hl2_nsq.fetched_numpy(dispatched[1])
        return False

    double_buffered_loop(dispatch, consume, lambda i: i < batches)
    return got


def _trace_spans(prof, tmp_path):
    """The ``psra.`` ranges of an exported trace, names without the
    prefix."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [dict(e, name=e["name"][len(profiling.PREFIX):]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(profiling.PREFIX)]


@pytest.fixture(scope="module")
def traced_seq(port_sys, tmp_path_factory):
    """The step's batch without a profiler, then under one: (plain
    outputs, traced outputs, spans, counters, indices)."""
    profiling.reset_counters()
    plain = _seq_batches(port_sys)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _seq_batches(port_sys)
    spans = _trace_spans(prof, tmp_path_factory.mktemp("seq_trace"))
    out = plain, traced, spans, profiling.counters(), profiling.indices()
    profiling.reset_counters()
    return out


def _inside(inner, outer) -> bool:
    return (inner.get("tid") == outer.get("tid")
            and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_seq_step_emits_its_spans_nested(traced_seq):
    _, _, spans, _, idx = traced_seq
    names = {s["name"] for s in spans}
    assert names == SEQ_SPANS
    by = lambda n: [s for s in spans if s["name"] == n]  # noqa: E731
    dispatch, consume = by("loop.dispatch"), by("loop.consume")
    assert len(dispatch) == len(consume) == 1
    for s in spans:
        if s["name"] not in ("loop.dispatch", "loop.consume"):
            assert any(_inside(s, d) for d in dispatch + consume), s
    # The LP tier's certificate pass inside _finalize, the rescue's K1
    # passes (one a float stage) inside the rescue, the first pass's K1
    # beside them.
    finalize, rescue = by("lp.finalize"), by("lp.rescue")
    assert len(finalize) == len(rescue) == 1
    certify = by("tier1.certify")
    assert sum(_inside(c, finalize[0]) for c in certify) == 1
    assert len(certify) == 2
    k1 = by("lp.k1")
    stages = sum(f is not None for f in IPMConfig().rescue_stages)
    assert sum(_inside(k, rescue[0]) for k in k1) == stages
    assert len(k1) == stages + 1
    assert any(_inside(p, rescue[0]) for p in by("lp.polish"))
    assert idx == {"loop.dispatch": [0], "loop.consume": [0]}


def test_seq_step_counters_under_a_profiler(traced_seq, port_sys):
    _, traced, _, got, _ = traced_seq
    lanes = SPAN_YEARS * SPAN_LP
    assert got["lp.buffer_lanes"] == lanes
    assert 0 < got["lp.real_lanes"] <= lanes
    # The packed sums' LP overflow is the queue beyond the buffer.
    assert int(traced[0][1]) == 0
    assert 0 <= got["lp.guard_fallback"] <= got["lp.real_lanes"]
    assert 0 <= got["lp.rescue_demand"] <= lanes
    # The host time of the layers: the LP tier's inside its spans, each
    # layer's outermost spans no longer than the batch's dispatch.
    for layer in profiling.LAYERS:
        assert 0 < got[f"host_ns.{layer}"] <= got["span_ns.loop.dispatch"]
    assert got["host_ns.lp"] >= got["span_ns.lp.finalize"]
    assert got["host_ns.tier1"] < got["span_ns.tier1.certify"]


def test_seq_step_outputs_are_the_same_bits_under_a_profiler(traced_seq):
    plain, traced, _, _, _ = traced_seq
    assert sorted(plain) == sorted(traced) == [0]
    np.testing.assert_array_equal(plain[0], traced[0])
    assert plain[0][3:].sum() > 0         # the batch sheds


def test_no_profiler_no_record_function_and_nothing_kept(port_sys,
                                                         monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called")

    monkeypatch.setattr(profiling, "record_function", refuse)
    profiling.reset_counters()
    got = _seq_batches(port_sys)
    assert sorted(got) == [0]
    assert profiling.counters() == {} and profiling.indices() == {}
    assert profiling.span("lp.k1") is profiling.span("loop.wait", 3)
    # The stand-in does refuse once a profiler records.
    with pytest.raises(AssertionError, match="called"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("lp.k1"):
                pass
    profiling.reset_counters()


class _DoneEvent:
    """Stands in for a CUDA event that has completed."""

    def synchronize(self):
        pass


def _spd(batch, m):
    g = torch.Generator().manual_seed(m)
    a = torch.randn(batch, m, m, generator=g)
    return a @ a.transpose(1, 2) + m * torch.eye(m)


# Spans the small SEQ step does not reach on the CPU, each from its call.
OTHER_SPANS = {
    "loop.wait": lambda sys_: hl2_nsq.fetched_numpy(
        (torch.zeros(3), _DoneEvent())),
    "lp.wait.gate": lambda sys_: lp_ipm_batched._gate(
        torch.tensor([0.1, 1.0]), 0.5),
    "lp.wait.blocked_chol": lambda sys_: blocked_chol.blocked_cholesky(
        _spd(2, 60)),
    "tier1.island_pf": lambda sys_: dcopf.certify_island_pf(
        sys_, torch.arange(4 * sys_.n_comp).reshape(4, -1) % 7 == 0,
        sys_.load_pd[None].expand(4, -1)),
}


@pytest.mark.parametrize("case", sorted(OTHER_SPANS))
def test_span_of_each_other_call(case, port_sys, tmp_path):
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        OTHER_SPANS[case](port_sys)
    name = ".".join(case.split(".")[:2])
    assert [s["name"] for s in _trace_spans(prof, tmp_path)] == [name]
    assert profiling.counters()[f"span_ns.{name}"] > 0
    profiling.reset_counters()
