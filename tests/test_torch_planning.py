"""PyTorch port: HL1 planning (``engines/planning.py``, ``engines/elu.py``,
``sampling/markov.py``, ``studies/planning_elu.py``,
``studies/markov_education.py``) against the JAX package on the CPU.

* The maintenance schedule and mask equal the reference's on the demo
  fleet against its load's weekly peaks, on RTS-24's fleet against its
  weekly peaks, and on the reference's peak-block case.
* The ELU fixed point: ``effective_q`` and ``q_history`` within 1e-5 of
  the reference's (float32 COPT sums in another order, combined in
  float64); ``weekly_hourly_risk`` within 1e-6 per hour and its LOLE
  within 1e-4 relative, at 600 and at 50 hydro hours.
* The energy-state Monte Carlo's construction on the reference's own
  draws (rebuilt with its key splits): yearly LOLE equal and the hourly
  profile within 1e-6; the reference's dispatch-semantics case (LOLE 23)
  and ``var_cvar`` cases.
* The Markov chain on the reference's own uniforms: paths bit-equal; the
  four educational studies equal to the reference's (the Monte Carlo
  ones fed the reference's uniforms).
* The studies on the port's own stream: the reference's < 20% gate at
  600 hydro hours, and the 50-hour tail study's Monte Carlo mean above
  the analytical one with CVaR >= VaR >= mean.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import (
    cases as ref_cases, load_profile as ref_lp)
from powersystemsreliabilityassessment_tpu.engines import (
    elu as ref_elu, planning as ref_planning)
from powersystemsreliabilityassessment_tpu.sampling import (
    markov as ref_markov)
from powersystemsreliabilityassessment_tpu.studies import (
    markov_education as ref_edu, planning_elu as ref_pe)

from powersystemsreliabilityassessment_tpu_torch.core import load_profile
from powersystemsreliabilityassessment_tpu_torch.engines import elu, planning
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.sampling import markov
from powersystemsreliabilityassessment_tpu_torch.studies import (
    markov_education, planning_elu)

torch.set_num_threads(1)

CPU = "cpu"
Q_TOL = 1e-5             # effective q: float32 sums in another order
RISK_ATOL = 1e-6         # hourly LOLP
LOLE_RTOL = 1e-4
PROFILE_ATOL = 1e-6      # Monte Carlo hourly failure share


def _fleets(hydro_hours):
    return (ref_pe.demo_planning_fleet(hydro_hours),
            planning_elu.demo_planning_fleet(hydro_hours))


def _rts24_fleets():
    case = ref_cases.rts24()
    make = lambda mod: mod.PlanningFleet(
        names=[f"G{i + 1}" for i in range(case.n_gen)],
        capacity=case.gen_pmax.astype(float), for_rate=np.zeros(case.n_gen),
        maint_weeks=np.round(case.gen_maint_weeks).astype(int),
        energy_limit=np.full(case.n_gen, np.inf))
    return make(ref_planning), make(planning)


def _peak_block():
    peaks = np.full(52, 800.0)
    peaks[20:30] = 1100.0   # a high-load block maintenance must avoid
    return peaks


@pytest.mark.parametrize("which", ["demo", "rts24", "peak_block"])
def test_maintenance_schedule_matches_reference(which):
    if which == "rts24":
        ref_f, port_f = _rts24_fleets()
        peaks = ref_lp.weekly_peaks(ref_lp.load_factors(52 * 168))
        np.testing.assert_array_equal(
            peaks, load_profile.weekly_peaks(load_profile.load_factors(
                52 * 168)))
    else:
        ref_f, port_f = _fleets(600.0)
        peaks = (_peak_block() if which == "peak_block"
                 else planning_elu.weekly_peaks_of(
                     planning_elu.demo_planning_load()))
        np.testing.assert_array_equal(
            planning_elu.weekly_peaks_of(planning_elu.demo_planning_load()),
            ref_pe.weekly_peaks_of(ref_pe.demo_planning_load()))
    want = ref_planning.schedule_maintenance(ref_f, peaks)
    got = planning.schedule_maintenance(port_f, peaks)
    np.testing.assert_array_equal(got, want)
    mask = planning.maintenance_mask(port_f)
    np.testing.assert_array_equal(mask, ref_planning.maintenance_mask(ref_f))
    np.testing.assert_array_equal(mask.sum(0), port_f.maint_weeks)
    assert (port_f.maint_start[port_f.maint_weeks > 0] > 0).all()
    if which == "peak_block":
        removed = (mask * port_f.capacity[None, :]).sum(1)
        assert removed[20:30].sum() == 0


def test_demo_load_and_fleet_equal_reference():
    for seed in (0, 3):
        np.testing.assert_array_equal(planning_elu.demo_planning_load(
            seed=seed), ref_pe.demo_planning_load(seed=seed))
    for hh in (600.0, 50.0):
        ref_f, port_f = _fleets(hh)
        for k in ("capacity", "for_rate", "maint_weeks", "energy_limit",
                  "effective_q", "maint_start"):
            np.testing.assert_array_equal(getattr(port_f, k),
                                          getattr(ref_f, k))
        assert port_f.names == ref_f.names and port_f.n == ref_f.n


@pytest.mark.parametrize("hydro_hours", [600.0, 50.0])
def test_elu_fixed_point_and_weekly_risk_match_reference(hydro_hours):
    load = planning_elu.demo_planning_load()
    lfu = float(load.max()) * 0.05
    ref_f, port_f = _fleets(hydro_hours)
    peaks = planning_elu.weekly_peaks_of(load)
    ref_planning.schedule_maintenance(ref_f, peaks)
    planning.schedule_maintenance(port_f, peaks)
    e_ref = ref_planning.expected_elu_energy(ref_f, 4, load, lfu, 20.0)
    e_got = planning.expected_elu_energy(port_f, 4, load, lfu, 20.0, CPU)
    assert e_got == pytest.approx(e_ref, rel=1e-5)
    ref_planning.iterate_elu(ref_f, load, lfu, 20.0)
    planning.iterate_elu(port_f, load, lfu, 20.0, device=CPU)
    assert len(port_f.q_history) == len(ref_f.q_history)
    for a, b in zip(port_f.q_history, ref_f.q_history):
        np.testing.assert_allclose(a, b, atol=Q_TOL, rtol=0)
    if hydro_hours == 50.0:
        assert port_f.effective_q[4] > port_f.for_rate[4]
    want = ref_planning.weekly_hourly_risk(ref_f, load, lfu, 20.0)
    got = planning.weekly_hourly_risk(port_f, load, lfu, 20.0, CPU)
    assert got.shape == want.shape == (8760,)
    np.testing.assert_allclose(got, want, atol=RISK_ATOL, rtol=0)
    assert got.sum() == pytest.approx(want.sum(), rel=LOLE_RTOL)


@pytest.mark.parametrize("hydro_hours", [600.0, 50.0])
def test_planning_analytical_matches_reference(hydro_hours):
    load = planning_elu.demo_planning_load()
    want = ref_pe.run_planning_analytical(
        ref_pe.demo_planning_fleet(hydro_hours), load)
    got = planning_elu.run_planning_analytical(
        planning_elu.demo_planning_fleet(hydro_hours), load, device=CPU)
    np.testing.assert_array_equal(got.maint_start, want.maint_start)
    np.testing.assert_allclose(got.effective_q, want.effective_q, atol=Q_TOL)
    assert got.lole_hr_yr == pytest.approx(want.lole_hr_yr, rel=LOLE_RTOL)
    np.testing.assert_allclose(got.hourly_risk, want.hourly_risk,
                               atol=RISK_ATOL)
    assert set(got.to_dict()) == set(want.to_dict())


def test_generous_limit_keeps_q_and_tight_limit_raises_it():
    load = planning_elu.demo_planning_load(seed=1)
    fleet = planning_elu.demo_planning_fleet(hydro_hours=1e6)
    planning.iterate_elu(fleet, load, 50.0, 20.0, iters=2, device=CPU)
    assert fleet.effective_q[4] == pytest.approx(fleet.for_rate[4])
    fleet = planning_elu.demo_planning_fleet(hydro_hours=50.0)
    planning.iterate_elu(fleet, load, 50.0, 20.0, iters=3, device=CPU)
    assert fleet.effective_q[4] > fleet.for_rate[4]


def _ref_elu_draws(key, n_years, H, G):
    """The reference's per-year draws of run_elu_mc, rebuilt with its key
    splits: (u [Y, H, G], z [Y, H])."""
    def one(k):
        ku, kl = jax.random.split(k)
        return jax.random.uniform(ku, (H, G)), jax.random.normal(kl, (H,))
    u, z = jax.vmap(one)(jax.random.split(key, n_years))
    return torch.as_tensor(np.array(u)), torch.as_tensor(np.array(z))


@pytest.mark.parametrize("hydro_hours,seed", [(600.0, 3), (50.0, 4)])
def test_elu_construction_on_reference_draws(hydro_hours, seed):
    load = planning_elu.demo_planning_load()
    lfu = float(load.max()) * 0.05
    fleet = ref_pe.demo_planning_fleet(hydro_hours)
    ref_planning.schedule_maintenance(fleet, ref_pe.weekly_peaks_of(load))
    n_years, key = 12, jax.random.key(seed)
    args = (fleet.capacity, fleet.for_rate, fleet.maint_start,
            fleet.maint_weeks, fleet.energy_limit, load)
    want_y, want_h = ref_elu.run_elu_mc(
        key, *(jnp.asarray(a, jnp.int32 if a.dtype.kind == "i"
                           else jnp.float32) for a in args), lfu, n_years)
    u, z = _ref_elu_draws(key, n_years, len(load), fleet.n)
    got_y, got_h = elu.elu_mc_from_draws(u, z, *args, lfu)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=PROFILE_ATOL, rtol=0)
    assert float(got_y.sum()) > 0


def test_mc_dispatch_semantics():
    # The reference's case: 1 unlimited 100 MW unit and a 50 MW ELU with 2
    # MWh; a constant 120 MW load, no failures, no maintenance, no LFU.
    # Hour 0 drains 20 MWh (past the limit), so from hour 1 on the ELU is
    # exhausted and every hour is in deficit.
    args = (np.array([100.0, 50.0]), np.array([0.0, 0.0]),
            np.array([0, 0]), np.array([0, 0]), np.array([np.inf, 2.0]),
            np.full(24, 120.0))
    gen = torch.Generator().manual_seed(0)
    lole_y, hourly = elu.run_elu_mc(gen, *args, 0.0, 4)
    assert float(hourly[0]) == 0.0
    assert float(hourly[1:].mean()) == 1.0
    assert float(lole_y.mean()) == 23.0
    want_y, want_h = ref_elu.run_elu_mc(
        jax.random.key(0), *(jnp.asarray(a) for a in args[:5]),
        jnp.asarray(args[5]), 0.0, 4)
    np.testing.assert_array_equal(lole_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(hourly.numpy(), np.asarray(want_h))


@pytest.mark.parametrize("n,alpha", [(100, 0.95), (37, 0.95), (1, 0.95),
                                     (2000, 0.99), (50, 0.5)])
def test_var_cvar_matches_reference(n, alpha):
    s = np.random.default_rng(n).gamma(2.0, 30.0, n).astype(np.float32)
    var, cvar = elu.var_cvar(torch.as_tensor(s), alpha)
    w_var, w_cvar = ref_elu.var_cvar(jnp.asarray(s), alpha)
    assert float(var) == float(w_var)
    assert float(cvar) == pytest.approx(float(w_cvar), rel=1e-6)
    if n == 100:
        var, cvar = elu.var_cvar(torch.arange(100, dtype=torch.float32))
        assert float(var) == 94.0
        assert float(cvar) == pytest.approx(np.mean([94, 95, 96, 97, 98,
                                                     99]))


def _ref_markov_uniforms(key, n, hours):
    keys = jax.random.split(key, hours)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


@pytest.mark.parametrize("seed", [0, 42])
def test_markov_chain_on_reference_uniforms(seed):
    mttf = np.array([1000.0, 1200.0, 80.0, 15.0, 2000.0])
    mttr = np.array([50.0, 60.0, 40.0, 20.0, 100.0])
    p01, p10 = twostate.transition_probs(mttf, mttr)
    hours, key = 3000, jax.random.key(seed)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    init = np.array([False, True, False, True, False])
    for init_down in (None, init):
        want = np.asarray(ref_markov.sample_markov_chain(
            key, f32(p01), f32(p10), hours,
            None if init_down is None else jnp.asarray(init_down)))
        got = markov.markov_chain_from_uniforms(
            torch.as_tensor(_ref_markov_uniforms(key, 5, hours)), p01, p10,
            None if init_down is None else torch.as_tensor(init_down))
        assert got.shape == (5, hours) and want.any() and (~want).any()
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(ref_markov.sample_markov_chain_batch(
        key, f32(p01), f32(p10), 200, 3))
    u = np.stack([_ref_markov_uniforms(k, 5, 200)
                  for k in jax.random.split(key, 3)])
    got = markov.markov_chain_from_uniforms(torch.as_tensor(u), p01, p10)
    np.testing.assert_array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(seed)
    assert markov.sample_markov_chain_batch(gen, p01, p10, 50, 4).shape == \
        (4, 5, 50)


def _feed_reference_uniforms(monkeypatch, seed):
    """The port's Markov draws replaced by the reference's for key
    ``seed``, so a study's Monte Carlo part sees the reference's path."""
    def uniforms(generator, n_comp, hours, batch=(), device="cuda"):
        return torch.as_tensor(_ref_markov_uniforms(
            jax.random.key(seed), n_comp, hours), device=device)
    monkeypatch.setattr(markov, "markov_uniforms", uniforms)


def test_educational_studies_match_reference(monkeypatch):
    for a, b in zip(markov_education.exponential_proof(1000.0, 20000),
                    ref_edu.exponential_proof(1000.0, 20000)):
        np.testing.assert_array_equal(a, b)
    times = markov_education.exponential_proof(1000.0, 20000)[0]
    assert np.mean(times) == pytest.approx(1000.0, rel=0.1)
    got, want = (markov_education.parameter_estimation_study(),
                 ref_edu.parameter_estimation_study())
    for k in ("up_durations", "down_durations", "running_lambda"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for k in ("est_mttf", "est_mttr", "est_lambda", "est_mu", "true_lambda"):
        assert getattr(got, k) == getattr(want, k)
    assert got.running_lambda[-1] == pytest.approx(got.true_lambda, rel=0.1)

    _feed_reference_uniforms(monkeypatch, 42)
    got = markov_education.single_component_study(device=CPU)
    want = ref_edu.single_component_study()
    np.testing.assert_array_equal(got.prob_down_analytical,
                                  want.prob_down_analytical)
    np.testing.assert_array_equal(got.mc_realization, want.mc_realization)
    assert got.steady_state == want.steady_state
    assert got.prob_down_analytical[-1] == pytest.approx(got.steady_state,
                                                         rel=0.05)
    cap, total = markov_education.multi_unit_capacity_series(device=CPU)
    w_cap, w_total = ref_edu.multi_unit_capacity_series()
    np.testing.assert_array_equal(cap, w_cap)
    assert total == w_total == 600.0
    assert 0 <= cap.min() and cap.max() <= total and cap.min() < total


def test_educational_studies_on_the_port_stream():
    s = markov_education.single_component_study(steps=400, device=CPU)
    assert set(np.unique(s.mc_realization)) <= {0, 1}
    assert s.mc_realization.shape == (400,)
    cap, total = markov_education.multi_unit_capacity_series(device=CPU)
    assert cap.shape == (1000,) and 0 <= cap.min() and cap.max() <= total


def test_elu_comparison_meets_the_reference_gate():
    # MCvsMarkovProcess's "600 h of water" configuration meets the
    # reference's own < 20% agreement gate (jl:330-335).
    fleet = planning_elu.demo_planning_fleet(hydro_hours=600.0)
    load = planning_elu.demo_planning_load(seed=3)
    res = planning_elu.run_elu_comparison(fleet, load, mc_years=400, seed=4,
                                          device=CPU)
    assert res.analytical_lole > 0
    assert res.success, (res.analytical_lole, res.mc_lole)
    assert res.mc_yearly_distribution.shape == (400,)
    assert res.mc_hourly_profile.shape == (8760,)
    assert res.cvar95 >= res.var95
    assert set(res.to_dict()) == {"analytical_lole", "mc_lole",
                                  "diff_percent", "success", "var95",
                                  "cvar95"}


def test_tail_risk_mc_exceeds_analytical():
    # tail_risk.jl's 50-hour water shortage: sequential exhaustion makes
    # more risk than the effective-q analytical value holds, with a heavy
    # tail.
    res = planning_elu.run_tail_risk_study(mc_years=300, seed=5, device=CPU)
    assert res.mc_lole > res.analytical_lole
    assert res.cvar95 >= res.var95 >= res.mc_lole
    assert not res.success
