"""PyTorch port: HL1 generation adequacy (``engines/copt.py``, the HL1
half of ``engines/copper_sheet.py``, ``studies/hl1_comparison.py`` and
``studies/hl1_rts24.py``) against the JAX package on the CPU.

* Every COPT function on the same fleets (the demo fleet at a 10 MW grid,
  RTS-24's at 1 MW): float32 tables within 1e-6 of the reference's
  (sums of up to 32 products in another order), the float64 host half
  (``build_copt_np``, ``copper_cv_means``) within 1e-12;
  tests/test_hl1.py's ``TestCOPT`` closed forms through the port (two
  units, the rounding split, the 16 MW frequency & duration example, load
  forecast uncertainty raising risk), and the copper means against a
  brute-force enumeration.
* ``LoadCurve`` and ``annual_indices_from_capacity`` on random
  capacities (LOLE equal, EUE within float32 rounding), and the
  ``nsq_batch`` construction on the reference's own uniforms: capacities
  and LOLE equal, EUE within float32 rounding.
* The HL1 studies: the fleets, loads and table equal the reference's, the
  RTS-24 analytical LOLE / EUE within 1e-5 of the reference's, and both
  Monte Carlo engines within their own standard errors of the analytical
  values.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.engines import (
    copper_sheet as ref_cs, copt as ref_copt)
from powersystemsreliabilityassessment_tpu.studies import (
    hl1_comparison as ref_hl1, hl1_rts24 as ref_rts24)

from powersystemsreliabilityassessment_tpu_torch.engines import (
    copper_sheet, copt)
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl1_comparison, hl1_rts24, hl2_nsq)

torch.set_num_threads(1)

CPU = "cpu"
# float32 tables and risks: the same recursion in another summation order.
TABLE_TOL = 1e-6
RISK_RTOL = 1e-5


def _demo():
    gens = hl1_comparison.demo_fleet()
    caps = np.asarray([g.capacity for g in gens], np.float32)
    fors = np.asarray([g.for_rate for g in gens], np.float32)
    return caps, fors, hl1_comparison.sinusoidal_load(seed=0)


def _rts24():
    gens = hl1_rts24.rts24_fleet()
    caps = np.asarray([g.capacity for g in gens], np.float32)
    fors = np.asarray([g.for_rate for g in gens], np.float32)
    return caps, fors, hl1_rts24.rts24_load()


FLEETS = {"demo": (_demo, 10.0), "rts24": (_rts24, 1.0)}


def _tables(name):
    make, step = FLEETS[name]
    caps, fors, load = make()
    n = copt.grid_points_for(float(caps.sum()), step)
    got = copt.build_copt(torch.as_tensor(caps), torch.as_tensor(fors),
                          step, n, device=CPU)
    want = ref_copt.build_copt(jnp.asarray(caps), jnp.asarray(fors), step, n)
    return caps, fors, load, step, got, np.asarray(want)


@pytest.mark.parametrize("name", ["demo", "rts24"])
def test_build_copt_matches_reference(name):
    caps, _, _, step, got, want = _tables(name)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TABLE_TOL)
    assert float(got.sum()) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("name", ["demo", "rts24"])
def test_risk_functions_match_reference(name):
    caps, _, load, step, got, want = _tables(name)
    total = float(caps.sum())
    s, s_ref = copt.summarize(got, step), ref_copt.summarize(
        jnp.asarray(want), step)
    assert s.sentinel == s_ref.sentinel == got.shape[0]
    n1 = s.sentinel + 1
    np.testing.assert_allclose(s.suffix_prob.numpy(),
                               np.asarray(s_ref.suffix_prob)[:n1],
                               atol=1e-5)
    np.testing.assert_allclose(s.suffix_xprob.numpy(),
                               np.asarray(s_ref.suffix_xprob)[:n1],
                               rtol=1e-4, atol=1e-3)
    load_t = torch.as_tensor(load)
    lolp, eue = copt.risk_at_loads(s, total, load_t, step)
    lolp_r, eue_r = ref_copt.risk_at_loads(s_ref, total, jnp.asarray(load),
                                           step)
    np.testing.assert_allclose(lolp.numpy(), np.asarray(lolp_r), atol=1e-5)
    np.testing.assert_allclose(eue.numpy(), np.asarray(eue_r), rtol=1e-4,
                               atol=1e-3)
    lole, eue_y = copt.lole_eue(got, step, total, load_t)
    lole_r, eue_yr = ref_copt.lole_eue(jnp.asarray(want), step, total,
                                       jnp.asarray(load))
    assert float(lole) == pytest.approx(float(lole_r), rel=RISK_RTOL)
    assert float(eue_y) == pytest.approx(float(eue_yr), rel=RISK_RTOL)
    ex = copt.expected_excess(s, total, load_t, step)
    assert float(ex) == pytest.approx(float(ref_copt.expected_excess(
        s_ref, total, jnp.asarray(load), step)), rel=RISK_RTOL)
    lfu = copt.lole_eue_lfu(got, step, total, load_t, 50.0)
    lfu_r = ref_copt.lole_eue_lfu(jnp.asarray(want), step, total,
                                  jnp.asarray(load), 50.0)
    assert float(lfu[0]) == pytest.approx(float(lfu_r[0]), rel=RISK_RTOL)
    assert float(lfu[1]) == pytest.approx(float(lfu_r[1]), rel=RISK_RTOL)
    np.testing.assert_array_equal(copt.LFU_POINTS, ref_copt.LFU_POINTS)
    np.testing.assert_array_equal(copt.LFU_PROBS, ref_copt.LFU_PROBS)


@pytest.mark.parametrize("name", ["demo", "rts24"])
def test_frequency_tables_match_reference(name):
    make, step = FLEETS[name]
    caps, fors, _ = make()
    lam = (8760.0 / np.asarray([g.mttf for g in (
        hl1_comparison.demo_fleet() if name == "demo"
        else hl1_rts24.rts24_fleet())])).astype(np.float32)
    n = copt.grid_points_for(float(caps.sum()), step)
    cp, cf = copt.build_copt_fd(torch.as_tensor(caps), torch.as_tensor(fors),
                                torch.as_tensor(lam), step, n, device=CPU)
    cp_r, cf_r = ref_copt.build_copt_fd(jnp.asarray(caps), jnp.asarray(fors),
                                        jnp.asarray(lam), step, n)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cp_r), atol=1e-5)
    np.testing.assert_allclose(cf.numpy(), np.asarray(cf_r), rtol=1e-4,
                               atol=1e-4)
    peak = 0.8 * float(caps.sum())
    got = copt.fd_risk(cp, cf, step, float(caps.sum()), peak)
    want = ref_copt.fd_risk(cp_r, cf_r, step, float(caps.sum()), peak)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-4)


def test_two_unit_closed_form():
    p = copt.build_copt(torch.tensor([16.0, 16.0]), torch.tensor([0.02, 0.02]),
                        1.0, 33, device=CPU).numpy()
    assert p[0] == pytest.approx(0.98 ** 2, rel=1e-5)
    assert p[16] == pytest.approx(2 * 0.98 * 0.02, rel=1e-5)
    assert p[32] == pytest.approx(0.02 ** 2, rel=1e-5)
    assert p.sum() == pytest.approx(1.0, rel=1e-5)


def test_rounding_split():
    # 56 MW on a 20 MW grid: q split 0.2 / 0.8 between 40 and 60
    # (generating_adequacy_assessment.jl:91-104).
    p = copt.build_copt(torch.tensor([56.0]), torch.tensor([0.1]), 20.0, 5,
                        device=CPU).numpy()
    assert p[0] == pytest.approx(0.9, rel=1e-5)
    assert p[2] == pytest.approx(0.1 * (1 - 0.8), rel=1e-4)
    assert p[3] == pytest.approx(0.1 * 0.8, rel=1e-4)


def test_fd_16mw_example():
    # generating_adequacy_frequency.jl:204-228: 2 x 16 MW, lambda 2/yr,
    # mu 98/yr.
    lam, mu = 2.0, 98.0
    q = lam / (lam + mu)
    cum_p, cum_f = copt.build_copt_fd(
        torch.tensor([16.0, 16.0]), torch.tensor([q, q]),
        torch.tensor([lam, lam]), 1.0, 33, device=CPU)
    p = 1 - q
    assert float(cum_p[16]) == pytest.approx(1 - p * p, rel=1e-5)
    assert float(cum_f[16]) == pytest.approx(p * p * 2 * lam, rel=1e-4)
    lole, lolf, lold = copt.fd_risk(cum_p, cum_f, 1.0, 32.0, 20.0)
    assert float(lole) == pytest.approx((1 - p * p) * 8760, rel=1e-4)
    assert float(lolf) == pytest.approx(p * p * 2 * lam, rel=1e-4)
    assert float(lold) == pytest.approx(
        (1 - p * p) * 8760 / (p * p * 2 * lam), rel=1e-3)


def test_lfu_increases_risk():
    caps, fors, load, step, probs, _ = _tables("demo")
    total = float(caps.sum())
    l0, _ = copt.lole_eue(probs, step, total, torch.as_tensor(load))
    l1, _ = copt.lole_eue_lfu(probs, step, total, torch.as_tensor(load),
                              50.0)
    assert float(l1) > float(l0)


@pytest.mark.parametrize("name", ["demo", "rts24"])
@pytest.mark.parametrize("step", [1.0, 7.0])
def test_host_tables_and_copper_means_match_reference(name, step):
    caps, fors, load = FLEETS[name][0]()
    caps, fors = caps.astype(np.float64), fors.astype(np.float64)
    np.testing.assert_allclose(copt.build_copt_np(caps, fors, step),
                               ref_copt.build_copt_np(caps, fors, step),
                               rtol=0, atol=1e-15)
    loads = load[:500].astype(np.float64)
    got = copt.copper_cv_means(caps, fors, loads, 1e-4, step)
    want = ref_copt.copper_cv_means(caps, fors, loads, 1e-4, step)
    assert got[0] == pytest.approx(want[0], rel=1e-12)
    assert got[1] == pytest.approx(want[1], rel=1e-12)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12, atol=1e-15)
    assert copt.grid_points_for(float(caps.sum()), step) == \
        ref_copt.grid_points_for(float(caps.sum()), step)


def test_copper_means_at_rts24_peak_are_the_reference_values():
    # The NSQ control variate's means (studies/hl2_nsq.py).
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    case = cases.rts24()
    total = np.float32(np.sum(np.asarray(case.bus_pd, np.float64)))
    mu_e, mu_l, _, _ = copt.copper_cv_means(
        np.asarray(case.gen_pmax, np.float64),
        twostate.unavailability(case)[:case.n_gen],
        np.asarray([total], np.float64), thresh_mw=1e-4)
    assert mu_e == pytest.approx(14.693678, rel=1e-6)
    assert mu_l == pytest.approx(0.0845781, rel=1e-6)


def test_copper_means_exact_against_enumeration():
    caps = np.array([5.0, 10.0, 20.0])
    q = np.array([0.1, 0.25, 0.05])
    loads = np.array([3.7, 12.0, 28.2, 34.9, 1.0])
    thresh = 0.01
    mu_e, mu_l, eue_h, lolp_h = copt.copper_cv_means(caps, q, loads,
                                                     thresh_mw=thresh)
    e_ref, l_ref = np.zeros_like(loads), np.zeros_like(loads)
    for m in range(8):
        up = np.array([(m >> i) & 1 == 0 for i in range(3)])
        p = np.prod(np.where(up, 1 - q, q))
        deficit = np.maximum(loads - caps[up].sum(), 0.0)
        e_ref += p * deficit
        l_ref += p * (deficit > thresh)
    np.testing.assert_allclose(eue_h, e_ref, atol=1e-12)
    np.testing.assert_allclose(lolp_h, l_ref, atol=1e-12)
    assert mu_e == pytest.approx(e_ref.sum(), rel=1e-13)
    assert mu_l == pytest.approx(l_ref.sum(), rel=1e-13)


def test_load_curve_and_annual_indices_match_reference():
    _, _, load = _rts24()
    curve = copper_sheet.LoadCurve.build(load, device=CPU)
    ref_curve = ref_cs.LoadCurve.build(jnp.asarray(load))
    np.testing.assert_array_equal(curve.sorted.numpy(),
                                  np.asarray(ref_curve.sorted))
    h = load.shape[0]
    np.testing.assert_allclose(curve.suffix_sum.numpy(),
                               np.asarray(ref_curve.suffix_sum)[:h + 1],
                               rtol=1e-6)
    rng = np.random.default_rng(5)
    cap = np.concatenate([rng.uniform(1500, 3500, 200), load[:50],
                          [0.0, 1e6]]).astype(np.float32)
    lole, eue = copper_sheet.annual_indices_from_capacity(
        torch.as_tensor(cap), curve)
    lole_r, eue_r = jax.vmap(lambda c: ref_cs.annual_indices_from_capacity(
        c, ref_curve))(jnp.asarray(cap))
    np.testing.assert_array_equal(lole.numpy(), np.asarray(lole_r))
    np.testing.assert_allclose(eue.numpy(), np.asarray(eue_r), rtol=1e-5,
                               atol=0.1)
    # tests/test_hl1.py's exact sweep, through the port.
    small = load[:100]
    c_small = copper_sheet.LoadCurve.build(small, device=CPU)
    for c in (1500.0, 2000.0, 2400.0):
        lo, eu = copper_sheet.annual_indices_from_capacity(
            torch.tensor(c), c_small)
        deficit = np.maximum(small - c, 0)
        assert float(lo) == (deficit > 0).sum()
        assert float(eu) == pytest.approx(deficit.sum(), rel=1e-5)


@pytest.mark.parametrize("name", ["demo", "rts24"])
def test_nsq_batch_on_reference_uniforms(name):
    caps, fors, load = FLEETS[name][0]()
    key, batch = jax.random.key(3), 512
    u = jax.random.uniform(key, (batch, caps.shape[0]))
    ref_curve = ref_cs.LoadCurve.build(jnp.asarray(load))
    lole_r, eue_r, cap_r = ref_cs.nsq_batch(key, jnp.asarray(caps),
                                            jnp.asarray(fors), ref_curve,
                                            batch)
    curve = copper_sheet.LoadCurve.build(load, device=CPU)
    lole, eue, cap = copper_sheet.nsq_batch_from_uniforms(
        torch.as_tensor(np.array(u)), torch.as_tensor(caps),
        torch.as_tensor(fors), curve)
    np.testing.assert_array_equal(cap.numpy(), np.asarray(cap_r))
    np.testing.assert_array_equal(lole.numpy(), np.asarray(lole_r))
    np.testing.assert_allclose(eue.numpy(), np.asarray(eue_r), rtol=1e-5,
                               atol=0.1)


def test_nsq_batch_is_its_construction_on_its_own_draws():
    caps, fors, load = _demo()
    curve = copper_sheet.LoadCurve.build(load, device=CPU)
    c, f = torch.as_tensor(caps), torch.as_tensor(fors)
    got = copper_sheet.nsq_batch(hl2_nsq.batch_generator(4, 2, CPU), c, f,
                                 curve, 300)
    u = copper_sheet.nsq_uniforms(hl2_nsq.batch_generator(4, 2, CPU),
                                  caps.shape[0], 300, CPU)
    want = copper_sheet.nsq_batch_from_uniforms(u, c, f, curve)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_hl1_inputs_and_table_match_reference():
    assert hl1_comparison.demo_fleet() == [
        hl1_comparison.GeneratorSpec(g.id, g.capacity, g.mttf, g.mttr)
        for g in ref_hl1.demo_fleet()]
    for g, r in zip(hl1_rts24.rts24_fleet(), ref_rts24.rts24_fleet()):
        assert (g.id, g.capacity, g.mttf, g.mttr, g.for_rate) == \
            (r.id, r.capacity, r.mttf, r.mttr, r.for_rate)
    np.testing.assert_array_equal(hl1_comparison.sinusoidal_load(seed=3),
                                  ref_hl1.sinusoidal_load(seed=3))
    np.testing.assert_array_equal(hl1_rts24.rts24_load(),
                                  ref_rts24.rts24_load())
    results = [hl1_comparison.MethodResult("Analytical", 9.1, 1000.5, 0.2,
                                           [])]
    ref_results = [ref_hl1.MethodResult("Analytical", 9.1, 1000.5, 0.2, [])]
    assert hl1_comparison.compare_results(results) == \
        ref_hl1.compare_results(ref_results)


def test_hl1_rts24_analytical_matches_reference():
    got = hl1_comparison.run_analytical(hl1_rts24.rts24_fleet(),
                                        hl1_rts24.rts24_load(), step=1.0,
                                        device=CPU)
    want = ref_hl1.run_analytical(ref_rts24.rts24_fleet(),
                                  ref_rts24.rts24_load(), step=1.0)
    assert got.lole_hours_yr == pytest.approx(want.lole_hours_yr, rel=1e-5)
    assert got.eue_mwh_yr == pytest.approx(want.eue_mwh_yr, rel=1e-5)
    # results/study_sweep.json["hl1_rts24"]["analytical"]
    assert got.lole_hours_yr == pytest.approx(9.394095, rel=1e-4)
    assert got.eue_mwh_yr == pytest.approx(1176.291, rel=1e-4)


def _batch_se(result, per):
    """Standard error of the mean from a Monte Carlo result's running
    LOLE history (batch means of ``per`` samples each)."""
    h = np.asarray(result.convergence_history)
    n = per * np.arange(1, h.size + 1)
    means = np.diff(np.concatenate([[0.0], h * n])) / per
    return means.std(ddof=1) / math.sqrt(means.size)


def test_hl1_monte_carlo_engines_agree_with_the_analytical_value():
    gens, load = hl1_comparison.demo_fleet(), hl1_comparison.sinusoidal_load()
    exact = hl1_comparison.run_analytical(gens, load, device=CPU)
    nsq = hl1_comparison.run_non_sequential_mc(gens, load, 20000, seed=0,
                                               batch=1000, device=CPU)
    seq = hl1_comparison.run_sequential_mc(gens, load, 200, seed=1,
                                           batch=20, device=CPU)
    assert len(nsq.convergence_history) == 20
    assert len(seq.convergence_history) == 10
    for res, per in ((nsq, 1000), (seq, 20)):
        se = _batch_se(res, per)
        assert res.standard_errors()[0] == pytest.approx(se, rel=1e-9)
        assert len(res.batch_means) == len(res.convergence_history)
        assert abs(res.lole_hours_yr - exact.lole_hours_yr) <= 4 * se, (
            res.method, res.lole_hours_yr, exact.lole_hours_yr, se)
    assert nsq.eue_mwh_yr == pytest.approx(exact.eue_mwh_yr, rel=0.2)
    assert seq.eue_mwh_yr == pytest.approx(exact.eue_mwh_yr, rel=0.25)
    again = hl1_comparison.run_non_sequential_mc(gens, load, 3000, seed=0,
                                                 batch=1000, device=CPU)
    assert again.convergence_history == nsq.convergence_history[:3]


def test_run_full_comparison_and_its_figure(capsys, tmp_path):
    out = hl1_comparison.run_full_comparison(
        iterations=2000, years=20, device=CPU,
        out_dir=str(tmp_path / "figures"))
    assert (tmp_path / "figures" / "hl1_comparison.png").stat().st_size > 0
    assert set(out) == {"Analytical", "Non-Sequential MC", "Sequential MC"}
    assert out["Analytical"]["batch_means"] == []
    assert "METHOD COMPARISON SUMMARY" in capsys.readouterr().out
    assert all(math.isfinite(r["lole_hours_yr"]) for r in out.values())


def test_hl1_rts24_run_reports_standard_errors(capsys):
    out = hl1_rts24.run(iterations=4000, years=200, device=CPU)
    assert "METHOD COMPARISON SUMMARY" in capsys.readouterr().out
    assert out["Analytical"]["se"] is None
    for method in ("Non-Sequential MC", "Sequential MC"):
        se = out[method]["se"]
        assert len(se) == 2 and all(math.isfinite(v) and v >= 0 for v in se)
    assert out["Analytical"]["lole"] == pytest.approx(9.394095, rel=1e-4)
