"""PyTorch port: the copper-sheet control variate of the NSQ and SEQ
studies (``run_nsq_study(control_variate=True)``,
``run_seq_study(control_variate=True)``) on the CPU, the counterparts of
tests/test_seq_cv.py.

* NSQ: the step's moments equal the plain step's minus the copper
  deficits recomputed on the host from the same draws (residuals within
  float32 rounding), and its residual moments equal the reference's
  ``batch_moments(cv=...)`` on the same states and DNS values; the study
  is unbiased and tighter (beta under half the plain one at one seed,
  the estimate within 4 of its standard errors of the exact copper mean
  plus the network's measured share, PLC likewise, nodal EENS
  untouched), and composes with ``is_boost=2``.
* SEQ: ``evaluate_years``' copper values against a host recompute on
  the same timelines (ENS within 1e-6, DLC equal) and against the
  reference's ``_years_eval`` on the same stationary year blocks; the
  study is unbiased and tighter (the annual spread under half the plain
  one, the estimate within 4 of its standard errors of the exact mean);
  ``sampling="reference"`` switches to
  stationary as in the reference; resume equals an uninterrupted run;
  maintenance with the control variate raises ValueError.
* The means the studies use equal the reference's ``copper_cv_means``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import copt as ref_copt
from powersystemsreliabilityassessment_tpu.parallel import (
    accumulators as ref_acc)
from powersystemsreliabilityassessment_tpu.sampling import (
    chronological as ref_chrono)
from powersystemsreliabilityassessment_tpu.studies import hl2_seq as ref_seq
from powersystemsreliabilityassessment_tpu.utils.config import (
    CompatFlags as RefCompat, IPMConfig as RefIPM)

from powersystemsreliabilityassessment_tpu_torch.core import (
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system, from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import copt, dcopf
from powersystemsreliabilityassessment_tpu_torch.parallel import accumulators
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
    sample_states)
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl2_nsq, hl2_seq)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

torch.set_num_threads(1)

CPU = "cpu"
COMPAT, IPM = CompatFlags(), IPMConfig()


def _nsq_copper_mu():
    case = cases.rts24()
    total = np.float32(np.sum(np.asarray(case.bus_pd, np.float64)))
    args = (np.asarray(case.gen_pmax, np.float64),
            twostate.unavailability(case)[:case.n_gen],
            np.asarray([total], np.float64))
    got = copt.copper_cv_means(*args,
                               thresh_mw=COMPAT.nsq_fail_flag_threshold_mw)
    want = ref_copt.copper_cv_means(
        *args, thresh_mw=COMPAT.nsq_fail_flag_threshold_mw)
    assert got[:2] == pytest.approx(want[:2], rel=1e-12)
    return got[0], got[1], float(total)


def test_nsq_cv_step_moments_are_the_residuals():
    case = cases.rts24()
    sys_ = build_system(case, device=CPU)
    mu_e, mu_l, total = _nsq_copper_mu()
    gen_cap = np.asarray(case.gen_pmax, np.float32)
    bpd = 512
    kw = dict(max_lp=bpd, nodal_mode="lp")
    plain = hl2_nsq.make_nsq_batch_step(sys_, bpd, COMPAT, IPM, **kw)
    cv = hl2_nsq.make_nsq_batch_step(
        sys_, bpd, COMPAT, IPM, cv_arrays=(gen_cap, total, mu_e, mu_l), **kw)
    mp, _, _ = plain(hl2_nsq.batch_generator(9, 0, CPU))
    mc, _, _ = cv(hl2_nsq.batch_generator(9, 0, CPU))
    down = sample_states(hl2_nsq.batch_generator(9, 0, CPU), sys_.unavail,
                         sys_.always_up_nsq, bpd).numpy()
    cap = (1.0 - down[:, :case.n_gen].astype(np.float64)) @ gen_cap
    c = np.maximum(np.float32(total) - cap, 0.0)
    cflag = c > COMPAT.nsq_fail_flag_threshold_mw
    assert float(mc.n) == float(mp.n) == bpd
    assert float(mc.sum_dns) == pytest.approx(float(mp.sum_dns) - c.sum(),
                                              abs=1e-2)
    assert float(mc.sum_flag) == pytest.approx(
        float(mp.sum_flag) - cflag.sum(), abs=1e-6)
    for a, b in ((mc.sum_nodal, mp.sum_nodal),
                 (mc.sum_comp_fail, mp.sum_comp_fail),
                 (mc.sum_flag_raw, mp.sum_flag_raw)):
        assert torch.equal(a, b)          # raw values stay raw
    assert c.sum() > 0                    # the batch has copper shed


# RTS-24 NSQ at its peak: EDNS = mu_C + the network's share. That share
# measured 0.0088 +- 0.0032 MW at 106,496 samples (chip_smoke.py cv24,
# NVIDIA H100); the estimate may sit above mu_C by at most this, and
# below it only by its own noise and float32 rounding of the residuals.
# PLC likewise (0.084691 against mu 0.084578 there).
NSQ_NETWORK_SHARE_MW = 0.025
NSQ_PLC_SHARE = 1e-3
ROUNDING_MW = 1e-4


def _assert_near_copper_mean(est, mu, sig):
    assert mu - 4 * sig - ROUNDING_MW <= est, (est, mu, sig)
    assert est <= mu + NSQ_NETWORK_SHARE_MW + 4 * sig, (est, mu, sig)


def test_nsq_cv_step_residual_moments_match_reference():
    # The step's control-variate moments against the reference's
    # batch_moments(cv=...) on the same states and DNS values, with the
    # copper deficit computed as the reference's step computes it.
    case = cases.rts24()
    sys_ = build_system(case, device=CPU)
    mu_e, mu_l, total = _nsq_copper_mu()
    gen_cap = np.asarray(case.gen_pmax, np.float32)
    bpd = 512
    step = hl2_nsq.make_nsq_batch_step(
        sys_, bpd, COMPAT, IPM, max_lp=bpd, nodal_mode="lp",
        cv_arrays=(gen_cap, total, mu_e, mu_l))
    mc, _, _ = step(hl2_nsq.batch_generator(4, 0, CPU))
    down = sample_states(hl2_nsq.batch_generator(4, 0, CPU), sys_.unavail,
                         sys_.always_up_nsq, bpd)
    # The step's own evaluation of these states (its buffers).
    res, _ = dcopf.evaluate_states_screened(
        sys_, down, sys_.load_pd[None, :].expand(bpd, -1), bpd, COMPAT,
        IPM, "lp", repair_buffer=dcopf.default_repair_buffer(bpd, 1.0),
        woodbury_k=hl2_nsq.default_woodbury_k(sys_),
        pf_buffer=dcopf.default_pf_buffer(sys_, bpd))
    raw = accumulators.batch_moments(res.dns_mw, res.nodal_mw, res.failure,
                                     down)
    assert torch.equal(raw.sum_flag_raw, mc.sum_flag_raw)
    assert torch.equal(raw.sum_nodal, mc.sum_nodal)
    gen_up = 1.0 - jnp.asarray(down.numpy()[:, :case.n_gen], jnp.float32)
    c_mw = jnp.maximum(np.float32(total) - gen_up @ jnp.asarray(gen_cap),
                       0.0)
    want = ref_acc.batch_moments(
        jnp.asarray(res.dns_mw.numpy()), jnp.asarray(res.nodal_mw.numpy()),
        jnp.asarray(res.failure.numpy()), jnp.asarray(down.numpy()),
        cv=(c_mw, c_mw > COMPAT.nsq_fail_flag_threshold_mw))
    c = np.asarray(c_mw, np.float64)
    assert c.sum() > 0 and float(res.dns_mw.sum()) > 0
    r = res.dns_mw.numpy().astype(np.float64) - c
    # float32 sums of 512 terms in two orders: a few ulps of the terms'
    # magnitudes.
    eps = 512 * np.finfo(np.float32).eps
    assert float(mc.sum_dns) == pytest.approx(
        float(want.sum_dns), abs=eps * np.abs(r).sum() + 1e-6)
    assert float(mc.sum_dns_sq) == pytest.approx(
        float(want.sum_dns_sq), abs=eps * (r * r).sum() + 1e-6)
    assert float(mc.sum_flag) == float(want.sum_flag)
    assert float(mc.sum_flag_raw) == float(want.sum_flag_raw)
    np.testing.assert_allclose(mc.sum_comp_fail.numpy(),
                               np.asarray(want.sum_comp_fail), rtol=1e-6)


def test_nsq_cv_unbiased_and_tighter(capsys):
    case = cases.rts24()
    cfg = MCSConfig(batch_size=256, max_samples=1024, beta_limit=0.0,
                    seed=7)
    plain = hl2_nsq.run_nsq_study(case, cfg, device=CPU, log_every=0)
    cv = hl2_nsq.run_nsq_study(case, cfg, device=CPU, log_every=1,
                               control_variate=True)
    assert "mu_EDNS 14.6937 MW, mu_PLC 0.084578" in capsys.readouterr().out
    assert plain.samples == cv.samples == 1024
    mu_e, mu_l, _ = _nsq_copper_mu()
    assert cv.beta < 0.5 * plain.beta, (cv.beta, plain.beta)
    _assert_near_copper_mean(cv.edns_mw, mu_e, cv.beta * cv.edns_mw)
    assert abs(cv.plc - mu_l) <= NSQ_PLC_SHARE, (cv.plc, mu_l)
    np.testing.assert_allclose(cv.nodal_eens_mwh_yr,
                               plain.nodal_eens_mwh_yr, rtol=1e-6)
    np.testing.assert_allclose(cv.comp_importance, plain.comp_importance,
                               rtol=1e-6)


def test_nsq_cv_composes_with_importance_sampling():
    cfg = MCSConfig(batch_size=256, max_samples=1024, beta_limit=0.0,
                    seed=11, is_boost=2.0)
    cv = hl2_nsq.run_nsq_study(cases.rts24(), cfg, device=CPU, log_every=0,
                               control_variate=True)
    mu_e, _, _ = _nsq_copper_mu()
    # E_q[w C] = mu_C exactly, so the weighted estimate stays anchored.
    _assert_near_copper_mean(cv.edns_mw, mu_e, cv.beta * cv.edns_mw)


def _seq_inputs(hours=48, scale=1.0):
    case = cases.rts24()
    sys_ = build_system(case, device=CPU)
    factors = load_profile.load_factors(hours, COMPAT.weekday_mode) * scale
    mt = twostate.mean_times(case)
    n_draws = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    total = float(np.sum(np.asarray(case.bus_pd, np.float64)))
    loads_mw = (np.asarray(factors, np.float64) * total).astype(np.float32)
    return case, sys_, factors, n_draws, loads_mw


def test_evaluate_years_copper_values_match_host_recompute():
    case, sys_, factors, n_draws, loads_mw = _seq_inputs(scale=1.6)
    hours, years = 48, 6
    gen_cap = np.asarray(case.gen_pmax, np.float32)
    down = hl2_seq.sample_years(hl2_nsq.batch_generator(3, 0, CPU), sys_,
                                years, hours, n_draws, stationary=True)
    load = hl2_seq.year_block_load(sys_, factors, years)
    outs = hl2_seq.evaluate_years(
        sys_, COMPAT, IPM, load, down, 64 * years, "lp",
        cv_arrays=(torch.as_tensor(loads_mw), torch.as_tensor(gen_cap)))
    assert len(outs) == 12
    plain = hl2_seq.evaluate_years(sys_, COMPAT, IPM, load, down,
                                   64 * years, "lp")
    for a, b in zip(outs[:10], plain):
        assert torch.equal(a, b)
    up = 1.0 - down.numpy()[:, :case.n_gen, :].astype(np.float32)
    deficit = np.maximum(loads_mw[None, :]
                         - np.einsum("ygh,g->yh", up, gen_cap), 0.0)
    np.testing.assert_allclose(outs[10].numpy(), deficit.sum(1), rtol=1e-6)
    np.testing.assert_array_equal(
        outs[11].numpy(),
        (deficit > COMPAT.seq_curtail_threshold_mw).sum(1))
    assert deficit.sum() > 0


def test_years_eval_copper_values_match_reference():
    # The reference's _years_eval with its control-variate outputs and
    # the port's evaluate_years on the same stationary year blocks.
    ref_sys = ref_build_system(ref_cases.rts24())
    port_sys = from_reference(ref_sys, device=CPU)
    case = cases.rts24()
    years, hours, max_lp = 2, 2016, 192
    mt = twostate.mean_times(case)
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    fac = (load_profile.load_factors(hours) * 1.4).astype(np.float32)
    total = float(np.sum(np.asarray(case.bus_pd, np.float64)))
    loads_mw = (fac.astype(np.float64) * total).astype(np.float32)
    gen_cap = np.asarray(case.gen_pmax, np.float32)
    keys = jax.random.split(jax.random.key(6), years)
    want = [np.asarray(a, np.float64) for a in ref_seq._years_eval(
        ref_sys, RefCompat(), RefIPM(), jnp.asarray(fac), hours, k, max_lp,
        None, "lp", keys, stationary=True,
        cv_arrays=(jnp.asarray(loads_mw), jnp.asarray(gen_cap)))]
    down = np.asarray(jax.vmap(
        lambda kk: ref_chrono.sample_timeline_stationary(
            kk, ref_sys.mttf, ref_sys.mttr, hours, k))(keys))
    got = [a.numpy().astype(np.float64) for a in hl2_seq.evaluate_years(
        port_sys, COMPAT, IPM, hl2_seq.year_block_load(port_sys, fac, years),
        torch.as_tensor(down.copy()), max_lp, "lp",
        cv_arrays=(torch.as_tensor(loads_mw), torch.as_tensor(gen_cap)))]
    assert len(got) == len(want) == 12
    assert want[10].min() > 0                    # every year has copper shed
    # float32 sums over 2,016 hours in two orders.
    np.testing.assert_allclose(got[10], want[10], rtol=1e-5)
    np.testing.assert_array_equal(got[11], want[11])
    np.testing.assert_array_equal(got[3], want[3])            # DLC


def _seq_kw(**extra):
    return dict(years_per_device=2, max_lp=168, hours=168, log_every=0,
                load_scale=1.3, device=CPU, **extra)


def test_seq_cv_unbiased_and_tighter():
    # Same seed: the same stationary paths; the control-variate run
    # differs only by each year's -C_i + mu_C.
    case = cases.rts24()
    cfg = MCSConfig(max_years=12, cov_threshold=0.0, seed=5)
    plain = hl2_seq.run_seq_study(case, cfg, sampling="stationary",
                                  **_seq_kw())
    cv = hl2_seq.run_seq_study(case, cfg, control_variate=True,
                               **_seq_kw())
    assert plain.years == cv.years == 12
    a_p, a_c = np.asarray(plain.annual_ens), np.asarray(cv.annual_ens)
    assert a_p.std() > 0
    assert a_c.std() < 0.5 * a_p.std(), (a_c.std(), a_p.std())
    _, _, factors, _, loads = _seq_inputs(hours=168, scale=1.3)
    mu_e, _, _, _ = copt.copper_cv_means(
        np.asarray(case.gen_pmax, np.float64),
        twostate.unavailability(case)[:case.n_gen], loads.astype(np.float64),
        thresh_mw=COMPAT.seq_curtail_threshold_mw)
    sig_c = a_c.std(ddof=1) / np.sqrt(len(a_c))
    # At 1.3 x the first week's load the network adds nothing to the
    # copper deficit on these paths (each year's ENS - C is float32
    # rounding, ~1e-4 MWh of ~2,000), so the estimate is the exact mean
    # within its noise and that rounding.
    assert abs(cv.eens_mwh_yr - mu_e) <= 4 * sig_c + 1e-5 * mu_e, (
        cv.eens_mwh_yr, mu_e, sig_c)
    assert cv.lole_hr_yr >= 0.0
    np.testing.assert_allclose(cv.nodal_eens_mwh_yr,
                               plain.nodal_eens_mwh_yr, rtol=1e-6)
    assert cv.lolf_occ_yr == plain.lolf_occ_yr
    # The reference's sampling switches to stationary under the variate.
    ref_mode = hl2_seq.run_seq_study(
        case, MCSConfig(max_years=4, cov_threshold=0.0, seed=5),
        control_variate=True, sampling="reference", **_seq_kw())
    assert ref_mode.annual_ens == cv.annual_ens[:4]


def test_seq_cv_resume_equals_uninterrupted_run(tmp_path):
    case = cases.rts24()
    full = hl2_seq.run_seq_study(
        case, MCSConfig(max_years=8, cov_threshold=0.0, seed=2),
        control_variate=True, **_seq_kw())
    ck = Checkpointer(str(tmp_path / "seq_cv.ckpt"))
    hl2_seq.run_seq_study(
        case, MCSConfig(max_years=4, cov_threshold=0.0, seed=2),
        control_variate=True, checkpointer=ck, checkpoint_every=1,
        **_seq_kw())
    resumed = hl2_seq.run_seq_study(
        case, MCSConfig(max_years=8, cov_threshold=0.0, seed=2),
        control_variate=True, checkpointer=ck, checkpoint_every=1,
        **_seq_kw())
    assert resumed.annual_ens == pytest.approx(full.annual_ens, rel=1e-12)
    assert resumed.eens_mwh_yr == pytest.approx(full.eens_mwh_yr,
                                                rel=1e-12)


def test_seq_cv_rejects_maintenance():
    with pytest.raises(ValueError, match="stationary"):
        hl2_seq.run_seq_study(
            cases.rts24(), MCSConfig(max_years=2, cov_threshold=0.0),
            control_variate=True, scheduled_maintenance=True,
            years_per_device=1, hours=48, log_every=0, device=CPU)
