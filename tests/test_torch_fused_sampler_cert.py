"""PyTorch port: the fused sampler + first-pass certificate (K4,
``ops/fused_sampler_cert.py``, its plain version on the CPU), its
completion ``dcopf.certify_finish``, the screened evaluator's ``pre``
and the ``fused_tier1`` study path.

The JAX kernel runs in Pallas interpret mode in explicit-state mode on
the same numpy states (RTS-24 at 40x unavailability, as
tests/test_fused_sampler_cert.py draws them).

* K4: states equal; deficit and shed within 1e-5 p.u. (float32 sums of
  <= 33 terms of ~1-34 p.u. in another order); both packages' first-pass
  masks are subsets of the port's ``certify_states`` (the guard band is
  sound) and agree on >= 99% of lanes (the two bands differ: the
  reference's models bf16 dots, the port's float32 FMA sums).
* The certified candidates pass an independent float64 flow check.
* ``certify_finish`` matches the reference's on the same first-pass
  outputs; first pass + finish equals ``certify_states`` exactly.
* ``evaluate_states_screened(pre=...)`` matches the default path; a
  finish buffer too small leaves lanes uncertified, never certified.
* The study step with ``fused_tier1`` runs the plain K4 on the CPU, and
  a 16384-sample fused study lands within 4 combined standard errors of
  results/nsq_results.json.
"""
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import dcopf as ref_dcopf
from powersystemsreliabilityassessment_tpu.ops import (
    fused_sampler_cert as ref_fused)

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system, from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.ops import (
    fused_sampler_cert as ff, hw_sampler)
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL_PU = 1e-5


def boosted_states(ref_sys, n, seed, boost=40.0):
    """numpy [n, n_comp] states at ``boost`` x unavailability (<= 0.5),
    the pinned condenser up."""
    rng = np.random.default_rng(seed)
    p = np.minimum(np.asarray(ref_sys.unavail) * boost, 0.5)
    down = rng.uniform(size=(n, p.shape[0])) < p[None, :]
    return down & ~np.asarray(ref_sys.always_up_nsq)[None, :]


def _quick_both(ref_sys, sys_, down):
    """(reference outputs as numpy, port outputs) of the first pass."""
    ref = ref_fused.sample_certify_quick(
        jax.random.key(0), ref_sys, down.shape[0], down=jnp.asarray(down))
    got = ff.sample_certify_quick(None, sys_, down.shape[0],
                                  down=torch.as_tensor(down))
    return tuple(np.asarray(r) for r in ref), got


@pytest.fixture(scope="module")
def setup():
    ref_sys = ref_build_system(ref_cases.rts24())
    sys_ = from_reference(ref_sys, device="cpu")
    B = 1024
    down = boosted_states(ref_sys, B, seed=7)
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (B, 1))
    ref, got = _quick_both(ref_sys, sys_, down)
    cert = dcopf.certify_states(sys_, torch.as_tensor(down),
                                torch.as_tensor(load), woodbury_k=2)
    return ref_sys, sys_, down, load, ref, got, cert


def test_quick_pass_matches_reference_and_is_sound(setup):
    _, sys_, down, _, ref, got, cert = setup
    r_down, r_ok1, r_def, r_shed = ref
    g_down, g_ok1, g_def, g_shed = got
    np.testing.assert_array_equal(g_down.numpy(), down)
    np.testing.assert_array_equal(r_down.astype(bool), down)
    np.testing.assert_allclose(g_def.numpy(), r_def, rtol=0, atol=TOL_PU)
    np.testing.assert_allclose(g_shed.numpy(), r_shed, rtol=0, atol=TOL_PU)
    ok1, c = g_ok1.numpy(), cert.certified.numpy()
    assert ok1.sum() > 500                  # the quick pass does real work
    assert (~ok1 | c).all() and (~r_ok1 | c).all()
    assert (ok1 == r_ok1).mean() >= 0.99
    # Among eligible lanes the first pass loses only a sliver of the
    # lanes the plain first check certifies (the band's share).
    first = dcopf.certify_states(sys_, torch.as_tensor(down),
                                 sys_.load_pd[None].expand(len(down), -1),
                                 repair_iters=0).certified.numpy()
    first &= down[:, sys_.n_gen:].sum(1) <= 1
    assert (first & ~ok1).sum() <= 0.02 * first.sum()


def test_quick_candidates_pass_float64_flow_check(setup):
    ref_sys, sys_, down, load, _, got, _ = setup
    _, ok1, deficit, shed = got
    ok1 = ok1.numpy()
    gen_up = 1.0 - torch.as_tensor(down[:, :sys_.n_gen]).float()
    lp = torch.as_tensor(load)
    disp = dcopf._dispatch_candidate(
        sys_, sys_.gen_pmax[None, :] * gen_up, lp, shed,
        lp.sum(1) - deficit).double().numpy()
    f64 = lambda a: np.asarray(a, np.float64)
    loh = f64(ref_sys.load_onehot)
    inj = (disp @ f64(ref_sys.gen_bus_onehot).T
           + shed.double().numpy() @ loh.T - load @ loh.T)
    f = inj @ f64(ref_sys.ptdf).T
    brd = down[:, sys_.n_gen:].astype(np.float64)
    post = (f + (brd * f) @ f64(ref_sys.lodf).T) * (1.0 - brd)
    ok_f64 = (np.abs(post) <= f64(ref_sys.br_rate)[None, :] + 1e-4).all(1)
    assert (brd.sum(1)[ok1] <= 1).all()
    assert ok_f64[ok1].all()


def test_finish_matches_reference_finish(setup):
    ref_sys, sys_, down, load, ref, _, _ = setup
    _, r_ok1, r_def, r_shed = ref
    B = down.shape[0]
    want = ref_dcopf.certify_finish(
        ref_sys, jnp.asarray(down), jnp.asarray(load), jnp.asarray(r_def),
        jnp.asarray(r_shed), jnp.asarray(r_ok1), B, woodbury_k=2)
    got = dcopf.certify_finish(
        sys_, torch.as_tensor(down), torch.as_tensor(load),
        torch.as_tensor(r_def.copy()), torch.as_tensor(r_shed.copy()),
        torch.as_tensor(r_ok1.copy()), B, woodbury_k=2)
    wc, gc = np.asarray(want.certified), got.certified.numpy()
    np.testing.assert_array_equal(gc, wc)
    assert (down[:, sys_.n_gen:].sum(1) >= 2).sum() > 20   # Woodbury lanes
    np.testing.assert_allclose(got.shed.numpy()[gc],
                               np.asarray(want.shed)[gc], rtol=0,
                               atol=TOL_PU)
    np.testing.assert_allclose(got.dispatch.numpy()[gc],
                               np.asarray(want.dispatch)[gc], rtol=0,
                               atol=TOL_PU)


def test_quick_plus_finish_is_certify_states(setup):
    _, sys_, down, load, _, got, cert = setup
    _, ok1, deficit, shed = got
    fin = dcopf.certify_finish(sys_, torch.as_tensor(down),
                               torch.as_tensor(load), deficit, shed, ok1,
                               down.shape[0], woodbury_k=2)
    assert torch.equal(fin.certified, cert.certified)
    np.testing.assert_allclose(fin.deficit.numpy(), cert.deficit.numpy(),
                               rtol=0, atol=TOL_PU)
    c = fin.certified
    np.testing.assert_allclose(fin.shed[c].double().sum(1).numpy(),
                               fin.deficit[c].double().numpy(), atol=2e-4)


def test_screened_eval_with_pre_matches_default():
    ref_sys = ref_build_system(ref_cases.rts24())
    sys_ = from_reference(ref_sys, device="cpu")
    B = 256
    down = torch.as_tensor(boosted_states(ref_sys, B, seed=3))
    load = sys_.load_pd[None, :].expand(B, sys_.n_load)
    d, ok1, deficit, shed = ff.sample_certify_quick(None, sys_, B, down=down)
    pre = dcopf.certify_finish(sys_, d, load, deficit, shed, ok1, B)
    res_p, over_p = dcopf.evaluate_states_screened(sys_, d, load, B,
                                                   pre=pre)
    res_d, over_d = dcopf.evaluate_states_screened(sys_, down, load, B)
    assert int(over_p) == int(over_d) == 0
    np.testing.assert_allclose(res_p.dns_mw.numpy(), res_d.dns_mw.numpy(),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(res_p.nodal_mw.numpy(),
                               res_d.nodal_mw.numpy(), rtol=0, atol=5e-3)
    assert torch.equal(res_p.failure, res_d.failure)


def test_finish_buffer_overflow_stays_uncertified(setup):
    ref_sys, sys_, _, _, _, _, _ = setup
    B = 512
    down = torch.as_tensor(boosted_states(ref_sys, B, seed=5, boost=60.0))
    load = sys_.load_pd[None, :].expand(B, sys_.n_load)
    _, ok1, deficit, shed = ff.sample_certify_quick(None, sys_, B,
                                                    down=down)
    assert int((~ok1).sum()) > 8
    small = dcopf.certify_finish(sys_, down, load, deficit, shed, ok1, 8)
    full = dcopf.certify_finish(sys_, down, load, deficit, shed, ok1, B)
    fs, fl = small.certified, full.certified
    assert bool((~fs | fl).all()) and bool((~ok1 | fs).all())
    assert int(fs.sum()) <= min(int(ok1.sum()) + 8, int(fl.sum()))
    assert dcopf.default_finish_buffer(B) == \
        ref_dcopf.default_finish_buffer(B)
    assert dcopf.default_finish_buffer(262144, hinted=True) == \
        ref_dcopf.default_finish_buffer(262144, hinted=True) == 8192


def test_batch_of_tile_plus_17(setup):
    ref_sys, sys_, _, _, _, _, _ = setup
    B = ref_fused.TILE + 17
    down = boosted_states(ref_sys, B, seed=9, boost=25.0)
    ref, got = _quick_both(ref_sys, sys_, down)
    assert got[0].shape == (B, sys_.n_comp)
    assert got[1].shape == (B,) and got[2].shape == (B,)
    np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=0, atol=TOL_PU)
    load = sys_.load_pd[None, :].expand(B, sys_.n_load)
    cert = dcopf.certify_states(sys_, torch.as_tensor(down), load)
    assert bool((~got[1] | cert.certified).all())


def test_supported_gate():
    assert ff.supported(build_system(cases.rts24(), device="cpu"))
    sys96 = build_system(cases.rts96(), device="cpu")
    assert not ff.supported(sys96)
    assert not ref_fused.supported(ref_build_system(ref_cases.rts96()))
    with pytest.raises(ValueError, match="128"):
        ff.sample_certify_quick(None, sys96, 4,
                                down=torch.zeros((4, 218), dtype=bool))
    with pytest.raises(ValueError, match="128"):
        hl2_nsq.make_nsq_batch_step(sys96, 64, CompatFlags(), IPMConfig(),
                                    fused_tier1=True)


def test_random_mode_draws_the_k6_states(setup):
    _, sys_, _, _, _, _, _ = setup
    gen = lambda: hl2_nsq.batch_generator(2, 9, "cpu")
    down, ok1, deficit, _ = ff.sample_certify_quick(gen(), sys_, 2048)
    want = hw_sampler.sample_states_hw(gen(), sys_.unavail,
                                       sys_.always_up_nsq, 2048)
    assert torch.equal(down, want)
    _, ok_e, def_e, _ = ff.sample_certify_quick(None, sys_, 2048, down=down)
    assert torch.equal(ok1, ok_e) and torch.equal(deficit, def_e)


def test_fused_step_runs_the_plain_kernel_on_cpu(monkeypatch):
    sys_ = build_system(cases.rts24(), device="cpu")
    calls = []
    plain = ff.sample_certify_quick_plain
    monkeypatch.setattr(ff, "sample_certify_quick_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    hint = dcopf.calibrate_shed_hint(sys_)
    kw = dict(max_lp=512, nodal_mode="proportional", shed_hint=hint)
    fused = hl2_nsq.make_nsq_batch_step(sys_, 4096, CompatFlags(),
                                        IPMConfig(), fused_tier1=True, **kw)
    m_f, over_f, _ = fused(hl2_nsq.batch_generator(0, 1, "cpu"))
    assert calls and ff.launches["sample_certify_quick"] == 0
    # The same states through the default step.
    monkeypatch.setattr(hl2_nsq, "sample_states",
                        lambda g, u, a, b: hw_sampler.sample_states_hw(
                            g, u, a, b))
    default = hl2_nsq.make_nsq_batch_step(sys_, 4096, CompatFlags(),
                                          IPMConfig(), **kw)
    m_d, over_d, _ = default(hl2_nsq.batch_generator(0, 1, "cpu"))
    assert int(over_f) == int(over_d) == 0
    assert float(m_f.n) == float(m_d.n) == 4096
    assert float(m_f.sum_flag) == float(m_d.sum_flag)
    assert torch.equal(m_f.sum_comp_fail, m_d.sum_comp_fail)
    np.testing.assert_allclose(float(m_f.sum_dns), float(m_d.sum_dns),
                               rtol=1e-5)
    np.testing.assert_allclose(m_f.sum_nodal.numpy(), m_d.sum_nodal.numpy(),
                               rtol=1e-4, atol=1e-2)


def test_small_fused_study_matches_committed_results():
    ref = json.loads((ROOT / "results" / "nsq_results.json").read_text())
    res = hl2_nsq.run_nsq_study(
        cases.rts24(), MCSConfig(batch_size=4096, max_samples=16384,
                                 fused_tier1=True),
        device="cpu", log_every=0)
    assert res.samples == 16384 and res.overflow_states == 0
    se_e = math.hypot(ref["beta"] * ref["edns_mw"], res.beta * res.edns_mw)
    se_p = math.hypot(
        math.sqrt(ref["plc"] * (1 - ref["plc"]) / ref["samples"]),
        math.sqrt(res.plc * (1 - res.plc) / res.samples))
    assert abs(res.edns_mw - ref["edns_mw"]) <= 4 * se_e
    assert abs(res.plc - ref["plc"]) <= 4 * se_p
    assert res.comp_importance[14] == 0.0        # the pinned condenser
