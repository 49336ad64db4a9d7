"""PyTorch port: the enumeration hybrid (``sampling/enumeration.py`` and
``run_nsq_study(enum_order=...)``) against the JAX package on the CPU.

* The colex unranking equal to the reference's and covering exactly
  ``itertools.combinations``' sets; exact at case300 scale.
* The enumerated mass against an independent Poisson-binomial DP.
* ``enumerate_exact`` at order 2 on RTS-24 (2,486 states) against the
  reference's, each at a chunk of 512: the state count equal, the mass
  within 1e-12 (the same float64 sums), EDNS and the nodal part within
  1e-3 MW (float32 evaluators whose per-state DNS agree within 0.05 MW
  on the LP lanes, weighted by probabilities summing to 0.83), the PLC
  and component parts within 1e-6; order 1 against a direct weighted
  evaluation (tests/test_enumeration.py's brute force).
* The step's tail mask: the plain step's moments minus the enum step's
  equal the low-order states' part recomputed on the host.
* The study end to end (order 2), resume from a checkpoint, and the
  exclusions (control variate, ``fused_tier1``, the mixture, and
  ``fused_tier1`` with ``island_blackout``), raised as ValueError.
"""
import functools
import itertools
from math import comb

import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.sampling import (
    enumeration as ref_enum)
from powersystemsreliabilityassessment_tpu.utils import config as ref_config

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system, from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.sampling import enumeration
from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
    sample_states)
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

torch.set_num_threads(1)

CPU = "cpu"
COMPAT, IPM = CompatFlags(), IPMConfig()
EXACT_MW_TOL = 1e-3


@pytest.fixture(scope="module")
def systems():
    ref_sys = ref_build_system(ref_cases.rts24())
    return ref_sys, from_reference(ref_sys, device=CPU)


@pytest.mark.parametrize("n,j", [(7, 1), (9, 2), (12, 3), (10, 4), (11, 5),
                                 (70, 3)])
def test_unranking_matches_reference_and_itertools(n, j):
    total = enumeration.count_states(n, j) - enumeration.count_states(
        n, j - 1)
    ranks = np.arange(total, dtype=np.int64)
    got = enumeration.unrank_combinations(ranks, j, n)
    np.testing.assert_array_equal(got,
                                  ref_enum.unrank_combinations(ranks, j, n))
    assert got.shape == (total, j)
    assert (np.diff(got, axis=1) > 0).all()
    assert {tuple(r) for r in got.tolist()} == set(
        itertools.combinations(range(n), j))


def test_unranking_large_rank_exact():
    n, j = 888, 5
    total = comb(n, j)
    ranks = np.asarray([0, 1, 12345678901, total - 2, total - 1], np.int64)
    got = enumeration.unrank_combinations(ranks, j, n)
    for r, row in zip(ranks.tolist(), got.tolist()):
        assert sorted(row) == row
        assert sum(comb(c, i + 1) for i, c in enumerate(row)) == r


def _poisson_binomial_cdf(p, k):
    pb = np.zeros(len(p) + 1, np.float64)
    pb[0] = 1.0
    for ui in p:
        pb[1:] = pb[1:] * (1 - ui) + pb[:-1] * ui
        pb[0] *= 1 - ui
    return float(np.sum(pb[:k + 1]))


def test_enumerated_mass_matches_poisson_binomial(systems):
    _, sys_ = systems
    unavail = sys_.unavail.numpy().astype(np.float64)
    free = enumeration.free_components(unavail, sys_.always_up_nsq.numpy())
    assert 14 not in free and len(free) == 70     # the sync condenser
    p = unavail[free]
    logit = np.log(p) - np.log1p(-p)
    log_base = float(np.sum(np.log1p(-p)))
    mass, n = float(np.exp(log_base)), 0
    for j, combos in enumeration._combo_chunks(len(free), 2, chunk=997):
        w = np.exp(enumeration.state_log_weights(combos, logit, log_base))
        np.testing.assert_array_equal(
            w, np.exp(ref_enum.state_log_weights(combos, logit, log_base)))
        mass += float(np.sum(w))
        n += combos.shape[0]
    assert n == 70 + 70 * 69 // 2
    assert mass == pytest.approx(_poisson_binomial_cdf(p, 2), rel=1e-12)


def test_enumerate_exact_order2_matches_reference(systems):
    ref_sys, sys_ = systems
    got = enumeration.enumerate_exact(sys_, COMPAT, IPM, "lp", order=2,
                                      chunk=512)
    want = ref_enum.enumerate_exact(ref_sys, ref_config.CompatFlags(),
                                    ref_config.IPMConfig(), "lp", order=2,
                                    chunk=512)
    assert got.n_states == want.n_states == 1 + 70 + 2415
    assert got.order == 2
    assert got.mass == pytest.approx(want.mass, rel=1e-12)
    assert got.tail_mass == pytest.approx(want.tail_mass, abs=1e-12)
    assert got.edns_mw == pytest.approx(want.edns_mw, abs=EXACT_MW_TOL)
    np.testing.assert_allclose(got.nodal_mw, want.nodal_mw,
                               atol=EXACT_MW_TOL)
    assert got.pfail == pytest.approx(want.pfail, abs=1e-6)
    np.testing.assert_allclose(got.comp_fail, want.comp_fail, atol=1e-6)
    assert got.infeasible == want.infeasible == 0
    assert 2.1 < got.edns_mw < 2.8


def test_enumerate_exact_order1_is_the_weighted_evaluation(systems):
    _, sys_ = systems
    ex = enumeration.enumerate_exact(sys_, COMPAT, IPM, "proportional",
                                     order=1, chunk=32)
    unavail = sys_.unavail.numpy().astype(np.float64)
    free = enumeration.free_components(unavail, sys_.always_up_nsq.numpy())
    n_comp = unavail.shape[0]
    down = np.zeros((1 + len(free), n_comp), bool)
    down[1 + np.arange(len(free)), free] = True
    p = unavail[free]
    w = np.concatenate([[1.0], p / (1 - p)]) * np.exp(
        float(np.sum(np.log1p(-p))))
    load = sys_.load_pd[None, :].expand(down.shape[0], sys_.n_load)
    res, n_over = dcopf.evaluate_states_screened(
        sys_, torch.as_tensor(down), load, 64, COMPAT, IPM, "proportional")
    assert int(n_over) == 0
    dns = res.dns_mw.numpy().astype(np.float64)
    fail = res.failure.numpy().astype(np.float64)
    assert ex.n_states == down.shape[0]
    assert ex.mass == pytest.approx(float(np.sum(w)), rel=1e-12)
    assert ex.edns_mw == pytest.approx(float(w @ dns), rel=1e-6, abs=1e-9)
    assert ex.pfail == pytest.approx(float(w @ fail), rel=1e-6, abs=1e-12)
    np.testing.assert_allclose(ex.nodal_mw, w @ res.nodal_mw.numpy().astype(
        np.float64), rtol=1e-6, atol=1e-9)
    comp_fail = np.zeros(n_comp)
    comp_fail[free] = w[1:] * fail[1:]
    np.testing.assert_allclose(ex.comp_fail, comp_fail, rtol=1e-6,
                               atol=1e-12)


def test_step_tail_mask_is_the_complement(systems):
    _, sys_ = systems
    bpd, k = 64, 2
    kw = dict(max_lp=bpd, nodal_mode="lp")
    plain = hl2_nsq.make_nsq_batch_step(sys_, bpd, COMPAT, IPM, **kw)
    tail = hl2_nsq.make_nsq_batch_step(sys_, bpd, COMPAT, IPM, enum_order=k,
                                       **kw)
    mp, _, _ = plain(hl2_nsq.batch_generator(5, 0, CPU))
    me, _, _ = tail(hl2_nsq.batch_generator(5, 0, CPU))
    down = sample_states(hl2_nsq.batch_generator(5, 0, CPU), sys_.unavail,
                         sys_.always_up_nsq, bpd)
    load = sys_.load_pd[None, :].expand(bpd, sys_.n_load)
    res, _ = dcopf.evaluate_states_screened(sys_, down, load, bpd, COMPAT,
                                            IPM, "lp")
    lo = (down.sum(1) <= k).numpy()
    dns = res.dns_mw.numpy().astype(np.float64)
    assert 0 < lo.sum() < bpd
    assert float(me.n) == float(mp.n) == bpd
    assert float(mp.sum_dns) - float(me.sum_dns) == pytest.approx(
        float(np.sum(dns * lo)), rel=1e-5, abs=1e-4)
    assert float(mp.sum_flag) - float(me.sum_flag) == pytest.approx(
        float(np.sum(res.failure.numpy() * lo)), abs=1e-6)
    assert float(mp.sum_dns_sq) - float(me.sum_dns_sq) == pytest.approx(
        float(np.sum((dns * lo) ** 2)), rel=1e-4, abs=1e-2)
    np.testing.assert_allclose(
        (mp.sum_nodal - me.sum_nodal).numpy(),
        (res.nodal_mw.numpy() * lo[:, None]).sum(0), rtol=1e-5, atol=1e-3)


@pytest.fixture
def small_chunks(monkeypatch):
    """The study's pre-pass at a chunk of 512 (the default 65,536 lanes
    are for the card)."""
    monkeypatch.setattr(hl2_nsq.enumeration, "enumerate_exact",
                        functools.partial(enumeration.enumerate_exact,
                                          chunk=512))


def test_enum_study_end_to_end(small_chunks, capsys):
    cfg = MCSConfig(batch_size=128, max_samples=512, beta_limit=0.0,
                    seed=11)
    res = hl2_nsq.run_nsq_study(cases.rts24(), cfg, device=CPU,
                                log_every=1, enum_order=2, max_lp=32)
    assert "enumeration order 2: 2,486 states" in capsys.readouterr().out
    assert res.enum_order == 2 and res.enum_states == 2486
    assert res.enum_mass == pytest.approx(0.8276, abs=1e-3)
    # tests/test_enumeration.py: the exact order-2 part ~2.45 MW.
    assert res.enum_edns_exact_mw == pytest.approx(2.45, abs=0.35)
    assert res.edns_mw >= res.enum_edns_exact_mw
    assert np.isfinite(res.beta) and res.samples == 512
    assert res.nodal_eens_mwh_yr.sum() > 0
    assert res.comp_importance.max() <= 1.0 + 1e-9
    assert res.to_dict()["enum_states"] == 2486


def test_enum_study_resume_equals_uninterrupted(small_chunks, tmp_path):
    cfg = MCSConfig(batch_size=128, max_samples=768, beta_limit=0.0,
                    seed=13)
    kw = dict(device=CPU, log_every=0, enum_order=2, max_lp=32)
    full = hl2_nsq.run_nsq_study(cases.rts24(), cfg, **kw)
    ck = Checkpointer(str(tmp_path / "enum.ckpt"))
    hl2_nsq.run_nsq_study(
        cases.rts24(), MCSConfig(batch_size=128, max_samples=256,
                                 beta_limit=0.0, seed=13),
        checkpointer=ck, checkpoint_every=1, **kw)
    # The resumed study does not enumerate again: the offsets come from
    # the checkpoint.
    calls = []
    orig = hl2_nsq.enumeration.enumerate_exact

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    hl2_nsq.enumeration.enumerate_exact = counting
    try:
        resumed = hl2_nsq.run_nsq_study(cases.rts24(), cfg, checkpointer=ck,
                                        checkpoint_every=1, **kw)
    finally:
        hl2_nsq.enumeration.enumerate_exact = orig
    assert not calls
    assert resumed.samples == full.samples
    assert resumed.edns_mw == pytest.approx(full.edns_mw, rel=1e-9)
    assert resumed.enum_mass == pytest.approx(full.enum_mass, rel=1e-12)
    assert resumed.enum_states == full.enum_states
    np.testing.assert_allclose(resumed.nodal_eens_mwh_yr,
                               full.nodal_eens_mwh_yr, rtol=1e-9)
    np.testing.assert_allclose(resumed.comp_importance,
                               full.comp_importance, rtol=1e-9)


def test_enum_exclusions_raise(systems):
    _, sys_ = systems
    small = MCSConfig(batch_size=128, max_samples=128)
    with pytest.raises(ValueError, match="control_variate"):
        hl2_nsq.run_nsq_study(cases.rts24(), small, device=CPU, log_every=0,
                              enum_order=2, control_variate=True)
    with pytest.raises(ValueError, match="fused_tier1"):
        hl2_nsq.run_nsq_study(
            cases.rts24(), MCSConfig(batch_size=128, max_samples=128,
                                     fused_tier1=True),
            device=CPU, log_every=0, enum_order=2)
    masks = np.zeros((2, sys_.n_comp), bool)
    masks[0, :10], masks[1, 10:sys_.n_gen] = True, True
    with pytest.raises(ValueError, match="mixture"):
        hl2_nsq.make_nsq_batch_step(sys_, 128, COMPAT, IPM, enum_order=2,
                                    mix=(masks, 2.0, 0.5))
    with pytest.raises(ValueError, match="plain MC"):
        hl2_nsq.make_nsq_batch_step(sys_, 128, COMPAT, IPM, enum_order=2,
                                    fused_tier1=True)
    with pytest.raises(ValueError, match="plain MC"):
        hl2_nsq.make_nsq_batch_step(sys_, 128,
                                    CompatFlags(island_blackout=True), IPM,
                                    fused_tier1=True)
