"""PyTorch port: the NSQ study's rare-event samplers against the reference.

* Antithetic, importance-sampled (scopes all / gens / branches, the CE
  ``q_override`` with its clamps, pinned and zero-U components) and
  defensive-mixture states and weights, built by the port from the
  reference's own draws (its ``jax.random.uniform`` / ``categorical``
  with the same key): states equal, weights within rel 1e-5, and against
  a float64 numpy likelihood ratio.
* The mixture's inverse-CDF component index, the port's own draws.
* Weighted ``batch_moments`` with and without the control variate.
* ``default_max_lp``, ``default_woodbury_k``, ``gen_area_masks`` and
  ``sparsify_ce_proposal`` against the reference's over RTS-24, RTS-96
  and case300s; ``calibrate_ce_proposal``'s bounds and its give-up.
* Studies on the CPU: the reference's boosted-scope and mixture
  agreement tests (tests/test_parallel.py) run through the port, every
  excluded combination raising, and a CE study resumed from its
  checkpoint equal to the uninterrupted one.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.parallel import (
    accumulators as ref_acc)
from powersystemsreliabilityassessment_tpu.sampling import (
    state as ref_state)
from powersystemsreliabilityassessment_tpu.studies import hl2_nsq as ref_nsq

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system, from_reference)
from powersystemsreliabilityassessment_tpu_torch.parallel import accumulators
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.sampling import state
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

# Weights: relative, i.e. absolute on log w. Both packages sum the
# log-ratio terms in float32 in their own order, which leaves ~sqrt(n)
# eps32 of the terms' absolute sum S: under 1e-5 at RTS-24 (n = 71,
# S ~ 3), up to ~7e-5 at case300s with every component boosted (n =
# 1,111, S ~ 34). The bound is the larger of W_RTOL and 4 sqrt(n) eps32 S
# per lane.
W_RTOL = 1e-5
EPS32 = 2.0 ** -24


def _assert_weights_close(w, want, term_abs_sum):
    n = term_abs_sum.shape[-1] if term_abs_sum.ndim > 1 else 1
    s = term_abs_sum.max(axis=-1) if term_abs_sum.ndim > 1 else term_abs_sum
    tol = np.maximum(W_RTOL, 4 * math.sqrt(n) * EPS32 * s)
    err = np.abs(np.log(np.asarray(w, np.float64))
                 - np.log(np.asarray(want, np.float64)))
    assert np.all(err <= tol), (err.max(), tol[np.argmax(err - tol)])


@pytest.fixture(scope="module")
def rts24():
    ref_sys = ref_build_system(ref_cases.rts24())
    return ref_sys, from_reference(ref_sys, device="cpu")


@pytest.fixture(scope="module")
def systems(rts24):
    out = {"rts24": rts24}
    for name in ("rts96", "case300s"):
        ref_sys = ref_build_system(getattr(ref_cases, name)())
        out[name] = (ref_sys, from_reference(ref_sys, device="cpu"))
    return out


def _t(a):
    return torch.as_tensor(np.array(a))


def _stressed_rates(ref_sys):
    """The system's rates with generator 3 at U = 0 (a zero-U component
    beside the pinned synchronous condenser)."""
    u = np.asarray(ref_sys.unavail, np.float32).copy()
    u[3] = 0.0
    return u, np.asarray(ref_sys.always_up_nsq)


def _log_terms(down, p, q, never):
    """float64 [B, n] terms of the log likelihood ratio log p(x) / q(x),
    0 on never-failing components."""
    p, q = p.astype(np.float64), q.astype(np.float64)
    x = down.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = x * np.log(p / q) + (1 - x) * np.log((1 - p) / (1 - q))
    return np.where(never[None, :], 0.0, t)


@pytest.mark.parametrize("batch", [64, 63])
def test_antithetic_states_equal_reference_on_its_uniforms(rts24, batch):
    ref_sys, sys_ = rts24
    key = jax.random.key(11)
    n = ref_sys.n_comp
    want = np.asarray(ref_state.sample_states(
        key, ref_sys.unavail, ref_sys.always_up_nsq, batch,
        antithetic=True))
    u = np.asarray(jax.random.uniform(key, ((batch + 1) // 2, n)))
    got = state.states_from_uniforms(
        state.antithetic_pairs(_t(u), batch), sys_.unavail,
        sys_.always_up_nsq)
    assert got.shape == (batch, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_antithetic_sampler_pairs_its_own_draws(rts24):
    _, sys_ = rts24
    batch, n = 4097, sys_.n_comp
    gen = hl2_nsq.batch_generator(2, 0, "cpu")
    u = torch.rand(((batch + 1) // 2, n), generator=gen)
    got = state.sample_states(hl2_nsq.batch_generator(2, 0, "cpu"),
                              sys_.unavail, sys_.always_up_nsq, batch,
                              antithetic=True)
    want = state.states_from_uniforms(state.antithetic_pairs(u, batch),
                                      sys_.unavail, sys_.always_up_nsq)
    assert torch.equal(got, want)
    # A lane and its pair fail together only where U > 1/2 (never here).
    half = batch // 2
    assert not bool((got[:half] & got[half + 1:2 * half + 1]).any())


def test_hw_sampler_with_antithetic_raises(rts24):
    _, sys_ = rts24
    with pytest.raises(ValueError, match="antithetic"):
        state.sample_states(hl2_nsq.batch_generator(0, 0, "cpu"),
                            sys_.unavail, sys_.always_up_nsq, 8,
                            rng_impl="hw", antithetic=True)


def _override(ref_sys, rng):
    """A sparse CE-like override on 40 components that crosses both
    clamps: below U on some, above 0.5 on five."""
    u = np.asarray(ref_sys.unavail, np.float32)
    q = u.copy()
    idx = rng.choice(u.size, 40, replace=False)
    q[idx] *= rng.uniform(0.2, 30.0, 40).astype(np.float32)
    q[idx[:5]] = 0.9
    return q


@pytest.mark.parametrize("case", ["rts24", "case300s"])
@pytest.mark.parametrize("mode", ["all", "gens", "branches", "override"])
def test_importance_equals_reference_on_its_uniforms(systems, case, mode):
    ref_sys, sys_ = systems[case]
    ng, n = ref_sys.n_gen, ref_sys.n_comp
    rates, always = _stressed_rates(ref_sys)
    key = jax.random.key(5)
    batch, boost = 512, 3.0
    mask = {"gens": np.arange(n) < ng,
            "branches": np.arange(n) >= ng}.get(mode)
    q_over = (_override(ref_sys, np.random.default_rng(1))
              if mode == "override" else None)
    want_down, want_w = ref_state.sample_states_importance(
        key, jnp.asarray(rates), jnp.asarray(always), batch, boost,
        boost_mask=None if mask is None else jnp.asarray(mask),
        q_override=None if q_over is None else jnp.asarray(q_over))
    u = np.asarray(jax.random.uniform(key, (batch, n)))
    q = state.importance_proposal(
        _t(rates), _t(always), boost,
        None if mask is None else _t(mask),
        None if q_over is None else _t(q_over))
    down, w = state.importance_from_uniforms(_t(u), _t(rates), _t(always), q)
    np.testing.assert_array_equal(down.numpy(), np.asarray(want_down))
    qn = q.numpy()
    never = always | (rates <= 0)
    terms = _log_terms(down.numpy(), rates, qn, never)
    size = np.broadcast_to(np.abs(terms).sum(1)[:, None], terms.shape)
    _assert_weights_close(w.numpy(), want_w, size)
    _assert_weights_close(w.numpy(), np.exp(terms.sum(1)), size)
    if q_over is not None:
        # Clamped to [U, max(U, 0.5)], pinned at 0.
        free = ~always
        assert np.all(qn[free] >= rates[free])
        assert np.all(qn[free] <= np.maximum(rates[free], 0.5))
    else:
        boosted = np.ones(n, bool) if mask is None else mask
        np.testing.assert_array_equal(
            qn[~always & ~boosted], rates[~always & ~boosted])
    assert qn[always].max() == 0.0
    assert not down.numpy()[:, always].any()
    if q_over is None:
        # A zero-U component never fails under a boost: min(boost 0, 0.5).
        assert qn[3] == 0.0 and not down.numpy()[:, 3].any()
    assert np.all(np.isfinite(w.numpy()))


def test_importance_sampler_is_its_construction_on_its_own_draws(rts24):
    _, sys_ = rts24
    batch = 1000
    gen = hl2_nsq.batch_generator(4, 1, "cpu")
    u = torch.rand((batch, sys_.n_comp), generator=gen)
    want = state.importance_from_uniforms(
        u, sys_.unavail, sys_.always_up_nsq,
        state.importance_proposal(sys_.unavail, sys_.always_up_nsq, 2.0))
    got = state.sample_states_importance(
        hl2_nsq.batch_generator(4, 1, "cpu"), sys_.unavail,
        sys_.always_up_nsq, batch, 2.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case,boost", [("rts96", 2.0), ("case300s", 3.0)])
def test_mixture_equals_reference_on_its_draws(systems, case, boost):
    ref_sys, sys_ = systems[case]
    masks = ref_nsq.gen_area_masks(getattr(ref_cases, case)())
    K = masks.shape[0]
    rates, always = _stressed_rates(ref_sys)
    key, alpha0, batch = jax.random.key(9), 0.5, 2048
    want_down, want_w = ref_state.sample_states_mixture(
        key, jnp.asarray(rates), jnp.asarray(always), batch,
        jnp.asarray(masks), boost, alpha0)
    km, ku = jax.random.split(key)
    probs = jnp.concatenate([jnp.asarray([alpha0], jnp.float32),
                             jnp.full((K,), (1 - alpha0) / K, jnp.float32)])
    comp = np.asarray(jax.random.categorical(km, jnp.log(probs),
                                             shape=(batch,)))
    u = np.asarray(jax.random.uniform(ku, (batch, ref_sys.n_comp)))
    down, w = state.mixture_from_draws(_t(comp).long(), _t(u), _t(rates),
                                       _t(always), _t(masks), boost, alpha0)
    np.testing.assert_array_equal(down.numpy(), np.asarray(want_down))
    wn = w.numpy()
    assert np.all(np.isfinite(wn)) and wn.max() <= 1 / alpha0 * (1 + 1e-6)
    # The float64 mixture ratio p / (alpha0 p + sum_k alpha_g q_k), from
    # each group's log q_k / p.
    never = always | (rates <= 0)
    qb = np.maximum(np.minimum(boost * rates, 0.5), rates)
    terms = np.stack([-_log_terms(down.numpy(), rates,
                                  np.where(m, qb, rates), never)
                      for m in masks], axis=1)                # [B, K, n]
    w64 = 1.0 / (alpha0 + (1 - alpha0) / K * np.exp(terms.sum(2)).sum(1))
    size = np.abs(terms).sum(2)                               # [B, K]
    size = np.broadcast_to(size.max(1)[:, None], (batch, ref_sys.n_comp))
    _assert_weights_close(wn, want_w, size)
    _assert_weights_close(wn, w64, size)


def test_mixture_component_is_the_inverse_cdf():
    K, alpha0 = 4, 0.5
    u = torch.tensor([0.0, 0.4999, 0.5, 0.6249, 0.625, 0.99999, 1 - 2 ** -24])
    got = state.mixture_component(u, K, alpha0).tolist()
    assert got == [0, 0, 1, 1, 2, 4, 4]
    B = 1 << 18
    gen = torch.Generator().manual_seed(3)
    comp = state.mixture_component(torch.rand(B, generator=gen), K, alpha0)
    freq = np.bincount(comp.numpy(), minlength=K + 1) / B
    p = np.array([alpha0] + [(1 - alpha0) / K] * K)
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / B))


def test_mixture_sampler_is_its_construction_on_its_own_draws(systems):
    _, sys_ = systems["rts96"]
    masks = torch.as_tensor(
        hl2_nsq.gen_area_masks(cases.rts96()))
    batch = 999
    gen = hl2_nsq.batch_generator(6, 2, "cpu")
    comp = state.mixture_component(torch.rand(batch, generator=gen),
                                   masks.shape[0], 0.5)
    u = torch.rand((batch, sys_.n_comp), generator=gen)
    want = state.mixture_from_draws(comp, u, sys_.unavail,
                                    sys_.always_up_nsq, masks, 2.0, 0.5)
    got = state.sample_states_mixture(hl2_nsq.batch_generator(6, 2, "cpu"),
                                      sys_.unavail, sys_.always_up_nsq,
                                      batch, masks, 2.0, 0.5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[1].max()) <= 2.0 * (1 + 1e-6)


@pytest.mark.parametrize("with_cv", [False, True])
def test_weighted_batch_moments_match_reference(with_cv):
    rng = np.random.default_rng(12)
    B = 512
    dns = np.where(rng.uniform(size=B) < 0.2,
                   rng.uniform(0, 300, B), 0.0).astype(np.float32)
    nodal = (rng.uniform(size=(B, 24)) * dns[:, None] / 24).astype(
        np.float32)
    fail = dns > 1e-4
    down = rng.uniform(size=(B, 71)) < 0.05
    w = rng.lognormal(0.0, 1.0, B).astype(np.float32)
    cv = None
    if with_cv:
        c = np.maximum(dns - rng.uniform(0, 5, B), 0).astype(np.float32)
        cv = (c, c > 1e-4)
    want = ref_acc.batch_moments(
        jnp.asarray(dns), jnp.asarray(nodal), jnp.asarray(fail),
        jnp.asarray(down), jnp.asarray(w),
        None if cv is None else tuple(map(jnp.asarray, cv)))
    got = accumulators.batch_moments(
        _t(dns), _t(nodal), _t(fail), _t(down), _t(w),
        None if cv is None else tuple(map(_t, cv)))
    for name, a, b in zip(accumulators.BatchMoments._fields, got, want):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-5,
                                   atol=1e-3, err_msg=name)
    assert float(got.n) == B
    # sum_flag_raw is the weighted flag sum, residual or not.
    assert float(got.sum_flag_raw) == pytest.approx(float((w * fail).sum()),
                                                    rel=1e-5)


@pytest.mark.parametrize("pf_tier", [False, True])
@pytest.mark.parametrize("mode", ["lp", "proportional"])
def test_default_max_lp_matches_reference_with_boosts(pf_tier, mode):
    for bpd in (512, 8192, 16384, 65536):
        for boost in (0.0, 1.0, 2.0, 3.0):
            for scope in ("all", "gens", "branches"):
                got = hl2_nsq.default_max_lp(bpd, mode, boost, scope,
                                             pf_tier=pf_tier)
                assert got == ref_nsq.default_max_lp(
                    bpd, mode, boost, scope, pf_tier=pf_tier), \
                    (bpd, boost, scope)


@pytest.mark.parametrize("case", ["rts24", "rts96", "case300s"])
def test_woodbury_k_and_area_masks_match_reference(systems, case):
    ref_sys, sys_ = systems[case]
    for boost in (0.0, 1.0, 2.0, 4.0, 42.0):
        for scope in ("all", "gens", "branches"):
            assert hl2_nsq.default_woodbury_k(sys_, boost, scope) == \
                ref_nsq.default_woodbury_k(ref_sys, boost, scope), \
                (boost, scope)
    q = _override(ref_sys, np.random.default_rng(2))
    assert hl2_nsq.default_woodbury_k(sys_, q_vec=q) == \
        ref_nsq.default_woodbury_k(ref_sys, q_vec=q)
    want = ref_nsq.gen_area_masks(getattr(ref_cases, case)())
    got = hl2_nsq.gen_area_masks(getattr(cases, case)())
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    if case == "rts24":
        assert want is None                   # one area
    if case == "case300s":
        assert want.shape[0] == 12


@pytest.mark.parametrize("case", ["rts24", "case300s"])
@pytest.mark.parametrize("top_k,cap,branches_only",
                         [(8, 0.05, True), (16, 0.02, True),
                          (4, 0.05, False)])
def test_sparsify_ce_proposal_is_bit_equal(systems, case, top_k, cap,
                                           branches_only):
    ref_sys, sys_ = systems[case]
    rng = np.random.default_rng(top_k)
    u = np.asarray(ref_sys.unavail, np.float64)
    q = np.clip(u * rng.uniform(0.5, 40.0, u.shape), u, 0.5).astype(
        np.float32)
    want = ref_nsq.sparsify_ce_proposal(q, ref_sys, top_k, cap,
                                        branches_only)
    got = hl2_nsq.sparsify_ce_proposal(q, sys_, top_k, cap, branches_only)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_sparsify_ce_proposal_keeps_no_zero_ratio_component(rts24):
    # top_k 48 over RTS-24's 38 branches under branches_only: the
    # reference pads its keep set with zero-ratio components, generators
    # among them, and so tilts generators; the port keeps the branches
    # alone and agrees with the reference on them.
    ref_sys, sys_ = rts24
    u = np.asarray(ref_sys.unavail, np.float32)
    ng = ref_sys.n_gen
    q = u.copy()
    q[ng + np.array([2, 9, 30])] *= 20.0
    q[:ng] = np.minimum(4 * u[:ng], 0.5)
    got = hl2_nsq.sparsify_ce_proposal(q, sys_, 48, 0.05)
    want = ref_nsq.sparsify_ce_proposal(q, ref_sys, 48, 0.05)
    assert np.any(want[:ng] > u[:ng])
    assert not np.any(got[:ng] > u[:ng])
    np.testing.assert_array_equal(got[ng:], want[ng:])


def test_calibrate_ce_proposal_bounds_and_give_up(rts24):
    _, sys_ = rts24
    compat, ipm = CompatFlags(), IPMConfig()
    q, diag = hl2_nsq.calibrate_ce_proposal(sys_, compat, ipm, batch=1024,
                                            rounds=2, seed=5, log_every=0)
    assert [r["round"] for r in diag["rounds"]] == [0, 1]
    assert diag["n_pilot"] == 1024 and diag["chunk"] == 1024
    assert all(r["events"] >= 8 for r in diag["rounds"])
    u = sys_.unavail.numpy()
    up = sys_.always_up_nsq.numpy()
    assert q.dtype == np.float32 and q.shape == u.shape
    assert np.all(q[up] == 0.0)
    assert np.all(q[~up] >= u[~up] * (1 - 1e-6)) and np.all(q <= 0.5)
    # A pilot too small to see 8 deficit events gives up after round 0.
    q0, diag0 = hl2_nsq.calibrate_ce_proposal(sys_, compat, ipm, batch=16,
                                              rounds=2, boost0=1.0, seed=5,
                                              log_every=0)
    assert q0 is None and len(diag0["rounds"]) == 1
    assert diag0["rounds"][0]["events"] < 8


@pytest.fixture(scope="module")
def plain_study():
    return hl2_nsq.run_nsq_study(
        cases.rts24(), MCSConfig(batch_size=1024, max_samples=4096, seed=9),
        device="cpu", log_every=0)


@pytest.mark.parametrize("scope,boost,rel", [("gens", 2.5, 0.35),
                                             ("branches", 3.0, 0.5)])
def test_nsq_scoped_boost_agrees_with_plain(plain_study, scope, boost, rel):
    # tests/test_parallel.py::test_nsq_gens_only_boost_agrees_with_plain
    # and ::test_nsq_branches_boost_agrees_with_plain, through the port.
    isb = hl2_nsq.run_nsq_study(
        cases.rts24(),
        MCSConfig(batch_size=1024, max_samples=4096, seed=9,
                  is_boost=boost, is_boost_scope=scope),
        device="cpu", log_every=0)
    assert isb.edns_mw == pytest.approx(plain_study.edns_mw, rel=rel)
    assert np.isfinite(isb.beta) and isb.overflow_states == 0


def test_nsq_mixture_step_agrees_with_plain():
    # tests/test_parallel.py::test_nsq_mixture_step_agrees_with_plain,
    # through the port: RTS-96's 3 areas, weighted EDNS within MC noise.
    case = cases.rts96()
    sys_ = build_system(case, device="cpu")
    masks = hl2_nsq.gen_area_masks(case)
    assert masks is not None and masks.shape[0] == 3
    kw = dict(nodal_mode="proportional")
    outs = {}
    for name, mix in (("plain", None), ("mix", (masks, 2.0, 0.5))):
        step = hl2_nsq.make_nsq_batch_step(sys_, 512, CompatFlags(),
                                           IPMConfig(), mix=mix, **kw)
        tot = n = 0.0
        for i in range(3):
            m, n_over, _ = step(hl2_nsq.batch_generator(5, i, "cpu"))
            assert int(n_over) == 0
            tot += float(m.sum_dns)
            n += float(m.n)
        outs[name] = tot / n
    assert np.isfinite(outs["mix"])
    assert outs["mix"] == pytest.approx(outs["plain"], rel=0.6, abs=2.0)


@pytest.mark.parametrize("kwargs,match", [
    (dict(antithetic=True, is_boost=2.0), "antithetic"),
    (dict(antithetic=True, is_q="q"), "antithetic"),
    (dict(is_q="q", is_boost=2.0), "is_q"),
    (dict(is_q="q", fused_tier1=True), "is_q"),
    (dict(mix="mix", is_boost=2.0), "mix"),
    (dict(mix="mix", is_q="q"), "mix"),
    (dict(mix="mix", antithetic=True), "mix"),
    (dict(mix="mix", fused_tier1=True), "mix"),
    (dict(fused_tier1=True, antithetic=True), "fused_tier1"),
    (dict(fused_tier1=True, is_boost=2.0), "fused_tier1"),
    (dict(is_boost=2.0, is_boost_scope="loads"), "is_boost_scope"),
])
def test_excluded_sampler_combinations_raise(rts24, kwargs, match):
    _, sys_ = rts24
    kwargs = dict(kwargs)
    if kwargs.get("is_q") == "q":
        kwargs["is_q"] = sys_.unavail.numpy()
    if kwargs.get("mix") == "mix":
        kwargs["mix"] = (np.ones((2, sys_.n_comp), bool), 2.0, 0.5)
    with pytest.raises(ValueError, match=match):
        hl2_nsq.make_nsq_batch_step(sys_, 64, CompatFlags(), IPMConfig(),
                                    **kwargs)


def test_ce_study_resumed_equals_uninterrupted(tmp_path, monkeypatch):
    cfg = lambda n: MCSConfig(batch_size=256, max_samples=n, seed=13,
                              is_ce=True, ce_batch=1024, ce_rounds=2)
    full = hl2_nsq.run_nsq_study(cases.rts24(), cfg(1024), device="cpu",
                                 log_every=0)
    ck = Checkpointer(str(tmp_path / "ce.ckpt"))
    hl2_nsq.run_nsq_study(cases.rts24(), cfg(512), device="cpu",
                          log_every=0, checkpointer=ck, checkpoint_every=1)
    saved = ck.restore()
    q = np.asarray(saved["is_q"], np.float32)
    assert saved["batch_idx"] == 2 and q.shape == (71,)
    # The sparse tilt: 1 to ce_top_k (8) components off their true rate.
    sys_ = build_system(cases.rts24(), device="cpu")
    free = ~sys_.always_up_nsq.numpy()
    assert 1 <= int((q != sys_.unavail.numpy())[free].sum()) <= 8
    # The resumed study runs the saved proposal: no second pilot.
    monkeypatch.setattr(hl2_nsq, "calibrate_ce_proposal",
                        lambda *a, **k: pytest.fail("pilot rerun"))
    resumed = hl2_nsq.run_nsq_study(cases.rts24(), cfg(1024), device="cpu",
                                    log_every=0, checkpointer=ck,
                                    checkpoint_every=1)
    assert resumed.samples == full.samples == 1024
    assert resumed.edns_mw == full.edns_mw and resumed.plc == full.plc
    assert resumed.beta == full.beta
    assert resumed.beta_history == full.beta_history
    np.testing.assert_array_equal(resumed.nodal_eens_mwh_yr,
                                  full.nodal_eens_mwh_yr)
    np.testing.assert_array_equal(np.asarray(ck.restore()["is_q"],
                                             np.float32), q)
    assert math.isfinite(full.edns_mw) and full.overflow_states == 0
