"""PyTorch port: tier 1.5, the island-aware power-flow certificate
(``dcopf.certify_island_pf``, ``_island_rebalance``, ``default_pf_buffer``
and the screened evaluator's ``pf_buffer``), and the study policies that
turn it on past m = 336, against the JAX package on the CPU.

* tests/test_island_pf.py's three tests on RTS-24's islanding and deep
  multi-branch states, through both packages: the same certified mask,
  deficit, shed and dispatch within 1e-4 p.u., certified lanes within
  0.05 MW of a float64 HiGHS solve and the bound at most 0.05 MW above
  it; the screened evaluator with ``pf_buffer=64`` within 0.6 MW of the
  one without (the reference test's tolerance).
* ``_island_rebalance`` on random inputs.
* case300s (m = 792): ``certify_states(woodbury_k=4)`` on 512 sampled
  states (half at the real unavailabilities, half at 8x branch
  unavailability), and ``certify_island_pf`` on 32 of their misses, with
  HiGHS judging those 32.
* ``default_pf_buffer``, ``default_max_lp(pf_tier=...)`` and
  ``default_woodbury_k(case300s)`` against the reference's.
* ``run_nsq_study``'s grow-and-redo on a scripted step: the LP buffer
  grows to 2,048 lanes where tier 1.5 is on and to the batch where it is
  not, and the lanes past the cap are counted as overflow.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import dcopf as ref_dcopf
from powersystemsreliabilityassessment_tpu.studies import hl2_nsq as ref_nsq

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.parallel import accumulators
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)
from test_island_pf import _states
from test_lp_dcopf import scipy_dns
from test_torch_gpu import sampled_300

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

PATTERN_TOL = 1e-4     # p.u.: deficit, shed and dispatch against the JAX
ORACLE_TOL_MW = 0.05   # tests/test_island_pf.py's bound against HiGHS
SCREENED_TOL_MW = 0.6  # tests/test_island_pf.py's screened tolerance


@pytest.fixture(scope="module")
def sys24():
    ref_sys = ref_build_system(ref_cases.rts24())
    return ref_sys, from_reference(ref_sys, device="cpu")


@pytest.fixture(scope="module")
def sys300():
    ref_sys = ref_build_system(ref_cases.case300s())
    return ref_sys, from_reference(ref_sys, device="cpu")


def _both_island_pf(systems, states, **kw):
    ref_sys, sys_ = systems
    load = np.tile(np.asarray(ref_sys.load_pd)[None], (len(states), 1))
    ref = ref_dcopf.certify_island_pf(ref_sys, jnp.asarray(states),
                                      jnp.asarray(load), **kw)
    got = dcopf.certify_island_pf(sys_, torch.as_tensor(states),
                                  torch.as_tensor(load), **kw)
    return ref, got, load


def _assert_same_certificate(ref, got):
    np.testing.assert_array_equal(got.certified.numpy(),
                                  np.asarray(ref.certified))
    for name in ("deficit", "shed", "dispatch"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=PATTERN_TOL, err_msg=name)


def _assert_sound(ref_sys, states, cert):
    """Certified lanes at the HiGHS optimum; the bound never above it."""
    deficit_mw = cert.deficit.double().numpy() * float(ref_sys.base_mva)
    certified = cert.certified.numpy()
    load = np.asarray(ref_sys.load_pd)
    for i in range(len(states)):
        oracle = scipy_dns(ref_sys, states[i], load)
        assert deficit_mw[i] <= oracle + ORACLE_TOL_MW, i
        if certified[i]:
            assert deficit_mw[i] == pytest.approx(oracle,
                                                  abs=ORACLE_TOL_MW), i


def test_island_pf_soundness_vs_oracle(sys24):
    states = _states(sys24[0])
    ref, got, _ = _both_island_pf(sys24, states,
                                  theta_cap=IPMConfig().theta_max)
    _assert_same_certificate(ref, got)
    # the state mix exercises the certificate
    assert int(got.certified.sum()) >= len(states) // 2
    assert int((got.deficit > 0).sum()) >= 3
    _assert_sound(sys24[0], states, got)


def test_island_bound_tightens_copper(sys24):
    states = _states(sys24[0], seed=3)
    ref, got, load = _both_island_pf(sys24, states)
    _assert_same_certificate(ref, got)
    _, sys_ = sys24
    copper_mw = dcopf.copper_sheet_bound(sys_, torch.as_tensor(states),
                                         torch.as_tensor(load)).numpy()
    assert np.all(got.deficit.numpy() * sys_.base_mva >= copper_mw - 1e-3)
    # the candidate respects its caps and totals the bound
    shed = got.shed.numpy()
    assert np.all(shed >= -1e-6) and np.all(shed <= load + 1e-5)
    np.testing.assert_allclose(shed.sum(1), got.deficit.numpy(), atol=2e-4)


def test_screened_with_pf_buffer_matches_oracle(sys24):
    ref_sys, sys_ = sys24
    states = _states(ref_sys, seed=5)
    states = np.concatenate([states, np.zeros(((-len(states)) % 8,
                                               states.shape[1]), np.float32)])
    B = len(states)
    load = np.tile(np.asarray(ref_sys.load_pd)[None], (B, 1))
    kw = dict(nodal_mode="proportional", woodbury_k=2)
    down_t, load_t = torch.as_tensor(states), torch.as_tensor(load)
    pf, over_pf = dcopf.evaluate_states_screened(
        sys_, down_t, load_t, 16, pf_buffer=64, **kw)
    plain, over0 = dcopf.evaluate_states_screened(sys_, down_t, load_t, 64,
                                                  **kw)
    ref, ref_over = ref_dcopf.evaluate_states_screened(
        ref_sys, jnp.asarray(states), jnp.asarray(load), max_lp=16,
        pf_buffer=64, **kw)
    assert int(over_pf) == int(ref_over) == int(over0) == 0
    dns_pf = pf.dns_mw.numpy()
    np.testing.assert_allclose(dns_pf, plain.dns_mw.numpy(),
                               atol=SCREENED_TOL_MW)
    np.testing.assert_allclose(dns_pf, np.asarray(ref.dns_mw),
                               atol=SCREENED_TOL_MW)
    # Tier 1.5 took lanes off the LP: fewer lanes carry an LP residual.
    assert (pf.primal_residual > 0).sum() < (plain.primal_residual > 0).sum()
    floor = CompatFlags().dns_noise_floor_mw
    for i in range(0, B, 3):        # a third against float64 HiGHS
        oracle = scipy_dns(ref_sys, states[i], np.asarray(ref_sys.load_pd))
        oracle = 0.0 if oracle < floor else oracle
        assert dns_pf[i] == pytest.approx(oracle, abs=SCREENED_TOL_MW), i


def test_island_rebalance_matches_reference():
    rng = np.random.default_rng(41)
    B, nb, k = 6, 9, 5
    # Block-diagonal islands: {0-3}, {4-6}, {7}, {8}, per lane.
    R = np.zeros((nb, nb), np.float32)
    for grp in ([0, 1, 2, 3], [4, 5, 6], [7], [8]):
        R[np.ix_(grp, grp)] = 1.0
    R = np.broadcast_to(R, (B, nb, nb)).copy()
    onehot = np.zeros((nb, k), np.float32)
    onehot[rng.integers(0, nb, k), np.arange(k)] = 1.0
    caps = rng.uniform(0.5, 2.0, (B, k)).astype(np.float32)
    x = (caps * rng.uniform(0.0, 1.0, (B, k))).astype(np.float32)
    # targets below and above the pattern's island totals, within caps
    target = ((onehot @ (caps * rng.uniform(0.1, 0.9, (B, k))).T).T
              ).astype(np.float32)
    args = (R, x, caps, target, onehot)
    ref = ref_dcopf._island_rebalance(*(jnp.asarray(a) for a in args))
    got = dcopf._island_rebalance(*(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # island totals of the result equal the targets' where an island has
    # an entity
    tot = np.einsum("bij,bj->bi", R, got.numpy() @ onehot.T)
    tgt = np.einsum("bij,bj->bi", R, target)
    has = np.einsum("ij,bj->bi", R[0], np.broadcast_to(
        onehot.sum(1), (B, nb))) > 0
    np.testing.assert_allclose(tot[has], tgt[has], atol=1e-5)


@pytest.fixture(scope="module")
def misses300(sys300):
    """512 case300s states (256 at the real unavailabilities, 256 at 8x
    branch unavailability) through certify_states(woodbury_k=4) in both
    packages, and the first 32 lanes that tier 1 leaves."""
    ref_sys, sys_ = sys300
    case = cases.case300s()
    down = np.concatenate([sampled_300(case, 256, seed=30),
                           sampled_300(case, 256, seed=31, branch_boost=8.0)])
    load = np.tile(np.asarray(ref_sys.load_pd)[None], (len(down), 1))
    ref = ref_dcopf.certify_states(ref_sys, jnp.asarray(down),
                                   jnp.asarray(load), woodbury_k=4)
    got = dcopf.certify_states(sys_, torch.as_tensor(down),
                               torch.as_tensor(load), woodbury_k=4)
    miss = np.nonzero(~got.certified.numpy())[0][:32]
    return down, ref, got, miss


def test_case300_tier1_matches_reference(misses300):
    down, ref, got, miss = misses300
    np.testing.assert_array_equal(got.certified.numpy(),
                                  np.asarray(ref.certified))
    np.testing.assert_allclose(got.deficit.numpy(), np.asarray(ref.deficit),
                               rtol=0, atol=PATTERN_TOL)
    assert len(miss) == 32


def test_case300_island_pf_matches_reference_and_highs(sys300, misses300):
    down, _, _, miss = misses300
    states = down[miss]
    ref, got, _ = _both_island_pf(sys300, states,
                                  theta_cap=IPMConfig().theta_max)
    _assert_same_certificate(ref, got)
    assert int(got.certified.sum()) >= 16       # most misses certify
    _assert_sound(sys300[0], states, got)


@pytest.mark.parametrize("case", ["rts24", "rts96", "case300s"])
def test_default_pf_buffer_matches_reference(case):
    ref_sys = ref_build_system(getattr(ref_cases, case)())
    sys_ = from_reference(ref_sys, device="cpu")
    for batch in (64, 256, 1024, 16384):
        assert dcopf.default_pf_buffer(sys_, batch) == \
            ref_dcopf.default_pf_buffer(ref_sys, batch)
    assert (dcopf.default_pf_buffer(sys_, 16384) is None) == \
        (case != "case300s")


@pytest.mark.parametrize("pf_tier", [False, True])
def test_default_max_lp_with_pf_tier_matches_reference(pf_tier):
    for bpd in (32, 1024, 8192, 16384, 65536, 262144):
        for mode in ("lp", "proportional"):
            assert hl2_nsq.default_max_lp(bpd, mode, pf_tier=pf_tier) == \
                ref_nsq.default_max_lp(bpd, mode, pf_tier=pf_tier), \
                (bpd, mode)
    assert hl2_nsq.default_max_lp(16384, "proportional", pf_tier=True) == 128


def test_default_woodbury_k_is_4_at_case300s(sys300):
    ref_sys, sys_ = sys300
    assert hl2_nsq.default_woodbury_k(sys_) == \
        ref_nsq.default_woodbury_k(ref_sys) == 4


@pytest.mark.parametrize("case,cap", [("case300s", 2048), ("rts24", 16384)])
def test_study_lp_buffer_grows_to_its_cap(monkeypatch, case, cap):
    """A scripted step stands in for the batch step: batch 0 needs 20,000
    LP lanes (more than any buffer holds), batch 1 needs 100. The buffer
    doubles and the batch is redone until the cap (2,048 lanes where tier
    1.5 is on, the batch where it is not); past it, the lanes that did not
    fit are counted as overflow, once."""
    bpd, need = 16384, (20000, 100)
    built = []

    def fake_step_factory(sys_, batch, compat, ipm, max_lp=None, **kw):
        built.append(max_lp)
        seeds = [hl2_nsq.batch_generator(0, i, "cpu").initial_seed()
                 for i in range(len(need))]
        zeros = torch.zeros(batch)

        def step(generator):
            i = seeds.index(generator.initial_seed())
            m = accumulators.batch_moments(
                zeros, torch.zeros(batch, sys_.n_bus), zeros > 0,
                torch.zeros(batch, sys_.n_comp, dtype=torch.bool))
            return (m, torch.tensor(max(need[i] - max_lp, 0)),
                    torch.tensor(0))
        return step

    monkeypatch.setattr(hl2_nsq, "make_nsq_batch_step", fake_step_factory)
    monkeypatch.setattr(hl2_nsq.dcopf, "calibrate_shed_hint",
                        lambda sys_: None)
    res = hl2_nsq.run_nsq_study(
        getattr(cases, case)(),
        MCSConfig(batch_size=bpd, max_samples=2 * bpd, beta_limit=0.0,
                  seed=0, nodal_mode="proportional"),
        device="cpu", log_every=0)
    start = 128 if case == "case300s" else bpd // 64
    grown = [start]
    while grown[-1] * 2 <= cap:
        grown.append(grown[-1] * 2)
    assert grown[-1] == cap
    # The first step, then one per growth; batch 1 runs on the grown step.
    assert built == grown
    assert res.samples == 2 * bpd
    assert res.overflow_states == need[0] - cap
