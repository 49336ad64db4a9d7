"""PyTorch port: the mid-m LP path (72 < m <= 336) on IEEE RTS-96 (m = 191)
against the JAX package on the CPU.

* ``rts96`` and ``replicate_case`` arrays equal to the reference's.
* ``solve_box_lp_batched`` on the same LPs (built by each package from
  the same numpy states) at RTS-96's m = 191 and RTS-24's m = 62:
  objectives within 1e-3 p.u. (0.1 MW, the reference's DNS noise floor).
* ``evaluate_states`` and ``evaluate_states_screened`` on the same states:
  DNS per lane within 0.05 MW (``ORACLE_TOL_MW``,
  scripts/golden_replay.py:53) and equal failure flags, and the trusted
  lanes within 0.05 MW of a float64 scipy HiGHS solve of the same LP.
* A small ``run_nsq_study`` on RTS-96 within 4 combined standard errors of
  results/study_sweep.json["rts96"] (different random streams: the
  estimators are compared, not bits).
* The screened evaluator at m > 336 (rts24 x 6, m = 384) with tier 1.5
  against ``evaluate_states`` on every lane, and the entry points
  default to the card.
"""
import dataclasses
import inspect
import json
import math
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
    dcopf as ref_dcopf, lp_ipm_batched as ref_lp)
from powersystemsreliabilityassessment_tpu.studies import hl2_nsq as ref_nsq
from powersystemsreliabilityassessment_tpu.utils.config import (
    CompatFlags as RefCompat, IPMConfig as RefIPM)

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system, from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched)
from powersystemsreliabilityassessment_tpu_torch.ops import blocked_chol
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE_TOL_MW = 0.05
N_LP = 64


def _case_fields_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def test_rts96_case_matches_reference():
    _case_fields_equal(ref_cases.rts96(), cases.rts96())
    c = cases.rts96()
    assert (c.n_bus, c.n_gen, c.n_branch, c.n_comp) == (72, 99, 119, 218)
    assert c.n_bus + c.n_branch == 191          # LP rows m


@pytest.mark.parametrize("n_areas", [2, 3, 4])
def test_replicate_case_matches_reference(n_areas):
    # n_areas > 2 closes the ties into a ring.
    _case_fields_equal(ref_cases.replicate_case(ref_cases.rts24(), n_areas),
                       cases.replicate_case(cases.rts24(), n_areas))


def test_entry_points_default_to_the_card():
    # Read from the signatures: nothing runs on a card here.
    for fn in (hl2_nsq.run_nsq_study, build_system):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.fixture(scope="module")
def rts96():
    ref_sys = ref_build_system(ref_cases.rts96())
    return ref_sys, from_reference(ref_sys, device="cpu")


def test_default_woodbury_k_rts96_matches_reference(rts96):
    ref_sys, sys_ = rts96
    assert hl2_nsq.default_woodbury_k(sys_) == \
        ref_nsq.default_woodbury_k(ref_sys) == 4


def _stressed_states(ref_sys, n, seed, boost=3.0):
    """``boost`` x unavailability at peak load; the pinned condensers up."""
    rng = np.random.default_rng(seed)
    down = rng.uniform(size=(n, ref_sys.n_comp)) < \
        boost * np.asarray(ref_sys.unavail)[None, :]
    down[:, np.asarray(ref_sys.always_up_nsq)] = False
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (n, 1))
    return down, load.astype(np.float32)


def _both_lps(ref_sys, sys_, down, load):
    """(c, A, b, l, u) of the same states from both packages."""
    ng = ref_sys.n_gen
    up = (1.0 - down).astype(np.float32)
    ref = jax.vmap(lambda g, b_, ld: ref_dcopf.build_state_lp(
        ref_sys, g, b_, ld, RefCompat(), RefIPM().theta_max))(
        jnp.asarray(up[:, :ng]), jnp.asarray(up[:, ng:]), jnp.asarray(load))
    got = dcopf.build_state_lp(
        sys_, torch.as_tensor(up[:, :ng]), torch.as_tensor(up[:, ng:]),
        torch.as_tensor(load), CompatFlags(), IPMConfig().theta_max)
    return ref, got


@pytest.mark.parametrize("case", ["rts96", "rts24"])
def test_solve_box_lp_batched_matches_reference(case, rts96):
    if case == "rts96":
        ref_sys, sys_ = rts96
        n = 32
    else:
        ref_sys = ref_build_system(ref_cases.rts24())
        sys_, n = from_reference(ref_sys, device="cpu"), N_LP
    down, load = _stressed_states(ref_sys, n, seed=61)
    ref_lpd, lp = _both_lps(ref_sys, sys_, down, load)
    for r, g in zip(ref_lpd, lp):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    m = lp[2].shape[1]
    assert m == {"rts96": 191, "rts24": 62}[case]
    ref = ref_lp.solve_box_lp_batched(*ref_lpd, RefIPM())
    got = lp_ipm_batched.solve_box_lp_batched(*lp, IPMConfig())
    # Two float32 IPMs with different factorizations (the reference's
    # CPU route takes jnp.linalg.cholesky, the port the blocked one at
    # m = 191, the plain K2 at m = 62): objectives within 1e-3 p.u. on
    # the lanes both trust (quality <= 5e-3, the evaluator's guard).
    q = lambda s: np.asarray(s.primal_residual) \
        + 2 * lp[0].shape[1] * np.asarray(s.duality_gap)
    trusted = (q(ref) <= 5e-3) & (q(got) <= 5e-3)
    assert trusted.mean() >= 0.85
    np.testing.assert_allclose(got.objective.numpy()[trusted],
                               np.asarray(ref.objective)[trusted],
                               rtol=0, atol=1e-3)
    assert (got.objective.numpy() > 1.0).sum() >= 3    # lanes really shed


def _oracle_dns_mw(lp, lane, base_mva):
    """float64 HiGHS solve of one lane's LP (tests/test_lp_dcopf.py)."""
    c, A, b, l, u = (np.asarray(t[lane], np.float64) for t in lp)
    r = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(l, u)), method="highs")
    assert r.status == 0, r.message
    return r.fun * base_mva


def test_evaluate_states_rts96_matches_reference_and_oracle(rts96):
    ref_sys, sys_ = rts96
    down, load = _stressed_states(ref_sys, N_LP, seed=62)
    ref = ref_dcopf.evaluate_states(ref_sys, jnp.asarray(down),
                                    jnp.asarray(load), woodbury_k=4)
    got = dcopf.evaluate_states(sys_, torch.as_tensor(down),
                                torch.as_tensor(load), woodbury_k=4)
    dns_ref, dns = np.asarray(ref.dns_mw), got.dns_mw.numpy()
    assert np.abs(dns - dns_ref).max() <= ORACLE_TOL_MW
    np.testing.assert_array_equal(got.failure.numpy(),
                                  np.asarray(ref.failure))
    assert (dns > 0).sum() >= 16
    # Every lane the reference trusts, the port trusts too. The port also
    # trusts the lanes that its rescue on the blocked route cleared, which
    # the reference degrades to the copper bound (ROADMAP.md Queue 3,
    # fault G); every lane the port trusts matches the float64 oracle.
    res, res_ref = got.primal_residual.numpy(), np.asarray(ref.primal_residual)
    assert not ((res_ref <= 5e-3) & ~(res <= 5e-3)).any()
    _, lp = _both_lps(ref_sys, sys_, down, load)
    checked = 0
    for lane in np.flatnonzero(res <= 5e-3):
        oracle = _oracle_dns_mw(lp, lane, sys_.base_mva)
        oracle = 0.0 if oracle < 0.1 else oracle    # the DNS noise floor
        assert abs(dns[lane] - oracle) <= ORACLE_TOL_MW, lane
        checked += 1
    assert checked >= 0.85 * N_LP


def test_screened_rts96_matches_reference(rts96):
    ref_sys, sys_ = rts96
    # 48 stressed lanes (most need the LP) and 80 plain Monte Carlo ones.
    stressed, load_s = _stressed_states(ref_sys, 48, seed=63)
    plain, load_p = _stressed_states(ref_sys, 80, seed=64, boost=1.0)
    down = np.concatenate([stressed, plain])
    load = np.concatenate([load_s, load_p])
    ref, ref_over = ref_dcopf.evaluate_states_screened(
        ref_sys, jnp.asarray(down), jnp.asarray(load), N_LP, woodbury_k=4)
    got, over = dcopf.evaluate_states_screened(
        sys_, torch.as_tensor(down), torch.as_tensor(load), N_LP,
        woodbury_k=4)
    assert int(over) == int(ref_over) == 0
    dns_ref, dns = np.asarray(ref.dns_mw), got.dns_mw.numpy()
    assert np.abs(dns - dns_ref).max() <= ORACLE_TOL_MW
    np.testing.assert_array_equal(got.failure.numpy(),
                                  np.asarray(ref.failure))
    assert (got.primal_residual.numpy() > 0).sum() >= 32   # LP lanes


def test_large_m_is_not_ported(rts96):
    # The name predates tier 1.5; the large-m screened path is ported
    # now. rts24 x 6: m = 144 buses + 240 branches = 384 > 336, where
    # default_pf_buffer turns tier 1.5 on. The screened evaluator with
    # it matches evaluate_states (the LP on every lane) on every lane,
    # and tier 1.5 certifies lanes tier 1 leaves.
    sys_ = build_system(cases.replicate_case(cases.rts24(), 6), device="cpu")
    assert sys_.n_bus + sys_.n_branch == 384
    ng, nl = sys_.n_gen, sys_.n_branch
    inc = sys_.incidence.numpy()
    fr, to = np.argmax(inc > 0, axis=1), np.argmax(inc < 0, axis=1)

    def cut(buses):         # the branches leaving a set of buses
        inside = np.isin(np.arange(sys_.n_bus), buses)
        return np.nonzero(inside[fr] != inside[to])[0]

    rng = np.random.default_rng(384)
    down = np.zeros((8, sys_.n_comp), bool)
    down[1, ng + cut([6, 7])] = True                 # a two-bus island
    down[2, ng + cut([6, 7])] = True                 # ... short of units
    down[2, np.nonzero(sys_.gen_bus_onehot.numpy()[6])[0][:2]] = True
    down[3, ng + cut(np.arange(48, 58))] = True      # area 2's south
    down[4, ng + rng.choice(nl, 6, replace=False)] = True
    down[5, rng.choice(ng, 8, replace=False)] = True
    down[5, ng + rng.choice(nl, 3, replace=False)] = True
    down[6:, :] = rng.uniform(size=(2, sys_.n_comp)) < 0.05
    down[:, :ng] &= sys_.gen_pmax.numpy() > 0        # condensers stay up
    d = torch.as_tensor(down)
    load = sys_.load_pd[None, :].expand(8, sys_.n_load)
    pf_buffer = dcopf.default_pf_buffer(sys_, 8)
    assert pf_buffer == 8
    tier1 = dcopf.certify_states(sys_, d, load, woodbury_k=4).certified
    tier15 = dcopf.certify_island_pf(sys_, d, load).certified
    assert int((~tier1 & tier15).sum()) >= 3
    full = dcopf.evaluate_states(sys_, d, load, woodbury_k=4)
    got, over = dcopf.evaluate_states_screened(
        sys_, d, load, 8, nodal_mode="proportional", woodbury_k=4,
        pf_buffer=pf_buffer)
    assert int(over) == 0
    np.testing.assert_allclose(got.dns_mw.numpy(), full.dns_mw.numpy(),
                               rtol=0, atol=ORACLE_TOL_MW)
    np.testing.assert_array_equal(got.failure.numpy(), full.failure.numpy())
    assert (full.dns_mw > 1.0).sum() >= 2            # two islands shed


def test_small_rts96_study_matches_committed_results():
    ref = json.loads((ROOT / "results" / "study_sweep.json")
                     .read_text())["rts96"]
    before = dict(blocked_chol.rescues)
    res = hl2_nsq.run_nsq_study(
        cases.rts96(), MCSConfig(batch_size=2048, max_samples=8192,
                                 beta_limit=0.0),
        device="cpu", log_every=0, max_lp=64)
    assert res.samples == 8192 and res.overflow_states == 0
    # The reference ran antithetic pairs (same expectation): EDNS standard
    # error beta * EDNS, PLC = LOLE / 8760 binomial, on both sides.
    se_e = math.hypot(ref["beta"] * ref["edns_mw"], res.beta * res.edns_mw)
    plc_ref = ref["lole_hr_yr"] / 8760
    se_p = math.hypot(math.sqrt(plc_ref * (1 - plc_ref) / ref["samples"]),
                      math.sqrt(res.plc * (1 - res.plc) / res.samples))
    assert abs(res.edns_mw - ref["edns_mw"]) <= 4 * se_e
    assert abs(res.plc - plc_ref) <= 4 * se_p
    assert res.nodal_eens_mwh_yr.shape == (72,)
    assert res.comp_importance.shape == (218,)
    # The LP tier went through the blocked Cholesky.
    assert blocked_chol.rescues["lanes_factored"] > \
        before["lanes_factored"]
