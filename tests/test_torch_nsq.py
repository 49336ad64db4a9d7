"""PyTorch port: the HL2 NSQ slice as a whole on the CPU.

* ``evaluate_states_screened`` from both packages on the same 4096 numpy
  states (proportional nodal mode, max_lp 256, the reference's shed
  hint): DNS per lane within 0.05 MW (``ORACLE_TOL_MW``,
  scripts/golden_replay.py:53) and equal failure flags and moments.
* The 98-state golden replay (states rebuilt from numpy seed 2024 as
  scripts/golden_replay.py builds them) against
  tests/golden/golden_replay.json, within 0.05 MW.
* A small ``run_nsq_study`` whose EDNS and PLC fall within 4 combined
  standard errors of results/nsq_results.json (the two runs draw
  different random streams, so their estimators are compared, not bits).
* The accumulators, the host loop and the study policies against the
  reference.
"""
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import dcopf as ref_dcopf
from powersystemsreliabilityassessment_tpu.parallel import (
    accumulators as ref_acc)
from powersystemsreliabilityassessment_tpu.runtime import (
    host_loop as ref_host_loop)
from powersystemsreliabilityassessment_tpu.studies import hl2_nsq as ref_nsq

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system, from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.parallel import accumulators
from powersystemsreliabilityassessment_tpu_torch.runtime import host_loop
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, MCSConfig)
from test_torch_gpu import check_golden_replay   # JAX-free, shared with the card

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE_TOL_MW = 0.05


@pytest.fixture(scope="module")
def screened():
    ref_sys = ref_build_system(ref_cases.rts24())
    sys_ = from_reference(ref_sys, device="cpu")
    rng = np.random.default_rng(23)
    B = 4096
    # 3x unavailability, and three branch outages on every 32nd lane
    # (beyond the rank-2 certificate): ~130 lanes reach the LP buffer.
    ng, nl = ref_sys.n_gen, ref_sys.n_branch
    down = rng.uniform(size=(B, ref_sys.n_comp)) < \
        3 * np.asarray(ref_sys.unavail)[None, :]
    down[:, 14] = False
    for lane in range(0, B, 32):
        down[lane, ng + rng.choice(nl, 3, replace=False)] = True
    load = np.tile(np.asarray(ref_sys.load_pd)[None, :], (B, 1))
    hint = ref_dcopf.calibrate_shed_hint(ref_sys, batch=4096)
    rbuf = ref_dcopf.default_repair_buffer(B, hinted=True)
    ref, ref_over = ref_dcopf.evaluate_states_screened(
        ref_sys, jnp.asarray(down), jnp.asarray(load), 256,
        nodal_mode="proportional", repair_buffer=rbuf,
        shed_hint=jnp.asarray(hint))
    got, over = dcopf.evaluate_states_screened(
        sys_, torch.as_tensor(down), torch.as_tensor(load), 256,
        nodal_mode="proportional", repair_buffer=rbuf, shed_hint=hint)
    return down, ref, int(ref_over), got, int(over)


def _guard_judged(screened):
    """[B] bool: the lanes where the two packages' DNS part by more than
    ORACLE_TOL_MW. On each, the reference's LP lane fails the evaluator's
    5e-3 quality guard, so it keeps the certificate's lower bound
    (ROADMAP.md Queue 3 A: its float32 IPM stalls there), while the
    port's warm rescue (``lp_ipm_structured._warm_rescue``) brings its
    lane past the guard and within ORACLE_TOL_MW of the float64 HiGHS
    optimum; the reference's bound lies at or below that optimum."""
    from scipy.optimize import linprog
    down, ref, _, got, _ = screened
    dns_ref, dns = np.asarray(ref.dns_mw), got.dns_mw.numpy()
    apart = np.abs(dns - dns_ref) > ORACLE_TOL_MW
    sys_ = from_reference(ref_build_system(ref_cases.rts24()), device="cpu")
    up = 1.0 - torch.as_tensor(down[apart]).float()
    lp = dcopf.build_state_lp(sys_, up[:, :33], up[:, 33:].contiguous(),
                              sys_.load_pd[None].expand(len(up), -1),
                              CompatFlags(), 6.0)
    for j, i in enumerate(np.flatnonzero(apart)):
        c, A, b, lo, hi = (t[j].double().numpy() for t in lp)
        r = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(lo, hi)),
                    method="highs")
        assert r.status == 0, r.message
        oracle = r.fun * sys_.base_mva
        assert float(ref.primal_residual[i]) > 5e-3, i
        assert float(got.primal_residual[i]) <= 5e-3, i
        assert abs(dns[i] - oracle) <= ORACLE_TOL_MW, (i, dns[i], oracle)
        assert dns_ref[i] <= oracle + ORACLE_TOL_MW, (i, dns_ref[i], oracle)
    return apart


def test_screened_dns_matches_reference(screened):
    _, ref, ref_over, got, over = screened
    dns_ref, dns = np.asarray(ref.dns_mw), got.dns_mw.numpy()
    assert over == ref_over == 0
    apart = _guard_judged(screened)
    assert np.abs(dns - dns_ref)[~apart].max() <= ORACLE_TOL_MW
    assert (dns_ref > 0).sum() > 500
    # Some lanes really went through the LP tier.
    assert (got.primal_residual.numpy() > 0).sum() >= 10
    np.testing.assert_array_equal(got.failure.numpy()[~apart],
                                  np.asarray(ref.failure)[~apart])
    assert not got.infeasible.any()


def test_screened_moments_match_reference(screened):
    down, ref, _, got, _ = screened
    m_ref = ref_acc.batch_moments(ref.dns_mw, ref.nodal_mw, ref.failure,
                                  jnp.asarray(down))
    m = accumulators.batch_moments(got.dns_mw, got.nodal_mw, got.failure,
                                   torch.as_tensor(down))
    assert float(m.n) == float(m_ref.n) == 4096
    # The guard-judged lanes are the only ones allowed to move the flags
    # and the sums, each by its own difference.
    apart = _guard_judged(screened)
    flag_diff = (got.failure.numpy().astype(np.float64)
                 - np.asarray(ref.failure, np.float64))
    assert not flag_diff[~apart].any()
    assert float(m.sum_flag) - float(m_ref.sum_flag) == flag_diff.sum()
    np.testing.assert_array_equal(
        m.sum_comp_fail.numpy() - np.asarray(m_ref.sum_comp_fail),
        flag_diff @ down.astype(np.float64))
    moved = float(np.abs(got.dns_mw.numpy() - np.asarray(ref.dns_mw))
                  [apart].sum())
    # Every other lane within 0.05 MW bounds the sums' difference.
    n_lp = int((got.primal_residual > 0).sum())
    assert abs(float(m.sum_dns) - float(m_ref.sum_dns)) <= \
        ORACLE_TOL_MW * max(n_lp, 1) + moved
    # Nodal splits of certified lanes are the same pattern; LP lanes'
    # splits may move along a degenerate optimal face, but each lane's
    # total stays within 0.05 MW.
    assert abs(float(m.sum_nodal.sum()) - float(m_ref.sum_nodal.sum())) \
        <= ORACLE_TOL_MW * max(n_lp, 1) + moved


def test_golden_replay():
    check_golden_replay(torch.device("cpu"))


def test_small_study_matches_committed_results():
    ref = json.loads((ROOT / "results" / "nsq_results.json").read_text())
    res = hl2_nsq.run_nsq_study(
        cases.rts24(), MCSConfig(batch_size=4096, max_samples=16384),
        device="cpu", log_every=0)
    assert res.samples == 16384 and res.overflow_states == 0
    assert len(res.beta_history) == 4
    se_e = math.hypot(ref["beta"] * ref["edns_mw"], res.beta * res.edns_mw)
    se_p = math.hypot(
        math.sqrt(ref["plc"] * (1 - ref["plc"]) / ref["samples"]),
        math.sqrt(res.plc * (1 - res.plc) / res.samples))
    assert abs(res.edns_mw - ref["edns_mw"]) <= 4 * se_e
    assert abs(res.plc - ref["plc"]) <= 4 * se_p
    assert res.lole_hr_yr == pytest.approx(res.plc * 8760)
    assert res.nodal_eens_mwh_yr.shape == (24,)
    assert res.comp_importance.shape == (71,)
    assert res.comp_importance[14] == 0.0        # the pinned condenser
    assert json.dumps(res.to_dict())


def test_study_lp_buffer_redo_is_exact(capsys):
    # An LP buffer far too small overflows, grows and redoes the batch
    # with the same generator: the estimates equal a run that never
    # overflowed.
    cfg = MCSConfig(batch_size=1024, max_samples=2048, seed=4)
    small = hl2_nsq.run_nsq_study(cases.rts24(), cfg, device="cpu",
                                  log_every=0, max_lp=16)
    assert "growing max_lp" in capsys.readouterr().out
    full = hl2_nsq.run_nsq_study(cases.rts24(), cfg, device="cpu",
                                 log_every=0)
    assert small.samples == full.samples == 2048
    assert small.edns_mw == full.edns_mw and small.plc == full.plc
    assert small.overflow_states == full.overflow_states == 0


@pytest.mark.parametrize("bpd,mode", [(8192, "lp"), (8192, "proportional"),
                                      (262144, "proportional"), (32, "lp")])
def test_default_max_lp_matches_reference(bpd, mode):
    assert hl2_nsq.default_max_lp(bpd, mode) == \
        ref_nsq.default_max_lp(bpd, mode)


def test_default_woodbury_k_matches_reference():
    ref_sys = ref_build_system(ref_cases.rts24())
    sys_ = from_reference(ref_sys, device="cpu")
    assert hl2_nsq.default_woodbury_k(sys_) == \
        ref_nsq.default_woodbury_k(ref_sys) == 2


def test_run_nsq_study_defaults_match_reference():
    # Every argument both studies take has the reference's default (the
    # mesh None: a study on one device); every argument of the reference
    # is the port's too, and the port adds ``device``.
    import dataclasses
    import inspect
    ref = inspect.signature(ref_nsq.run_nsq_study).parameters
    got = inspect.signature(hl2_nsq.run_nsq_study).parameters
    shared = (set(ref) & set(got)) - {"case"}
    assert shared >= {"cfg", "compat", "ipm", "checkpointer",
                      "checkpoint_every", "log_every", "max_lp",
                      "control_variate", "enum_order", "mesh"}
    assert set(ref) - set(got) == set()
    assert set(got) - set(ref) == {"device"}
    for name in shared:
        a, b = got[name].default, ref[name].default
        if dataclasses.is_dataclass(a):
            # The port's config classes carry the reference's fields
            # that its ported code reads, with the reference's values.
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            b = {k: b[k] for k in a}
        assert a == b, name
    assert got["checkpoint_every"].default == 50


@pytest.mark.parametrize("with_cv", [False, True])
def test_batch_moments_and_running_stats_match_reference(with_cv):
    rng = np.random.default_rng(8)
    B = 512
    dns = np.where(rng.uniform(size=B) < 0.1,
                   rng.uniform(0, 300, B), 0.0).astype(np.float32)
    nodal = (rng.uniform(size=(B, 24)) * dns[:, None] / 24).astype(
        np.float32)
    fail = dns > 1e-4
    down = rng.uniform(size=(B, 71)) < 0.05
    cv_np = None
    if with_cv:
        c = np.maximum(dns - rng.uniform(0, 5, B), 0).astype(np.float32)
        cv_np = (c, c > 1e-4)
    m_ref = ref_acc.batch_moments(
        jnp.asarray(dns), jnp.asarray(nodal), jnp.asarray(fail),
        jnp.asarray(down),
        cv=None if cv_np is None else tuple(map(jnp.asarray, cv_np)))
    m = accumulators.batch_moments(
        torch.as_tensor(dns), torch.as_tensor(nodal), torch.as_tensor(fail),
        torch.as_tensor(down),
        cv=None if cv_np is None else tuple(map(torch.as_tensor, cv_np)))
    for a, b in zip(m, m_ref):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-5)
    s, s_ref = accumulators.RunningStats(), ref_acc.RunningStats()
    if with_cv:   # the control-variate offsets carry the exact means
        s.mu_dns = s_ref.mu_dns = 3.5
        s.mu_flag = s_ref.mu_flag = 0.02
    for _ in range(3):
        s.update(m)
        s_ref.update(m_ref)
    for attr in ("n", "edns", "plc", "beta"):
        assert getattr(s, attr) == pytest.approx(getattr(s_ref, attr),
                                                 rel=1e-6), attr
    np.testing.assert_allclose(s.nodal_eens(), s_ref.nodal_eens(), rtol=1e-6)
    np.testing.assert_allclose(s.component_importance(),
                               s_ref.component_importance(), rtol=1e-6)


def _drive_loop(loop, overflow_at):
    """Run a host loop with a fake step; batch ``overflow_at`` overflows
    once. Returns the call trace."""
    trace, redone = [], set()

    def dispatch(i):
        trace.append(("dispatch", i))
        return i

    def consume(out, next_idx):
        trace.append(("consume", out, next_idx))
        if out == overflow_at and out not in redone:
            redone.add(out)
            return True
        return False

    end = loop(dispatch, consume, lambda i: i < 5)
    return trace, end


@pytest.mark.parametrize("overflow_at", [None, 0, 2, 4])
def test_double_buffered_loop_matches_reference(overflow_at):
    assert _drive_loop(host_loop.double_buffered_loop, overflow_at) == \
        _drive_loop(ref_host_loop.double_buffered_loop, overflow_at)


def test_island_blackout_is_not_ported_yet():
    # The name is from when the flag raised; the flag now runs: line 7-8
    # out islands bus 7, whose 125 MW is shed outright
    # (tests/test_torch_island_blackout.py holds it to the reference).
    sys_ = build_system(cases.rts24(), device="cpu")
    down = torch.zeros((4, 71), dtype=torch.bool)
    down[1, 33 + 10] = True
    load = sys_.load_pd[None, :].expand(4, 17)
    res = dcopf.evaluate_states(sys_, down, load,
                                CompatFlags(island_blackout=True))
    assert res.dns_mw.tolist() == pytest.approx([0.0, 125.0, 0.0, 0.0],
                                                abs=1.0)
    assert res.failure.tolist() == [False, True, False, False]
