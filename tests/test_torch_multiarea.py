"""PyTorch port: the multi-area HL1.5 engine (``engines/multiarea.py``,
``studies/multiarea_demo.py``) against the JAX package on the CPU.

* ``areas_from_case`` on RTS-96 and on a 4-area ring equal to the
  reference's (fleets, loads, ties).
* ``solve_curtailment`` (the LP on the plain K2a / K2b here) against the
  reference on the same margins: ISOLATED equal; INTERCONNECTED totals
  within 1e-3 MW, each area within 0.1 MW (degenerate optima move with
  float32 rounding) and never above its isolated deficit; the
  reference's closed-form chain and three-area cases; 12 random
  topologies against float64 HiGHS totals.
* The step's evaluation (``evaluate_block``) on the reference's own
  ``sample_timeline`` draws against the reference step's per-area loss
  hours and EUE, for both policies, on the two-area demo and on RTS-96's
  three areas: loss hours equal but where one side's curtailment is
  float32 noise (<= 1e-3 MW), EUE within 0.1 MW a loss hour.
* The studies at a few hundred hours: interconnection helps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import cases as ref_cases
from powersystemsreliabilityassessment_tpu.engines import (
    multiarea as ref_ma)
from powersystemsreliabilityassessment_tpu.parallel import mesh as ref_mesh
from powersystemsreliabilityassessment_tpu.sampling import (
    chronological as ref_chrono)
from powersystemsreliabilityassessment_tpu.studies import (
    multiarea_demo as ref_demo)
from powersystemsreliabilityassessment_tpu.utils.config import (
    IPMConfig as RefIPM)

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.engines import multiarea
from powersystemsreliabilityassessment_tpu_torch.studies import (
    multiarea_demo)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)

torch.set_num_threads(1)

CPU = "cpu"
TOTAL_TOL_MW = 1e-3      # minimum total curtailment, port vs reference
AREA_TOL_MW = 0.1        # per area: degenerate optima, float32 IPMs
HIGHS_TOL_MW = 0.15      # the reference's own bound against HiGHS
NOISE_MW = 1e-3          # float32 noise of the closed-form repair


def _assert_systems_equal(got, want):
    assert got.area_names == want.area_names
    for k in ("gen_capacity", "gen_mttf", "gen_mttr"):
        for a, b in zip(getattr(got, k), getattr(want, k)):
            np.testing.assert_array_equal(a, b)
    for k in ("hourly_load", "tie_from", "tie_to", "tie_cap"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_areas_from_case_matches_reference():
    case = cases.rts96()
    sys_ = multiarea.areas_from_case(case, np.arange(case.n_bus) // 24,
                                     np.ones(10))
    _assert_systems_equal(sys_, ref_ma.areas_from_case(
        ref_cases.rts96(), np.arange(case.n_bus) // 24, np.ones(10)))
    assert sys_.n_areas == 3 and sys_.tie_cap.shape == (5,)
    ab = sys_.tie_cap[((sys_.tie_from == 0) & (sys_.tie_to == 1))
                      | ((sys_.tie_from == 1) & (sys_.tie_to == 0))]
    assert ab.sum() == pytest.approx(1175.0)
    for a in range(3):     # 32 real units (sync condenser dropped), 3405 MW
        assert len(sys_.gen_capacity[a]) == 32
        assert sys_.gen_capacity[a].sum() == pytest.approx(3405.0)
    assert sys_.hourly_load[:, 0] == pytest.approx(2850.0)
    _assert_systems_equal(multiarea_demo.rts96_three_area_system(500),
                          ref_demo.rts96_three_area_system(500))
    _assert_systems_equal(multiarea_demo.ring_system(4, 300),
                          ref_demo.ring_system(4, 300))
    _assert_systems_equal(multiarea_demo.demo_system(700),
                          ref_demo.demo_system(700))
    with pytest.raises(ValueError, match="area structure"):
        multiarea_demo.case_system(cases.rts24())


def _curtail(margins, tf, tt, cap, policy=multiarea.INTERCONNECTED):
    got = multiarea.solve_curtailment(
        torch.as_tensor(margins, dtype=torch.float32), tf, tt,
        np.asarray(cap, np.float32), policy).numpy()
    want = np.asarray(ref_ma.solve_curtailment(
        jnp.asarray(margins, jnp.float32), jnp.asarray(tf, jnp.int32),
        jnp.asarray(tt, jnp.int32), jnp.asarray(cap, jnp.float32), policy))
    return got, want


@pytest.mark.parametrize("n_areas,seed", [(2, 0), (3, 1), (5, 2)])
def test_solve_curtailment_matches_reference(n_areas, seed):
    rng = np.random.default_rng(seed)
    T = n_areas + 1
    tf = rng.integers(0, n_areas, T)
    tt = (tf + rng.integers(1, n_areas, T)) % n_areas
    cap = rng.uniform(5.0, 80.0, T)
    m = rng.uniform(-100.0, 120.0, (256, n_areas))
    m[:16] = np.abs(m[:16])                     # no deficit anywhere
    got, want = _curtail(m, tf, tt, cap, multiarea.ISOLATED)
    np.testing.assert_array_equal(got, want)
    got, want = _curtail(m, tf, tt, cap)
    assert (got[:16] == 0).all()
    np.testing.assert_allclose(got.sum(1), want.sum(1), atol=TOTAL_TOL_MW)
    np.testing.assert_allclose(got, want, atol=AREA_TOL_MW)
    assert (got <= np.maximum(-m, 0.0) + 1e-3).all()


def test_flow_conservation_cases():
    m = np.array([[-5.0, 3.0, 4.0]])
    tf, tt = np.array([0, 1]), np.array([1, 2])
    # chain 0-1-2 with big caps: area 0 can import from both
    got, _ = _curtail(m, tf, tt, [10.0, 10.0])
    assert got[0, 0] == pytest.approx(0.0, abs=1e-3)
    # tie caps 1 each: only 1 MW reaches area 0 (the 0-1 link binds)
    got, _ = _curtail(m, tf, tt, [1.0, 1.0])
    assert got[0, 0] == pytest.approx(4.0, abs=1e-2)


def test_three_area_closed_form():
    # A(+100) -- 30 --> B(-50), B -- 40 --> C(-80), A -- 10 --> C: B keeps
    # the 30 it can import (curtails 20); C gets only the direct 10 from A
    # (B has no surplus to forward) and curtails 70.
    got, want = _curtail(np.array([[100.0, -50.0, -80.0]]),
                         np.array([0, 1, 0]), np.array([1, 2, 2]),
                         [30.0, 40.0, 10.0])
    assert got[0] == pytest.approx([0.0, 20.0, 70.0], abs=0.1)
    np.testing.assert_allclose(got, want, atol=AREA_TOL_MW)


def test_random_topologies_match_float64_highs():
    # TOTAL curtailment (float32 IPM + closed-form repair, surplus-only
    # cap, flow tiebreak) equals the float64 HiGHS optimum of the uncapped
    # minimum-total-curtailment LP; each area stays within its isolated
    # deficit.
    from scipy.optimize import linprog
    rng = np.random.default_rng(17)
    for trial in range(12):
        A = int(rng.integers(2, 6))
        T = int(rng.integers(1, 2 * A))
        tf = rng.integers(0, A, T)
        tt = (tf + rng.integers(1, A, T)) % A        # no self-loops
        cap = rng.uniform(5.0, 80.0, T)
        m = rng.uniform(-100.0, 120.0, (4, A))
        got = multiarea.solve_curtailment(
            torch.as_tensor(m, dtype=torch.float32), tf, tt,
            cap.astype(np.float32)).numpy()
        inc = np.zeros((A, T))
        np.add.at(inc, (tt, np.arange(T)), 1.0)
        np.add.at(inc, (tf, np.arange(T)), -1.0)
        for b in range(m.shape[0]):
            # min sum(c) s.t. c + inc (f+ - f-) >= -margin, c, f >= 0
            res = linprog(
                c=np.concatenate([np.ones(A), np.zeros(2 * T)]),
                A_ub=np.concatenate([-np.eye(A), -inc, inc], axis=1),
                b_ub=m[b], bounds=[(0, None)] * A
                + [(0, c) for c in cap] * 2, method="highs")
            assert res.status == 0
            assert got[b].sum() == pytest.approx(res.fun, abs=HIGHS_TOL_MW), (
                trial, b)
            assert np.all(got[b] <= np.maximum(-m[b], 0.0) + 1e-3)


def _ref_block(sys_, years, seed):
    """The reference step's (loss hours, EUE sums) on a one-device mesh
    for both policies, and the timelines it drew (rebuilt with its key
    splits: device 0's fold_in, then one key a year)."""
    ipm = RefIPM(iterations=20)
    mesh = ref_mesh.scenario_mesh(jax.devices()[:1])
    key = jax.random.key(seed)
    want = {p: tuple(np.asarray(a) for a in ref_ma.make_multiarea_batch_step(
        sys_, mesh, years, p, ipm)(key)) for p in multiarea_demo.POLICIES}
    caps, mttf, mttr = ref_ma._padded_fleet(sys_)
    H = sys_.hourly_load.shape[1]
    nd = ref_chrono.default_num_draws(mttf.reshape(-1), mttr.reshape(-1), H)
    keys = jax.random.split(jax.random.fold_in(key, 0), years)
    down = jax.vmap(lambda kk: ref_chrono.sample_timeline(
        kk, jnp.asarray(mttf.reshape(-1), jnp.float32),
        jnp.asarray(mttr.reshape(-1), jnp.float32), H, nd,
        quantize=False))(keys)
    return want, torch.as_tensor(np.array(down)), caps


@pytest.mark.parametrize("which", ["demo", "rts96"])
def test_step_evaluation_on_reference_draws(which):
    if which == "demo":
        sys_, years = multiarea_demo.demo_system(hours=1500), 2
    else:
        # Loads raised 30% so that 600 winter hours hold losses in both
        # policies.
        sys_ = multiarea_demo.rts96_three_area_system(600)
        sys_, years = dataclasses.replace(
            sys_, hourly_load=sys_.hourly_load * 1.3), 2
    want, down, caps = _ref_block(sys_, years, seed=3)
    load = torch.as_tensor(sys_.hourly_load, dtype=torch.float32)
    caps = torch.as_tensor(caps)
    margins = multiarea.block_margins(down, caps, load)
    for policy in multiarea_demo.POLICIES:
        loss, eue = multiarea.evaluate_block(
            down, caps, load, sys_.tie_from, sys_.tie_to, sys_.tie_cap,
            policy, IPMConfig(iterations=20))
        w_loss, w_eue = want[policy]
        assert w_loss.sum() > 0, policy
        got, ref = _curtail(margins.numpy(), sys_.tie_from, sys_.tie_to,
                            sys_.tie_cap, policy)
        np.testing.assert_array_equal(loss.numpy(), (got > 0).sum(0))
        np.testing.assert_array_equal(w_loss, (ref > 0).sum(0))
        # A loss hour the two packages count differently is float32 noise
        # of the closed-form repair: an area that exports its whole
        # surplus keeps -(margin + flows) within a few ulps of 0 (the
        # reference's 3.05e-5 MW in a 262 MW surplus area).
        apart = (got > 0) != (ref > 0)
        assert (np.maximum(got, ref)[apart] <= NOISE_MW).all()
        if policy == multiarea.ISOLATED or which == "demo":
            np.testing.assert_array_equal(loss.numpy(), w_loss)
        np.testing.assert_allclose(
            eue.numpy(), w_eue, rtol=1e-5, atol=AREA_TOL_MW * w_loss.max())
    iso, inter = (want[p][1] for p in multiarea_demo.POLICIES)
    assert (inter <= iso + 1e-3).all() and inter.sum() < iso.sum()


def test_batches_sum_to_the_study_and_repeat_by_seed():
    sys_ = multiarea_demo.demo_system(hours=400)
    loss, eue, ypb = multiarea.multiarea_batches(
        sys_, multiarea.INTERCONNECTED, 5, seed=2, years_per_device=2,
        device=CPU)
    assert loss.shape == eue.shape == (3, 2) and ypb == 2
    lole, eue_yr = multiarea.run_multiarea_sequential(
        sys_, multiarea.INTERCONNECTED, 5, seed=2, years_per_device=2,
        device=CPU)
    np.testing.assert_array_equal(lole, loss.sum(0) / 6)
    np.testing.assert_array_equal(eue_yr, eue.sum(0) / 6)
    # years_per_device is capped at the years asked for
    assert multiarea.multiarea_batches(sys_, multiarea.ISOLATED, 1, seed=2,
                                       device=CPU)[2] == 1


def test_demo_interconnection_helps():
    res = multiarea_demo.run_demo(n_years=8, seed=1, hours=2000, device=CPU)
    iso = res[multiarea.ISOLATED]
    inter = res[multiarea.INTERCONNECTED]
    for a in range(2):
        assert inter["eue"][a] <= iso["eue"][a] + 1e-6
    assert sum(inter["eue"]) < sum(iso["eue"])


def test_ring_and_rts96_interconnection_helps():
    out = multiarea_demo.run_nring_demo(n_areas=4, n_years=3, hours=800,
                                        device=CPU)
    iso, inter = out[multiarea.ISOLATED], out[multiarea.INTERCONNECTED]
    assert len(iso["lole"]) == 4
    for a in range(4):
        assert inter["eue"][a] <= iso["eue"][a] + 1e-6
    out = multiarea_demo.run_rts96_hl15(n_years=4, hours=1000, device=CPU)
    iso, inter = out[multiarea.ISOLATED], out[multiarea.INTERCONNECTED]
    assert len(iso["lole"]) == 3
    assert sum(inter["eue"]) <= sum(iso["eue"]) + 1e-6
    out = multiarea_demo.run_case_hl15(cases.rts96(), n_years=2, hours=300,
                                       device=CPU)
    assert set(out) == set(multiarea_demo.POLICIES)
