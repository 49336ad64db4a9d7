"""PyTorch port: the SEQ year block past RTS-24, on the CPU.

Against the JAX package, on the same hours:

* a one-year case300s stress block (m = 792, tier 1.5 on) and a two-year
  RTS-96 stress block (m = 191, the blocked Cholesky route over the plain
  K2 / K3), each rebuilt with numpy from the recipe its golden keeps
  (``chip_smoke.stress_block``): the port's ``evaluate_years`` against
  the reference's ``evaluate_states_screened`` on the flat hours with
  the arguments reference ``_years_eval`` gives it, at an LP buffer below
  the block's need. Hours on which the two DNS part are judged by float64
  HiGHS, the per-year indices follow from the hours
  (``chip_smoke.judge_block``), the LP queues and ``n_over`` are equal,
  and at case300s ``n_over`` is far below the count without tier 1.5;
* the committed goldens (tests/golden/seq_stress_*.npz, which
  ``chip_smoke.py`` holds the card to) against what the reference
  computes now;
* a 16-year x 2,016-hour study pinned at the port's own values, the
  counterpart of tests/test_golden.py's SEQ pin;
* ``seq_lp_cap`` and ``default_pf_buffer`` against the reference's
  (past m = 336 the port's cap is 4,096 LP lanes a block).

``JAX_PLATFORMS=cpu python -m tests.test_torch_seq_large`` (from the
repository's root) writes the goldens anew.
"""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu.core import (
    cases as ref_cases, load_profile as ref_lp)
from powersystemsreliabilityassessment_tpu.core.system import (
    build_system as ref_build_system)
from powersystemsreliabilityassessment_tpu.engines import (
    copper_sheet as ref_cs, dcopf as ref_dcopf)
from powersystemsreliabilityassessment_tpu.studies import hl2_seq as ref_seq
from powersystemsreliabilityassessment_tpu.utils.config import (
    CompatFlags as RefCompat, IPMConfig as RefIPM)

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    from_reference)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_seq
from powersystemsreliabilityassessment_tpu_torch.utils.config import MCSConfig

import chip_smoke

# The suite runs several pytest workers side by side: one PyTorch
# intra-op thread per worker keeps them from oversubscribing the cores.
torch.set_num_threads(1)

# Each block: natural outages with the branches' repair times scaled up
# (at case300s 40 times, so that multi-branch hours, the tier-1 misses
# tier 1.5 closes, are common), and over a window of peak hours the
# components the case300s record names most often in comp_importance
# (22, 188, 131, 35, 351, 555, 551) with 33, or the large units of two
# RTS-96 areas, held down; the LP buffer holds half of the hours the
# block sends to the LP.
RECIPES = {
    "case300s": dict(seed=5, years=1, hours=336, dwells=8,
                     branch_repair_scale=40.0,
                     forced=[22, 35, 33, 188, 131, 351, 555, 551],
                     window=[205, 211], max_lp=3),
    "rts96": dict(seed=5, years=2, hours=336, dwells=8,
                  branch_repair_scale=4.0,
                  forced=[20, 21, 22, 23, 32, 53, 54, 55, 56, 65],
                  window=[200, 212], max_lp=12),
}
GOLDEN_KEYS = ("ens", "dlc", "nlc", "nodal", "comp_fail", "n_over", "dns",
               "q", "need_lp")

# tests/test_golden.py's SEQ pin, and the port's own values of the same
# study: the port's Philox stream cannot reproduce the reference's
# threefry draws, so the port pins its own, recorded on the CPU.
REF_SEQ_EENS, REF_SEQ_LOLE, REF_SEQ_LOLF = 3.8826998472213745, 0.375, 0.1875
PORT_SEQ_EENS = 221.30874967575073
PORT_SEQ_LOLE = 2.0625
PORT_SEQ_LOLF = 0.4375


def _block(name):
    case = getattr(cases, name)()
    return chip_smoke.stress_block(twostate.mean_times(case), case.n_gen,
                                   RECIPES[name])


def _reference(ref_sys, down, max_lp):
    """Reference ``evaluate_states_screened`` on the block's flat hours,
    called as reference ``_years_eval`` calls it, reduced to the
    per-year indices as ``_years_eval`` reduces them; the LP queue is
    the evaluator's, replayed from its two certificates."""
    years, _, hours = down.shape
    B = years * hours
    flat = np.swapaxes(down, 1, 2).reshape(B, -1)
    fac = ref_lp.load_factors(hours).astype(np.float32)
    load = jnp.tile(jnp.asarray(fac)[:, None] * ref_sys.load_pd[None, :],
                    (years, 1))
    compat, ipm = RefCompat(), RefIPM()
    repair, pf = max(4096, B // 16), ref_dcopf.default_pf_buffer(ref_sys, B)
    res, n_over = ref_dcopf.evaluate_states_screened(
        ref_sys, jnp.asarray(flat), load, max_lp, compat, ipm, "lp",
        repair_buffer=repair, pf_buffer=pf)
    pre = ref_dcopf.certify_states(ref_sys, jnp.asarray(flat), load,
                                   repair_buffer=repair)
    cert = np.array(pre.certified)
    deficit = np.array(pre.deficit)
    need = ~(cert & (deficit <= 0))
    if pf:
        pidx = np.flatnonzero(need)[:pf]
        isl = ref_dcopf.certify_island_pf(ref_sys, jnp.asarray(flat[pidx]),
                                          load[pidx], theta_cap=ipm.theta_max)
        cert[pidx] |= np.asarray(isl.certified)
        deficit[pidx] = np.maximum(np.asarray(isl.deficit), deficit[pidx])
        need = ~(cert & (deficit <= 0))
    dns = np.asarray(res.dns_mw, np.float64)
    d = dns.reshape(years, hours)
    flag = d > compat.seq_curtail_threshold_mw
    nodal = np.where(flag[:, :, None],
                     np.asarray(res.nodal_mw, np.float64).reshape(
                         years, hours, -1), 0.0).sum(1)
    return dict(
        ens=d.sum(1), dlc=flag.sum(1).astype(np.float64),
        nlc=np.asarray(ref_cs.count_curtailment_events(jnp.asarray(flag)),
                       np.float64),
        nodal=nodal,
        comp_fail=np.einsum("yh,yhc->yc", flag.astype(np.float64),
                            flat.reshape(years, hours, -1).astype(
                                np.float64)),
        n_over=int(n_over), dns=dns,
        q=np.asarray(res.primal_residual, np.float64), need_lp=need)


@pytest.fixture(scope="module")
def blocks():
    """name -> (reference system, port system, block, reference's
    evaluation); each computed once."""
    out = {}

    def get(name):
        if name not in out:
            ref_sys = ref_build_system(getattr(ref_cases, name)())
            down = _block(name)
            out[name] = (ref_sys, from_reference(ref_sys, device="cpu"),
                         down, _reference(ref_sys, down,
                                          RECIPES[name]["max_lp"]))
        return out[name]

    return get


def _check_block(blocks, name, got):
    _, port_sys, down, want = blocks(name)
    max_lp = RECIPES[name]["max_lp"]
    assert (want["dlc"] > 0).all()                      # every year sheds
    n_need = int(want["need_lp"].sum())
    assert want["n_over"] == n_need - max_lp > 0        # the queue replayed
    chip_smoke.judge_block(port_sys, down, want, got,
                           chip_smoke.SEQ_ORACLE_TOL_MW[name], name)
    # On the CPU the two certificates put the same hours in the LP queue.
    np.testing.assert_array_equal(got["need_lp"], want["need_lp"])
    assert got["n_over"] == want["n_over"]


def test_year_block_case300s_matches_reference(blocks):
    _, port_sys, down, _ = blocks("case300s")
    max_lp = RECIPES["case300s"]["max_lp"]
    got = chip_smoke.evaluate_block(port_sys, down, max_lp)
    # Tier 1.5 runs in the block: without it the tier-1 misses (the
    # multi-branch hours that the island certificate closes) queue for
    # the LP and overflow the buffer.
    none = chip_smoke.evaluate_block(port_sys, down, max_lp, pf=False)
    assert none["n_over"] >= chip_smoke.SEQ300_NO_PF_RATIO * max(
        got["n_over"], 1), (got["n_over"], none["n_over"])
    _check_block(blocks, "case300s", got)


def test_year_block_rts96_matches_reference(blocks):
    _, port_sys, down, _ = blocks("rts96")
    got = chip_smoke.evaluate_block(port_sys, down,
                                    RECIPES["rts96"]["max_lp"])
    _check_block(blocks, "rts96", got)
    # Tier 1.5 is off at m = 191 (default_pf_buffer None).
    assert dcopf.default_pf_buffer(port_sys, down.size) is None
    # Every kept LP lane within float64 HiGHS.
    lanes = np.flatnonzero(got["q"] > 0)
    assert len(lanes) == RECIPES["rts96"]["max_lp"]
    assert (got["q"][lanes] <= chip_smoke.LP_QUALITY_GUARD).all()
    years, _, hours = down.shape
    flat = np.swapaxes(down, 1, 2).reshape(years * hours, -1)
    oracle = chip_smoke._highs300(port_sys, flat.astype(np.float32),
                                  list(lanes), got["load"])
    np.testing.assert_allclose(got["dns"][lanes], oracle, rtol=0,
                               atol=chip_smoke.SEQ_ORACLE_TOL_MW["rts96"])


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_golden_equals_reference(blocks, name):
    """The committed golden: the same recipe, the same block, and what
    the reference computes on it now."""
    golden = np.load(chip_smoke.SEQ_GOLDEN[name])
    for k in chip_smoke.SEQ_GOLDEN_RECIPE:
        np.testing.assert_array_equal(golden[k], RECIPES[name][k])
    _, _, down, want = blocks(name)
    assert str(golden["digest"]) == chip_smoke.block_digest(down)
    for k in GOLDEN_KEYS:
        if k in ("n_over", "need_lp", "dlc", "nlc", "comp_fail"):
            np.testing.assert_array_equal(golden[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(golden[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_seq_small_sample_regression_pin():
    """tests/test_golden.py's SEQ pin through the port (16 years x 2,016
    hours, seed 2, two years a step, 96 LP lanes a year): the port's own
    values to rel 1e-5 / 1e-6, and within 4 standard errors of the
    reference's pinned values (the reference's standard error taken
    equal to the port's per-year one)."""
    r = hl2_seq.run_seq_study(
        cases.rts24(), MCSConfig(max_years=16, cov_threshold=0.0, seed=2),
        device="cpu", years_per_device=2, max_lp=96, hours=2016,
        log_every=0)
    assert r.years == 16 and r.overflow_hours == 0
    assert r.eens_mwh_yr == pytest.approx(PORT_SEQ_EENS, rel=1e-5)
    assert r.lole_hr_yr == pytest.approx(PORT_SEQ_LOLE, rel=1e-6)
    assert r.lolf_occ_yr == pytest.approx(PORT_SEQ_LOLF, rel=1e-6)
    for got, ref, per_year in ((r.eens_mwh_yr, REF_SEQ_EENS, r.annual_ens),
                               (r.lole_hr_yr, REF_SEQ_LOLE, r.annual_dlc),
                               (r.lolf_occ_yr, REF_SEQ_LOLF, r.annual_nlc)):
        se = np.std(per_year, ddof=1) / math.sqrt(len(per_year))
        assert abs(got - ref) <= 4 * math.sqrt(2.0) * se, (got, ref, se)


@pytest.mark.parametrize("years", [1, 2, 4, 16])
@pytest.mark.parametrize("n_bus,n_branch", [(24, 38), (73, 118), (300, 492)])
def test_seq_lp_cap_and_pf_buffer_against_reference(n_bus, n_branch, years):
    """m = 62, 191 and 792 (RTS-24, RTS-96, case300s): the same
    ``default_pf_buffer`` and, at m <= 336, the same ``seq_lp_cap``; past
    m = 336 the port's cap is 4,096 LP lanes a block where the
    reference's is 4,096 / Y^2 lanes a year (a deliberate difference,
    ROADMAP.md Queue 3)."""
    m, hours = n_bus + n_branch, 8736
    got = hl2_seq.seq_lp_cap(m, hours, years)
    want = ref_seq.seq_lp_cap(m, hours, years)
    if m <= 336:
        assert got == want == hours
    else:
        assert want == min(hours, max(128, 4096 // years ** 2))
        assert got == min(hours, max(128, 4096 // years)) >= want
    sizes = types.SimpleNamespace(n_bus=n_bus, n_branch=n_branch)
    assert dcopf.default_pf_buffer(sizes, years * hours) == \
        ref_dcopf.default_pf_buffer(sizes, years * hours)


def write_goldens():
    """Write tests/golden/seq_stress_<system>.npz: the recipe, the
    block's digest and the reference's evaluation."""
    for name, recipe in RECIPES.items():
        ref_sys = ref_build_system(getattr(ref_cases, name)())
        down = _block(name)
        want = _reference(ref_sys, down, recipe["max_lp"])
        np.savez(chip_smoke.SEQ_GOLDEN[name], digest=chip_smoke.block_digest(
            down), **recipe, **{k: want[k] for k in GOLDEN_KEYS})
        print(name, {k: want[k] for k in ("ens", "dlc", "nlc", "n_over")},
              "LP queue", int(want["need_lp"].sum()))


if __name__ == "__main__":
    write_goldens()
