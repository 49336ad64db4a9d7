"""The RTS-96 configuration, the K2a and K3 work counts, and the readers
of the RTS-96 cell (``rts96.seq.y16``): the configuration holds the
program's case but for the departures it lists, the plain reference
judges it at m = 191 as it stands, the recorders count what the blocked
Cholesky hands the kernels, and the new readers give None where the
program kept nothing."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.utils import profiling
from psra_bench import check, control, run
from psra_bench.kernels import k2, k3, peaks
from psra_bench.metrics import (
    k2_roofline, k3_roofline, rescue_lanes_per_step)
from psra_bench.reference import case as rc, draws, lp
from psra_bench.studies import seq_blocked
from psra_bench.tests.faults import FAULTS
from psra_bench.tests.test_bench_reference import _highs, _states
from psra_bench.trace import TraceView

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "psra_bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "rts96.seq.y16"

# RTS-79 Table 12's outage durations (h) of branches 5-9 of each area (as
# in test_bench_reference.py); the program's case shifts them in every
# area. The ties (branches 114-118) are the program's.
TABLE12_DUR = [10.0, 768.0, 10.0, 10.0, 35.0]
PROGRAM_DUR = [768.0, 10.0, 10.0, 35.0, 10.0]
AREA_BRANCHES = 38


def _cfg():
    return json.loads((HERE / "configs" / "rts96.json").read_text())


def test_config_holds_the_programs_case_but_table12():
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    want = cases.rts96()
    cfg = _cfg()
    got = cfg["case"]
    for k in ("bus_pd", "bus_qd", "bus_area", "gen_bus", "gen_pmax",
              "gen_pmin", "gen_mttf", "gen_mttr", "gen_maint_weeks",
              "br_from", "br_to", "br_x", "br_rate", "br_lambda"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(getattr(want, k)), k)
    assert got["base_mva"] == want.base_mva
    dur, prog = np.asarray(got["br_dur"]), np.asarray(want.br_dur)
    fixed = np.zeros(dur.size, bool)
    for a in range(3):
        s = slice(a * AREA_BRANCHES + 5, a * AREA_BRANCHES + 10)
        np.testing.assert_array_equal(dur[s], TABLE12_DUR)
        np.testing.assert_array_equal(prog[s], PROGRAM_DUR)
        fixed[s] = True
    np.testing.assert_array_equal(dur[~fixed], prog[~fixed])
    # 72 buses (the tie 325-121 leaves from bus 323), 99 units, 119
    # branches, 51 loads, peak 8,550 MW; LP m = 191, n = 341.
    case = rc.from_config(cfg)
    assert (case.n_bus, case.n_gen, case.n_branch, case.n_load) == \
        (72, 99, 119, 51)
    assert case.bus_pd.sum() == cfg["load_profile"]["peak_mw"] == 8550.0
    assert case.n_bus + case.n_branch == 191
    # The areas' study and load model are RTS-24's.
    rts24 = json.loads((HERE / "configs" / "rts24.json").read_text())
    assert cfg["study"] == rts24["study"]
    assert {k: v for k, v in cfg["load_profile"].items() if k != "peak_mw"} \
        == {k: v for k, v in rts24["load_profile"].items()
            if k != "peak_mw"}
    assert cfg["reduced"] == [] and len(cfg["assumed"]) >= 4


def test_reference_judges_rts96_against_highs():
    """The plain reference as it stands, read through the RTS-96 file, at
    m = 191: its float64 LP agrees with float64 HiGHS."""
    case = rc.from_config(_cfg())
    down, load = _states(case, 24, seed=5, boost=4.0)
    got = lp.min_shed(case, torch.as_tensor(down), torch.as_tensor(load),
                      lp.Precision("float64"))[0].sum(1).numpy()
    want = _highs(case, down, load)
    assert (want > 1e-3).sum() >= 6
    # The reference stops at a merit of 1e-9 relative to 1 + |b|, so its
    # error grows with the shed (1.4e-5 MW at 1,406 MW here).
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-7)


def test_draws_and_load_match_the_program():
    from powersystemsreliabilityassessment_tpu_torch.core import load_profile
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from psra_bench.studies.common import case_data
    cfg = _cfg()
    case = rc.from_config(cfg)
    np.testing.assert_array_equal(rc.load_factors(case, 8736),
                                  load_profile.load_factors(8736))
    mt = twostate.mean_times(case_data(cfg))
    assert draws.num_draws(case, 8736) == chronological.default_num_draws(
        mt[:, 0], mt[:, 1], 8736)
    np.testing.assert_array_equal(case.unavail,
                                  twostate.unavailability(case_data(cfg)))


@pytest.mark.parametrize("kernel,shape,bound_ms", [
    # The kernel table's RTS-96 rows (PERF.md section 6): K2a on the
    # 56- and 23-wide panels, K3 at K 56, K 1 and P 23.
    ("k2", (2048, 56), 0.0078), ("k2", (2048, 23), 0.0013),
    ("k3", (2048, 56, 56), 0.0192), ("k3", (2048, 56, 23), 0.0102),
    ("k3", (2048, 56, 1), 0.0042), ("k3", (2048, 23, 1), 0.0008)])
def test_kernel_counts_match_the_kernel_table(kernel, shape, bound_ms):
    import chip_smoke
    mod, ref = {"k2": (k2, chip_smoke._chol_work),
                "k3": (k3, chip_smoke._trsm_work)}[kernel]
    got = mod.work(*shape)
    assert got == pytest.approx(ref(*shape))
    assert peaks.bound_s(*got) * 1e3 == pytest.approx(bound_ms, abs=5e-5)


class _Tracer:
    def __init__(self):
        self.recording = True
        self.calls = {"k2": [], "k3": []}


def test_recorders_see_the_blocked_route_and_restore():
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol, blocked_chol)
    before = (batched_chol.cholesky, blocked_chol.trsm_fwd,
              blocked_chol.trsm_bwd)
    tracer = _Tracer()
    undo = k2.install(tracer) + k3.install(tracer)
    try:
        g = torch.Generator().manual_seed(3)
        X = torch.randn((2, 191, 191), generator=g)
        M = X @ X.transpose(1, 2) + 191 * torch.eye(191)
        f = blocked_chol.blocked_cholesky(M)
        tracer.recording = False
        blocked_chol.blocked_cho_solve(f, torch.ones(2, 191))
    finally:
        for u in undo:
            u()
    assert (batched_chol.cholesky, blocked_chol.trsm_fwd,
            blocked_chol.trsm_bwd) == before
    # Four diagonal panels (56, 56, 56, 23); six panels below them; the
    # probe's three substitutions, each four forward and four backward.
    assert sorted(c["shape"] for c in tracer.calls["k2"]) == \
        [(2, 23, 23)] + [(2, 56, 56)] * 3
    k3_shapes = [c["shape"] for c in tracer.calls["k3"]]
    assert sorted(k3_shapes[:6]) == [(2, 56, 23)] * 3 + [(2, 56, 56)] * 3
    assert len(k3_shapes) == 6 + 3 * 8
    k2.count(tracer.calls["k2"])
    k3.count(tracer.calls["k3"])
    assert tracer.calls["k2"][0]["flops"] == 2 * 56 ** 3 / 3


def _view(calls, kernels):
    """A trace of one step holding ``kernels`` (name, microseconds)."""
    ev = [dict(ph="X", cat="kernel", tid=7, ts=100.0 * i, dur=us, name=n,
               args={}) for i, (n, us) in enumerate(kernels)]
    return TraceView(ev, 1, calls)


def test_roofline_readers():
    calls = {"k2": [dict(flops=0.0, bytes=3.35e6)],       # 1 us bound
             "k3": [dict(flops=67e6, bytes=0.0)] * 2}      # 1 us each
    view = _view(calls, [("cholesky_lanes_kernel", 4.0),
                         ("trsm_vec_kernel", 2.0), ("trsm_cols_kernel", 6.0),
                         ("cho_solve_kernel", 9.0)])
    assert k2_roofline.read(view, "seq96") == pytest.approx(25.0)
    assert k3_roofline.read(view, "seq96") == pytest.approx(25.0)


def test_new_readers_give_none_without_the_program():
    profiling.reset_counters()
    empty = _view({}, [("trsm_vec_kernel", 2.0)])
    assert k2_roofline.read(empty, "seq96") is None
    assert k3_roofline.read(empty, "seq96") is None
    no_kernel = _view({"k3": [dict(flops=1.0, bytes=1.0)]}, [])
    assert k3_roofline.read(no_kernel, "seq96") is None
    assert rescue_lanes_per_step.read(empty, "seq96") is None


def test_cell_entries():
    w = run.cell_of(SPEC, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("rts96", "seq.y16", 1)
    traffic = json.loads((HERE / "traffic" / "seq.y16.json").read_text())
    assert traffic == {"study": "seq_blocked", "years_per_device": 16,
                       "max_lp": 256, "nodal_mode": "lp", "warm_batches": 4,
                       "check_batches": 4, "trace_start": 8,
                       "trace_steps": 10}
    limits = json.loads((HERE / "limits" / f"{CELL}.json").read_text())
    assert limits["states_off"] == 0 and limits["flags_off"] == 0
    per = sorted(m["name"] for m in SPEC["per_layer"]
                 if CELL in m.get("workloads", []))
    assert per == sorted([
        "k3_roofline.seq96", "k2_roofline.seq96",
        "rescue_demand_per_step.seq96", "rescue_lanes_per_step.seq96",
        "guard_fallback_per_step.seq96", "host_ms_per_step.lp.seq96"])


# The cell at its CPU size: one year a block, 64 LP lanes a year.
SMALL = {"years_per_device": 1, "max_lp": 64, "warm_batches": 1,
         "check_batches": 1}


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_control_is_judged_incorrect(few_threads):
    """The reference in TF32 in the program's place fails the cell's
    limits at its CPU size, as it does on the card at the cell's own."""
    traffic = json.loads((HERE / "traffic" / "seq.y16.json").read_text())
    # The control knows the SEQ study by the name "seq"; the cell's driver
    # is that study behind a probe of the program (studies/seq_blocked.py).
    traffic.update(SMALL, study="seq")
    limits = json.loads((HERE / "limits" / f"{CELL}.json").read_text())
    got = control.readings(_cfg(), traffic, 31, 2, "cpu",
                           limits["dns_gap_mw"])
    assert not check.verdict(got, limits), got
    assert got["dns_gap_mw"] > limits["dns_gap_mw"]


# The one-year block 1 of seed 135 holds 16 hours short of generating
# capacity, all in its second half, so every planted fault has answers to
# alter in the block the run keeps (most one-year blocks of RTS-96 shed
# nothing).
FAULT_SEED = 135


def test_program_is_judged_correct_on_the_fault_seed(few_threads):
    """The sound program on the block the faults alter (the SEQ study
    flags hours from the losses of load, so ``lost_flag``, which drops
    only the evaluator's flags, is the NSQ cell's fault alone)."""
    out = run.run_cell(SPEC, CELL, FAULT_SEED, 0.5, False, "cpu", SMALL,
                       t_start=0.0)
    assert out["correct"], out["compared"]
    assert out["info"]["kept_batches"] == [1]
    assert out["info"]["spread"]["worst"][0][1] > 1.0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_judged_incorrect(fault, monkeypatch, few_threads):
    """Each fault planted under the timed path reads ``correct`` false in
    the cell at its CPU size."""
    FAULTS[fault](monkeypatch)
    out = run.run_cell(SPEC, CELL, FAULT_SEED, 0.5, False, "cpu", SMALL,
                       t_start=0.0)
    assert out["info"]["kept_batches"] == [1]
    assert not out["correct"], out["compared"]


def test_traced_run_on_the_cpu_is_correct_and_counts():
    """A small traced run of the cell on the CPU: one year a block, 64 LP
    lanes a year."""
    profiling.reset_counters()
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        out = run.run_cell(SPEC, CELL, 20261018, 0.5, True, "cpu",
                           {"years_per_device": 1, "max_lp": 64,
                            "warm_batches": 1, "check_batches": 1,
                            "trace_start": 0, "trace_steps": 1},
                           t_start=0.0)
    finally:
        torch.set_num_threads(n)
        profiling.reset_counters()
    assert out["correct"], out["compared"]
    got = out["metrics"]
    for name in ("rescue_demand_per_step.seq96",
                 "rescue_lanes_per_step.seq96",
                 "guard_fallback_per_step.seq96"):
        assert name in got, sorted(got)
    # No device operation on the CPU: no kernel time, no window.
    assert "k3_roofline.seq96" not in got
    assert "host_ms_per_step.lp.seq96" not in got


def test_probe_clears_every_lane_on_the_program(few_threads):
    """The program's blocked route brings every probe lane that its
    one-iteration pass leaves past the guard back under it."""
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from psra_bench.studies.common import case_data, compat_flags
    cfg = _cfg()
    compat = compat_flags(cfg)
    sys = build_system(case_data(cfg), compat, "cpu")
    assert sys.n_bus + sys.n_branch == 191
    assert seq_blocked.probe(sys, compat) == 0


def test_program_without_the_blocked_rescue_is_refused(monkeypatch,
                                                        few_threads):
    """Without the rescue (the pass's answer kept as it is) every probe
    lane stays past the guard, and the cell stops at set-up before the
    evaluator is tapped."""
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        dcopf, lp_ipm_batched)
    monkeypatch.setattr(lp_ipm_batched, "_rescue_flagged",
                        lambda c, b, l, u, ops, cfg, sol, valid: sol)
    screened = dcopf.evaluate_states_screened
    with pytest.raises(run.BenchError, match="32 of 32 probe lanes"):
        run.run_cell(SPEC, CELL, FAULT_SEED, 0.5, False, "cpu", SMALL,
                     t_start=0.0)
    assert dcopf.evaluate_states_screened is screened
