"""Whole runs of the harness on the CPU at small sizes: the program
judged correct, and ``correct`` false with the control in its place and
with each fault a cell can have planted under the timed path."""
import json
from pathlib import Path

import pytest
import torch

from psra_bench import check, control, run
from psra_bench.tests.faults import FAULTS, lost_flag

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# The NSQ cell is parked out of BENCHMARK.json (its rate spreads too wide
# for a bound on a host-paced card); its traffic and limits stay, and the
# NSQ driver is tested through them.
PARKED = [{"name": "rts24.nsq.lp.b8192", "config": "rts24",
           "traffic": "nsq.lp.b8192", "chips": 1}]
CELLS = {**SPEC, "workloads": SPEC["workloads"] + PARKED}
SMALL = {
    "rts24.nsq.lp.b8192": {"batch": 2048, "warm_batches": 1,
                           "check_batches": 1},
    "rts24.seq.y4": {"years_per_device": 2, "warm_batches": 1,
                     "check_batches": 1},
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _run(cell, seed=20261018, **over):
    return run.run_cell(CELLS, cell, seed, 0.5, False, "cpu",
                        {**SMALL[cell], **over}, t_start=0.0)


def test_every_cell_has_a_small_size():
    assert sorted(SMALL) == sorted(w["name"] for w in CELLS["workloads"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_is_judged_correct(cell):
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert out["compared"]["states_off"]["value"] == 0
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_judged_incorrect(cell):
    w = next(x for x in CELLS["workloads"] if x["name"] == cell)
    cfg = run.load_json(run.HERE / "configs" / f"{w['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{w['traffic']}.json")
    traffic.update(SMALL[cell])
    limits = run.load_json(run.HERE / "limits" / f"{cell}.json")
    got = control.readings(cfg, traffic, 31, 2, "cpu", limits["dns_gap_mw"])
    assert not check.verdict(got, limits), got


# Every two-year block of seed 2 holds shed hours, so a planted fault has
# answers to alter in whichever block the run keeps.
FAULT_SEEDS = {"rts24.nsq.lp.b8192": 20261018, "rts24.seq.y4": 2}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(FAULT_SEEDS))
def test_fault_is_judged_incorrect(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(cell, seed=FAULT_SEEDS[cell])
    assert not out["correct"], out["compared"]


def test_lost_flag_is_judged_incorrect(monkeypatch):
    """The NSQ study folds the evaluator's failure flags into PLC and LOLE
    (the SEQ study flags hours from the losses of load themselves)."""
    lost_flag(monkeypatch)
    cell = "rts24.nsq.lp.b8192"
    out = _run(cell, seed=FAULT_SEEDS[cell])
    assert not out["correct"], out["compared"]
    assert out["compared"]["flags_off"]["value"] > 0
