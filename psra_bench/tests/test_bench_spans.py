"""The readers of the program's spans and counters on a synthetic trace:
the four host-time layers add up to the window, the readers that were
there read the same with and without the program's ``psra.`` ranges in
the trace, and the new readers give None where the program kept nothing
(a program without spans, as before they were added). Then one traced
run on the CPU reports the counters' metrics."""
import importlib
import json
from pathlib import Path

import pytest
import torch

from powersystemsreliabilityassessment_tpu_torch.utils import profiling
from psra_bench import run
from psra_bench.trace import TraceView

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("host_ms_per_step", "wait_ms_per_step", "lp_lane_fill",
       "rescue_demand_per_step", "guard_fallback_per_step")
STEPS = 2


def _reader(metric):
    return importlib.import_module(
        "psra_bench.metrics." + metric.split(".")[0])


def _events(program_spans: bool) -> list:
    """Two steps of 10 ms: a launch and a kernel in each layer's range,
    a sync, and (``program_spans``) the program's own ranges."""
    ev = []
    for s in range(STEPS):
        t = 10_000.0 * s
        for k, (layer, a) in enumerate((("sampling", 100.0),
                                        ("tier1", 1_000.0),
                                        ("lp", 4_000.0))):
            corr = 10 * s + k
            ev.append(dict(ph="X", cat="user_annotation", tid=1, ts=t + a,
                           dur=2_000.0, name=f"psra_layer:{layer}"))
            ev.append(dict(ph="X", cat="cuda_runtime", tid=1,
                           ts=t + a + 10, dur=5.0, name="cudaLaunchKernel",
                           args={"correlation": corr}))
            ev.append(dict(ph="X", cat="kernel", tid=7, ts=t + a + 20,
                           dur=300.0, name=f"k_{layer}",
                           args={"correlation": corr}))
        ev.append(dict(ph="X", cat="cuda_runtime", tid=1, ts=t + 9_000,
                       dur=900.0, name="cudaEventSynchronize", args={}))
        if program_spans:
            ev += [dict(ph="X", cat="user_annotation", tid=1, ts=t + a,
                        dur=1_500.0, name=f"psra.{n}", args={})
                   for n, a in (("sampling.years", 100.0),
                                ("tier1.certify", 1_000.0),
                                ("lp.k1", 4_000.0),
                                ("loop.wait", 9_000.0))]
    return ev


def _program_totals(monkeypatch):
    """What the program's spans and counters keep over those steps."""
    t = profiling._Totals()
    t.host_ns = {"sampling": 3_000_000, "tier1": 4_000_000,
                 "lp": 9_000_000}
    t.span_ns = {"loop.wait": 1_800_000, "lp.k1": 6_000_000}
    t.kept = {"lp.buffer_lanes": [(None, (1024,)), (None, (1024,))],
              "lp.real_lanes": [(None, (torch.tensor(300),)),
                                (None, (torch.tensor(212),))],
              "lp.rescue_demand": [(None, (torch.tensor(5),))] * 2,
              "lp.guard_fallback": [(lambda b, v: int((b & v).sum()), (
                  torch.tensor([True, True]), torch.tensor([True, False])))]}
    monkeypatch.setattr(profiling, "_totals", t)


def test_host_time_layers_add_up_to_the_window(monkeypatch):
    _program_totals(monkeypatch)
    view = TraceView(_events(True), STEPS, {})
    got = {layer: _reader("host_ms_per_step").read(view, f"{layer}.seq")
           for layer in ("sampling", "tier1", "lp", "loop")}
    assert got["sampling"] == pytest.approx(1.5)
    assert got["lp"] == pytest.approx(4.5)
    assert sum(got.values()) == pytest.approx(view.window_us / 1e3 / STEPS)
    assert got["loop"] > 0
    assert _reader("wait_ms_per_step").read(view, "seq") == \
        pytest.approx(0.9)
    assert _reader("lp_lane_fill").read(view, "seq") == pytest.approx(25.0)
    assert _reader("rescue_demand_per_step").read(view, "seq") == 5.0
    assert _reader("guard_fallback_per_step").read(view, "seq") == 0.5


def test_readers_that_were_there_read_the_same(monkeypatch):
    _program_totals(monkeypatch)
    old = [m["name"] for m in SPEC["per_layer"]
           if m["name"].split(".")[0] not in NEW]
    assert len(old) == 7
    plain = TraceView(_events(False), STEPS, {})
    spanned = TraceView(_events(True), STEPS, {})
    for name in old:
        split = name.partition(".")[2]
        assert _reader(name).read(plain, split) == \
            _reader(name).read(spanned, split), name
    assert _reader("lp_ms_per_step").read(spanned, "seq") == \
        pytest.approx(0.3)


def test_new_readers_give_none_without_the_program_totals():
    profiling.reset_counters()
    new = [m["name"] for m in SPEC["per_layer"]
           if m["name"].split(".")[0] in NEW]
    assert len(new) == 8
    for events in (_events(False), _events(True)):
        view = TraceView(events, STEPS, {})
        for name in new:
            assert _reader(name).read(view, name.partition(".")[2]) is None


def test_traced_run_on_the_cpu_reports_the_counters():
    profiling.reset_counters()
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        out = run.run_cell(SPEC, "rts24.seq.y4", 20261018, 0.5, True, "cpu",
                           {"years_per_device": 1, "warm_batches": 1,
                            "check_batches": 1, "trace_start": 0,
                            "trace_steps": 1}, t_start=0.0)
    finally:
        torch.set_num_threads(n)
        profiling.reset_counters()
    assert out["correct"], out["compared"]
    got = out["metrics"]
    for name in ("lp_lane_fill.seq", "rescue_demand_per_step.seq",
                 "guard_fallback_per_step.seq"):
        assert name in got, sorted(got)
    # No device operation on the CPU, so no window to share out.
    assert "host_ms_per_step.loop.seq" not in got
