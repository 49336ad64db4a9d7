"""What the program's spans cost, and how much of the card's idle time
they leave unexplained, on the benchmark's SEQ cell (``rts24.seq.y4``).

One process, one card. The benchmark's SEQ study
(``psra_bench.studies.seq``) warms up, then runs windows of ``--seconds`` in turns: no profiler; a
``torch.profiler`` recording throughout with the spans and counters on;
the same with their flag check stubbed off (the spans' own share of a
traced window). Then one ``utils.profiling.device_trace`` of about 20
steps, read back:

* the card's idle time (no device operation) inside the trace's window,
  and the part of it during which the dispatching thread was in no
  ``psra.`` range;
* the host ms a step of each layer worked out from the trace's ranges by
  the benchmark's rule (the outermost ``sampling`` / ``tier1`` / ``lp``
  range, the rest the loop's), beside the spans' own totals
  (``host_ns.<layer>`` of ``profiling.counters()``), and each span's
  own host ms a step (``span_ns.<span>``).

Last, one span's host cost in microseconds, opened and closed
``--span-calls`` times with no profiler and under one (CPU activity).

    python3 scripts/torch_span_cost.py --seconds 6 --rounds 3 --seed 7 \
        --out span_cost.json

Prints the result as JSON and writes it to ``--out``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from powersystemsreliabilityassessment_tpu_torch.utils import (  # noqa: E402
    profiling)
from psra_bench import run  # noqa: E402
from psra_bench.studies import seq  # noqa: E402

CELL = "rts24.seq.y4"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _measure(iv, lo, hi):
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in iv)


def _minus(gaps, cover):
    """Length of ``gaps`` not covered by the sorted disjoint ``cover``."""
    return sum(b - a - _measure(cover, a, b) for a, b in gaps)


def read_trace(path: Path, steps: int) -> dict:
    events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    rt = [e for e in events if e.get("cat") == "cuda_runtime"
          and e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"
             and str(e.get("name", "")).startswith(profiling.PREFIX)]
    tid = max({e.get("tid") for e in rt},
              key=lambda t: sum(e.get("tid") == t for e in rt))
    spans = [s for s in spans if s.get("tid") == tid]
    t0 = min(e["ts"] for e in dev + rt)
    t1 = max(e["ts"] + e["dur"] for e in dev + rt)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        gaps.append((cur, t1))
    idle = sum(b - a for a, b in gaps)
    any_span = _union([(s["ts"], s["ts"] + s["dur"]) for s in spans])
    uncovered = _minus(gaps, any_span)
    # The benchmark's rule: outermost range of a layered span, rest loop.
    layered = [s for s in spans
               if s["name"][len(profiling.PREFIX):].split(".")[0]
               in profiling.LAYERS]
    layered.sort(key=lambda s: (s["ts"], -s["dur"]))
    host, end = {k: 0.0 for k in profiling.LAYERS}, -1.0
    for s in layered:
        if s["ts"] >= end:
            layer = s["name"][len(profiling.PREFIX):].split(".")[0]
            host[layer] += _measure([(s["ts"], s["ts"] + s["dur"])], t0, t1)
            end = s["ts"] + s["dur"]
    window = t1 - t0
    host["loop"] = window - sum(host.values())
    return dict(steps=steps, window_ms_per_step=window / 1e3 / steps,
                idle_share=idle / window,
                idle_without_span_share=(uncovered / idle if idle else 0.0),
                trace_host_ms_per_step={k: v / 1e3 / steps
                                        for k, v in host.items()},
                spans=len(spans))


def span_us(calls: int) -> dict:
    """Host microseconds of one empty span, off and under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    def loop():
        t = time.perf_counter()
        for _ in range(calls):
            with profiling.span("lp.k1"):
                pass
        return (time.perf_counter() - t) / calls * 1e6

    off = loop()
    with profile(activities=[ProfilerActivity.CPU]):
        on = loop()
    profiling.reset_counters()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--trace-seconds", type=float, default=0.25)
    p.add_argument("--span-calls", type=int, default=20000)
    p.add_argument("--out", type=Path, default=Path("span_cost.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    spec = run.load_spec(ROOT)
    cell = run.cell_of(spec, CELL)
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    study = seq.Driver(cfg, traffic, args.seed, "cuda")
    study.warm(int(traffic["warm_batches"]))
    real = profiling._profiler_enabled

    def window(mode: str) -> float:
        from torch.profiler import ProfilerActivity, profile
        units = study.window_units
        if mode == "off":
            dt = study.window(args.seconds)
        else:
            if mode == "profiler_spans_off":
                profiling._profiler_enabled = lambda: False
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]):
                    dt = study.window(args.seconds)
            finally:
                profiling._profiler_enabled = real
            profiling.reset_counters()
        return (study.window_units - units) / dt

    modes = ("off", "profiler_spans_on", "profiler_spans_off")
    rates = {m: [] for m in modes}
    for r in range(args.rounds):
        for m in (modes if r % 2 == 0 else modes[::-1]):
            rates[m].append(window(m))
    steps0 = study.loop.window_dispatches
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.device_trace(trace_dir):
            study.window(args.trace_seconds)
        steps = study.loop.window_dispatches - steps0
        trace = read_trace(Path(trace_dir) / "trace.json", steps)
    got = profiling.counters()
    result = dict(
        device=torch.cuda.get_device_name(0), seed=args.seed,
        seconds=args.seconds,
        years_per_s={m: v for m, v in rates.items()},
        median_years_per_s={m: statistics.median(v)
                            for m, v in rates.items()},
        trace=trace,
        span_host_ms_per_step={
            k: got.get(f"host_ns.{k}", 0) / 1e6 / steps
            for k in profiling.LAYERS},
        span_ms_per_step={k[len("span_ns."):]: v / 1e6 / steps
                          for k, v in got.items()
                          if k.startswith("span_ns.")},
        counters={k: v for k, v in got.items() if not k.startswith(
            ("host_ns.", "span_ns."))},
        span_us=span_us(args.span_calls))
    text = json.dumps(result, indent=1)
    args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
