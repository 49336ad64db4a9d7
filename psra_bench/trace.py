"""The traced run: a profiler over a fixed run of steady steps, and the
per-layer metrics read from it.

``Tracer.install`` wraps, for the length of the run, each function that
``layers.json`` names in a ``torch.profiler.record_function`` range of
its layer, and the Python entry of each kernel that ``kernels/`` counts
(K1's fused IPM loop) in a recorder of what it is handed. The profiler
starts before the window's ``start``-th dispatch and stops before the
``start + steps``-th, each time after a device sync, so the trace holds
exactly ``steps`` batches of device work.

A kernel belongs to the outermost named range around the host call that
launched it (its CUDA runtime call, matched by correlation id), so the
LP tier's own certificate pass counts in the LP tier. Each per-layer
metric is read by ``metrics/<name>.py`` (the part of the metric's name
before its first dot), whose ``read(view, split)`` returns a number or
None when the trace holds nothing for it.
"""
from __future__ import annotations

import importlib
import json
import os
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
PREFIX = "psra_layer:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def _resolve(path: str):
    mod, attr = path.split(":")
    return importlib.import_module(mod), attr


class TraceView:
    """What the readers see: the traced steps' events, in microseconds."""

    def __init__(self, events: list, steps: int, calls: dict):
        self.steps = steps
        self.calls = calls
        self.device_ops = [e for e in events if e.get("cat") in DEVICE_CATS
                           and e.get("ph") == "X"]
        self.kernels = [e for e in self.device_ops if e["cat"] == "kernel"]
        self.runtime = [e for e in events if e.get("cat") == "cuda_runtime"
                        and e.get("ph") == "X"]
        self.spans = [e for e in events if e.get("cat") == "user_annotation"
                      and e.get("ph") == "X"
                      and str(e.get("name", "")).startswith(PREFIX)]
        self._label(self.spans)
        timed = self.device_ops + self.runtime
        self.t0 = min((e["ts"] for e in timed), default=0.0)
        self.t1 = max((e["ts"] + e["dur"] for e in timed), default=0.0)
        self.busy_us, self.gaps = self._union()

    def _label(self, spans: list) -> None:
        """``layer`` of every device op: the outermost span around its
        launch, or None."""
        by_corr = {e["args"].get("correlation"): e for e in self.runtime
                   if "args" in e}
        spans = sorted(spans, key=lambda s: (s["ts"], -s["dur"]))
        starts = [s["ts"] for s in spans]
        import bisect
        for op in self.device_ops:
            op["layer"] = None
            rt = by_corr.get(op.get("args", {}).get("correlation"))
            if rt is None:
                continue
            t = rt["ts"]
            hi = bisect.bisect_right(starts, t)
            best = None
            for s in spans[:hi]:
                if s["ts"] <= t <= s["ts"] + s["dur"] \
                        and s.get("tid") == rt.get("tid"):
                    if best is None or s["dur"] > best["dur"]:
                        best = s
            if best is not None:
                op["layer"] = best["name"][len(PREFIX):]

    def _union(self):
        iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device_ops)
        busy, gaps, cur = 0.0, [], None
        for a, b in iv:
            if cur is None:
                cur = [a, b]
            elif a <= cur[1]:
                cur[1] = max(cur[1], b)
            else:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
                cur = [a, b]
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy, gaps

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def layer_us(self, layer: str) -> float:
        return sum(e["dur"] for e in self.device_ops if e["layer"] == layer)

    def kernel_us(self, *names: str) -> float:
        return sum(e["dur"] for e in self.kernels
                   if any(n in e["name"] for n in names))

    def host_reads(self) -> int:
        """Host waits on the device, less the tracer's own two device
        syncs around the traced steps (both land in the trace)."""
        n = sum(1 for e in self.runtime if e["name"] in SYNC_CALLS)
        return max(n - 2, 0)

    def sync_calls(self) -> dict:
        out: dict[str, int] = {}
        for e in self.runtime:
            if e["name"] in SYNC_CALLS:
                out[e["name"]] = out.get(e["name"], 0) + 1
        return out


class Tracer:
    """Profiles ``steps`` dispatches from the window's ``start``-th."""

    def __init__(self, per_layer: list, start: int, steps: int, device):
        self.per_layer, self.start, self.steps = per_layer, start, steps
        self.device = device
        self.prof = None
        self.recording = False
        self.traced_steps = 0
        self.calls: dict[str, list] = {}
        self.restore: list = []          # callables that undo a wrapper
        self.kernel_mods = {}
        with open(HERE / "layers.json") as f:
            self.layers = json.load(f)

    def install(self, loop) -> None:
        from torch.profiler import record_function
        for layer, paths in self.layers.items():
            for path in paths:
                mod, attr = _resolve(path)
                orig = getattr(mod, attr)

                def wrapped(*a, _orig=orig, _name=PREFIX + layer, **k):
                    with record_function(_name):
                        return _orig(*a, **k)
                setattr(mod, attr, wrapped)
                self.restore.append(
                    lambda m=mod, a=attr, o=orig: setattr(m, a, o))
        for name in sorted(p.stem for p in (HERE / "kernels").glob("k*.py")):
            km = importlib.import_module(f"psra_bench.kernels.{name}")
            self.kernel_mods[name] = km
            self.calls[name] = []
            self.restore.extend(km.install(self))
        loop.on_dispatch = self._on_dispatch

    def _sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _on_dispatch(self, k: int) -> None:
        if k == self.start and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self._sync()
            self.prof.start()
            self.recording = True
        elif self.recording:
            self.traced_steps += 1
            if k == self.start + self.steps:
                self._stop()

    def _stop(self) -> None:
        self._sync()
        self.prof.stop()
        self.recording = False

    def finish(self) -> dict:
        """Stop if still tracing, undo the wrappers, read every metric."""
        if self.recording:
            self.traced_steps += 1
            self._stop()
        for undo in reversed(self.restore):
            undo()
        if self.prof is None:
            raise RuntimeError("the window ended before the traced steps "
                               "began; lengthen the run or trace earlier")
        fd, path = tempfile.mkstemp(suffix=".json", dir=Path.cwd())
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        events = raw["traceEvents"] if isinstance(raw, dict) else raw
        for name, km in self.kernel_mods.items():
            km.count(self.calls[name])
        view = TraceView(events, self.traced_steps, self.calls)
        metrics = {}
        for m in self.per_layer:
            base, _, split = m["name"].partition(".")
            reader = importlib.import_module(f"psra_bench.metrics.{base}")
            v = reader.read(view, split)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        return dict(metrics=metrics, busy_s=view.busy_us / 1e6,
                    window_s=view.window_us / 1e6,
                    breakdown=breakdown(view), steps=view.steps,
                    sync_calls=view.sync_calls())


def breakdown(view: TraceView) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the host was doing when each began."""
    tot: dict[str, float] = {}
    for e in view.device_ops:
        tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"] / 1e6
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(view.gaps, key=lambda g: g[0] - g[1])[:10]

    def doing(t):
        """The outermost layer the host was in when the gap began, and
        the CUDA runtime call it was in, if any."""
        layer = [s for s in view.spans if s["ts"] <= t <= s["ts"] + s["dur"]]
        where = (max(layer, key=lambda s: s["dur"])["name"][len(PREFIX):]
                 if layer else "study loop")
        call = [e for e in view.runtime if e["ts"] <= t <= e["ts"] + e["dur"]]
        return f"host in {where}" + (f", {call[-1]['name']}" if call else "")
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[doing(a), (b - a) / 1e6] for a, b in gaps]}
