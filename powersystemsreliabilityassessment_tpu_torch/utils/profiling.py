"""Tracing / profiling hooks.

Port of ``powersystemsreliabilityassessment_tpu/utils/profiling.py``:

* ``Timings``: labelled wall-clock sections with an item-throughput
  counter (the per-kernel solves/s counters of BASELINE's north star),
  unchanged;
* ``device_trace``: a ``torch.profiler`` trace (CPU activity, and CUDA
  kernels where a card is present) written as a Chrome trace into
  ``log_dir``, in place of the reference's ``jax.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import os
import time


class Timings:
    """Accumulates labelled wall-clock sections and item throughputs.
    Mirrors reference ``utils/profiling.py::Timings``."""

    def __init__(self):
        self.sections: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, label: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.sections[label] = self.sections.get(label, 0.0) + dt
            self.counts[label] = self.counts.get(label, 0) + items

    def report(self) -> str:
        lines = [f"{'section':<28} {'time (s)':>10} {'items/s':>12}"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            n = self.counts.get(k, 0)
            rate = f"{n / v:,.0f}" if n and v > 0 else "-"
            lines.append(f"{k:<28} {v:>10.3f} {rate:>12}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write
    ``{log_dir}/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto); yields the profiler, whose ``key_averages()`` gives the
    per-operator table. CUDA kernels are traced when a card is present.
    Mirrors reference ``utils/profiling.py::device_trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
