"""Tracing / profiling hooks: the program's spans and counters, and
``device_trace``.

A span names a stage of one layer, ``psra.<layer>.<stage>`` with
``<layer>`` one of ``sampling``, ``tier1``, ``lp`` and ``loop``. Spans and
counters are on exactly while a torch profiler records (torch's own
flag, no option of this package): a span then opens a
``torch.profiler.record_function`` range of its name, so a trace holds it
beside the device work launched inside it, and adds its host time to the
totals below; a counter keeps a reference to a host int or to a tensor
the step computes anyway. Off, :func:`span` returns one shared null
context and :func:`count` returns at once. Nothing here launches a kernel
or reads the device while a step runs: a counter is reduced when
:func:`counters` is called, after the profiler has stopped.

The totals (:func:`counters`): each counter's sum; ``host_ns.<layer>``,
the host time inside the outermost open span of layer ``sampling``,
``tier1`` or ``lp`` (the LP tier's own certificate pass counts in the LP
tier; the host time outside these is the study loop's); and
``span_ns.<layer>.<stage>``, each span's own host time. A span that the
profiler's start or stop cuts counts nowhere. :func:`indices` gives the
batch indices of the loop's spans in order, so the k-th
``psra.loop.dispatch`` range of a trace is the k-th dispatched index (a
redone batch shows its index twice).

``device_trace`` writes a ``torch.profiler`` trace (CPU activity, and
CUDA kernels where a card is present) as a Chrome trace, in place of the
reference's ``jax.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "psra."
# Host time goes to the outermost open span of one of these layers.
LAYERS = ("sampling", "tier1", "lp")
_NULL = contextlib.nullcontext()


class _Totals:
    """What the spans and counters kept since the last reset."""

    def __init__(self):
        self.kept: dict[str, list] = {}     # counter -> [(reduce, values)]
        self.span_ns: dict[str, int] = {}
        self.host_ns: dict[str, int] = {}
        self.indices: dict[str, list] = {}
        self.open_layered = 0


_totals = _Totals()


class _Span:
    __slots__ = ("name", "layer", "index", "range", "t0")

    def __init__(self, name: str, index):
        self.name, self.index = name, index
        self.layer = name.split(".", 1)[0]

    def __enter__(self):
        self.range = record_function(PREFIX + self.name)
        self.range.__enter__()
        if self.layer in LAYERS:
            _totals.open_layered += 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        t = _totals
        outermost = False
        if self.layer in LAYERS:
            t.open_layered = max(t.open_layered - 1, 0)
            outermost = t.open_layered == 0
        if _profiler_enabled():
            t.span_ns[self.name] = t.span_ns.get(self.name, 0) + dt
            if outermost:
                t.host_ns[self.layer] = t.host_ns.get(self.layer, 0) + dt
            if self.index is not None:
                t.indices.setdefault(self.name, []).append(self.index)
        self.range.__exit__(*exc)
        return False


def span(name: str, index: int | None = None):
    """Context of the span ``psra.<name>`` (``name`` is
    ``<layer>.<stage>``); ``index``, the batch a loop span handles, is
    kept in order (:func:`indices`). Off: the shared null context."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name, index)


def traced(name: str):
    """Decorator: the function runs inside :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, *values, reduce=None) -> None:
    """Add to counter ``name``: ``int(values[0])``, or ``reduce(*values)``,
    worked out when :func:`counters` is called. ``values`` are kept by
    reference: host ints, or tensors the caller never writes again."""
    if _profiler_enabled():
        _totals.kept.setdefault(name, []).append((reduce, values))


def counters() -> dict[str, int]:
    """Every counter's total (reduced now), ``host_ns.<layer>`` and
    ``span_ns.<layer>.<stage>``; call it after the profiler stops."""
    t = _totals
    out = {name: sum(int(r(*v)) if r is not None else int(v[0])
                     for r, v in kept)
           for name, kept in t.kept.items()}
    out.update({f"host_ns.{k}": v for k, v in t.host_ns.items()})
    out.update({f"span_ns.{k}": v for k, v in t.span_ns.items()})
    return out


def indices() -> dict[str, list]:
    """Batch indices of the loop's spans by span name, in order."""
    return {k: list(v) for k, v in _totals.indices.items()}


def reset_counters() -> None:
    """Drop every counter, host time and index kept so far."""
    global _totals
    _totals = _Totals()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write
    ``{log_dir}/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto); yields the profiler, whose ``key_averages()`` gives the
    per-operator table. CUDA kernels are traced when a card is present.
    The trace holds the program's ``psra.`` spans, and :func:`counters`
    afterwards this block's totals. Mirrors reference
    ``utils/profiling.py::device_trace``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_counters()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
