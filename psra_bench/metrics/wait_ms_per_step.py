"""Host ms a step that the study loop waits for a finished batch: the
program's ``psra.loop.wait`` spans (``hl2_nsq.fetched_numpy``'s event
wait, the step's one host read on the m <= 72 path)."""
from psra_bench.metrics import _program


def read(view, split):
    ns = _program.per_step(view, "span_ns.loop.wait")
    return None if ns is None else ns / 1e6
