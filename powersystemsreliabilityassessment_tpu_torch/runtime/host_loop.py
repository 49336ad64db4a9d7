"""Double-buffered host dispatch loop with grow-and-redo.

Port of ``powersystemsreliabilityassessment_tpu/runtime/host_loop.py``
(``double_buffered_loop``, the reference's protocol step for step). The loop
dispatches batch ``k+1`` before it synchronizes on batch ``k``'s partial
sums, so the host's round trip hides behind device work. On CUDA the
contract is that ``dispatch`` only enqueues work and ``consume`` waits
for its own batch alone (``studies/hl2_nsq.py`` records a CUDA event per
batch), never for the batch dispatched after it. ``consume`` may report
that a batch overflowed its LP buffer after rebuilding the step with a
larger one; since batch draws are deterministic in the batch index, the
re-dispatch is an exact redo, not a resample.

Each call runs inside a ``psra.loop.dispatch`` or ``psra.loop.consume``
span of its batch index (``utils/profiling.py``), so a redo shows in a
trace as the same index twice.
"""
from __future__ import annotations

from typing import Any, Callable

from powersystemsreliabilityassessment_tpu_torch.utils.profiling import span


def double_buffered_loop(dispatch: Callable[[int], Any],
                         consume: Callable[[Any, int], bool],
                         should_continue: Callable[[int], bool],
                         start_idx: int = 0) -> int:
    """Run the double-buffered dispatch/consume loop; mirrors reference
    ``runtime/host_loop.py::double_buffered_loop``.

    ``dispatch(i)``
        Launch batch ``i`` on the device and return its (async) outputs.
        Must be deterministic in ``i`` (seed the batch generator from ``i``) so
        a redo reproduces the batch exactly. Reads the CURRENT step
        closure — a redo rebuilds it before this is called again.
    ``consume(out, next_idx)``
        Synchronize on a finished batch and fold it into the running
        statistics; return True iff the batch overflowed and must be
        redone (after ``consume`` itself rebuilt the step with a larger
        buffer). ``next_idx`` is the batch index a checkpoint written
        now should resume from (everything below it is folded in or
        about to be redone).
    ``should_continue(i)``
        Checked before dispatching batch ``i``; False stops dispatching
        (the in-flight batch is still drained and consumed).

    Returns the next undispatched batch index.
    """
    def run_dispatch(idx: int):
        with span("loop.dispatch", idx):
            return dispatch(idx)

    def run_consume(done: tuple[int, Any], next_idx: int) -> bool:
        with span("loop.consume", done[0]):
            return consume(done[1], next_idx)

    pending: tuple[int, Any] | None = None
    i = start_idx
    while should_continue(i):
        out = run_dispatch(i)
        if pending is not None and run_consume(pending, i):
            # Redo the overflowed batch with the grown buffer; the batch
            # just dispatched above used the old step, so rewind and
            # re-dispatch it next iteration.
            out = run_dispatch(pending[0])
            i = pending[0]
        pending = (i, out)
        i += 1
    # Drain the in-flight batch; if IT overflows, redo it too (dropping
    # it would lose its samples and break the grow-and-redo exactness).
    while pending is not None:
        if run_consume(pending, pending[0] + 1):
            pending = (pending[0], run_dispatch(pending[0]))
        else:
            pending = None
    return i


__all__ = ["double_buffered_loop"]
