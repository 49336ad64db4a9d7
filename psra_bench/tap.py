"""Keep the per-state answers of a sample of the timed batches.

The program's screened evaluator (``engines.dcopf.evaluate_states_screened``)
is what a study step calls to turn a batch of outage states into losses of
load. The tap wraps it for the length of a run: it keeps references to the
states and answers of the batch being dispatched (no copy, no device sync),
and once a batch is folded into the study's statistics a reservoir sample
drawn from the run's seed decides whether its answers stay for the
comparison with the reference after the window.
"""
from __future__ import annotations

import random

from powersystemsreliabilityassessment_tpu_torch.engines import dcopf


class Tap:
    """Reservoir of ``keep`` folded batches' states and answers."""

    def __init__(self, seed: int, keep: int):
        self.rng = random.Random(seed * 0x9E3779B1 + 7)
        self.keep = keep
        self.seen = 0
        self.kept: dict[int, dict] = {}
        self.pending: dict[int, dict] = {}
        self.current: int | None = None
        self.armed = False
        self._orig = dcopf.evaluate_states_screened
        orig = self._orig

        def screened(sys, comp_down, *args, **kwargs):
            res, n_over = orig(sys, comp_down, *args, **kwargs)
            if self.armed and self.current is not None:
                self.pending[self.current] = dict(
                    down=comp_down, dns=res.dns_mw, nodal=res.nodal_mw,
                    failure=res.failure)
            return res, n_over

        dcopf.evaluate_states_screened = screened

    def dispatching(self, batch_idx: int) -> None:
        """The next evaluator call is batch ``batch_idx``'s (a redo
        replaces what an earlier dispatch of it left)."""
        self.current = batch_idx

    def folded(self, batch_idx: int, partials) -> None:
        """Batch ``batch_idx`` entered the statistics with ``partials``
        (the step's packed sums as the host read them)."""
        got = self.pending.pop(batch_idx, None)
        if got is None or not self.armed:
            return
        got["partials"] = partials
        self.seen += 1
        if len(self.kept) < self.keep:
            self.kept[batch_idx] = got
            return
        r = self.rng.randrange(self.seen)
        if r < self.keep:
            del self.kept[sorted(self.kept)[r]]
            self.kept[batch_idx] = got

    def close(self) -> dict[int, dict]:
        """Restore the evaluator; the kept batches by index."""
        dcopf.evaluate_states_screened = self._orig
        self.pending.clear()
        return self.kept
