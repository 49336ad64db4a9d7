"""Sequential (SEQ) study driver: the port's year-block step under its own
host loop and ``AnnualStats``, stopped by a clock.

Set-up is ``run_seq_study``'s for "reference" sampling without options:
``build_system``, the RTS-79 load factors, the draw count K, the LP cap
and ``make_seq_batch_step``. The loop body is a frozen copy of the
study's ``consume`` (a batch that overflows its LP buffer is redone
through a transient step of twice the buffer; three redone batches in a
row promote that size) without checkpoints and logging.

Traffic keys: ``years_per_device`` (years a batch), ``max_lp`` (LP lanes
a year), ``nodal_mode``, ``warm_batches``, ``check_batches``,
``trace_start`` / ``trace_steps``.
"""
from __future__ import annotations

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core import load_profile
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.parallel.accumulators import (
    AnnualStats)
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq, hl2_seq
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)

from psra_bench.studies.common import Loop, case_data, compat_flags
from psra_bench.tap import Tap

RATE_METRIC = "seq_years_per_s"


def _mean(v: list) -> float:
    return float(np.mean(v)) if v else 0.0


class Driver:
    """One SEQ study of the configuration ``cfg`` under ``traffic``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.seed = seed
        self.compat = compat_flags(cfg)
        self.ipm = IPMConfig()
        case = case_data(cfg)
        self.sys = build_system(case, self.compat, device)
        self.hours = self.compat.hours_per_year_seq
        factors = load_profile.load_factors(self.hours,
                                            self.compat.weekday_mode)
        self.factors = torch.as_tensor(factors, dtype=torch.float32,
                                       device=self.sys.device)
        mt = twostate.mean_times(case)
        self.n_draws = chronological.default_num_draws(mt[:, 0], mt[:, 1],
                                                       self.hours)
        self.years = int(traffic["years_per_device"])
        self.nodal_mode = traffic["nodal_mode"]
        self.lp_cap = hl2_seq.seq_lp_cap(self.sys.n_bus + self.sys.n_branch,
                                         self.hours, self.years)
        self.max_lp = min(int(traffic["max_lp"]), self.lp_cap)
        self.steps: dict[int, object] = {}
        self.redo_lp: dict[int, int] = {}
        self.consec_over = 0
        self.stats = AnnualStats()
        self.partials: list[np.ndarray] = []
        self.overflow = self.infeasible = self.window_units = 0
        self.tap = Tap(seed, int(traffic["check_batches"]))
        self.loop = Loop(self._dispatch, self._consume, device)

    def _step_for(self, lp: int):
        if lp not in self.steps:
            self.steps[lp] = hl2_seq.make_seq_batch_step(
                self.sys, self.years, self.compat, self.ipm, self.hours,
                self.n_draws, lp, self.factors, nodal_mode=self.nodal_mode)
        return self.steps[lp]

    def _dispatch(self, i: int):
        lp = self.redo_lp.get(i, self.max_lp)
        self.tap.dispatching(i)
        out = self._step_for(lp)(hl2_nsq.batch_generator(
            self.seed, i, self.sys.device))
        return i, lp, hl2_nsq.fetch_async(hl2_seq._pack(out))

    def _consume(self, dispatched, next_idx) -> bool:
        idx, lp_used, fetched = dispatched
        v = hl2_nsq.fetched_numpy(fetched)
        per_year, nodal, comp_fail, loss_h, n_over, n_infeas = \
            hl2_seq._unpack(v, self.years, self.sys.n_bus, 5)
        if n_over > 0 and lp_used < self.lp_cap:
            self.redo_lp[idx] = min(2 * lp_used, self.lp_cap)
            return True
        if n_over > 0:
            self.redo_lp.pop(idx, None)
            self.consec_over = 0
        elif idx in self.redo_lp:
            self.consec_over += 1
            size = self.redo_lp.pop(idx)
            if self.consec_over >= 3 and size > self.max_lp:
                self.max_lp = size
        else:
            self.consec_over = 0
        self.stats.update_years(*per_year, nodal, comp_fail, loss_h)
        self.overflow += n_over
        self.infeasible += n_infeas
        self.partials.append(v)
        if self.loop.in_window:
            self.window_units += self.years
        self.tap.folded(idx, v)
        return False

    def warm(self, batches: int) -> None:
        self.loop.warm(batches)

    def window(self, seconds: float) -> float:
        self.tap.armed = True
        return self.loop.window(seconds)

    def check_data(self) -> dict:
        """What the reference judges, once the window has closed; drops
        the program's steps and system."""
        kept = self.tap.close()
        s = self.stats
        out = dict(
            study="seq", seed=self.seed, years=self.years, hours=self.hours,
            kept=kept, partials=self.partials, n_bus=self.sys.n_bus,
            overflow=self.overflow,
            indices=dict(eens=s.eens, lole=_mean(s.dlc), lolf=_mean(s.nlc),
                         nodal_eens=(np.zeros(self.sys.n_bus)
                                     if s.sum_nodal is None
                                     else s.nodal_eens())))
        self.steps.clear()
        self.sys = None
        return out
