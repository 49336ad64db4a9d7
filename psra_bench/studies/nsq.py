"""Non-sequential (NSQ) study driver: the port's batch step under its own
host loop and accumulator, stopped by a clock.

Set-up is ``run_nsq_study``'s for plain Monte Carlo: ``build_system``,
the shed-hint calibration, ``default_max_lp`` for the traffic's nodal
mode, ``make_nsq_batch_step``. The loop body is a frozen copy of the
study's ``consume`` (grow the LP buffer and redo the batch on overflow,
else fold the batch into ``RunningStats``) without checkpoints and
logging, because the study itself stops only at a sample count or a
convergence target.

Traffic keys: ``batch`` (states a batch), ``nodal_mode`` ("lp" or
"proportional"), ``max_lp`` (LP lanes; null: the study's default),
``warm_batches``, ``check_batches`` (batches whose every state the
reference judges), ``trace_start`` / ``trace_steps``.
"""
from __future__ import annotations

import numpy as np

from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.parallel import accumulators
from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)

from psra_bench.studies.common import Loop, case_data, compat_flags
from psra_bench.tap import Tap

RATE_METRIC = "nsq_states_per_s"


class Driver:
    """One NSQ study of the configuration ``cfg`` under ``traffic``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.seed = seed
        self.compat = compat_flags(cfg)
        self.ipm = IPMConfig()
        self.sys = build_system(case_data(cfg), self.compat, device)
        B = self.batch = int(traffic["batch"])
        self.nodal_mode = traffic["nodal_mode"]
        pf_tier = dcopf.default_pf_buffer(self.sys, B) is not None
        self.max_lp = traffic.get("max_lp") or hl2_nsq.default_max_lp(
            B, self.nodal_mode, pf_tier=pf_tier)
        self.lp_cap = min(B, hl2_nsq.PF_TIER_LP_CAP) if pf_tier else B
        hint = dcopf.calibrate_shed_hint(self.sys)
        self.shed_hint = None if hint is None else np.asarray(hint,
                                                             np.float32)
        self.step = self._make_step()
        self.stats = accumulators.RunningStats()
        self.partials: list[np.ndarray] = []
        self.overflow = self.infeasible = self.window_units = 0
        self.tap = Tap(seed, int(traffic["check_batches"]))
        self.loop = Loop(self._dispatch, self._consume, device)

    def _make_step(self):
        return hl2_nsq.make_nsq_batch_step(
            self.sys, self.batch, self.compat, self.ipm, max_lp=self.max_lp,
            nodal_mode=self.nodal_mode, shed_hint=self.shed_hint)

    def _dispatch(self, i: int):
        self.tap.dispatching(i)
        m, n_over, n_infeas = self.step(hl2_nsq.batch_generator(
            self.seed, i, self.sys.device))
        dt = m.sum_dns.dtype
        return i, hl2_nsq.fetch_async(accumulators.pack_moments(
            m, n_over.to(dt), n_infeas.to(dt)))

    def _consume(self, dispatched, next_idx) -> bool:
        idx, fetched = dispatched
        v = hl2_nsq.fetched_numpy(fetched)
        moments, (n_over, n_infeas) = accumulators.unpack_moments(
            v, self.sys.n_bus, 2)
        n_over, n_infeas = int(n_over), int(n_infeas)
        if n_over > 0:
            grown = 2 * self.max_lp
            if grown <= self.lp_cap:
                self.max_lp = grown
                self.step = self._make_step()
                return True
            self.overflow += n_over
        self.infeasible += n_infeas
        self.stats.update(moments)
        self.partials.append(v)
        if self.loop.in_window:
            self.window_units += self.batch
        self.tap.folded(idx, v)
        return False

    def warm(self, batches: int) -> None:
        self.loop.warm(batches)

    def window(self, seconds: float) -> float:
        self.tap.armed = True
        return self.loop.window(seconds)

    def check_data(self) -> dict:
        """What the reference judges, once the window has closed; drops
        the program's step and system."""
        kept = self.tap.close()
        s = self.stats
        hours = self.compat.hours_per_year_annualize
        out = dict(
            study="nsq", seed=self.seed, kept=kept, partials=self.partials,
            n_bus=self.sys.n_bus, overflow=self.overflow, annualize=hours,
            indices=dict(edns=s.edns, plc=s.plc, lole=s.lole(hours),
                         nodal_eens=(np.zeros(self.sys.n_bus)
                                     if s.sum_nodal is None
                                     else s.nodal_eens(hours))))
        self.step = self.sys = None
        return out
