"""What both study drivers share: the program's inputs made from a
configuration file, and the timed loop around the port's host loop."""
from __future__ import annotations

import time

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core.cases import CaseData
from powersystemsreliabilityassessment_tpu_torch.runtime.host_loop import (
    double_buffered_loop)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags)


def case_data(cfg: dict) -> CaseData:
    """The program's ``CaseData`` holding the configuration file's case."""
    c = cfg["case"]
    f = lambda k: np.asarray(c[k], np.float64)  # noqa: E731
    i = lambda k: np.asarray(c[k], np.int32)    # noqa: E731
    area = c.get("bus_area")
    return CaseData(
        name=cfg["name"], base_mva=float(c["base_mva"]), bus_pd=f("bus_pd"),
        bus_qd=f("bus_qd"), gen_bus=i("gen_bus"), gen_pmax=f("gen_pmax"),
        gen_pmin=f("gen_pmin"), gen_mttf=f("gen_mttf"),
        gen_mttr=f("gen_mttr"), gen_maint_weeks=f("gen_maint_weeks"),
        br_from=i("br_from"), br_to=i("br_to"), br_x=f("br_x"),
        br_rate=f("br_rate"), br_lambda=f("br_lambda"), br_dur=f("br_dur"),
        bus_area=None if area is None else np.asarray(area, np.int64))


def compat_flags(cfg: dict) -> CompatFlags:
    """The study's thresholds and options as the configuration states."""
    s = cfg["study"]
    return CompatFlags(**{k: s[k] for k in (
        "dns_noise_floor_mw", "nsq_fail_flag_threshold_mw",
        "seq_curtail_threshold_mw", "nodal_noise_threshold_mw",
        "hours_per_year_seq", "hours_per_year_annualize",
        "sync_cond_always_up_nsq", "enforce_pmin", "weekday_mode")})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """Runs a driver's ``dispatch`` / ``consume`` through the port's
    double-buffered host loop: first ``warm`` batches, then a window that
    stops dispatching at a clock. Batch indices continue across both, as
    one study's do. ``on_dispatch(k)`` is called before the window's k-th
    dispatch (redos included)."""

    def __init__(self, dispatch, consume, device):
        self.dispatch, self.consume, self.device = dispatch, consume, device
        self.next_idx = 0
        self.in_window = False
        self.window_dispatches = 0
        self.on_dispatch = None

    def _dispatch(self, i):
        if self.in_window:
            if self.on_dispatch is not None:
                self.on_dispatch(self.window_dispatches)
            self.window_dispatches += 1
        return self.dispatch(i)

    def warm(self, batches: int) -> None:
        start = self.next_idx
        self.next_idx = double_buffered_loop(
            self._dispatch, self.consume, lambda i: i < start + batches,
            start_idx=start)
        sync(self.device)

    def window(self, seconds: float) -> float:
        """Run for ``seconds``; the window's length, from its first
        dispatch to the sync of its last folded batch."""
        self.in_window = True
        t0 = time.perf_counter()
        end = t0 + seconds
        self.next_idx = double_buffered_loop(
            self._dispatch, self.consume,
            lambda i: time.perf_counter() < end, start_idx=self.next_idx)
        sync(self.device)
        t1 = time.perf_counter()
        self.in_window = False
        return t1 - t0
