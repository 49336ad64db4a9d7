"""Copper-sheet helpers: generation against load, no network.

Port of the SEQ-path parts of
``powersystemsreliabilityassessment_tpu/engines/copper_sheet.py``: the
``calnlc`` frequency count (Montecarlo_seq/calnlc.m:22-34), the
available-capacity series of a chronological DOWN indicator, and its
hourly deficit against a load series (PowerSystemAdequacy.jl:214-269).
The HL1 evaluators (``LoadCurve``, ``annual_indices_from_capacity``,
``nsq_batch``) come with HL1 (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import torch


def hourly_deficit(cap_series: torch.Tensor, hourly_load: torch.Tensor):
    """Chronological deficit ``(lole_hours, eens, deficit_series)`` of an
    available capacity ``cap_series`` [..., H] against ``hourly_load``
    [H]. Mirrors reference ``engines/copper_sheet.py::hourly_deficit``."""
    deficit = torch.clamp_min(hourly_load - cap_series, 0.0)
    lole = (deficit > 0).sum(-1).to(cap_series.dtype)
    return lole, deficit.sum(-1), deficit


def count_curtailment_events(flags: torch.Tensor) -> torch.Tensor:
    """Number of distinct 0 -> 1 events along the last axis
    (calnlc.m:22-34), a series that starts failed counting one. Mirrors
    reference ``engines/copper_sheet.py::count_curtailment_events``."""
    f = flags.to(torch.int32)
    rises = ((f[..., 1:] - f[..., :-1]) == 1).sum(-1)
    return rises + f[..., 0]


def capacity_series_from_down(down: torch.Tensor,
                              capacities: torch.Tensor) -> torch.Tensor:
    """Available capacity series [..., H] from a DOWN indicator [...,
    n_gen, H]. Mirrors reference
    ``engines/copper_sheet.py::capacity_series_from_down``."""
    up = 1.0 - down.to(capacities.dtype)
    return torch.einsum("...gh,g->...h", up, capacities)
