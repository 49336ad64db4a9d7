"""HL1 "copper sheet" evaluators: generation against load, no network.

Port of ``powersystemsreliabilityassessment_tpu/engines/copper_sheet.py``:

* the non-sequential year (PowerSystemAdequacy.jl:169-208): a sample's
  available capacity against the whole hourly load curve, as one
  ``searchsorted`` in the sorted curve and a suffix-sum lookup
  (``LoadCurve``, ``annual_indices_from_capacity``, ``nsq_batch``), an
  exact reformulation of the hour sweep;
* the sequential year (PowerSystemAdequacy.jl:214-269): the hourly
  deficit of a chronological capacity series (the series from
  ``sampling/chronological.py``), and the ``calnlc`` frequency count
  (Montecarlo_seq/calnlc.m:22-34).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LoadCurve(NamedTuple):
    """An hourly load prepared for O(log H) adequacy lookups; mirrors
    reference ``engines/copper_sheet.py::LoadCurve`` without its 128-
    padding of the suffix table."""
    hourly: torch.Tensor      # [H] chronological order
    sorted: torch.Tensor      # [H] ascending
    suffix_sum: torch.Tensor  # [H + 1]; suffix_sum[i] = sum(sorted[i:])

    @staticmethod
    def build(hourly_load, device: torch.device | str = "cuda"
              ) -> "LoadCurve":
        """The curve of ``hourly_load`` on ``device`` (the card unless the
        caller asks for the CPU)."""
        hourly = torch.as_tensor(hourly_load, device=device)
        s = torch.sort(hourly).values
        suffix = torch.cat([torch.flip(torch.cumsum(torch.flip(s, [0]), 0),
                                       [0]), s.new_zeros(1)])
        return LoadCurve(hourly=hourly, sorted=s, suffix_sum=suffix)


def annual_indices_from_capacity(cap: torch.Tensor, curve: LoadCurve):
    """``(lole_hours, eue_mwh)`` of a constant available capacity ``cap``
    (any shape) over the curve: lole = #{h: load_h > cap}, eue = the sum
    over those hours of load_h - cap (PowerSystemAdequacy.jl:186-197).
    Mirrors reference
    ``engines/copper_sheet.py::annual_indices_from_capacity``; the
    insertion index is ``searchsorted(right=True)``, the count of sorted
    loads <= cap, which equals the reference's compare-and-count."""
    h = curve.sorted.shape[0]
    idx = torch.searchsorted(curve.sorted, cap.contiguous(), right=True)
    count = (h - idx).to(curve.sorted.dtype)
    return count, curve.suffix_sum[idx] - count * cap


def nsq_uniforms(generator: torch.Generator, n_units: int, batch: int,
                 device: torch.device | str = "cuda") -> torch.Tensor:
    """float32 [batch, n_units] uniforms in [0, 1): the draw of
    :func:`nsq_batch` (the reference's ``jax.random.uniform(key, (batch,
    n))``)."""
    return torch.rand((batch, n_units), generator=generator, device=device,
                      dtype=torch.float32)


def nsq_batch_from_uniforms(u: torch.Tensor, capacities: torch.Tensor,
                            for_rates: torch.Tensor, curve: LoadCurve):
    """The construction of :func:`nsq_batch` from its uniforms ``u``: unit
    i is up where u >= its forced-outage rate; returns per sample
    ``(lole_hours [B], eue [B], cap [B])``."""
    up = u >= for_rates[None, :]
    cap = up.to(capacities.dtype) @ capacities
    lole, eue = annual_indices_from_capacity(cap, curve)
    return lole, eue, cap


def nsq_batch(generator: torch.Generator, capacities: torch.Tensor,
              for_rates: torch.Tensor, curve: LoadCurve, batch: int):
    """One NSQ Monte Carlo batch: i.i.d. unit states, each sample's whole
    year. Returns per sample ``(lole_hours [B], eue [B], cap [B])`` on
    ``capacities``' device (the generator's). Mirrors reference
    ``engines/copper_sheet.py::nsq_batch``: :func:`nsq_uniforms`, then
    :func:`nsq_batch_from_uniforms`."""
    u = nsq_uniforms(generator, capacities.shape[0], batch,
                     capacities.device)
    return nsq_batch_from_uniforms(u, capacities, for_rates, curve)


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
