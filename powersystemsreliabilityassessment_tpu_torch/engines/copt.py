"""Analytical capacity-outage probability table (COPT) engines.

Port of ``powersystemsreliabilityassessment_tpu/engines/copt.py``: the
recursive unit-addition convolution on a fixed MW grid, each unit a
shift-and-add of the table.

* probability convolution with the capacity-rounding interpolation
  (``generating_adequacy_assessment.jl:30-107``,
  ``PowerSystemAdequacy.jl:67-111``,
  ``generating_adequacy_comprehensive.jl:34-70``);
* the frequency-extended recursion on cumulative tables
  F_new(X) = p F(X) + q F(X-C) + lambda p [P(X-C) - P(X)]
  (``generating_adequacy_frequency.jl:110-148``);
* LOLE / EUE against a load curve
  (``generating_adequacy_assessment.jl:113-146``) and LOLE / LOLF / LOLD
  from cumulative P / F tables (``generating_adequacy_frequency.jl:155-186``);
* the 7-point discretized-normal load-forecast-uncertainty mixture
  (``generating_adequacy_comprehensive.jl:76-80``), as one batched pass.

Two halves: float64 numpy (``build_copt_np``, ``copper_cv_means``: the
control variate's exact means, which must not inject bias) and torch
(the rest), on the tensors' device. The reference's 128-padding of the
lookup tables and its dynamic-slice shift work around TPU compile times
and are not ported: a shift here is a slice of a filled copy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# 7-step discretized normal: (sigma multiple, probability)
# (generating_adequacy_comprehensive.jl:76-80)
LFU_POINTS = np.array([-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0])
LFU_PROBS = np.array([0.006, 0.061, 0.242, 0.382, 0.242, 0.061, 0.006])


def grid_points_for(total_capacity: float, step: float) -> int:
    """Grid points covering 0 .. total_capacity at ``step``. Mirrors
    reference ``engines/copt.py::grid_points_for``."""
    return int(np.ceil(total_capacity / step)) + 1


def _shift(p: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """``p`` shifted right by ``k`` grid slots along its last axis:
    out[..., i] = p[..., i - k], ``fill`` below 0."""
    n = p.shape[-1]
    k = min(max(k, 0), n)
    return torch.cat([p.new_full((*p.shape[:-1], k), fill), p[..., :n - k]],
                     dim=-1)


def build_copt(capacities, q, step: float, n_points: int,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """Exact-probability COPT: P[Outage = i step] for i < ``n_points``, in
    the dtype of ``capacities`` (float32 at the reference's call sites),
    on ``device`` (the card unless the caller asks for the CPU). Mirrors
    reference ``engines/copt.py::build_copt``.

    A capacity off the grid splits its outage between the two adjacent
    slots with weights (1 - alpha, alpha) (the reference's rounding
    interpolation, generating_adequacy_assessment.jl:91-104). Each unit
    is one shift-and-add; the shifts are read from the host copy of the
    capacities, so the loop enqueues work without waiting for the
    device."""
    caps = torch.as_tensor(capacities)
    dt = caps.dtype if caps.is_floating_point() else torch.float32
    caps_h = caps.detach().cpu().to(dt)
    q_h = torch.as_tensor(q).detach().cpu().to(dt)
    q_d = q_h.to(device)
    probs = torch.zeros(n_points, dtype=dt, device=device)
    probs[0] = 1.0
    for u in range(caps_h.shape[0]):
        ratio = caps_h[u] / step                  # in the table's dtype
        k_low = int(torch.floor(ratio))
        alpha = ratio - k_low
        qq = q_d[u]
        probs = ((1.0 - qq) * probs
                 + qq * (1.0 - alpha) * _shift(probs, k_low)
                 + qq * alpha * _shift(probs, k_low + 1))
    return probs


def build_copt_fd(capacities, q, lam_per_yr, step: float, n_points: int,
                  device: torch.device | str = "cuda"):
    """Frequency & duration COPT on cumulative tables: ``(cum_prob,
    cum_freq)``, P[Outage >= i step] and the cumulative frequency F[Outage
    >= i step] in occurrences a year, with P(>= negative) = 1 and
    F(>= negative) = 0 (generating_adequacy_frequency.jl:93-99). Each
    capacity convolves at its nearest grid multiple. Mirrors reference
    ``engines/copt.py::build_copt_fd``."""
    caps = torch.as_tensor(capacities)
    dt = caps.dtype if caps.is_floating_point() else torch.float32
    caps_h = caps.detach().cpu().to(dt)
    q_d = torch.as_tensor(q).to(device=device, dtype=dt)
    lam_d = torch.as_tensor(lam_per_yr).to(device=device, dtype=dt)
    cum_p = torch.zeros(n_points, dtype=dt, device=device)
    cum_p[0] = 1.0
    cum_f = torch.zeros(n_points, dtype=dt, device=device)
    for u in range(caps_h.shape[0]):
        k = int(torch.round(caps_h[u] / step))
        qq, lam = q_d[u], lam_d[u]
        p = 1.0 - qq
        p_shift = _shift(cum_p, k, fill=1.0)
        f_shift = _shift(cum_f, k)
        cum_p, cum_f = (p * cum_p + qq * p_shift,
                        p * cum_f + qq * f_shift + lam * p * (p_shift - cum_p))
    return cum_p, cum_f


class COPTSummary(NamedTuple):
    """Suffix sums of a COPT; mirrors reference ``COPTSummary`` without
    its padding (``sentinel`` is the last index, the all-zero slot)."""
    suffix_prob: torch.Tensor   # [..., n + 1] S0[i] = P[Outage >= i step]
    suffix_xprob: torch.Tensor  # [..., n + 1] S1[i] = E[Outage; >= i step]
    sentinel: int               # n: the "beyond the table" slot


def summarize(probs: torch.Tensor, step: float) -> COPTSummary:
    """Suffix sums of ``probs`` along its last axis (a batch of tables
    summarizes row by row); mirrors reference ``engines/copt.py::summarize``
    (no 128-padding)."""
    x = torch.arange(probs.shape[-1], dtype=probs.dtype,
                     device=probs.device) * step
    zero = probs.new_zeros(*probs.shape[:-1], 1)

    def suffix(v):
        return torch.cat([torch.flip(torch.cumsum(torch.flip(v, [-1]), -1),
                                     [-1]), zero], dim=-1)

    return COPTSummary(suffix_prob=suffix(probs),
                       suffix_xprob=suffix(probs * x),
                       sentinel=probs.shape[-1])


def risk_at_loads(summary: COPTSummary, total_capacity, loads, step: float):
    """``(lolp, eue_rate)`` against loads of any shape: lolp = P[Outage >
    reserve], eue_rate = E[(Outage - reserve)+], reserve = capacity -
    load (strict inequality through the floor(reserve / step) + 1 index,
    generating_adequacy_assessment.jl:122-141). Mirrors reference
    ``engines/copt.py::risk_at_loads``."""
    reserve = total_capacity - loads
    idx = torch.clamp(torch.floor(reserve / step).to(torch.int64) + 1, 0,
                      summary.sentinel)
    s0 = summary.suffix_prob[idx]
    return s0, summary.suffix_xprob[idx] - reserve * s0


def expected_excess(summary: COPTSummary, total_capacity, loads,
                    step: float) -> torch.Tensor:
    """sum_h E[(Outage - reserve_h)+], the ELU energy-demand kernel.
    Mirrors reference ``engines/copt.py::expected_excess``."""
    return risk_at_loads(summary, total_capacity, loads, step)[1].sum()


def lole_eue(probs: torch.Tensor, step: float, total_capacity, loads):
    """Annual LOLE (h) and EUE (MWh) of an hourly load vector. Mirrors
    reference ``engines/copt.py::lole_eue``."""
    lolp, eue = risk_at_loads(summarize(probs, step), total_capacity,
                              loads, step)
    return lolp.sum(), eue.sum()


def lole_eue_lfu(probs: torch.Tensor, step: float, total_capacity, loads,
                 lfu_sigma_mw: float):
    """LOLE / EUE under the 7-point load-forecast-uncertainty mixture, the
    seven shifted load curves as one [7, H] pass. Mirrors reference
    ``engines/copt.py::lole_eue_lfu``."""
    s = summarize(probs, step)
    pts = torch.as_tensor(LFU_POINTS, dtype=probs.dtype,
                          device=probs.device)
    ws = torch.as_tensor(LFU_PROBS, dtype=probs.dtype, device=probs.device)
    loads = torch.as_tensor(loads, dtype=probs.dtype, device=probs.device)
    lolp, eue = risk_at_loads(s, total_capacity,
                              loads[None, :] + pts[:, None] * lfu_sigma_mw,
                              step)
    return (ws * lolp.sum(1)).sum(), (ws * eue.sum(1)).sum()


def build_copt_np(capacities_mw: np.ndarray, q: np.ndarray,
                  step: float = 1.0) -> np.ndarray:
    """Host float64 COPT (the recursion of :func:`build_copt`), for the
    control variate's exact means (studies/hl2_nsq.py, hl2_seq.py). For
    integer-MW capacities on a 1 MW grid (every RTS fleet) the table is
    exact: the rounding interpolation never triggers. Mirrors reference
    ``engines/copt.py::build_copt_np``."""
    caps = np.asarray(capacities_mw, np.float64)
    q = np.asarray(q, np.float64)
    n = int(np.ceil(caps.sum() / step)) + 1
    probs = np.zeros(n)
    probs[0] = 1.0
    for cap, qq in zip(caps, q):
        k_low = int(np.floor(cap / step))
        alpha = cap / step - k_low
        new = (1.0 - qq) * probs
        shifted = np.zeros(n)
        shifted[k_low:] = probs[:n - k_low]
        new += qq * (1.0 - alpha) * shifted
        if alpha > 0.0:
            shifted2 = np.zeros(n)
            shifted2[k_low + 1:] = probs[:n - k_low - 1]
            new += qq * alpha * shifted2
        probs = new
    return probs


def copper_cv_means(capacities_mw: np.ndarray, q: np.ndarray,
                    loads_mw: np.ndarray, thresh_mw: float = 0.0,
                    step: float = 1.0):
    """Exact float64 means of the copper-sheet control variates:
    ``(mu_eens, mu_lole, eue_h, lolp_h)`` for an hourly load vector under
    the stationary outage law, with

        eue_h  = E[(Outage - reserve_h)+]        (MWh at 1-hour steps)
        lolp_h = P[Outage > reserve_h + thresh]  (copper deficit > thresh)

    and reserve_h = sum(capacities) - loads_mw[h]. Pass the float32-
    rounded loads the device uses, so both sides see the same values.
    Mirrors reference ``engines/copt.py::copper_cv_means``."""
    probs = build_copt_np(capacities_mw, q, step)
    n = probs.shape[0]
    x = np.arange(n, dtype=np.float64) * step
    s0 = np.concatenate([np.cumsum(probs[::-1])[::-1], [0.0]])
    s1 = np.concatenate([np.cumsum((probs * x)[::-1])[::-1], [0.0]])
    total = float(np.asarray(capacities_mw, np.float64).sum())
    reserve = total - np.asarray(loads_mw, np.float64)
    idx = np.clip(np.floor(reserve / step).astype(np.int64) + 1, 0, n)
    eue_h = s1[idx] - reserve * s0[idx]
    idx2 = np.clip(np.floor((reserve + thresh_mw) / step).astype(np.int64)
                   + 1, 0, n)
    lolp_h = s0[idx2]
    return float(eue_h.sum()), float(lolp_h.sum()), eue_h, lolp_h


def fd_risk(cum_p: torch.Tensor, cum_f: torch.Tensor, step: float,
            total_capacity, peak_load, hours_per_year: float = 8760.0):
    """(LOLE h/yr, LOLF occ/yr, LOLD h/occ) at a constant peak load, from
    the first outage level strictly above the reserve
    (generating_adequacy_frequency.jl:155-186). Mirrors reference
    ``engines/copt.py::fd_risk``."""
    n = cum_p.shape[0]
    reserve = torch.as_tensor(total_capacity - peak_load, dtype=cum_p.dtype,
                              device=cum_p.device)
    idx = torch.clamp(torch.floor(reserve / step).to(torch.int64) + 1, 0,
                      n - 1)
    lole = cum_p[idx] * hours_per_year
    lolf = cum_f[idx]
    lold = torch.where(lolf > 0, lole / lolf, torch.zeros_like(lole))
    return lole, lolf, lold
