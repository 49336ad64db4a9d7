"""Generation-planning features on top of the COPT engine.

Port of ``powersystemsreliabilityassessment_tpu/engines/planning.py``:

* maintenance scheduling by reserve levelization
  (``generating_adequacy_comprehensive.jl:86-112`` /
  ``MCvsMarkovProcess.jl:44-71``): greedy largest-burden-first placement
  of each unit's maintenance window to maximize the minimum weekly
  reserve. Host numpy, copied: a 52 x units search run once a study;
* the iterative energy-limited-unit (ELU) effective-FOR adjustment
  (``generating_adequacy_comprehensive.jl:118-175``,
  ``MCvsMarkovProcess.jl:116-164``): the expected energy the rest of the
  system's COPT demands of the unit under the 7-point LFU mixture; any
  excess over the energy limit becomes an additive unavailability;
* the weekly-COPT hourly risk profile with maintenance and LFU
  (``generating_adequacy_comprehensive.jl:181-271``).

The tables are built by ``engines/copt.py`` on the caller's device (the
card unless the caller passes ``device="cpu"``); the fixed-point loop
and the fleet stay on the host, which reads one [14] vector of sums a
unit and pass.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.engines import copt

HOURS_PER_WEEK = 168
N_WEEKS = 52


@dataclasses.dataclass
class PlanningFleet:
    """Host-side fleet description for planning studies; mirrors
    reference ``engines/planning.py::PlanningFleet``."""
    names: list
    capacity: np.ndarray        # [G] MW
    for_rate: np.ndarray        # [G] base mechanical FOR (q)
    maint_weeks: np.ndarray     # [G] int weeks/yr
    energy_limit: np.ndarray    # [G] MWh, inf if unlimited
    # planning state
    effective_q: np.ndarray = None
    maint_start: np.ndarray = None  # [G] 1-based start week, 0 = none
    q_history: list = None

    def __post_init__(self):
        if self.effective_q is None:
            self.effective_q = np.asarray(self.for_rate, np.float64).copy()
        if self.maint_start is None:
            self.maint_start = np.zeros(len(self.capacity), np.int32)
        if self.q_history is None:
            self.q_history = [self.effective_q.copy()]

    @property
    def n(self) -> int:
        return len(self.capacity)


def schedule_maintenance(fleet: PlanningFleet,
                         weekly_peaks: np.ndarray) -> np.ndarray:
    """Greedy reserve-levelization schedule; fills ``fleet.maint_start``.
    Largest capacity x weeks burden first; each unit takes the window
    maximizing the minimum weekly reserve (comprehensive.jl:86-112).
    Mirrors reference ``engines/planning.py::schedule_maintenance``."""
    total = float(fleet.capacity.sum())
    avail = np.full(N_WEEKS, total)
    order = np.argsort(-(fleet.capacity * fleet.maint_weeks))
    for g in order:
        w = int(fleet.maint_weeks[g])
        if w <= 0:
            continue
        best_start, best_res = 1, -np.inf
        for start in range(1, N_WEEKS - w + 2):
            window = slice(start - 1, start - 1 + w)
            min_res = float(np.min(avail[window] - weekly_peaks[window]))
            if min_res > best_res:
                best_res, best_start = min_res, start
        fleet.maint_start[g] = best_start
        avail[best_start - 1: best_start - 1 + w] -= fleet.capacity[g]
    return fleet.maint_start


def maintenance_mask(fleet: PlanningFleet) -> np.ndarray:
    """[52, G] bool: unit on maintenance during the week (1-based
    weeks). Mirrors reference ``engines/planning.py::maintenance_mask``."""
    weeks = np.arange(1, N_WEEKS + 1)[:, None]
    start = fleet.maint_start[None, :]
    return ((start > 0) & (weeks >= start)
            & (weeks < start + fleet.maint_weeks[None, :]))


def expected_elu_energy(fleet: PlanningFleet, unit: int,
                        base_load: np.ndarray, lfu_sigma_mw: float,
                        step: float,
                        device: torch.device | str = "cuda") -> float:
    """Expected energy demanded of ``unit`` by the rest of the system's
    COPT, E = sum_h sum_z p_z E[min(C_unit, max(0, Outage_rest -
    reserve_hz))] (MCvsMarkovProcess.jl:129-147), exact with suffix sums:
    E[min(C, (X - r)+)] = E[(X - r)+] - E[(X - (r + C))+]. Mirrors
    reference ``engines/planning.py::expected_elu_energy``.

    The reference sums each of its 14 shifted load curves and reads each
    sum; here the 14 curves are one [14, H] pass on ``device`` and one
    read. The float32 shifts and sums are the reference's; the mixture
    is combined on the host in float64, in the reference's order."""
    others = np.arange(fleet.n) != unit
    caps = torch.as_tensor(fleet.capacity[others], dtype=torch.float32)
    qs = torch.as_tensor(fleet.effective_q[others], dtype=torch.float32)
    total_rest = float(fleet.capacity[others].sum())
    n_pts = copt.grid_points_for(total_rest, step)
    probs = copt.build_copt(caps, qs, step, n_pts, device=device)
    s = copt.summarize(probs, step)
    load = torch.as_tensor(np.asarray(base_load), dtype=torch.float32,
                           device=device)
    cap_u = float(fleet.capacity[unit])
    shifts = [float(z) * lfu_sigma_mw for z in copt.LFU_POINTS]
    # Row 2i: reserve at the load shifted by z_i sigma; row 2i + 1: the
    # reserve plus the unit's capacity (the load less C).
    shift_t = torch.tensor([v for sh in shifts for v in (sh, sh - cap_u)],
                           dtype=torch.float32, device=device)
    _, eue = copt.risk_at_loads(s, total_rest, load[None, :]
                                + shift_t[:, None], step)
    sums = eue.sum(1).cpu().numpy()
    total = 0.0
    for i, w in enumerate(copt.LFU_PROBS):
        total += w * (float(sums[2 * i]) - float(sums[2 * i + 1]))
    return total


def update_elu(fleet: PlanningFleet, base_load: np.ndarray,
               lfu_sigma_mw: float, step: float, hours: int | None = None,
               device: torch.device | str = "cuda") -> bool:
    """One ELU effective-q update pass; True if any q changed:
    q_eff = q_base + max(0, E_required - E_limit) / (C hours)
    (MCvsMarkovProcess.jl:149-159). Mirrors reference
    ``engines/planning.py::update_elu``."""
    hours = hours or len(base_load)
    changed = False
    for g in range(fleet.n):
        if not np.isfinite(fleet.energy_limit[g]):
            continue
        e_req = expected_elu_energy(fleet, g, base_load, lfu_sigma_mw, step,
                                    device)
        new_q = float(fleet.for_rate[g])
        if e_req > fleet.energy_limit[g]:
            new_q += (e_req - fleet.energy_limit[g]) / (
                fleet.capacity[g] * hours)
        new_q = min(new_q, 1.0)
        if abs(new_q - fleet.effective_q[g]) > 1e-5:
            fleet.effective_q[g] = new_q
            changed = True
    fleet.q_history.append(fleet.effective_q.copy())
    return changed


def iterate_elu(fleet: PlanningFleet, base_load: np.ndarray,
                lfu_sigma_mw: float, step: float, iters: int = 5,
                device: torch.device | str = "cuda") -> None:
    """Fixed-point ELU iteration (5 passes, MCvsMarkovProcess.jl:166-169).
    Mirrors reference ``engines/planning.py::iterate_elu``."""
    for i in range(iters):
        if not update_elu(fleet, base_load, lfu_sigma_mw, step,
                          device=device) and i > 0:
            break


def weekly_hourly_risk(fleet: PlanningFleet, base_load: np.ndarray,
                       lfu_sigma_mw: float, step: float,
                       device: torch.device | str = "cuda") -> np.ndarray:
    """Hourly LOLP profile [H] under per-week maintenance COPTs and the
    LFU mixture; LOLE = profile.sum(). Mirrors reference
    ``engines/planning.py::weekly_hourly_risk``.

    A deliberate difference in form, not in value: the reference builds
    the 52 weekly tables by a vmap of ``build_copt`` with each unit's
    capacity set to zero in its maintenance weeks. Here the 52 tables are
    one [52, n] shift-and-add a unit, with the unit's q set to 0 in its
    maintenance weeks: a q = 0 step and a zero-capacity step both leave a
    table as it was (up to one float32 rounding of (1 - q) p + q p), and
    the shift stays one host-known integer a unit. Every hour then reads
    its week's suffix table under the 7-point LFU mixture, as one [7, H]
    pass."""
    H = len(base_load)
    mask = maintenance_mask(fleet)                          # [52, G]
    caps = torch.as_tensor(fleet.capacity, dtype=torch.float32)
    q_w = torch.as_tensor(np.where(mask, 0.0, fleet.effective_q[None, :]),
                          dtype=torch.float32, device=device)
    total_cap = float(fleet.capacity.sum())
    n = copt.grid_points_for(total_cap, step)
    probs = torch.zeros(N_WEEKS, n, dtype=torch.float32, device=device)
    probs[:, 0] = 1.0
    for u in range(fleet.n):
        ratio = caps[u] / step                   # float32, as build_copt
        k_low = int(torch.floor(ratio))
        alpha = ratio - k_low
        qq = q_w[:, u:u + 1]
        probs = ((1.0 - qq) * probs
                 + qq * (1.0 - alpha) * copt._shift(probs, k_low)
                 + qq * alpha * copt._shift(probs, k_low + 1))
    s0 = copt.summarize(probs, step).suffix_prob           # [52, n + 1]
    # Installed capacity a week: integer-MW sums, exact in float32.
    installed_w = torch.as_tensor(
        fleet.capacity[None, :] * (~mask), dtype=torch.float32,
        device=device).sum(1)                              # [52]
    week_of_hour = torch.as_tensor(
        np.minimum(np.arange(H) // HOURS_PER_WEEK, N_WEEKS - 1),
        device=device)
    load = torch.as_tensor(np.asarray(base_load), dtype=torch.float32,
                           device=device)
    pts = torch.as_tensor(copt.LFU_POINTS, dtype=torch.float32,
                          device=device)
    ws = torch.as_tensor(copt.LFU_PROBS, dtype=torch.float32, device=device)
    sigma = torch.tensor(lfu_sigma_mw, dtype=torch.float32, device=device)
    reserve = installed_w[week_of_hour][None, :] - (
        load[None, :] + (pts * sigma)[:, None])            # [7, H]
    idx = torch.clamp(torch.floor(reserve / step).to(torch.int64) + 1, 0, n)
    risk = (ws[:, None] * s0[week_of_hour[None, :], idx]).sum(0)
    return risk.cpu().numpy()
