"""Planning-feature studies: maintenance + LFU + energy-limited units.

Port of ``powersystemsreliabilityassessment_tpu/studies/planning_elu.py``,
which covers three reference drivers:

* ``generating_adequacy_comprehensive.jl``: the full planning pipeline,
  maintenance scheduling, the iterative ELU q-update and the weekly-COPT
  hourly risk;
* ``MCvsMarkovProcess.jl`` / ``generating_adequancy_comparative.jl``:
  analytical-with-ELU against explicit-energy-state Monte Carlo, with
  the "< 20% difference" gate (MCvsMarkovProcess.jl:330-335);
* ``tail_risk.jl``: the annual-LOLE distribution against the analytical
  mean, with VaR / CVaR tail metrics.

Every entry point runs on the card unless the caller passes
``device="cpu"``. The Monte Carlo draws come from
``hl2_nsq.batch_generator(seed, 0, device)`` in place of the reference's
``jax.random.key(seed)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.engines import elu as elu_mod
from powersystemsreliabilityassessment_tpu_torch.engines import planning
from powersystemsreliabilityassessment_tpu_torch.engines.planning import (
    PlanningFleet)
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    batch_generator)


def demo_planning_fleet(hydro_hours: float = 600.0) -> PlanningFleet:
    """The 6-unit planning fleet (MCvsMarkovProcess.jl:295-306);
    ``hydro_hours=50`` is tail_risk.jl's water-shortage variant. Mirrors
    reference ``demo_planning_fleet``."""
    return PlanningFleet(
        names=["Nuclear", "Coal_A", "Coal_B", "Gas", "Hydro_ELU", "Old_56"],
        capacity=np.array([400.0, 300.0, 300.0, 150.0, 200.0, 56.0]),
        for_rate=np.array([0.02, 0.04, 0.04, 0.05, 0.01, 0.10]),
        maint_weeks=np.array([4, 3, 3, 2, 2, 0]),
        energy_limit=np.array([np.inf, np.inf, np.inf, np.inf,
                               200.0 * hydro_hours, np.inf]),
    )


def demo_planning_load(hours: int = 8760, seed: int = 0) -> np.ndarray:
    """Load curve of the planning demos (MCvsMarkovProcess.jl:309-311),
    numpy ``default_rng``: the reference's numbers. Mirrors reference
    ``demo_planning_load``."""
    h = np.arange(1, hours + 1)
    rng = np.random.default_rng(seed)
    load = (750.0 + 300.0 * np.sin((h - 2000) / hours * 2 * np.pi)
            + 50.0 * rng.standard_normal(hours))
    return np.maximum(load, 0.0)


def weekly_peaks_of(load: np.ndarray) -> np.ndarray:
    """Peak of each of 52 168-hour weeks; mirrors reference
    ``weekly_peaks_of``."""
    n_weeks = 52
    return np.array([load[w * 168: min((w + 1) * 168, len(load))].max()
                     for w in range(n_weeks)])


@dataclasses.dataclass
class PlanningResult:
    """Mirrors reference ``PlanningResult``."""
    maint_start: np.ndarray
    effective_q: np.ndarray
    q_history: list
    hourly_risk: np.ndarray
    lole_hr_yr: float

    def to_dict(self) -> dict[str, Any]:
        return {
            "maint_start": self.maint_start.tolist(),
            "effective_q": self.effective_q.tolist(),
            "q_history": [q.tolist() for q in self.q_history],
            "lole_hr_yr": self.lole_hr_yr,
        }


def run_planning_analytical(fleet: PlanningFleet, load: np.ndarray,
                            step: float = 20.0,
                            lfu_sigma_percent: float = 5.0,
                            elu_iters: int = 5,
                            device: torch.device | str = "cuda"
                            ) -> PlanningResult:
    """The analytical planning pipeline (comprehensive.jl main loop):
    schedule, ELU fixed point, weekly hourly risk. Mirrors reference
    ``run_planning_analytical``."""
    lfu_mw = float(load.max()) * lfu_sigma_percent / 100.0
    planning.schedule_maintenance(fleet, weekly_peaks_of(load))
    planning.iterate_elu(fleet, load, lfu_mw, step, elu_iters, device)
    risk = planning.weekly_hourly_risk(fleet, load, lfu_mw, step, device)
    return PlanningResult(
        maint_start=fleet.maint_start.copy(),
        effective_q=fleet.effective_q.copy(),
        q_history=list(fleet.q_history),
        hourly_risk=risk,
        lole_hr_yr=float(risk.sum()),
    )


@dataclasses.dataclass
class ELUComparisonResult:
    """Mirrors reference ``ELUComparisonResult``."""
    analytical_lole: float
    mc_lole: float
    diff_percent: float
    success: bool                  # < 20% gate, MCvsMarkovProcess.jl:330
    mc_yearly_distribution: np.ndarray
    mc_hourly_profile: np.ndarray
    analytical_hourly_profile: np.ndarray
    var95: float
    cvar95: float

    def to_dict(self) -> dict[str, Any]:
        return {
            "analytical_lole": self.analytical_lole,
            "mc_lole": self.mc_lole,
            "diff_percent": self.diff_percent,
            "success": self.success,
            "var95": self.var95,
            "cvar95": self.cvar95,
        }


def run_elu_comparison(fleet: PlanningFleet | None = None,
                       load: np.ndarray | None = None,
                       mc_years: int = 1000, step: float = 20.0,
                       lfu_sigma_percent: float = 5.0,
                       seed: int = 0,
                       device: torch.device | str = "cuda"
                       ) -> ELUComparisonResult:
    """Analytical-with-ELU against energy-state Monte Carlo
    (MCvsMarkovProcess.jl run_comparison / tail_risk.jl pipeline).
    Mirrors reference ``run_elu_comparison``."""
    fleet = fleet if fleet is not None else demo_planning_fleet()
    load = load if load is not None else demo_planning_load()
    lfu_mw = float(load.max()) * lfu_sigma_percent / 100.0

    ana = run_planning_analytical(fleet, load, step, lfu_sigma_percent,
                                  device=device)
    lole_y, hourly = elu_mod.run_elu_mc(
        batch_generator(seed, 0, device), fleet.capacity, fleet.for_rate,
        fleet.maint_start, fleet.maint_weeks,
        np.where(np.isfinite(fleet.energy_limit), fleet.energy_limit,
                 np.inf), load, lfu_mw, mc_years)
    var95, cvar95 = elu_mod.var_cvar(lole_y, 0.95)
    lole_y = lole_y.cpu().numpy()
    mc_lole = float(lole_y.mean())
    diff = abs(mc_lole - ana.lole_hr_yr) / max(ana.lole_hr_yr, 1e-12) * 100
    return ELUComparisonResult(
        analytical_lole=ana.lole_hr_yr,
        mc_lole=mc_lole,
        diff_percent=diff,
        success=diff < 20.0,
        mc_yearly_distribution=lole_y,
        mc_hourly_profile=hourly.cpu().numpy(),
        analytical_hourly_profile=ana.hourly_risk,
        var95=float(var95),
        cvar95=float(cvar95),
    )


def run_tail_risk_study(mc_years: int = 2000, seed: int = 0,
                        device: torch.device | str = "cuda"
                        ) -> ELUComparisonResult:
    """tail_risk.jl's variant: a 50-hour hydro energy limit exposes the
    gap between the analytical mean and the heavy-tailed Monte Carlo
    distribution. Mirrors reference ``run_tail_risk_study``."""
    return run_elu_comparison(demo_planning_fleet(hydro_hours=50.0),
                              mc_years=mc_years, seed=seed, device=device)
