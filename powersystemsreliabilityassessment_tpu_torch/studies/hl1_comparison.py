"""HL1 three-engine comparison study (the ``run_full_comparison.jl`` /
``PowerSystemAdequacy.jl`` capability).

Port of ``powersystemsreliabilityassessment_tpu/studies/hl1_comparison.py``
on one device: the analytical COPT convolution (``engines/copt.py``), the
non-sequential and the sequential copper-sheet Monte Carlo
(``engines/copper_sheet.py``, ``sampling/chronological.py``) on the same
fleet and load curve, with a comparison table and convergence histories.
Each Monte Carlo batch draws from its own ``torch.Generator``, seeded
from (seed, batch index) as ``hl2_nsq.batch_generator`` seeds a study
batch (the reference folds the batch index into a threefry key). The
batches' sums stay on the device and are read once at the end.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.engines import (
    copper_sheet, copt)
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    batch_generator)


@dataclasses.dataclass(frozen=True)
class GeneratorSpec:
    """HL1 generator (PowerSystemAdequacy.jl Generator struct :20-37);
    mirrors reference ``GeneratorSpec``."""
    id: int
    capacity: float
    mttf: float
    mttr: float

    @property
    def for_rate(self) -> float:
        lam, mu = 1.0 / self.mttf, 1.0 / self.mttr
        return lam / (lam + mu)


@dataclasses.dataclass
class MethodResult:
    """Mirrors reference ``MethodResult``."""
    method: str
    lole_hours_yr: float
    eue_mwh_yr: float
    computation_time: float
    convergence_history: list
    # Each Monte Carlo batch's (LOLE, EUE) means, for the standard errors
    # (not in the reference's result).
    batch_means: list = dataclasses.field(default_factory=list)

    def standard_errors(self) -> tuple[float, float] | None:
        """(LOLE, EUE) standard errors of the means from the batch means
        (equal batches), or None below two batches."""
        if len(self.batch_means) < 2:
            return None
        v = np.asarray(self.batch_means, np.float64)
        se = v.std(0, ddof=1) / np.sqrt(v.shape[0])
        return float(se[0]), float(se[1])


def demo_fleet() -> list[GeneratorSpec]:
    """8-unit demo fleet in the spirit of run_full_comparison.jl:6-16;
    mirrors reference ``demo_fleet``."""
    data = [(1, 200, 1000, 50), (2, 200, 1100, 60), (3, 150, 900, 45),
            (4, 150, 950, 55), (5, 100, 1200, 40), (6, 100, 1150, 50),
            (7, 50, 800, 30), (8, 50, 850, 35)]
    return [GeneratorSpec(*d) for d in data]


def sinusoidal_load(hours: int = 8760, base: float = 600.0,
                    seasonal: float = 200.0, daily: float = 50.0,
                    noise: float = 20.0, seed: int = 0) -> np.ndarray:
    """Seasonal and daily sinusoids plus numpy noise, float32 [hours];
    mirrors reference ``sinusoidal_load`` (the same numbers)."""
    h = np.arange(hours)
    rng = np.random.default_rng(seed)
    load = (base + seasonal * np.sin(2 * np.pi * h / hours)
            + daily * np.sin(2 * np.pi * h / 24)
            + noise * rng.standard_normal(hours))
    return np.maximum(load, 0.0).astype(np.float32)


def _fleet(gens, device):
    caps = torch.tensor([g.capacity for g in gens], dtype=torch.float32,
                        device=device)
    fors = torch.tensor([g.for_rate for g in gens], dtype=torch.float32,
                        device=device)
    return caps, fors


def _running(sums: list, per_batch: int):
    """(mean LOLE, mean EUE, LOLE history, batch means) from device batch
    sums, read on the host once and accumulated in float64."""
    v = torch.stack([torch.stack(p) for p in sums]).cpu().numpy().astype(
        np.float64)
    n = per_batch * np.arange(1, v.shape[0] + 1)
    tot = np.cumsum(v, axis=0)
    return (float(tot[-1, 0] / n[-1]), float(tot[-1, 1] / n[-1]),
            (tot[:, 0] / n).tolist(), (v / per_batch).tolist())


def run_analytical(gens: list[GeneratorSpec], hourly_load: np.ndarray,
                   step: float = 10.0,
                   device: torch.device | str = "cuda") -> MethodResult:
    """COPT convolution (float32, as the reference's call site), then LOLE
    and EUE against the hourly load. Mirrors reference
    ``run_analytical``."""
    t0 = time.time()
    caps, fors = _fleet(gens, "cpu")
    total = float(caps.sum())
    n = copt.grid_points_for(total, step)
    probs = copt.build_copt(caps, fors, step, n, device=device)
    lole, eue = copt.lole_eue(probs, step, total,
                              torch.as_tensor(hourly_load, device=device))
    return MethodResult("Analytical", float(lole), float(eue),
                        time.time() - t0, [])


def run_non_sequential_mc(gens: list[GeneratorSpec], hourly_load: np.ndarray,
                          iterations: int, seed: int = 0, batch: int = 1000,
                          device: torch.device | str = "cuda"
                          ) -> MethodResult:
    """Capacity-sampling Monte Carlo, ``batch`` samples a batch until
    ``iterations`` (rounded up to whole batches); mirrors reference
    ``run_non_sequential_mc`` on one device (PowerSystemAdequacy.jl:
    169-208)."""
    t0 = time.time()
    caps, fors = _fleet(gens, device)
    curve = copper_sheet.LoadCurve.build(hourly_load, device=device)
    sums = []
    for b in range((iterations + batch - 1) // batch):
        lole, eue, _ = copper_sheet.nsq_batch(
            batch_generator(seed, b, device), caps, fors, curve, batch)
        sums.append((lole.sum(), eue.sum()))
    lole_m, eue_m, history, means = _running(sums, batch)
    return MethodResult("Non-Sequential MC", lole_m, eue_m,
                        time.time() - t0, history, means)


def run_sequential_mc(gens: list[GeneratorSpec], hourly_load: np.ndarray,
                      years: int, seed: int = 1, batch: int = 100,
                      device: torch.device | str = "cuda") -> MethodResult:
    """Chronological copper-sheet Monte Carlo, ``batch`` years a batch
    (``sample_timeline_batch``, ``capacity_series_from_down``,
    ``hourly_deficit``); mirrors reference ``run_sequential_mc`` on one
    device (PowerSystemAdequacy.jl:214-269's per-hour countdown)."""
    t0 = time.time()
    caps, _ = _fleet(gens, device)
    mttf = np.asarray([g.mttf for g in gens])
    mttr = np.asarray([g.mttr for g in gens])
    hours = len(hourly_load)
    k = chronological.default_num_draws(mttf, mttr, hours)
    load_d = torch.as_tensor(hourly_load, device=device)
    mttf_d = torch.as_tensor(mttf, dtype=torch.float32, device=device)
    mttr_d = torch.as_tensor(mttr, dtype=torch.float32, device=device)
    sums = []
    for b in range((years + batch - 1) // batch):
        down = chronological.sample_timeline_batch(
            batch_generator(seed, b, device), mttf_d, mttr_d, hours, k,
            batch)
        cap_series = copper_sheet.capacity_series_from_down(down, caps)
        lole, eens, _ = copper_sheet.hourly_deficit(cap_series, load_d)
        sums.append((lole.sum(), eens.sum()))
    lole_m, eens_m, history, means = _running(sums, batch)
    return MethodResult("Sequential MC", lole_m, eens_m, time.time() - t0,
                        history, means)


def compare_results(results: list[MethodResult]) -> str:
    """Comparison table (PowerSystemAdequacy.jl:275-298); mirrors
    reference ``compare_results``."""
    lines = ["=" * 60,
             "       METHOD COMPARISON SUMMARY",
             "=" * 60,
             f"{'Method':<20} | {'LOLE(h/yr)':<10} | {'EUE(MWh)':<10} | "
             f"{'Time(s)':<8}",
             "-" * 60]
    for r in results:
        lines.append(f"{r.method:<20} | {r.lole_hours_yr:<10.4f} | "
                     f"{r.eue_mwh_yr:<10.2f} | {r.computation_time:<8.4f}")
    lines.append("-" * 60)
    return "\n".join(lines)


def run_full_comparison(iterations: int = 5000, years: int = 500,
                        seed: int = 0, out_dir: str | None = None,
                        device: torch.device | str = "cuda"
                        ) -> dict[str, Any]:
    """The run_full_comparison.jl study: the three engines on the demo
    fleet and its sinusoidal load, and the table, plus the convergence /
    comparison figure ``{out_dir}/hl1_comparison.png`` when ``out_dir`` is
    given (PowerSystemAdequacy.jl:275-298); mirrors reference
    ``run_full_comparison``."""
    gens = demo_fleet()
    load = sinusoidal_load(seed=seed)
    results = [
        run_analytical(gens, load, device=device),
        run_non_sequential_mc(gens, load, iterations, seed=seed,
                              device=device),
        run_sequential_mc(gens, load, years, seed=seed + 1, device=device),
    ]
    print(compare_results(results))
    if out_dir is not None:
        from powersystemsreliabilityassessment_tpu_torch.utils import report
        os.makedirs(out_dir, exist_ok=True)
        report.plot_hl1_comparison(
            results, os.path.join(out_dir, "hl1_comparison.png"))
    return {r.method: dataclasses.asdict(r) for r in results}
