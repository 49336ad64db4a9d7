"""HL1 generation adequacy on IEEE RTS-24 (BASELINE config 1).

Port of ``powersystemsreliabilityassessment_tpu/studies/hl1_rts24.py``:
copper-sheet (no network) adequacy of the RTS-24 generation fleet against
the RTS-79 chronological load curve by all three engines of
``studies/hl1_comparison.py`` (analytical COPT, non-sequential and
sequential Monte Carlo), on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core import (
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.studies import (
    hl1_comparison)


def rts24_fleet() -> list[hl1_comparison.GeneratorSpec]:
    """RTS-24's units with capacity (the sync condenser left out);
    mirrors reference ``hl1_rts24.rts24_fleet``."""
    case = cases.rts24()
    return [
        hl1_comparison.GeneratorSpec(i + 1, float(case.gen_pmax[i]),
                                     float(case.gen_mttf[i]),
                                     float(case.gen_mttr[i]))
        for i in range(case.n_gen) if case.gen_pmax[i] > 0
    ]


def rts24_load(hours: int = 8736) -> np.ndarray:
    """The RTS-79 hourly system load, MW, float32 [hours]; mirrors
    reference ``hl1_rts24.rts24_load``."""
    return (load_profile.PEAK_MW
            * load_profile.load_factors(hours)).astype(np.float32)


def run(iterations: int = 20000, years: int = 2000, seed: int = 0,
        device: torch.device | str = "cuda") -> dict:
    """The three engines on RTS-24 (the card unless the caller passes
    ``device="cpu"``): ``{method: {"lole", "eue", "se"}}``, ``se`` the
    Monte Carlo methods' (LOLE, EUE) standard errors from their batch
    means (None for the analytical one). Mirrors reference
    ``hl1_rts24.run``, which returns no ``se``."""
    gens = rts24_fleet()
    load = rts24_load()
    results = [
        hl1_comparison.run_analytical(gens, load, step=1.0, device=device),
        hl1_comparison.run_non_sequential_mc(gens, load, iterations,
                                             seed=seed, device=device),
        hl1_comparison.run_sequential_mc(gens, load, years, seed=seed + 1,
                                         device=device),
    ]
    print(hl1_comparison.compare_results(results))
    return {r.method: {"lole": r.lole_hours_yr, "eue": r.eue_mwh_yr,
                       "se": r.standard_errors()} for r in results}
