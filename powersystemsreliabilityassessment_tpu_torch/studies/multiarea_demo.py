"""Multi-area interconnected adequacy studies (run_adequacy_assessmentII.jl).

Port of ``powersystemsreliabilityassessment_tpu/studies/multiarea_demo.py``:
the ISOLATED against INTERCONNECTED support-policy comparison on the
reference's two-area demo (AdequacyAssessmentII.jl:256-291: a "rich"
area of 5 x 400 MW and a "poor" one of 5 x 200 MW joined by a 200 MW
tie; interconnection must lower both areas' risk), on any case that
carries a per-bus area assignment (RTS-96's three areas, the N-area
ring of tiled RTS-24s). Every entry point runs on the card unless the
caller passes ``device="cpu"``, or on every rank of a scenario mesh
(``mesh=``, ``parallel/mesh.py``), where rank 0 alone prints the tables.
"""
from __future__ import annotations

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core import (
    cases, load_profile)
from powersystemsreliabilityassessment_tpu_torch.engines import multiarea

POLICIES = (multiarea.ISOLATED, multiarea.INTERCONNECTED)


def demo_system(hours: int = 8760) -> multiarea.MultiAreaSystem:
    """The reference's two-area demo system; mirrors reference
    ``demo_system``."""
    h = np.linspace(0, 2 * np.pi, hours)
    return multiarea.MultiAreaSystem(
        area_names=["Area_Rich", "Area_Poor"],
        gen_capacity=[np.full(5, 400.0), np.full(5, 200.0)],
        gen_mttf=[np.full(5, 1000.0), np.full(5, 900.0)],
        gen_mttr=[np.full(5, 50.0), np.full(5, 60.0)],
        hourly_load=np.stack([1000.0 + 500.0 * np.sin(h),
                              800.0 + 400.0 * np.sin(h)]),
        tie_from=np.array([0], np.int32),
        tie_to=np.array([1], np.int32),
        tie_cap=np.array([200.0]),
    )


def _both_policies(sys, n_years: int, seed: int,
                   device: torch.device | str, mesh=None) -> dict:
    out = {}
    for policy in POLICIES:
        lole, eue = multiarea.run_multiarea_sequential(
            sys, policy, n_years, seed=seed, device=device, mesh=mesh)
        out[policy] = {"lole": lole.tolist(), "eue": eue.tolist()}
    return out


def run_demo(n_years: int = 100, seed: int = 0, hours: int = 8760,
             device: torch.device | str = "cuda", mesh=None) -> dict:
    """Both policies on :func:`demo_system`, with the reference's table;
    mirrors reference ``run_demo``."""
    sys = demo_system(hours)
    results = _both_policies(sys, n_years, seed, device, mesh)
    if mesh is not None and mesh.rank != 0:
        return results
    print("\n=== MULTI-AREA COMPARISON ===")
    print(f"{'Policy':<15} | {'Area':<10} | {'LOLE (h/yr)':>11} | "
          f"{'EUE (MWh/yr)':>12}")
    print("-" * 60)
    for policy, res in results.items():
        for a, name in enumerate(sys.area_names):
            print(f"{policy:<15} | {name:<10} | {res['lole'][a]:>11.2f} | "
                  f"{res['eue'][a]:>12.2f}")
    return results


def case_system(case, hours: int = 8736) -> multiarea.MultiAreaSystem:
    """The HL1.5 view of a case carrying a per-bus area assignment
    (``bus_area``); mirrors reference ``case_system``."""
    if case.bus_area is None:
        raise ValueError(
            f"case {case.name!r} carries no area structure (bus_area is "
            "None / all buses share one MATPOWER area number) — the "
            "multi-area HL1.5 view needs >= 2 areas")
    return multiarea.areas_from_case(case, case.bus_area,
                                     load_profile.load_factors(hours))


def run_case_hl15(case, n_years: int = 50, seed: int = 0,
                  hours: int = 8736, device: torch.device | str = "cuda",
                  mesh=None) -> dict:
    """ISOLATED against INTERCONNECTED on any area-carrying case; mirrors
    reference ``run_case_hl15``."""
    return _both_policies(case_system(case, hours), n_years, seed, device,
                          mesh)


def rts96_three_area_system(hours: int = 8736) -> multiarea.MultiAreaSystem:
    """RTS-96 as three RTS-24 areas with its five published ties (A-B
    aggregates 1,175 MW) and RTS-79 chronological loads an area; mirrors
    reference ``rts96_three_area_system``."""
    return case_system(cases.rts96(), hours)


def ring_system(n_areas: int,
                hours: int = 8736) -> multiarea.MultiAreaSystem:
    """An N-area ring of tiled RTS-24s (two 500 MW ties between
    neighbours); mirrors reference ``ring_system``."""
    return case_system(cases.replicate_case(cases.rts24(), n_areas), hours)


def run_nring_demo(n_areas: int = 4, n_years: int = 50, seed: int = 0,
                   hours: int = 8736, device: torch.device | str = "cuda",
                   mesh=None) -> dict:
    """ISOLATED against INTERCONNECTED on an N-area ring (N > 2); mirrors
    reference ``run_nring_demo``."""
    sys = ring_system(n_areas, hours)
    out = _both_policies(sys, n_years, seed, device, mesh)
    if mesh is not None and mesh.rank != 0:
        return out
    print(f"\n=== {n_areas}-AREA RING ===")
    for policy, res in out.items():
        for a, name in enumerate(sys.area_names):
            print(f"{policy:<15} | {name:<6} | LOLE {res['lole'][a]:8.2f} "
                  f"h/yr | EUE {res['eue'][a]:10.2f} MWh/yr")
    return out


def run_rts96_hl15(n_years: int = 50, seed: int = 0, hours: int = 8736,
                   device: torch.device | str = "cuda", mesh=None) -> dict:
    """Three-area generation adequacy on the RTS-96 topology; mirrors
    reference ``run_rts96_hl15``."""
    return _both_policies(rts96_three_area_system(hours), n_years, seed,
                          device, mesh)
