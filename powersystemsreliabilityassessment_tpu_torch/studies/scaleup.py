"""Scale-up study (BASELINE config 5): larger multi-area systems with
antithetic variance reduction.

Port of ``powersystemsreliabilityassessment_tpu/studies/scaleup.py`` on
one device: the HL2 NSQ study (``studies.hl2_nsq.run_nsq_study``) on an
RTS-96-style tiled system (three RTS-24 areas joined by inter-area ties,
``core/cases.py::replicate_case``) or any builtin / MATPOWER case, by
default with antithetic sampling (paired u, 1 - u uniforms: an exact
variance reduction for monotone state functions). Both entry points run
on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.core import cases
from powersystemsreliabilityassessment_tpu_torch.core.matpower_io import (
    resolve_case)
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    run_nsq_study)
from powersystemsreliabilityassessment_tpu_torch.utils.config import MCSConfig


def run(case_name: str = "rts96", samples: int = 50_000,
        batch_size: int = 4096, antithetic: bool = True,
        seed: int = 0, device: torch.device | str = "cuda") -> dict:
    """One NSQ study of ``samples`` states on ``case_name`` (a builtin
    name or a MATPOWER ``.m`` path) with no beta stop; mirrors reference
    ``studies/scaleup.py::run``."""
    case = resolve_case(case_name)
    res = run_nsq_study(
        case,
        MCSConfig(batch_size=batch_size, max_samples=samples,
                  beta_limit=0.0, seed=seed, antithetic=antithetic),
        device=device)
    return {"case": case.name, "n_bus": case.n_bus, "n_comp": case.n_comp,
            "edns_mw": res.edns_mw, "lole_hr_yr": res.lole_hr_yr,
            "beta": res.beta, "samples": res.samples,
            "antithetic": antithetic}


def antithetic_variance_comparison(samples: int = 20_000, seed: int = 0,
                                   device: torch.device | str = "cuda"
                                   ) -> dict:
    """The same budget on RTS-24 with and without antithetic pairing:
    ``{"independent" | "antithetic": {"edns", "beta"}}``; mirrors
    reference ``studies/scaleup.py::antithetic_variance_comparison``."""
    case = cases.rts24()
    out = {}
    for anti in (False, True):
        res = run_nsq_study(case, MCSConfig(
            batch_size=2048, max_samples=samples, beta_limit=0.0,
            seed=seed, antithetic=anti), device=device, log_every=0)
        out["antithetic" if anti else "independent"] = {
            "edns": res.edns_mw, "beta": res.beta}
    return out
