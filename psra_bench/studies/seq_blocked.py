"""SEQ study driver for a configuration whose DC-OPF LP takes the
program's blocked-Cholesky route (72 < m <= 336): the driver of
:mod:`psra_bench.studies.seq`, run only on a program whose LP tier sends
every lane that its pass leaves past the quality guard through a rescue.

A program without that rescue answers such a lane with the copper-sheet
bound, a loss of load too low, so on this route its indices are not the
study's (ROADMAP.md Queue 3, fault G). At set-up, before the first batch,
the driver hands the program's LP solver a probe buffer of
:data:`PROBE_LANES` states with its pass cut to one Mehrotra iteration,
so that every lane leaves the pass past the guard, and requires every
lane to end under it. A program that fails the probe is refused at once
(``BenchError``: exit 2, no result line), where it would otherwise run a
study that the check calls incorrect. The probe runs on the CPU (the
rescue's gate and ladder are the same code on every device), so the card
starts the study as it would without it; it adds about 3 s to set-up.

Traffic keys: those of :mod:`psra_bench.studies.seq`.
"""
from __future__ import annotations

import dataclasses

import torch

from powersystemsreliabilityassessment_tpu_torch.core.system import (
    build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    dcopf, lp_ipm_batched)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)

from psra_bench.run import BenchError
from psra_bench.studies import seq
from psra_bench.studies.common import case_data, compat_flags
from psra_bench.studies.seq import RATE_METRIC  # noqa: F401

PROBE_LANES = 32


def probe(sys, compat) -> int:
    """Lanes of the probe buffer that the program's LP solver leaves past
    its quality guard (the score ``dcopf`` guards, against
    ``IPMConfig.escalate_tol``) when its pass runs one iteration and a
    rescue its usual count. Lane i is the system with unit i down at
    60% to 100% of its peak load (evenly over the lanes)."""
    full = IPMConfig()
    ipm = dataclasses.replace(full, iterations=1,
                              rescue_iterations=full.iterations)
    dt, dev = sys.bus_pd.dtype, sys.device
    lanes = torch.arange(PROBE_LANES, device=dev)
    gen_up = torch.ones((PROBE_LANES, sys.n_gen), dtype=dt, device=dev)
    gen_up[lanes, lanes % sys.n_gen] = 0.0
    br_up = torch.ones((PROBE_LANES, sys.n_branch), dtype=dt, device=dev)
    load = sys.load_pd * torch.linspace(0.6, 1.0, PROBE_LANES, dtype=dt,
                                        device=dev)[:, None]
    c, A, b, l, u = dcopf.build_state_lp(sys, gen_up, br_up, load, compat,
                                         ipm.theta_max)
    sol = lp_ipm_batched.solve_box_lp_batched(c, A, b, l, u, ipm)
    score = sol.primal_residual + 2 * c.shape[1] * sol.duality_gap
    return int((~(score <= ipm.escalate_tol)).sum())


class Driver(seq.Driver):
    """:class:`psra_bench.studies.seq.Driver` behind the probe."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        compat = compat_flags(cfg)
        sys = build_system(case_data(cfg), compat, "cpu")
        left = probe(sys, compat)
        if left:
            raise BenchError(
                f"the program's LP tier leaves {left} of {PROBE_LANES} "
                f"probe lanes past its quality guard at m = "
                f"{sys.n_bus + sys.n_branch}: this configuration needs a "
                f"rescue of every such lane on the blocked-Cholesky route, "
                f"without which those lanes fall back to the copper-sheet "
                f"bound")
        super().__init__(cfg, traffic, seed, device)
