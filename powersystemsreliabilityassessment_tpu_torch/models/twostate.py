"""Two-state Markov component models (host-side numpy).

Port of ``powersystemsreliabilityassessment_tpu/models/twostate.py``:
``unavailability`` and ``mean_times``. The SEQ-path estimators
(``transition_probs`` and the rest) come with the SEQ slice (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

from powersystemsreliabilityassessment_tpu_torch.core.cases import CaseData

HOURS_PER_YEAR = 8760.0  # rate conversion (failprob.m:31)


def unavailability(case: CaseData) -> np.ndarray:
    """Steady-state component unavailability U, [n_comp] float64.

    Generators: U = MTTR/(MTTF+MTTR); branches: U = lambda/(lambda+mu)
    with mu = 8760/duration (failprob.m:21-39). Mirrors reference
    ``models/twostate.py::unavailability``.
    """
    u_gen = case.gen_mttr / (case.gen_mttf + case.gen_mttr)
    mu_br = HOURS_PER_YEAR / case.br_dur
    u_br = case.br_lambda / (case.br_lambda + mu_br)
    return np.concatenate([u_gen, u_br])


def mean_times(case: CaseData) -> np.ndarray:
    """[n_comp, 2] (MTTF, MTTR) hours (seqmeantime.m:19-36). Mirrors
    reference ``models/twostate.py::mean_times``."""
    gen = np.stack([case.gen_mttf, case.gen_mttr], axis=1)
    br = np.stack([HOURS_PER_YEAR / case.br_lambda, case.br_dur], axis=1)
    return np.concatenate([gen, br], axis=0)
