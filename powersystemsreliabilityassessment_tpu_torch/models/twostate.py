"""Two-state Markov component models (host-side numpy).

Port of ``powersystemsreliabilityassessment_tpu/models/twostate.py``:
steady-state unavailabilities, the [MTTF, MTTR] table, exact one-step
transition probabilities and the analytical state-probability evolution
(Markov_process.jl:89-130), and the rate estimators of
parameter_estimation.jl:93-114.
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


def transition_probs(mttf, mttr, dt: float = 1.0):
    """Exact one-step (dt hours) transition probabilities of the two-state
    chain, ``(p_fail, p_repair)`` = (P[up->down], P[down->up]):
    p01 = 1 - exp(-lambda dt), p10 = 1 - exp(-mu dt)
    (Markov_process.jl:89-94). Mirrors reference
    ``models/twostate.py::transition_probs``."""
    p01 = 1.0 - np.exp(-dt / np.asarray(mttf))
    p10 = 1.0 - np.exp(-dt / np.asarray(mttr))
    return p01, p10


def availability_evolution(mttf: float, mttr: float, steps: int,
                           dt: float = 1.0, p0_down: float = 0.0) -> np.ndarray:
    """Analytical P[down](t) for t = 1..steps, the closed form of
    pi(t+1) = pi(t) P: U + (p0_down - U) r^t with r = 1 - p01 - p10 and
    U = p01 / (p01 + p10) (Markov_process.jl:100-110). Mirrors reference
    ``models/twostate.py::availability_evolution``."""
    p01, p10 = transition_probs(mttf, mttr, dt)
    u = p01 / (p01 + p10)
    r = 1.0 - p01 - p10
    t = np.arange(1, steps + 1)
    return u + (p0_down - u) * np.power(r, t)


def steady_state_unavailability(mttf, mttr):
    """U = MTTR / (MTTF + MTTR) (Markov_process.jl:128-130). Mirrors
    reference ``models/twostate.py::steady_state_unavailability``."""
    return np.asarray(mttr) / (np.asarray(mttf) + np.asarray(mttr))


def estimate_rates(up_durations: np.ndarray, down_durations: np.ndarray):
    """(MTTF, MTTR, lambda, mu) from field up/down logs, lambda_hat =
    N / sum(TTF) (parameter_estimation.jl:93-114). Mirrors reference
    ``models/twostate.py::estimate_rates``."""
    mttf = float(np.mean(up_durations))
    mttr = float(np.mean(down_durations))
    return mttf, mttr, 1.0 / mttf, 1.0 / mttr


def running_lambda_estimate(up_durations: np.ndarray) -> np.ndarray:
    """Running estimate lambda_hat(i) = i / sum_{k<=i} TTF_k, [n].
    Mirrors reference ``models/twostate.py::running_lambda_estimate``."""
    csum = np.cumsum(up_durations)
    n = np.arange(1, len(up_durations) + 1)
    return n / csum
