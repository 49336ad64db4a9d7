"""Educational Markov-process and parameter-estimation studies.

Port of ``powersystemsreliabilityassessment_tpu/studies/markov_education.py``,
the vectorized re-implementations of two teaching scripts:

* ``Markov_process.jl``: (a) a simulation proof that a constant hazard
  gives exponential times to failure; (b) one component's analytical
  pi(t+1) = pi(t) P evolution against one Monte Carlo realization and the
  steady-state limit; (c) a 5-unit system's available-capacity series;
* ``parameter_estimation.jl``: synthetic field logs (alternating
  exponential up / down durations) and the running estimate of MTTF /
  MTTR / lambda / mu converging to the true rates.

(a) and the estimation study are numpy, copied (the same numbers as the
reference). (b) and (c) draw the Markov chain on the card unless the
caller passes ``device="cpu"``, from ``hl2_nsq.batch_generator(seed, 0,
device)`` in place of the reference's ``jax.random.key(seed)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.sampling import markov
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    batch_generator)


def exponential_proof(mttf: float = 1000.0, n_samples: int = 10000,
                      max_time: int = 5000, seed: int = 42):
    """Constant-rate failure times against the exponential PDF: the
    geometric(p01) hour of failure sampled directly, the distribution of
    the reference's hourly coin flips (Markov_process.jl:35-76). Mirrors
    reference ``exponential_proof``."""
    p01 = 1.0 - np.exp(-1.0 / mttf)
    rng = np.random.default_rng(seed)
    # geometric: failures BEFORE the first success -> hours 0, 1, ...
    times = rng.geometric(p01, n_samples).astype(np.float64) - 1.0
    times = times[times <= max_time]
    t_theory = np.arange(0, max_time, 10.0)
    pdf_theory = (1.0 / mttf) * np.exp(-t_theory / mttf)
    return times, t_theory, pdf_theory


@dataclasses.dataclass
class SingleComponentStudy:
    """Mirrors reference ``SingleComponentStudy``."""
    prob_down_analytical: np.ndarray   # [T]
    mc_realization: np.ndarray         # [T] 0/1
    steady_state: float


def single_component_study(mttf: float = 1000.0, mttr: float = 50.0,
                           steps: int = 200, seed: int = 42,
                           device: torch.device | str = "cuda"
                           ) -> SingleComponentStudy:
    """Analytical evolution against one Monte Carlo realization
    (Markov_process.jl:81-144). Mirrors reference
    ``single_component_study``."""
    p_ana = twostate.availability_evolution(mttf, mttr, steps)
    p01, p10 = twostate.transition_probs(np.array([mttf]), np.array([mttr]))
    path = markov.sample_markov_chain(batch_generator(seed, 0, device),
                                      p01, p10, steps)
    return SingleComponentStudy(
        prob_down_analytical=p_ana,
        mc_realization=path[0].cpu().numpy().astype(np.int32),
        steady_state=float(mttr / (mttf + mttr)),
    )


def multi_unit_capacity_series(seed: int = 42, hours: int = 1000,
                               device: torch.device | str = "cuda"):
    """5-generator available-capacity series (Markov_process.jl:149-207):
    ``(capacity [hours] MW, installed MW)``. Mirrors reference
    ``multi_unit_capacity_series``."""
    mttf = np.array([1000.0, 1200.0, 800.0, 1500.0, 2000.0])
    mttr = np.array([50.0, 60.0, 40.0, 20.0, 100.0])
    caps = np.array([100.0, 100.0, 50.0, 200.0, 150.0])
    p01, p10 = twostate.transition_probs(mttf, mttr)
    path = markov.sample_markov_chain(batch_generator(seed, 0, device),
                                      p01, p10, hours)    # [5, H] down
    cap = (1.0 - path.cpu().numpy().astype(np.float32).T) @ caps
    return cap, float(caps.sum())


@dataclasses.dataclass
class EstimationStudy:
    """Mirrors reference ``EstimationStudy``."""
    up_durations: np.ndarray
    down_durations: np.ndarray
    est_mttf: float
    est_mttr: float
    est_lambda: float
    est_mu: float
    running_lambda: np.ndarray
    true_lambda: float


def parameter_estimation_study(true_mttf: float = 200.0,
                               true_mttr: float = 50.0,
                               n_events: int = 6, n_long: int = 1000,
                               seed: int = 123) -> EstimationStudy:
    """Field-log simulation and running rate estimation
    (parameter_estimation.jl:12-114). Mirrors reference
    ``parameter_estimation_study``."""
    rng = np.random.default_rng(seed)
    ups = -true_mttf * np.log(rng.uniform(size=n_events))
    downs = -true_mttr * np.log(rng.uniform(size=n_events))
    mttf, mttr, lam, mu = twostate.estimate_rates(ups, downs)
    long_ups = -true_mttf * np.log(rng.uniform(size=n_long))
    return EstimationStudy(
        up_durations=ups, down_durations=downs,
        est_mttf=mttf, est_mttr=mttr, est_lambda=lam, est_mu=mu,
        running_lambda=twostate.running_lambda_estimate(long_ups),
        true_lambda=1.0 / true_mttf,
    )
