"""Per-hour Markov-transition sampling (the educational engines' method).

Port of ``powersystemsreliabilityassessment_tpu/sampling/markov.py``,
which replicates ``GeneratingAdequacy/Markov_process.jl:172-195``
(per-hour Bernoulli transitions with p01 = 1 - exp(-lambda dt), p10 =
1 - exp(-mu dt)) as a scan over hours carrying the component states.
The chain's stationary law matches the state-duration sampler's; its
dwell times are geometric rather than rounded exponential.

Two parts: :func:`markov_uniforms` draws one uniform a component and
hour from a ``torch.Generator`` (the reference draws them from one key
an hour), and :func:`markov_chain_from_uniforms` is the pure
construction, which the tests feed with the reference's own uniforms.
"""
from __future__ import annotations

import torch


def markov_uniforms(generator: torch.Generator, n_comp: int, hours: int,
                    batch: tuple = (), device: torch.device | str = "cuda"):
    """float32 ``[*batch, hours, n_comp]`` uniforms in [0, 1) on
    ``device`` (the generator's)."""
    return torch.rand((*batch, hours, n_comp), generator=generator,
                      device=device, dtype=torch.float32)


def markov_chain_from_uniforms(u: torch.Tensor, p_fail, p_repair,
                               init_down: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """bool ``[..., n_comp, hours]`` (True = DOWN) from the uniforms ``u``
    ``[..., hours, n_comp]``: the construction of reference
    ``sampling/markov.py::sample_markov_chain``. An UP component fails
    when u < p_fail, a DOWN one is repaired when u < p_repair; components
    start UP unless ``init_down`` says otherwise."""
    p_fail = torch.as_tensor(p_fail, dtype=torch.float32, device=u.device)
    p_repair = torch.as_tensor(p_repair, dtype=torch.float32,
                               device=u.device)
    hours = u.shape[-2]
    state = (torch.zeros(u.shape[:-2] + u.shape[-1:], dtype=torch.bool,
                         device=u.device)
             if init_down is None else init_down.to(u.device))
    path = torch.empty(u.shape, dtype=torch.bool, device=u.device)
    for t in range(hours):
        ut = u[..., t, :]
        fail = ~state & (ut < p_fail)
        repair = state & (ut < p_repair)
        state = (state | fail) & ~repair
        path[..., t, :] = state
    return path.transpose(-1, -2)


def sample_markov_chain(generator: torch.Generator, p_fail, p_repair,
                        hours: int,
                        init_down: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """bool ``[n_comp, hours]``, True = DOWN, on the generator's device.
    Mirrors reference ``sampling/markov.py::sample_markov_chain``."""
    u = markov_uniforms(generator, len(p_fail), hours,
                        device=generator.device)
    return markov_chain_from_uniforms(u, p_fail, p_repair, init_down)


def sample_markov_chain_batch(generator: torch.Generator, p_fail, p_repair,
                              hours: int, batch: int) -> torch.Tensor:
    """``[batch, n_comp, hours]`` independent chains. Mirrors reference
    ``sampling/markov.py::sample_markov_chain_batch``."""
    u = markov_uniforms(generator, len(p_fail), hours, (batch,),
                        device=generator.device)
    return markov_chain_from_uniforms(u, p_fail, p_repair)
