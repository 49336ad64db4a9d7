"""Non-sequential (state-sampling) Monte Carlo: Bernoulli outage draws.

Port of ``powersystemsreliabilityassessment_tpu/sampling/state.py``
(plain Monte Carlo only; antithetic, importance and mixture sampling come
with ROADMAP.md Queue 1 item 14). Threefry keys become explicit
``torch.Generator`` objects: Philox on CUDA, Mersenne Twister on the
CPU. The streams differ from JAX's by design, so the sampler is checked
on its distribution, not on its bits.
"""
from __future__ import annotations

import torch


def sample_states(generator: torch.Generator, unavail: torch.Tensor,
                  always_up: torch.Tensor, batch: int) -> torch.Tensor:
    """Draw ``batch`` component-failure indicators (True = failed).

    Component i fails when its uniform draw is below its unavailability
    U_i (mc_sampling.m:24-45); ``always_up`` components never fail
    (mc_sampling.m:40-41 pins the synchronous condenser). The draw runs
    on ``unavail``'s device, which must be the generator's. Mirrors
    reference ``sampling/state.py::sample_states`` (plain MC).

    Returns bool [batch, n_comp].
    """
    u = torch.rand((batch, unavail.shape[0]), generator=generator,
                   device=unavail.device, dtype=unavail.dtype)
    return (u < unavail[None, :]) & ~always_up[None, :]
