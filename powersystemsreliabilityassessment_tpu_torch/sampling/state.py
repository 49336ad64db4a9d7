"""Non-sequential (state-sampling) Monte Carlo: Bernoulli outage draws.

Port of ``powersystemsreliabilityassessment_tpu/sampling/state.py``
(plain Monte Carlo only; antithetic, importance and mixture sampling come
with ROADMAP.md Queue 1 item 8). Threefry keys become explicit
``torch.Generator`` objects: Philox on CUDA, Mersenne Twister on the
CPU. The streams differ from JAX's by design, so the sampler is checked
on its distribution, not on its bits.
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import hw_sampler

RNG_IMPLS = ("default", "hw")


def sample_states(generator: torch.Generator, unavail: torch.Tensor,
                  always_up: torch.Tensor, batch: int,
                  rng_impl: str = "default") -> torch.Tensor:
    """Draw ``batch`` component-failure indicators (True = failed).

    Component i fails when its uniform draw is below its unavailability
    U_i (mc_sampling.m:24-45); ``always_up`` components never fail
    (mc_sampling.m:40-41 pins the synchronous condenser). The draw runs
    on ``unavail``'s device, which must be the generator's. Mirrors
    reference ``sampling/state.py::sample_states`` (plain MC).

    ``rng_impl``: "default" draws ``torch.rand`` uniforms from
    ``generator``; "hw" runs the K6 sampler (``ops/hw_sampler.py``:
    Philox4x32-10 keyed by two words drawn from ``generator``, P(fail) =
    ceil(U 2^24) / 2^24), the same Bernoulli law on another stream. Any
    other value raises ValueError, as the reference does. A deliberate
    difference from the reference: there "hw" falls back to threefry
    off the TPU; here a CPU tensor runs K6's plain version, the same
    bits as the kernel, and a CUDA tensor the kernel (ROADMAP.md
    Queue 3).

    Returns bool [batch, n_comp].
    """
    if rng_impl not in RNG_IMPLS:
        raise ValueError(f"unknown rng_impl {rng_impl!r}; expected one of "
                         f"{RNG_IMPLS}")
    if rng_impl == "hw":
        return hw_sampler.sample_states_hw(generator, unavail, always_up,
                                           batch)
    u = torch.rand((batch, unavail.shape[0]), generator=generator,
                   device=unavail.device, dtype=unavail.dtype)
    return (u < unavail[None, :]) & ~always_up[None, :]
