"""The outage states of a batch, drawn again from the study seed.

A study draws batch i of seed s from a Philox generator (on the card)
seeded with the first 64 bits of ``numpy.random.SeedSequence((s, i))``,
so that a batch can be redrawn from its index. Non-sequential batches are
one uniform a component and state, a component out where the uniform is
below its unavailability (pinned units never). Sequential blocks are
years of alternating up and repair dwells from K pairs of uniforms a
component and year: up = round(-MTTF log u), repair = ceil(-MTTR log u),
every year starting up, a component out at hour h when an odd number of
dwell ends lie at or before h (Billinton and Li, "Reliability Assessment
of Electric Power Systems Using Monte Carlo Methods", ch. 4). This module
makes those states from the seed alone, in plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from psra_bench.reference.case import RefCase

# The smallest uniform of a dwell draw: log(u) stays finite.
U_MIN = 1e-12


def batch_generator(seed: int, batch_idx: int, device) -> torch.Generator:
    words = np.random.SeedSequence((seed, batch_idx)).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words.view(np.uint64)[0]))
    return gen


def nsq_states(case: RefCase, seed: int, batch_idx: int, batch: int,
               device) -> torch.Tensor:
    """bool [batch, n_comp]: batch ``batch_idx`` of a non-sequential
    study seeded ``seed``."""
    gen = batch_generator(seed, batch_idx, device)
    u = torch.rand((batch, case.n_comp), generator=gen, device=device,
                   dtype=torch.float32)
    q = torch.as_tensor(case.unavail.astype(np.float32), device=device)
    pinned = torch.as_tensor(case.pinned_nsq, device=device)
    return (u < q) & ~pinned


def num_draws(case: RefCase, hours: int) -> int:
    """K: the mean number of up-repair cycles in ``hours`` plus eight
    standard deviations and eight, for the component that cycles most."""
    n = hours / (case.mttf + case.mttr)
    return int(np.ceil(np.max(n + 8.0 * np.sqrt(np.maximum(n, 1.0)) + 8.0)))


def seq_states(case: RefCase, seed: int, batch_idx: int, years: int,
               hours: int, n_draws: int, device) -> torch.Tensor:
    """bool [years, hours, n_comp]: block ``batch_idx`` of a sequential
    study seeded ``seed``. The dwells are float32 as the study draws
    them; their ends are whole hours."""
    gen = batch_generator(seed, batch_idx, device)
    shape = (years, case.n_comp, n_draws)
    u_up = torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32) + U_MIN
    u_rep = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32) + U_MIN
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    up = torch.round(-f32(case.mttf)[:, None] * torch.log(u_up))
    rep = torch.ceil(-f32(case.mttr)[:, None] * torch.log(u_rep))
    ends = torch.stack([up, rep], dim=-1).reshape(years, case.n_comp, -1)
    ends = torch.cumsum(ends.to(torch.float64), dim=-1).to(torch.int64)
    # Count the dwell ends at or before each hour: a histogram of the ends
    # inside the year, summed from hour 0.
    hist = torch.zeros((years, case.n_comp, hours + 1), dtype=torch.int32,
                       device=device)
    hist.scatter_add_(2, ends.clamp(max=hours),
                      torch.ones_like(ends, dtype=torch.int32))
    count = torch.cumsum(hist[..., :hours], dim=-1)
    return (count % 2 == 1).transpose(1, 2).contiguous()
