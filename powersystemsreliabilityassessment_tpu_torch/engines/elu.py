"""Sequential Monte Carlo with explicit energy-limited-unit bookkeeping.

Port of ``powersystemsreliabilityassessment_tpu/engines/elu.py``, which
replaces the scalar per-hour Julia loops of ``MCvsMarkovProcess.jl:210-284``
/ ``tail_risk.jl:12-91`` / ``generating_adequancy_comparative.jl:15-120``
with a scan over hours carrying each unit's energy used, vmapped over
years. Semantics, the reference's:

* per-hour i.i.d. availability draws ``u < q`` (hourly independence, not
  a Markov chain);
* the maintenance mask by week of year;
* continuous-normal load-forecast uncertainty ``load + sigma z``;
* dispatch order: unlimited units first; if they cannot cover the load,
  the energy-limited units discharge, in proportion to capacity when they
  can cover the rest, else "drain all" at full capacity with the rest in
  deficit (MCvsMarkovProcess.jl:252-266);
* a unit whose energy used reaches its limit is exhausted for the rest
  of the year.

Two parts, like the port's other samplers: :func:`elu_draws` draws the
uniforms ``[Y, H, G]`` and normals ``[Y, H]`` on the card from a
``torch.Generator``, and :func:`elu_mc_from_draws` is the pure
construction, which the tests feed with the reference's own draws. The
reference's ``lax.scan`` is plain jnp, not a Pallas kernel, so the hour
loop stays PyTorch: everything that does not depend on the energy state
(availability, unlimited capacity, unserved load) is one batched pass,
and the loop over the H hours enqueues 12 small operations an hour on
``[Y, G]`` state (14 kernel launches on the card, PERF.md) with no read
of the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

HOURS_PER_WEEK = 168


def elu_draws(generator: torch.Generator, n_years: int, hours: int,
              n_units: int, device: torch.device | str = "cuda"):
    """``(u [Y, H, G], z [Y, H])``, float32: the per-hour availability
    uniforms in [0, 1) and the load-forecast normals of ``n_years``
    years, drawn on ``device`` (the generator's), uniforms first. They
    take the place of the reference's per-year ``split(key)`` draws."""
    u = torch.rand((n_years, hours, n_units), generator=generator,
                   device=device, dtype=torch.float32)
    z = torch.randn((n_years, hours), generator=generator, device=device,
                    dtype=torch.float32)
    return u, z


def elu_mc_from_draws(u: torch.Tensor, z: torch.Tensor, capacity,
                      for_rate, maint_start, maint_weeks, energy_limit,
                      base_load, lfu_sigma_mw: float):
    """``(yearly_lole [Y], hourly_failure_prob [H])`` from given draws
    ``u`` ``[Y, H, G]`` and ``z`` ``[Y, H]``: the construction of
    reference ``engines/elu.py::run_elu_mc``, with its float32 operations
    in its order (so a year's loss hours equal the reference's on the
    same draws). ``energy_limit``: ``inf`` for unlimited units. Every
    other argument is made a float32 (int32 for the weeks) tensor on
    ``u``'s device."""
    dev = u.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    capacity, for_rate = f32(capacity), f32(for_rate)
    energy_limit, base_load = f32(energy_limit), f32(base_load)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    maint_start, maint_weeks = i32(maint_start), i32(maint_weeks)
    Y, H, G = u.shape
    is_elu = torch.isfinite(energy_limit)
    week = torch.clamp_max(
        torch.arange(H, device=dev, dtype=torch.int32) // HOURS_PER_WEEK + 1,
        52)
    on_maint = ((maint_start[None, :] > 0)
                & (week[:, None] >= maint_start[None, :])
                & (week[:, None] < maint_start[None, :]
                   + maint_weeks[None, :]))                # [H, G]
    avail = (u >= for_rate) & ~on_maint                    # ~(u < q)
    load = base_load + lfu_sigma_mw * z                    # [Y, H]
    cap_unl = torch.where(avail & ~is_elu, capacity, 0.0).sum(-1)
    unserved = torch.clamp_min(load - cap_unl, 0.0)        # [Y, H]
    # An ELU that can be dispatched this hour, energy left aside.
    elu_on = avail & is_elu & (unserved > 0)[..., None]   # [Y, H, G]
    elu_up = avail & is_elu
    need = unserved[..., None] * capacity                  # [Y, H, G]
    energy_used = torch.zeros((Y, G), dtype=torch.float32, device=dev)
    cap_elu = torch.empty((Y, H), dtype=torch.float32, device=dev)
    for h in range(H):
        # exhausted = is_elu & (used >= limit); elu_av = up & ~exhausted
        elu_av = elu_up[:, h] & (energy_used < energy_limit)
        c_elu = torch.where(elu_av, capacity, 0.0).sum(-1)
        cap_elu[:, h] = c_elu
        share = torch.where((unserved[:, h] > c_elu)[:, None], capacity,
                            need[:, h] / torch.clamp_min(c_elu, 1e-9)[:, None])
        energy_used = energy_used + torch.where(
            elu_on[:, h] & elu_av, share, 0.0)
    failed = torch.clamp_min(unserved - cap_elu, 0.0) > 0  # [Y, H]
    return failed.sum(1).to(torch.float32), failed.to(torch.float32).mean(0)


def run_elu_mc(generator: torch.Generator, capacity, for_rate, maint_start,
               maint_weeks, energy_limit, base_load, lfu_sigma_mw: float,
               n_years: int):
    """``(yearly_lole [Y], hourly_failure_prob [H])`` of ``n_years``
    years drawn from ``generator`` on its device (the card unless the
    caller passes a CPU generator). Mirrors reference
    ``engines/elu.py::run_elu_mc``: :func:`elu_draws`, then
    :func:`elu_mc_from_draws`."""
    H, G = len(base_load), len(capacity)
    u, z = elu_draws(generator, n_years, H, G, generator.device)
    return elu_mc_from_draws(u, z, capacity, for_rate, maint_start,
                             maint_weeks, energy_limit, base_load,
                             lfu_sigma_mw)


def var_cvar(samples: torch.Tensor, alpha: float = 0.95):
    """Value-at-risk and conditional value-at-risk at level ``alpha`` of
    an annual-index distribution (tail_risk.jl studies the annual-LOLE
    distribution against the analytical mean). Mirrors reference
    ``engines/elu.py::var_cvar``: VaR = the ceil(alpha n)-th smallest,
    CVaR = the mean from it up."""
    s = torch.sort(samples).values
    n = s.shape[0]
    # ceil(alpha n) of the float32 alpha n, as the reference rounds it.
    idx = min(max(math.ceil(np.float32(alpha * n)) - 1, 0), n - 1)
    return s[idx], s[idx:].sum() / (n - idx)
