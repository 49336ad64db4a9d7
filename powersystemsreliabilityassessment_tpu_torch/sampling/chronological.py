"""Sequential (chronological) state-duration sampling.

Port of ``powersystemsreliabilityassessment_tpu/sampling/chronological.py``,
which replaces the reference's per-component "next event" loop
(``Montecarlo_seq/seq_mcsampling.m:44-75``: alternate exponential TTF /
TTR draws, ``round`` for up-times, ``ceil`` for repair times) with a
fixed number of draws:

1. draw K (up, down) duration uniforms per component;
2. turn them into durations, interleave them and prefix-sum them into
   event boundaries ``[2K]``;
3. a component is DOWN at (0-based) hour ``h`` iff the number of
   boundaries ``<= h`` is odd, the reference's integer interval
   semantics (down hours are ``[t, t + ttr)`` after an up-time ending at
   ``t``).

Each sampler is two parts: the draw of the uniforms ``[..., n_comp, K]``
from an explicit ``torch.Generator`` (the device's own stream, not JAX's
threefry), and a pure construction from those uniforms
(``timeline_from_uniforms``, ``timeline_from_state_uniforms``), which
the tests feed with the reference's own uniforms.

Step 3 counts with ``torch.searchsorted(bounds, hours, right=True)`` on
``[rows, 2K]``: a cumsum of non-negative durations does not decrease, so
the search counts exactly the bounds ``<= h``, ties included. The
reference's broadcast compare-and-count (a ``[rows, 2K, H]`` tensor,
chosen for the TPU's vector units) would be 1.17e9 elements at a
16-year RTS-24 block. K is chosen so that the drawn events cover the
horizon with probability > 1 - 1e-6 (the tail past the last event counts
as UP).
"""
from __future__ import annotations

import numpy as np
import torch

# jax.random.uniform(minval=1e-12, maxval=1.0) in float32: maxval -
# minval rounds to 1, so a draw is u + 1e-12 (never 0, so log(u) is
# finite).
_U_MIN = 1e-12


def default_num_draws(mttf: np.ndarray, mttr: np.ndarray, hours: int) -> int:
    """Static per-run draw count K: mean cycles + 8 sigma + slack.
    Mirrors reference ``sampling/chronological.py::default_num_draws``."""
    cycle = np.asarray(mttf, dtype=np.float64) + np.asarray(mttr, np.float64)
    n_mean = hours / cycle
    k = n_mean + 8.0 * np.sqrt(np.maximum(n_mean, 1.0)) + 8.0
    return int(np.ceil(k.max()))


def timeline_uniforms(generator: torch.Generator, n_comp: int, n_draws: int,
                      batch: tuple = (), device="cuda"):
    """``(u_up, u_down)``, each float32 ``[*batch, n_comp, n_draws]`` in
    (0, 1): the dwell draws of :func:`sample_timeline`, up-time uniforms
    first (the reference's ``ku``, then ``kd``), made as the reference's
    ``jax.random.uniform(..., minval=1e-12, maxval=1.0)`` makes them."""
    shape = (*batch, n_comp, n_draws)
    draw = lambda: torch.rand(shape, generator=generator, device=device,
                              dtype=torch.float32).add_(_U_MIN)
    return draw(), draw()


def _down_from_durations(d_first: torch.Tensor, d_second: torch.Tensor,
                         hours: int,
                         down0: torch.Tensor | None = None) -> torch.Tensor:
    """bool ``[..., n, hours]``: interleave the first / second dwells of
    each cycle, prefix-sum them into boundaries and take the parity of the
    count of boundaries ``<= h`` (plus ``down0``)."""
    lead, k = d_first.shape[:-1], d_first.shape[-1]
    bounds = torch.stack([d_first, d_second], dim=-1).reshape(-1, 2 * k)
    bounds = torch.cumsum(bounds, dim=-1)
    hour_idx = torch.arange(hours, dtype=bounds.dtype, device=bounds.device)
    cnt = torch.searchsorted(
        bounds, hour_idx.expand(bounds.shape[0], hours).contiguous(),
        right=True, out_int32=True)
    if down0 is not None:
        cnt = cnt + down0.reshape(-1, 1).to(torch.int32)
    return (cnt & 1).bool().reshape(*lead, hours)


def timeline_from_uniforms(u_up: torch.Tensor, u_down: torch.Tensor,
                           mttf: torch.Tensor, mttr: torch.Tensor,
                           hours: int, quantize: bool = True) -> torch.Tensor:
    """Chronological realizations from given dwell uniforms ``[..., n,
    K]``: bool ``[..., n, hours]``, True = DOWN. The construction of
    reference ``sampling/chronological.py::sample_timeline``:
    TTF = -MTTF log(u), TTR = -MTTR log(u), and with ``quantize`` the
    reference's round(TTF) / ceil(TTR) (seq_mcsampling.m:369-376)."""
    ttf = -mttf[:, None] * torch.log(u_up)
    ttr = -mttr[:, None] * torch.log(u_down)
    if quantize:
        ttf = torch.round(ttf)
        ttr = torch.ceil(ttr)
    return _down_from_durations(ttf, ttr, hours)


def timeline_from_state_uniforms(u_a: torch.Tensor, u_b: torch.Tensor,
                                 down0: torch.Tensor, mttf: torch.Tensor,
                                 mttr: torch.Tensor, hours: int,
                                 antithetic: bool = False) -> torch.Tensor:
    """Chronological realizations starting from ``down0`` ``[..., n]``
    (continuous dwells) from given uniforms ``[..., n, K]``: the
    construction of reference
    ``sampling/chronological.py::sample_timeline_from_state``. A DOWN
    component's first dwell is a repair time, and the parity gains
    ``down0``. ``antithetic`` reflects every uniform, u -> max(1 - u,
    1e-12)."""
    if antithetic:
        u_a = torch.clamp_min(1.0 - u_a, _U_MIN)
        u_b = torch.clamp_min(1.0 - u_b, _U_MIN)
    m_first = torch.where(down0, mttr, mttf)
    m_second = torch.where(down0, mttf, mttr)
    d_first = -m_first[..., None] * torch.log(u_a)
    d_second = -m_second[..., None] * torch.log(u_b)
    return _down_from_durations(d_first, d_second, hours, down0)


def sample_timeline(generator: torch.Generator, mttf: torch.Tensor,
                    mttr: torch.Tensor, hours: int, n_draws: int,
                    quantize: bool = True) -> torch.Tensor:
    """One chronological realization for all components, bool
    ``[n_comp, hours]``, True = DOWN, drawn on ``mttf``'s device (the
    generator's). Mirrors reference
    ``sampling/chronological.py::sample_timeline``; ``quantize=False``
    keeps continuous event times (hour state = state at its start)."""
    uu, ud = timeline_uniforms(generator, mttf.shape[0], n_draws,
                               device=mttf.device)
    return timeline_from_uniforms(uu, ud, mttf, mttr, hours, quantize)


def sample_timeline_batch(generator: torch.Generator, mttf: torch.Tensor,
                          mttr: torch.Tensor, hours: int, n_draws: int,
                          batch: int, quantize: bool = True) -> torch.Tensor:
    """``[batch, n_comp, hours]`` independent yearly realizations. Mirrors
    reference ``sampling/chronological.py::sample_timeline_batch``."""
    uu, ud = timeline_uniforms(generator, mttf.shape[0], n_draws, (batch,),
                               device=mttf.device)
    return timeline_from_uniforms(uu, ud, mttf, mttr, hours, quantize)


def sample_timeline_stationary(generator: torch.Generator,
                               mttf: torch.Tensor, mttr: torch.Tensor,
                               hours: int, n_draws: int,
                               batch: tuple = ()) -> torch.Tensor:
    """Stationary-start realization(s) with continuous dwells, bool
    ``[*batch, n_comp, hours]``. Mirrors reference
    ``sampling/chronological.py::sample_timeline_stationary``.

    The initial state is ``Bernoulli(U)``, ``U = mttr / (mttf + mttr)``;
    by the memorylessness of exponential dwells the state at every hour
    is then exactly ``Bernoulli(U)`` (the reference's SEQ study starts
    all-up, seq_mcsampling.m:44-55, and under-counts failures in its
    first ~MTTR hours)."""
    # The initial-state uniforms (plain [0, 1), the reference's k0) first.
    u0 = torch.rand((*batch, mttf.shape[0]), generator=generator,
                    device=mttf.device, dtype=torch.float32)
    ua, ub = timeline_uniforms(generator, mttf.shape[0], n_draws, batch,
                               device=mttf.device)
    down0 = u0 < mttr / (mttf + mttr)
    return timeline_from_state_uniforms(ua, ub, down0, mttf, mttr, hours)


def sample_timeline_from_state(generator: torch.Generator,
                               down0: torch.Tensor, mttf: torch.Tensor,
                               mttr: torch.Tensor, hours: int, n_draws: int,
                               antithetic: bool = False) -> torch.Tensor:
    """Realization(s) starting from the component state ``down0``
    ``[..., n_comp]`` (True = DOWN at hour 0), continuous dwells. Mirrors
    reference ``sampling/chronological.py::sample_timeline_from_state``:
    by memorylessness a trajectory can be cloned from its binary state;
    ``antithetic=True`` reflects every dwell uniform."""
    ua, ub = timeline_uniforms(generator, mttf.shape[0], n_draws,
                               tuple(down0.shape[:-1]), device=mttf.device)
    return timeline_from_state_uniforms(ua, ub, down0, mttf, mttr, hours,
                                        antithetic)
