"""Non-sequential (state-sampling) Monte Carlo: Bernoulli outage draws.

Port of ``powersystemsreliabilityassessment_tpu/sampling/state.py``:
plain, antithetic, importance-sampled and defensive-mixture draws.
Threefry keys become explicit ``torch.Generator`` objects: Philox on
CUDA, Mersenne Twister on the CPU. The streams differ from JAX's by
design, so each sampler is two parts: the draw of its uniforms from the
generator, and a pure construction from those uniforms
(``states_from_uniforms``, ``importance_from_uniforms``,
``mixture_from_draws``), which the tests feed with the reference's own
draws.

The weighted samplers compute their log-weights as float32 products of
the state matrix (TF32 stays off, ``__init__``), and every step they run
in stays free of host syncs: the mixture's component index is an inverse
CDF (``torch.searchsorted``) of one uniform a lane, not
``torch.multinomial``.
"""
from __future__ import annotations

import math

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import hw_sampler

RNG_IMPLS = ("default", "hw")
# The floor under the proposal rates in the log-ratios (reference's 1e-30).
_TINY = 1e-30


def antithetic_pairs(u: torch.Tensor, batch: int) -> torch.Tensor:
    """``[u, 1 - u][:batch]`` along the batch axis: the antithetic batch
    from ``half = (batch + 1) // 2`` rows of uniforms. An odd batch's last
    row is unpaired, as in the reference."""
    return torch.cat([u, 1.0 - u], dim=0)[:batch]


def states_from_uniforms(u: torch.Tensor, unavail: torch.Tensor,
                         always_up: torch.Tensor) -> torch.Tensor:
    """Component i fails where ``u < U_i``, never where pinned."""
    return (u < unavail[None, :]) & ~always_up[None, :]


def sample_states(generator: torch.Generator, unavail: torch.Tensor,
                  always_up: torch.Tensor, batch: int,
                  rng_impl: str = "default",
                  antithetic: bool = False) -> torch.Tensor:
    """Draw ``batch`` component-failure indicators (True = failed).

    Component i fails when its uniform draw is below its unavailability
    U_i (mc_sampling.m:24-45); ``always_up`` components never fail
    (mc_sampling.m:40-41 pins the synchronous condenser). The draw runs
    on ``unavail``'s device, which must be the generator's. Mirrors
    reference ``sampling/state.py::sample_states``.

    ``antithetic``: ``half = (batch + 1) // 2`` rows of uniforms, then
    :func:`antithetic_pairs` (the second half uses 1 - u of the first).

    ``rng_impl``: "default" draws ``torch.rand`` uniforms from
    ``generator``; "hw" runs the K6 sampler (``ops/hw_sampler.py``:
    Philox4x32-10 keyed by two words drawn from ``generator``, P(fail) =
    ceil(U 2^24) / 2^24), the same Bernoulli law on another stream. Any
    other value raises ValueError, as the reference does. Deliberate
    differences from the reference (ROADMAP.md Queue 3): there "hw"
    falls back to threefry off the TPU and with ``antithetic``; here a
    CPU tensor runs K6's plain version, the same bits as the kernel, a
    CUDA tensor the kernel, and "hw" with ``antithetic`` raises
    ValueError (K6 draws bits, not reusable uniforms, and no fallback
    hides it).

    Returns bool [batch, n_comp].
    """
    if rng_impl not in RNG_IMPLS:
        raise ValueError(f"unknown rng_impl {rng_impl!r}; expected one of "
                         f"{RNG_IMPLS}")
    if rng_impl == "hw":
        if antithetic:
            raise ValueError("rng_impl='hw' draws no uniforms to pair; "
                             "antithetic sampling needs rng_impl='default'")
        return hw_sampler.sample_states_hw(generator, unavail, always_up,
                                           batch)
    rows = (batch + 1) // 2 if antithetic else batch
    u = torch.rand((rows, unavail.shape[0]), generator=generator,
                   device=unavail.device, dtype=unavail.dtype)
    if antithetic:
        u = antithetic_pairs(u, batch)
    return states_from_uniforms(u, unavail, always_up)


def importance_proposal(unavail: torch.Tensor, always_up: torch.Tensor,
                        boost: float,
                        boost_mask: torch.Tensor | None = None,
                        q_override: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """The proposal rates q [n_comp] of :func:`sample_states_importance`:
    ``q_override`` clamped to [U, max(U, 0.5)], else min(boost U, 0.5)
    where ``boost_mask`` holds (everywhere without one) and U elsewhere;
    0 on pinned components."""
    if q_override is not None:
        q = torch.clamp(q_override, unavail, torch.clamp(unavail, min=0.5))
    else:
        q = torch.clamp(boost * unavail, max=0.5)
        if boost_mask is not None:
            q = torch.where(boost_mask, q, unavail)
    return torch.where(always_up, torch.zeros_like(q), q)


def importance_from_uniforms(u: torch.Tensor, unavail: torch.Tensor,
                             always_up: torch.Tensor, q: torch.Tensor):
    """(down bool [B, n], weight [B]) from uniforms ``u`` [B, n] and the
    proposal ``q``: a component fails where ``u < q_i``, and the weight is
    the exact likelihood ratio prod_i (U_i/q_i)^x_i ((1-U_i)/(1-q_i))^(1-x_i)
    as exp of two products of the float32 state matrix. Pinned and
    zero-U components contribute factor 1 (no 0 * -inf)."""
    down = (u < q[None, :]) & ~always_up[None, :]
    p = torch.where(always_up, torch.zeros_like(unavail), unavail)
    never = always_up | (unavail <= 0.0)
    zero = torch.zeros_like(unavail)
    log_fail = torch.where(never, zero,
                           torch.log(p / torch.clamp(q, min=_TINY)))
    log_ok = torch.where(never, zero,
                         torch.log((1.0 - p) / torch.clamp(1.0 - q,
                                                           min=_TINY)))
    x = down.to(unavail.dtype)
    logw = x @ log_fail + (1.0 - x) @ log_ok
    return down, torch.exp(logw)


def sample_states_importance(generator: torch.Generator,
                             unavail: torch.Tensor, always_up: torch.Tensor,
                             batch: int, boost: float,
                             boost_mask: torch.Tensor | None = None,
                             q_override: torch.Tensor | None = None):
    """Importance-sampled state draw: failure-biased proposal + weights.

    Components fail with the proposal rates q of
    :func:`importance_proposal` (min(boost U, 0.5) on ``boost_mask``'s
    components, the true U elsewhere; or ``q_override``, the
    cross-entropy proposal, clamped to [U, 0.5]), and each state carries
    its exact likelihood ratio, so a w-weighted mean of any index is
    unbiased (E_q[w f(X)] = E_p[f(X)]). Mirrors reference
    ``sampling/state.py::sample_states_importance``.

    Returns (down bool [batch, n_comp], weight [batch]).
    """
    q = importance_proposal(unavail, always_up, boost, boost_mask,
                            q_override)
    u = torch.rand((batch, unavail.shape[0]), generator=generator,
                   device=unavail.device, dtype=unavail.dtype)
    return importance_from_uniforms(u, unavail, always_up, q)


def mixture_component(u: torch.Tensor, n_groups: int,
                      alpha0: float) -> torch.Tensor:
    """The mixture component of each lane, int64 [B] in [0, n_groups]
    (0 = the plain measure, k = group k's proposal), from one uniform a
    lane by inverse CDF: ``searchsorted`` of ``u`` in the cumulative
    [alpha0, alpha_g x K], alpha_g = (1 - alpha0) / K. The top is clamped
    to K (the float32 sum may end just under 1)."""
    probs = torch.cat([u.new_full((1,), alpha0),
                       u.new_full((n_groups,), (1.0 - alpha0) / n_groups)])
    cum = torch.cumsum(probs, 0)
    return torch.clamp(torch.searchsorted(cum, u, right=True), max=n_groups)


def mixture_from_draws(comp: torch.Tensor, u: torch.Tensor,
                       unavail: torch.Tensor, always_up: torch.Tensor,
                       group_masks: torch.Tensor, boost: float,
                       alpha0: float = 0.5):
    """(down bool [B, n], weight [B]) of the defensive mixture from each
    lane's component ``comp`` [B] (0 = plain, k = group k) and uniforms
    ``u`` [B, n]: group k's components fail with max(U, min(boost U,
    0.5)), the rest with U; the weight is the exact mixture likelihood
    ratio p / (alpha0 p + sum_k alpha_g q_k), with log w = -logsumexp
    over [log alpha0, log alpha_g + delta_k] (log p cancels), delta_k
    the log q_k / p of group k from two float32 products of the state
    matrix."""
    n_groups = group_masks.shape[0]
    dtype = unavail.dtype
    zero = torch.zeros_like(unavail)
    p = torch.where(always_up, zero, unavail)
    qb = torch.maximum(torch.clamp(boost * unavail, max=0.5), unavail)
    qb = torch.where(always_up, zero, qb)
    gm = group_masks.to(dtype)                                  # [K, n]
    # The lane's boosted components: a one-hot of its component (0, the
    # plain measure, selects no group) times the group masks.
    groups = torch.arange(1, n_groups + 1, device=comp.device)
    sel = (comp[:, None] == groups[None, :]).to(dtype)          # [B, K]
    lane_boost = sel @ gm                                       # [B, n]
    q_lane = torch.where(lane_boost > 0.5, qb[None, :], p[None, :])
    down = (u < q_lane) & ~always_up[None, :]
    never = always_up | (unavail <= 0.0)
    d_fail = torch.where(never, zero,
                         torch.log(torch.clamp(qb, min=_TINY)
                                   / torch.clamp(p, min=_TINY)))
    d_ok = torch.where(never, zero,
                       torch.log(torch.clamp(1.0 - qb, min=_TINY)
                                 / torch.clamp(1.0 - p, min=_TINY)))
    x = down.to(dtype)
    delta = x @ (gm * d_fail[None, :]).T \
        + (1.0 - x) @ (gm * d_ok[None, :]).T                    # [B, K]
    alpha_g = (1.0 - alpha0) / n_groups
    stack = torch.cat([delta.new_full((delta.shape[0], 1),
                                      math.log(alpha0)),
                       math.log(alpha_g) + delta], dim=1)
    return down, torch.exp(-torch.logsumexp(stack, dim=1))


def sample_states_mixture(generator: torch.Generator, unavail: torch.Tensor,
                          always_up: torch.Tensor, batch: int,
                          group_masks: torch.Tensor, boost: float,
                          alpha0: float = 0.5):
    """Defensive-mixture importance sampling over component groups.

    With probability ``alpha0`` a lane samples from the true measure,
    else from one of K per-group proposals (group k's components boosted
    to min(boost U, 0.5), everything else exact); each lane carries the
    exact mixture likelihood ratio, which the defensive plain component
    bounds by 1 / alpha0. ``group_masks``: bool [K, n_comp] on the
    sampler's device, typically one row per area's generators
    (``studies.hl2_nsq.gen_area_masks``). Mirrors reference
    ``sampling/state.py::sample_states_mixture``; the component index is
    an inverse CDF of one uniform a lane (:func:`mixture_component`)
    where the reference draws ``jax.random.categorical``.

    Returns (down bool [batch, n_comp], weight [batch]).
    """
    dev, dtype = unavail.device, unavail.dtype
    comp = mixture_component(
        torch.rand((batch,), generator=generator, device=dev, dtype=dtype),
        group_masks.shape[0], alpha0)
    u = torch.rand((batch, unavail.shape[0]), generator=generator,
                   device=dev, dtype=dtype)
    return mixture_from_draws(comp, u, unavail, always_up, group_masks,
                              boost, alpha0)
