"""Dataclass configuration objects.

Port of ``powersystemsreliabilityassessment_tpu/utils/config.py``
(``CompatFlags``, ``IPMConfig``, ``MCSConfig``). Field names, defaults and
meanings are the reference's. The port carries the fields its ported
code reads: the NSQ and SEQ studies with the NSQ samplers (antithetic,
importance with its scopes, the cross-entropy proposal), the control
variate, the enumeration hybrid and ``island_blackout``, and the large-m
LP solver. It leaves out the reference's ``IPMConfig.structured_gram``
and ``large_m_schur``: at m > 336 the port always takes the structured
operator and its block-Schur pass (``engines/lp_ipm_batched.lp_route``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Reproducibility switches; mirrors reference ``CompatFlags``
    (utils/config.py). Defaults replicate the reference behaviour."""

    # mc_sampling.m:40-41: the sync condenser (component 15, 1-based) is
    # pinned up in the NSQ sampler only (the SEQ sampler does not pin it).
    sync_cond_always_up_nsq: bool = True
    # mc_simulation.m:57-59: DNS noise floor.
    dns_noise_floor_mw: float = 0.1
    # nsqMain.m:270: failure flag threshold on total DNS.
    nsq_fail_flag_threshold_mw: float = 1e-4
    # seqMain.m:41: curtailment event threshold of the SEQ study.
    seq_curtail_threshold_mw: float = 0.01
    # mc_simulation.m:86: nodal shed noise threshold.
    nodal_noise_threshold_mw: float = 1e-3
    # SEQ simulates 8736 h a year (seqMain.m:38); NSQ LOLE annualization
    # uses 8760 h.
    hours_per_year_seq: int = 8736
    hours_per_year_annualize: int = 8760
    # Committed-unit Pmin in the min-shed LP (reference default False).
    enforce_pmin: bool = False
    # anloducurve.m:39's day-of-week formula ("reference") or the
    # conventional calendar ("calendar"); core/load_profile.py.
    weekday_mode: str = "reference"
    # Shed the loads cut off from bus 0 outright and take their island's
    # generators out (engines/dcopf.py::apply_island_blackout).
    island_blackout: bool = False


@dataclasses.dataclass(frozen=True)
class MCSConfig:
    """Monte Carlo study configuration; mirrors reference ``MCSConfig``."""

    seed: int = 0
    batch_size: int = 8192
    max_samples: int = 100_000      # NSQ cap (nsqMain.m:61)
    beta_limit: float = 0.0017      # NSQ convergence target (nsqMain.m:60)
    max_years: int = 4000           # SEQ cap (seqMain.m:39)
    cov_threshold: float = 0.05     # SEQ convergence target (seqMain.m:40)
    # NSQ: the second half of each batch takes 1 - u of the first half's
    # uniforms (sampling/state.py::sample_states). Mutually exclusive with
    # importance sampling.
    antithetic: bool = False
    # Importance sampling: > 1 draws failures from q = min(is_boost * U,
    # 0.5) with exact likelihood-ratio weights
    # (sampling/state.py::sample_states_importance); 0 disables.
    is_boost: float = 0.0
    # The components the boost applies to: "all" (every non-pinned
    # component), "gens" (generators only) or "branches" (branches only);
    # the others keep their true rates, likelihood-ratio factor 1.
    is_boost_scope: str = "all"
    # Cross-entropy adaptive importance sampling: a pilot of ce_rounds
    # rounds of ce_batch samples learns per-component proposal rates
    # (studies.hl2_nsq.calibrate_ce_proposal), starting from a uniform
    # branch boost ce_boost0 and smoothing each round's marginals as
    # q <- ce_smoothing q_CE + (1 - ce_smoothing) q. Overrides is_boost
    # when the pilot sees enough events.
    is_ce: bool = False
    ce_rounds: int = 2
    ce_batch: int = 32768
    ce_boost0: float = 4.0
    ce_smoothing: float = 0.7
    # Keep the learned tilt on its top ce_top_k components by q / U,
    # capped at ce_q_cap, U elsewhere (studies.hl2_nsq.
    # sparsify_ce_proposal); None keeps the dense proposal.
    ce_top_k: int | None = 8
    ce_q_cap: float = 0.05
    # Certificate multi-branch-outage rank; None = auto per system
    # (studies.hl2_nsq.default_woodbury_k).
    woodbury_k: int | None = None
    # "lp": deficit states get their nodal split from the LP;
    # "proportional": certified deficit states keep the certificate's
    # pattern (same aggregate indices, fewer LP lanes).
    nodal_mode: str = "lp"
    # Fused sampler + first-pass certificate kernel
    # (ops/fused_sampler_cert.py) for the NSQ hot path. Draws a
    # DIFFERENT (Philox4x32-10, counter-based) stream than the default
    # sampler, so same-seed results differ from the default path while
    # the estimator distribution is identical; deterministic for a fixed
    # (seed, batch). Plain-MC only, single-128-block systems
    # (RTS-24-class).
    fused_tier1: bool = False


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Batched interior-point settings; mirrors reference ``IPMConfig``."""

    iterations: int = 16
    tau: float = 0.99               # fraction-to-boundary
    regularization: float = 1e-7    # normal-matrix diagonal shift
    theta_max: float = 6.0          # voltage-angle box, rad
    # Freeze threshold on the mean complementarity product mu.
    mu_tol: float = 1e-7
    # Below this mu, damped pure-centering steps replace Mehrotra steps.
    center_tol: float = 1e-4
    # Extra polished warm-restart passes of the batched IPM (the stall
    # rescue at large m; lp_ipm_batched.solve_box_lp_ops). None = 1 on the
    # large LP route (past the blocked Cholesky's range), else 0.
    restarts: int | None = None
    # Large-m only: after the restarts, up to this many further warm-
    # restart passes, each run only when some lane's quality score
    # (primal_residual + 2 n duality_gap, the score dcopf's 5e-3 guard
    # reads) still exceeds escalate_tol. A clean batch skips them.
    escalate_passes: int = 2
    escalate_tol: float = 5e-3
    # Large-m only: in place of the restart on the whole buffer, compact
    # the worst restart_compact lanes by quality score into a sub-buffer
    # and run the restart and escalation there (the rescue ladder, on the
    # dense factor); lanes left behind keep their first-pass solution,
    # whose score bounds their duality gap. 0 restarts the whole buffer.
    restart_compact: int = 32
    # Mehrotra iterations of each rescue-ladder sub-solve; None =
    # ``iterations``.
    rescue_iterations: int | None = None
    # Rescue-ladder stage insets, in trajectory order: a float is a warm
    # sub-solve started that fraction of the box width inside its
    # trajectory point, None the cold side branch (box midpoint; it feeds
    # the per-lane merge only). A stage runs only while some lane's best
    # score exceeds escalate_tol: warm 2% (escapes step-length jams) ->
    # cold (escapes a wrong basin) -> two 1e-3 feasibility restorations.
    rescue_stages: tuple = (0.02, None, 1e-3, 1e-3)
