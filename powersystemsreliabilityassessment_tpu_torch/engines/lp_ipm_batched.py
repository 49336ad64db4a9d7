"""Batched box-LP interior-point solver and the LP routes.

Port of ``powersystemsreliabilityassessment_tpu/engines/lp_ipm_batched.py``,
all of it: ``LPBatchSolution``, ``_pos``, ``_merge_lanes``,
``_schur_solvers``, ``polish_box_lp``, the operator solver (``LinOps``
with its block-Schur fields and ``take``, ``dense_linops``,
``solve_box_lp_batched``, ``solve_box_lp_ops`` with the large-m warm
restarts, compacted rescue ladder and escalation) and the backend choice
``_make_chol_ops``. The reference decides by the LP's row count m in
several places (``on_tpu`` and m branches here, in ``dcopf`` and in the
studies); the port decides once, in the route table (:class:`LPRoute`,
:func:`lp_route`; ``_make_chol_ops`` is its ``kernels``), which every LP
caller reads.

The reference's ``jax.lax.cond`` gates of the large-m ladder (run a
stage only while some lane's quality score exceeds ``escalate_tol``)
read their flag on the host here: one read a gate, at most seven a
solve (the compacted rescue, its four stages, two escalations), none per
iteration.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, NamedTuple

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import (
    batched_chol as bc, blocked_chol, ipm_fused, xla_chol)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)
from powersystemsreliabilityassessment_tpu_torch.utils.profiling import (
    count, span)


class LPBatchSolution(NamedTuple):
    """Mirrors reference ``engines/lp_ipm_batched.py::LPBatchSolution``."""
    x: torch.Tensor                # [B, n]
    objective: torch.Tensor        # [B]
    primal_residual: torch.Tensor  # [B]
    duality_gap: torch.Tensor      # [B]


def _pos(a, eps=1e-12):
    """max(a, eps); mirrors reference ``lp_ipm_batched.py::_pos``."""
    return torch.clamp_min(a, eps)


def _merge_lanes(new: LPBatchSolution, old: LPBatchSolution
                 ) -> LPBatchSolution:
    """Per-lane keep-the-better merge of two solver passes; mirrors
    reference ``lp_ipm_batched.py::_merge_lanes``. Lanes are ranked by
    objective plus a heavy penalty on a primal residual past 3e-4 and on
    a duality-gap bound (2 n gap) past 1e-3, so a feasible but
    suboptimal candidate (small residual, large gap) never displaces a
    near-optimal one, and a well-converged lane never regresses."""
    n = new.x.shape[-1]

    def pen(s):
        return s.objective + 1e4 * (
            torch.clamp_min(s.primal_residual - 3e-4, 0.0)
            + torch.clamp_min(2 * n * s.duality_gap - 1e-3, 0.0))

    take_new = pen(new) < pen(old)
    return LPBatchSolution(*(
        torch.where(take_new[:, None] if a.dim() == 2 else take_new, a, o)
        for a, o in zip(new, old)))


def _quality(sol: LPBatchSolution) -> torch.Tensor:
    """[B] the evaluator's trust score, primal residual + 2 n gap."""
    return sol.primal_residual + 2 * sol.x.shape[-1] * sol.duality_gap


class LPKernels(NamedTuple):
    """The kernels one LP route runs."""
    factor: Callable      # [B, m, m] -> Cholesky factor
    solve: Callable       # (factor, [B, m]) -> solution
    iterate: Callable | None  # fused Mehrotra loop (ops/ipm_fused.py), m <= 72


class LPRoute(NamedTuple):
    """How the port solves an LP of m rows: everything that depends on m,
    one value per route (:data:`STRUCTURED`, :data:`BLOCKED`,
    :data:`LARGE`), chosen by :func:`lp_route`."""
    name: str
    max_m: int | None   # the route's largest m; None: no bound
    graphs: bool        # the LP tier's and tier 1's small-op chains may
    #                     run as CUDA graphs on the card (runtime/graphs)
    rescue: str         # after the pass: "warm" (lp_ipm_structured.
    #                     _warm_rescue), "flagged" (_rescue_flagged),
    #                     "ladder" (_rescue, restarts and escalation)
    island_pf: bool     # tier 1.5 runs (dcopf.default_pf_buffer)
    seq_block_lanes: int | None  # SEQ LP lanes a year block
    #                     (hl2_seq.seq_lp_cap); None: the whole year

    def kernels(self, device) -> LPKernels:
        """The route's kernels on ``device``, read from the module's
        tables at each call (a caller may swap an entry after import)."""
        if self is not STRUCTURED:
            return _BLOCKED_KERNELS if self is BLOCKED else _LARGE_KERNELS
        dev = torch.device(device).type
        if dev not in _DIRECT_KERNELS:
            raise NotImplementedError(f"no LP kernels for device {device}")
        return _DIRECT_KERNELS[dev]


# m <= 72 (the fused and direct batched-Cholesky kernels' range; reference
# _PALLAS_MAX_M = _FUSED_MAX_M = 72, a TPU VMEM budget not yet measured
# again on the H100, PERF.md Open questions): K1 on the shared LP
# structure, the polish, the warm rescue of the 16 worst lanes.
STRUCTURED = LPRoute("structured", bc.MAX_M, graphs=True, rescue="warm",
                     island_pf=False, seq_block_lanes=None)
# 72 < m <= 336 (the blocked factor's range): the blocked Cholesky on the
# materialized A, then the rescue of every lane past the guard.
BLOCKED = LPRoute("blocked", blocked_chol.MAX_M, graphs=False,
                  rescue="flagged", island_pf=False, seq_block_lanes=None)
# m > 336 (case300s): the block-Schur pass on the structured operator,
# the rescue ladder and escalation; tier 1.5 first, where one LP lane
# costs milliseconds. A SEQ step holds 4,096 LP lanes a block: on an 80 GB
# H100 a case300s step at 4,096 lanes peaks at 26.2 GB at Y = 2 and 26.3
# GB at Y = 4 (chip_smoke.py seq300full, scripts/torch_seq300_step.py).
LARGE = LPRoute("large", None, graphs=False, rescue="ladder",
                island_pf=True, seq_block_lanes=4096)


def lp_route(m: int) -> LPRoute:
    """The route of an LP of ``m`` rows: the first whose range holds m."""
    return next(r for r in (STRUCTURED, BLOCKED, LARGE)
                if r.max_m is None or m <= r.max_m)


# STRUCTURED, device type -> kernels: on CUDA the hand-written K1 fused IPM
# and K2 batched Cholesky, on the CPU their plain PyTorch versions.
_DIRECT_KERNELS = {
    "cuda": LPKernels(bc.cholesky, bc.cho_solve,
                      ipm_fused.fused_ipm_iterations),
    "cpu": LPKernels(bc.cholesky_plain, bc.cho_solve_plain,
                     ipm_fused.fused_ipm_iterations_plain),
}
# BLOCKED, any device: the panel-blocked Cholesky of
# ops/blocked_chol.py, whose K2 and K3 wrappers launch the kernels on
# CUDA tensors and run the plain versions on CPU tensors. This differs on
# purpose from the reference's CPU route, which takes jnp.linalg.cholesky
# at m > 72: routing the CPU through the blocked code lets the CPU tests
# reach its glue.
_BLOCKED_KERNELS = LPKernels(blocked_chol.blocked_cholesky,
                             blocked_chol.blocked_cho_solve, None)


# Large-m refinement steps of a dense solve against the retained matrix
# (reference _make_chol_ops, m > _BLOCKED_MAX_M).
LARGE_REFINE_STEPS = 2


def _large_factor(M: torch.Tensor):
    """m > 336: the Cholesky factor (``xla_chol.chol``, cuSOLVER on the
    card) and the matrix itself, kept for the refinement in
    :func:`_large_solve`. The reference factors into the explicit L^-1
    (``ops/xla_chol.factor``), a TPU choice that makes each solve two
    matrix products. On an NVIDIA H100 80GB HBM3 at 700 W the
    substitutions cost more (a refined solve of 32 lanes 3.7 ms against
    0.4 ms), but they cleared case300s stress lane 106 (a 94 MW shed),
    which every explicit-inverse variant left past the guard at its 0 MW
    bound (PERF.md §6)."""
    return xla_chol.chol(M), M


def _large_solve(LM, r: torch.Tensor) -> torch.Tensor:
    """Solve with :func:`_large_factor`, then LARGE_REFINE_STEPS steps of
    iterative refinement against the retained M, which restore the
    Newton directions a float32 factor of these barrier-weighted
    matrices stalls (reference ``_make_chol_ops``)."""
    L, M = LM
    dy = xla_chol.cho_solve(L, r)
    for _ in range(LARGE_REFINE_STEPS):
        dy = dy + xla_chol.cho_solve(L, r - (M @ dy[:, :, None])[:, :, 0])
    return dy


# LARGE, any device: the dense factor (cuSOLVER on the card), used by a
# dense operator's pass and by every rescue-ladder sub-solve. The
# block-Schur pass of a structured operator runs K2a and K3 instead
# (ops/blocked_chol.explicit_spd_inv).
_LARGE_KERNELS = LPKernels(_large_factor, _large_solve, None)


def _bdot(p, q):
    return (p * q).sum(-1)


def _equilibrated_factor(factor, M, delta: float):
    """Factor of the unit-diagonal scaling of M plus ``delta`` I, and the
    scaling s (the reference's inline ``equilibrated_chol``)."""
    s = torch.rsqrt(torch.clamp_min(
        torch.diagonal(M, dim1=1, dim2=2), 1e-30))
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return factor((M * s[:, :, None] * s[:, None, :]
                   + delta * eye).contiguous()), s


def _eq_solve(chol_solve, chol_s, rhs):
    """Solve with an :func:`_equilibrated_factor` (reference ``eq_solve``)."""
    chol, s = chol_s
    return s * chol_solve(chol, (s * rhs).contiguous())


def _schur_solvers(mv_fn, mtv_fn, schur_factor, schur_solve, delta: float):
    """(factor, solve) over gram-convention weights for the block-Schur
    route; mirrors reference ``lp_ipm_batched.py::_schur_solvers``.
    ``factor(w, ridge)`` builds the two-block inverse of A diag(w) A' +
    ridge I; ``solve`` refines the one substitution pass twice against
    the matrix-free operator, which removes the explicit inverses'
    float32 rounding and the equilibration ridge, and returns the iterate
    with the smallest max-norm residual (at extreme barrier-weight spans
    the refinement can diverge)."""
    def nfactor(w, ridge: float = 0.0):
        return schur_factor(w, ridge, delta), w, ridge

    def nsolve(F3, rhs):
        F, w, ridge = F3

        def apply_n(v):
            out = mv_fn(w * mtv_fn(v))
            return out + ridge * v if ridge else out

        dy = schur_solve(F, rhs)
        best_dy = dy
        best_rn = (rhs - apply_n(dy)).abs().amax(1)
        for _ in range(2):
            dy = dy + schur_solve(F, rhs - apply_n(dy))
            rn = (rhs - apply_n(dy)).abs().amax(1)
            best_dy = torch.where((rn < best_rn)[:, None], dy, best_dy)
            best_rn = torch.minimum(rn, best_rn)
        return best_dy

    return nfactor, nsolve


def polish_box_lp(state, c, b, l, u, cfg: IPMConfig, mv_fn, mtv_fn,
                  gram_fn, schur=None, kernels=None) -> LPBatchSolution:
    """Post-iteration polish; mirrors reference
    ``engines/lp_ipm_batched.py::polish_box_lp``.

    ``state`` is ``(x, y, zl, zu, best_score, best_x)``; the constraint
    operator comes as ``mv_fn(v) -> A v``, ``mtv_fn(y) -> A' y`` and
    ``gram_fn(w) -> A diag(w) A'``; ``schur``, a ``(schur_factor,
    schur_solve)`` pair, takes the block-Schur route for the m x m
    solves (:func:`_schur_solvers`) in place of the dense factor;
    ``kernels`` (an :class:`LPKernels`; None: those of m's route) factor
    and solve them otherwise. Steps:
    best-iterate selection, projection onto Ax = b, a Woodbury crossover
    snap toward the active bounds kept only when it does not worsen
    feasibility or objective, and the final residual and duality-gap
    report.
    """
    x, y, zl, zu, best_score, best_x = state
    B, n = x.shape
    m = b.shape[1]
    eye_m = torch.eye(m, dtype=x.dtype, device=x.device)
    if schur is not None:
        nfactor, fsolve = _schur_solvers(mv_fn, mtv_fn, *schur,
                                         cfg.regularization)
        chol_aat = nfactor(torch.ones_like(x))
    else:
        factor, chol_solve = (kernels or lp_route(m).kernels(x.device))[:2]

        def fsolve(chol_s, rhs):
            return _eq_solve(chol_solve, chol_s, rhs)

        chol_aat = _equilibrated_factor(factor, gram_fn(torch.ones_like(x)),
                                        cfg.regularization)

    def project(xv):
        return xv + mtv_fn(fsolve(chol_aat, b - mv_fn(xv)))

    width = u - l
    # Final candidate vs best-ever, then one projection polish.
    sl = _pos(x - l)
    su = _pos(u - x)
    rp_f = b - mv_fn(x)
    mu_f = (_bdot(sl, zl) + _bdot(su, zu)) / (2 * n)
    score_f = mu_f + rp_f.abs().amax(-1)
    x = torch.where((score_f <= best_score)[:, None], x, best_x)
    x = torch.clamp(project(x), l, u)

    # Crossover polish via Woodbury (only m x m factorizations):
    # (W + A'A)^-1 rhs = W^-1 rhs - W^-1 A' (I + A W^-1 A')^-1 A W^-1 rhs
    snap_tol = 1e-3 * width
    at_l = (x - l) < snap_tol
    at_u = (u - x) < snap_tol
    target = torch.where(at_l, l, torch.where(at_u, u, x))
    w = torch.where(at_l | at_u, 1e2, 1e-4)
    rhs = mtv_fn(b) + w * target
    winv = 1.0 / w
    if schur is not None:
        cholK = nfactor(winv, 1.0)
    else:
        cholK = _equilibrated_factor(factor, gram_fn(winv) + eye_m,
                                     cfg.regularization)
    t1 = winv * rhs
    t2 = fsolve(cholK, mv_fn(t1))
    xp = t1 - winv * mtv_fn(t2)
    xp = torch.clamp(project(xp), l, u)
    ok = (torch.isfinite(xp).all(-1)
          & ((mv_fn(xp) - b).abs().amax(-1)
             <= (mv_fn(x) - b).abs().amax(-1) + 1e-5)
          & (_bdot(c, xp) <= _bdot(c, x)))
    x = torch.where(ok[:, None], xp, x)

    rp = b - mv_fn(x)
    sl = _pos(x - l)
    su = _pos(u - x)
    mu = (_bdot(sl, zl) + _bdot(su, zu)) / (2 * n)
    # Weak-duality certificate: for any y, g(y) = b'y + sum_j min(r_j l_j,
    # r_j u_j) with r = c - A'y lower-bounds the optimum; the |y|'|rp|
    # cross-term keeps it rigorous for slightly infeasible x. The
    # reported gap is the smaller of it and the 2n*mu surrogate.
    r = c - mtv_fn(y)
    gap_weak = (_bdot(c, x) - _bdot(b, y)
                - torch.minimum(r * l, r * u).sum(-1))
    gap_weak = gap_weak + (y.abs() * rp.abs()).sum(-1)
    gap = torch.minimum(mu, _pos(gap_weak) / (2 * n))
    return LPBatchSolution(x=x, objective=_bdot(c, x),
                           primal_residual=rp.abs().amax(-1),
                           duality_gap=gap)


class LinOps(NamedTuple):
    """Batched constraint operator for the box-LP core; mirrors reference
    ``engines/lp_ipm_batched.py::LinOps``. ``normal`` stays apart from
    ``gram`` so the dense operator keeps its symmetric square-root
    rounding. ``schur_factor(w, ridge, delta) -> F`` and
    ``schur_solve(F, r) -> one unrefined substitution pass`` are the
    block-Schur factorization of A diag(w) A' + ridge I for structured A
    (``dcopf.make_dc_linops``); None on dense operators."""
    mv: Callable      # v [B, n] -> A v                 [B, m]
    mtv: Callable     # y [B, m] -> A' y                [B, n]
    gram: Callable    # w [B, n] -> A diag(w) A'        [B, m, m]
    normal: Callable  # d [B, n] -> A diag(1/d) A'      [B, m, m]
    take: Callable    # idx [k] -> LinOps over the idx lanes
    schur_factor: Callable | None = None
    schur_solve: Callable | None = None


def dense_linops(A: torch.Tensor) -> LinOps:
    """:class:`LinOps` over an explicit [B, m, n] constraint tensor;
    mirrors reference ``engines/lp_ipm_batched.py::dense_linops``."""
    At = A.transpose(1, 2)

    def mv(v):
        return (A @ v[:, :, None])[:, :, 0]

    def mtv(y):
        return (y[:, None, :] @ A)[:, 0, :]

    def gram(w):
        return (A * w[:, None, :]) @ At

    def normal(d):
        # Symmetric square-root form G G' with G = A diag(d)^-1/2, as the
        # reference keeps it (not gram(1/d): another rounding).
        G = A * torch.rsqrt(d)[:, None, :]
        return G @ G.transpose(1, 2)

    def take(idx):
        return dense_linops(A[idx])

    return LinOps(mv, mtv, gram, normal, take)


def solve_box_lp_batched(c, A, b, l, u, cfg: IPMConfig = IPMConfig(),
                         x_init=None, valid=None) -> LPBatchSolution:
    """Solve a batch of LPs min c'x s.t. Ax = b, l <= x <= u; c, l, u
    [B, n], A [B, m, n], b [B, m], float32 on one device. Mirrors
    reference ``engines/lp_ipm_batched.py::solve_box_lp_batched``
    (``valid``: see :func:`solve_box_lp_ops`)."""
    return solve_box_lp_ops(c, b, l, u, dense_linops(A), cfg, x_init=x_init,
                            valid=valid)


def _gate(score: torch.Tensor, tol: float) -> bool:
    """The reference's ``lax.cond`` predicate ``any(score > tol)``, read
    on the host (one device sync, in a ``psra.lp.wait`` span)."""
    flag = (score > tol).any()
    with span("lp.wait"):
        return bool(flag)


def solve_box_lp_ops(c, b, l, u, ops: LinOps, cfg: IPMConfig = IPMConfig(),
                     x_init=None, valid=None) -> LPBatchSolution:
    """Batched Mehrotra IPM over a constraint operator, then the polish,
    then the rescue of m's route (:func:`lp_route`); mirrors reference
    ``engines/lp_ipm_batched.py::solve_box_lp_ops``.

    The pass (:func:`_ipm`) starts at the box midpoint (or ``x_init``,
    strictly inside the box). Its normal matrices go through the route's
    kernels, or, on the large route when ``ops`` has the block-Schur
    fields, through :func:`_schur_solvers` (two [B, nb, nb] explicit
    inverses on K2a and K3).

    After the pass, ``cfg.restarts`` (None: 1 on the large route, else 0)
    full-length warm passes from the polished solution, 2% inside the
    box, merged lane by lane (:func:`_merge_lanes`). Then the route's
    rescue:

    * ``"ladder"`` (m > 336): the compacted rescue ladder (:func:`_rescue`)
      on the ``restart_compact`` worst lanes by quality score replaces
      the restarts (``restart_compact`` 0 keeps them), run only while some
      lane's score exceeds ``escalate_tol``; then up to
      ``escalate_passes`` full-buffer warm passes (insets 0.05, 0.1), each
      run only while a lane still exceeds it. The gates read their flag
      on the host (:func:`_gate`).
    * ``"flagged"`` (72 < m <= 336): every lane past ``escalate_tol``
      goes through the same ladder, however many there are
      (:func:`_rescue_flagged`); ``valid`` ([B] bool, a padded buffer's
      real lanes; None: every lane) limits it to the lanes whose answers
      are kept. This differs on purpose from the reference, which
      rescues nothing at this route (ROADMAP.md Queue 3, fault G). Only
      this route opens the ``psra.lp.pass`` span around the pass.
    * the structured route's warm K1 rescue belongs to its own solver
      (``lp_ipm_structured``); here m <= 72 (dense operators: the
      multi-area LP, the tests) runs the pass alone.
    """
    route = lp_route(b.shape[1])
    ladder = route.rescue == "ladder"
    schur = ladder and ops.schur_factor is not None
    run = _ipm(c, b, l, u, ops, cfg,
               None if schur else route.kernels(c.device), cfg.iterations)
    x0 = 0.5 * (l + u) if x_init is None else x_init
    with span("lp.pass") if route.rescue == "flagged" else nullcontext():
        sol = run(x0)
    width = u - l

    def inset(xv, frac):
        return torch.clamp(xv, l + frac * width, u - frac * width)

    n_restarts = int(ladder) if cfg.restarts is None else cfg.restarts
    # A buffer no larger than restart_compact takes the whole-buffer
    # "compacted" restart: a full restart, but through the dense rescue
    # sub-solve, which must not share the Schur bulk pass's failure mode.
    k = min(cfg.restart_compact, c.shape[0])
    if ladder and n_restarts > 0 and k > 0:
        score = _quality(sol)
        if _gate(score, cfg.escalate_tol):
            sol = _rescue(c, b, l, u, ops, cfg, sol, score, k)
        n_restarts = 0   # the rescue ladder replaces the full restarts
    for _ in range(n_restarts):
        sol = _merge_lanes(run(inset(sol.x, 0.02)), sol)
    # Escalation: further warm passes, deeper inside the box each time,
    # while some lane stays past the evaluator's trust tolerance.
    for i in range(cfg.escalate_passes if ladder else 0):
        if not _gate(_quality(sol), cfg.escalate_tol):
            break
        sol = _merge_lanes(run(inset(sol.x, (0.05, 0.1)[min(i, 1)])), sol)
    if route.rescue == "flagged":
        sol = _rescue_flagged(c, b, l, u, ops, cfg, sol, valid)
    return sol


def _ipm(c, b, l, u, ops: LinOps, cfg: IPMConfig, kernels: LPKernels | None,
         iterations: int) -> Callable[[torch.Tensor], LPBatchSolution]:
    """One pass of the IPM as a function of its start point x (strictly
    inside the box): ``iterations`` predictor-corrector steps (damped pure
    centering once mu < ``cfg.center_tol``), per-lane freezing at
    ``cfg.mu_tol`` or on a non-finite step, best-iterate tracking and
    :func:`polish_box_lp`. ``kernels`` factor and solve every normal
    matrix; None takes the block-Schur solve of ``ops``
    (:func:`_schur_solvers`) instead."""
    B, n = c.shape
    margin = 1e-9 * _pos(u - l)
    tau = cfg.tau

    if kernels is None:
        s_factor, nsolve = _schur_solvers(
            ops.mv, ops.mtv, ops.schur_factor, ops.schur_solve,
            cfg.regularization)

        def nfactor(d):
            return s_factor(1.0 / d)
    else:
        factor, chol_solve = kernels[:2]

        def nfactor(d):
            return _equilibrated_factor(factor, ops.normal(d),
                                        cfg.regularization)

        def nsolve(chol_s, rhs):
            return _eq_solve(chol_solve, chol_s, rhs)

    def newton_step(d, sl, su, zl, zu, rd, rp, rcl, rcu, chol_s):
        rhat = rd - rcl / sl + rcu / su
        rhs = rp + ops.mv(rhat / d)
        dy = nsolve(chol_s, rhs)
        dx = (ops.mtv(dy) - rhat) / d
        dzl = (rcl - zl * dx) / sl
        dzu = (rcu + zu * dx) / su
        return dx, dy, dzl, dzu

    def ratio(num, den, mask):
        return torch.where(mask, num / den, 1e30).amin(-1)

    def max_step(sl, su, zl, zu, dx, dzl, dzu):
        ap = torch.minimum(
            ratio(-sl, torch.clamp_max(dx, -1e-30), dx < 0),
            ratio(su, torch.clamp_min(dx, 1e-30), dx > 0))
        ad = torch.minimum(
            ratio(-zl, torch.clamp_max(dzl, -1e-30), dzl < 0),
            ratio(-zu, torch.clamp_max(dzu, -1e-30), dzu < 0))
        return (torch.clamp_max(tau * ap, 1.0)[:, None],
                torch.clamp_max(tau * ad, 1.0)[:, None])

    def one_pass(x) -> LPBatchSolution:
        y = torch.zeros_like(b)
        zl, zu = torch.ones_like(c), torch.ones_like(c)
        done = torch.zeros(B, dtype=torch.bool, device=c.device)
        best_score = torch.full((B,), float("inf"), dtype=c.dtype,
                                device=c.device)
        best_x = x
        for _ in range(iterations):
            sl = _pos(x - l)
            su = _pos(u - x)
            rp = b - ops.mv(x)
            rd = c - ops.mtv(y) - zl + zu
            mu = (_bdot(sl, zl) + _bdot(su, zu)) / (2 * n)

            score = mu + rp.abs().amax(-1)
            better = score < best_score
            best_score = torch.where(better, score, best_score)
            best_x = torch.where(better[:, None], x, best_x)

            done = done | (mu < cfg.mu_tol)
            d = torch.clamp(zl / sl + zu / su, 1e-6, 1e10)
            chol_s = nfactor(d)
            centering = (mu < cfg.center_tol)[:, None]

            dxa, dya, dzla, dzua = newton_step(
                d, sl, su, zl, zu, rd, rp, -sl * zl, -su * zu, chol_s)
            apa, ada = max_step(sl, su, zl, zu, dxa, dzla, dzua)
            mu_aff = (_bdot(sl + apa * dxa, zl + ada * dzla)
                      + _bdot(su - apa * dxa, zu + ada * dzua)) / (2 * n)
            sigma = torch.where(
                centering[:, 0], 0.5,
                torch.clamp((mu_aff / _pos(mu)) ** 3, 0.0, 1.0))[:, None]
            gate = torch.where(centering, 0.0, 1.0)

            rcl = sigma * mu[:, None] - sl * zl - gate * dxa * dzla
            rcu = sigma * mu[:, None] - su * zu + gate * dxa * dzua
            dx, dy, dzl, dzu = newton_step(
                d, sl, su, zl, zu, rd, rp, rcl, rcu, chol_s)
            ap, ad = max_step(sl, su, zl, zu, dx, dzl, dzu)
            damp = torch.where(centering, 0.9, 1.0)
            ap = damp * ap
            ad = damp * ad

            xn = torch.clamp(x + ap * dx, l + margin, u - margin)
            yn = y + ad * dy
            zln = _pos(zl + ad * dzl)
            zun = _pos(zu + ad * dzu)
            finite = (torch.isfinite(xn).all(-1) & torch.isfinite(yn).all(-1)
                      & torch.isfinite(zln).all(-1)
                      & torch.isfinite(zun).all(-1))
            keep = (done | ~finite)[:, None]
            done = done | ~finite
            x = torch.where(keep, x, xn)
            y = torch.where(keep, y, yn)
            zl = torch.where(keep, zl, zln)
            zu = torch.where(keep, zu, zun)
        return polish_box_lp(
            (x, y, zl, zu, best_score, best_x), c, b, l, u, cfg,
            mv_fn=ops.mv, mtv_fn=ops.mtv, gram_fn=ops.gram,
            schur=((ops.schur_factor, ops.schur_solve) if kernels is None
                   else None), kernels=kernels)

    return one_pass


def _rescue(c, b, l, u, ops: LinOps, cfg: IPMConfig, sol: LPBatchSolution,
            score: torch.Tensor, k: int, flagged=None) -> LPBatchSolution:
    """The compacted rescue ladder of reference ``solve_box_lp_ops``
    (``run_rescue``): the ``k`` worst lanes by ``score`` are solved again
    by passes of :func:`_ipm` on the dense factor (``_LARGE_KERNELS``; no
    Schur, no restarts or escalation of their own) of
    ``cfg.rescue_iterations`` (None: ``cfg.iterations``) iterations,
    through ``cfg.rescue_stages``. A float stage is a warm
    sub-solve from the trajectory point clipped that fraction of the box
    width inside (its result is the next stage's start); None is the cold
    side branch from the box midpoint, which feeds only the merge. Each
    stage runs only while the best-so-far worst score exceeds
    ``escalate_tol``; results merge lane by lane (:func:`_merge_lanes`)
    and go back into the buffer through the same merge. ``flagged`` ([B]
    bool, or None for every lane) names the lanes whose scores the stage
    gates read."""
    idx = torch.topk(score, k).indices
    li, ui = l[idx], u[idx]
    wid = ui - li
    sub_ops = ops.take(idx)
    cs, bs = c[idx], b[idx]
    best = LPBatchSolution(*(t[idx] for t in sol))
    probe_x = best.x
    gated = None if flagged is None else flagged[idx]
    run = _ipm(cs, bs, li, ui, sub_ops, cfg, _LARGE_KERNELS,
               cfg.iterations if cfg.rescue_iterations is None
               else cfg.rescue_iterations)
    for frac in cfg.rescue_stages:
        q = _quality(best)
        if not _gate(q if gated is None else torch.where(gated, q, 0.0),
                     cfg.escalate_tol):
            break
        x0 = (0.5 * (li + ui) if frac is None
              else torch.clamp(probe_x, li + frac * wid, ui - frac * wid))
        s = run(x0)
        if frac is not None:
            probe_x = s.x
        best = _merge_lanes(s, best)
    cand = LPBatchSolution(*(t.index_copy(0, idx, v)
                             for t, v in zip(sol, best)))
    return _merge_lanes(cand, sol)


# The blocked route's rescue (72 < m <= 336). The lanes past the guard are
# rounded up to a power of two of at least RESCUE_MIN_LANES (capped at the
# buffer), so the sub-solves see few shapes; the next-worst lanes fill the
# rounding. The ladder's sub-solves take the dense factor of the m > 336
# route (_LARGE_KERNELS: one cuSOLVER Cholesky a factor, two refinement
# steps a solve): a sub-solve of a few dozen lanes is bound by its
# launches, and the blocked factor's panels, probe and substitutions
# launch several times more. On an NVIDIA H100 80GB HBM3 at 700 W, the 30
# lanes past the guard in 60 steps of the RTS-96 SEQ cell (two seeds),
# solved again 32 at a time through the whole ladder (3-4 sub-solves of 16
# iterations), took 0.61-1.05 s on the blocked factor and 0.24-0.35 s on
# the dense one; both cleared every lane, the widest gap to float64 HiGHS
# 1.0e-3 and 2.0e-3 p.u. (PERF.md §6).
RESCUE_MIN_LANES = 32


def rescue_size(n_past: int, B: int) -> int:
    """Lanes the blocked route's ladder runs for ``n_past`` lanes past the
    guard in a buffer of ``B``: 0 for none, else the next power of two of
    at least RESCUE_MIN_LANES, capped at ``B``."""
    if n_past <= 0:
        return 0
    return min(B, max(RESCUE_MIN_LANES, 1 << (n_past - 1).bit_length()))


def _rescue_flagged(c, b, l, u, ops: LinOps, cfg: IPMConfig,
                    sol: LPBatchSolution, valid) -> LPBatchSolution:
    """72 < m <= 336: every lane of ``valid`` (None: every lane) whose
    quality score is past ``escalate_tol`` (NaN included) after the pass
    goes through :func:`_rescue`, warm from the polished point, its
    sub-solves on the dense factor; one host read counts them (in
    ``psra.lp.wait``), and a clean buffer does no more. Only those lanes
    take the ladder's answer: the lanes that fill the rounding, as every
    lane that passed the guard, keep their bits. The counters
    ``lp.rescue_demand`` (those lanes) and ``lp.rescue_lanes`` (the
    ladder's lanes, after :func:`rescue_size`) take each call. A lane the
    ladder leaves past the guard falls back in ``dcopf._finalize`` as
    before."""
    score = torch.nan_to_num(_quality(sol), nan=float("inf"))
    past = ~(score <= cfg.escalate_tol)
    if valid is not None:
        past = past & valid
        score = torch.where(valid, score, -float("inf"))
    n_past = past.sum()
    with span("lp.wait"):
        n_past = int(n_past)
    k = rescue_size(n_past, c.shape[0])
    count("lp.rescue_demand", n_past)
    count("lp.rescue_lanes", k)
    if k == 0:
        return sol
    with span("lp.rescue"):
        got = _rescue(c, b, l, u, ops, cfg, sol, score, k, flagged=past)
        return LPBatchSolution(*(
            torch.where(past[:, None] if a.dim() == 2 else past, a, o)
            for a, o in zip(got, sol)))
