"""Batched box-LP interior-point solver and the LP kernel routes.

Port of ``powersystemsreliabilityassessment_tpu/engines/lp_ipm_batched.py``:
``LPBatchSolution``, ``_pos``, ``polish_box_lp``, the materialized-A
solver (``LinOps``, ``dense_linops``, ``solve_box_lp_batched``,
``solve_box_lp_ops``) and the backend choice ``_make_chol_ops``. The
reference picks its backend in several places (``on_tpu`` branches here
and in ``dcopf._solve_batch``); the port has one place,
:func:`lp_kernels`, that every LP caller reads, and one guard,
:func:`check_lp_rows`, for the row counts it solves. The large-m
machinery (m > 336: the warm restarts and ``_merge_lanes``, the
compacted restart, the rescue ladder, the escalation passes, the
block-Schur operator fields of ``LinOps`` and ``LinOps.take``) is not
ported yet (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import (
    batched_chol as bc, blocked_chol, ipm_fused)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)


class LPBatchSolution(NamedTuple):
    """Mirrors reference ``engines/lp_ipm_batched.py::LPBatchSolution``."""
    x: torch.Tensor                # [B, n]
    objective: torch.Tensor        # [B]
    primal_residual: torch.Tensor  # [B]
    duality_gap: torch.Tensor      # [B]


def _pos(a, eps=1e-12):
    """max(a, eps); mirrors reference ``lp_ipm_batched.py::_pos``."""
    return torch.clamp_min(a, eps)


class LPKernels(NamedTuple):
    """The kernels one LP route runs."""
    factor: Callable      # [B, m, m] -> Cholesky factor
    solve: Callable       # (factor, [B, m]) -> solution
    iterate: Callable | None  # fused Mehrotra loop (ops/ipm_fused.py), m <= 72


# Largest m of the fused and direct batched-Cholesky kernels (reference
# _PALLAS_MAX_M = _FUSED_MAX_M = 72: a TPU VMEM budget, not yet measured
# again on the H100 — PERF.md, Open questions), and of the blocked
# Cholesky (reference _BLOCKED_MAX_M = 336, a TPU crossover).
_PALLAS_MAX_M = bc.MAX_M
_BLOCKED_MAX_M = 336

# m <= 72, device type -> kernels: on CUDA the hand-written K1 fused IPM
# and K2 batched Cholesky, on the CPU their plain PyTorch versions.
_DIRECT_KERNELS = {
    "cuda": LPKernels(bc.cholesky, bc.cho_solve,
                      ipm_fused.fused_ipm_iterations),
    "cpu": LPKernels(bc.cholesky_plain, bc.cho_solve_plain,
                     ipm_fused.fused_ipm_iterations_plain),
}
# 72 < m <= 336, any device: the panel-blocked Cholesky of
# ops/blocked_chol.py, whose K2 and K3 wrappers launch the kernels on
# CUDA tensors and run the plain versions on CPU tensors. This differs on
# purpose from the reference's CPU route, which takes jnp.linalg.cholesky
# at m > 72: routing the CPU through the blocked code lets the CPU tests
# reach its glue.
_BLOCKED_KERNELS = LPKernels(blocked_chol.blocked_cholesky,
                             blocked_chol.blocked_cho_solve, None)


def check_lp_rows(m: int) -> None:
    """Raise NotImplementedError for an LP the port cannot solve yet."""
    if m > _BLOCKED_MAX_M:
        raise NotImplementedError(
            f"LP with m = {m} > {_BLOCKED_MAX_M} rows: the large-m path "
            "(xla_chol, explicit_spd_inv, the rescue ladder) is not ported "
            "yet (ROADMAP.md Queue 1 item 6)")


def lp_kernels(device: torch.device, m: int) -> LPKernels:
    """The LP kernels for ``device`` and row count ``m``."""
    check_lp_rows(m)
    if m > _PALLAS_MAX_M:
        return _BLOCKED_KERNELS
    dev = torch.device(device).type
    if dev not in _DIRECT_KERNELS:
        raise NotImplementedError(f"no LP kernels for device {device}")
    return _DIRECT_KERNELS[dev]


def _make_chol_ops(device: torch.device, m: int):
    """(factor, solve) for ``device`` and ``m``; mirrors reference
    ``lp_ipm_batched.py::_make_chol_ops`` through :func:`lp_kernels`."""
    k = lp_kernels(device, m)
    return k.factor, k.solve


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


def polish_box_lp(state, c, b, l, u, cfg: IPMConfig, mv_fn, mtv_fn,
                  gram_fn) -> LPBatchSolution:
    """Post-iteration polish; mirrors reference
    ``engines/lp_ipm_batched.py::polish_box_lp`` (dense-factor branch).

    ``state`` is ``(x, y, zl, zu, best_score, best_x)``; the constraint
    operator comes as ``mv_fn(v) -> A v``, ``mtv_fn(y) -> A' y`` and
    ``gram_fn(w) -> A diag(w) A'``. Steps: best-iterate selection,
    projection onto Ax = b, a Woodbury crossover snap toward the active
    bounds kept only when it does not worsen feasibility or objective,
    and the final residual and duality-gap report.
    """
    x, y, zl, zu, best_score, best_x = state
    B, n = x.shape
    m = b.shape[1]
    factor, chol_solve = _make_chol_ops(x.device, m)
    eye_m = torch.eye(m, dtype=x.dtype, device=x.device)

    def equilibrated_chol(M):
        return _equilibrated_factor(factor, M, cfg.regularization)

    def eq_solve(chol_s, rhs):
        return _eq_solve(chol_solve, chol_s, rhs)

    chol_aat = equilibrated_chol(gram_fn(torch.ones_like(x)))

    def project(xv):
        return xv + mtv_fn(eq_solve(chol_aat, b - mv_fn(xv)))

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
    cholK = equilibrated_chol(gram_fn(winv) + eye_m)
    t1 = winv * rhs
    t2 = eq_solve(cholK, mv_fn(t1))
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
    ``engines/lp_ipm_batched.py::LinOps`` without the block-Schur fields
    and ``take`` (both serve only m > 336). ``normal`` stays apart from
    ``gram`` so the dense operator keeps its symmetric square-root
    rounding."""
    mv: Callable      # v [B, n] -> A v                 [B, m]
    mtv: Callable     # y [B, m] -> A' y                [B, n]
    gram: Callable    # w [B, n] -> A diag(w) A'        [B, m, m]
    normal: Callable  # d [B, n] -> A diag(1/d) A'      [B, m, m]


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

    return LinOps(mv, mtv, gram, normal)


def solve_box_lp_batched(c, A, b, l, u,
                         cfg: IPMConfig = IPMConfig()) -> LPBatchSolution:
    """Solve a batch of LPs min c'x s.t. Ax = b, l <= x <= u; c, l, u
    [B, n], A [B, m, n], b [B, m], float32 on one device. Mirrors
    reference ``engines/lp_ipm_batched.py::solve_box_lp_batched`` (without
    ``x_init``, which only the large-m recursion passes)."""
    return solve_box_lp_ops(c, b, l, u, dense_linops(A), cfg)


def solve_box_lp_ops(c, b, l, u, ops: LinOps,
                     cfg: IPMConfig = IPMConfig()) -> LPBatchSolution:
    """Batched Mehrotra IPM over a constraint operator, then the polish;
    mirrors reference ``engines/lp_ipm_batched.py::solve_box_lp_ops`` for
    m <= 336: the box-midpoint start, ``cfg.iterations`` predictor-
    corrector steps (damped pure centering once mu < ``center_tol``),
    per-lane freezing at ``mu_tol`` or on a non-finite step, best-iterate
    tracking and ``polish_box_lp``. The reference's warm restarts
    (``IPMConfig.restarts``) run only at m > 336 and are not ported.
    Every normal matrix goes through :func:`_make_chol_ops` (at
    72 < m <= 336 the blocked Cholesky)."""
    B, n = c.shape
    m = b.shape[1]
    factor, chol_solve = _make_chol_ops(c.device, m)
    margin = 1e-9 * _pos(u - l)
    tau = cfg.tau

    def nfactor(d):
        return _equilibrated_factor(factor, ops.normal(d), cfg.regularization)

    def newton_step(d, sl, su, zl, zu, rd, rp, rcl, rcu, chol_s):
        rhat = rd - rcl / sl + rcu / su
        rhs = rp + ops.mv(rhat / d)
        dy = _eq_solve(chol_solve, chol_s, rhs)
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

    x, y = 0.5 * (l + u), torch.zeros_like(b)
    zl, zu = torch.ones_like(c), torch.ones_like(c)
    done = torch.zeros(B, dtype=torch.bool, device=c.device)
    best_score = torch.full((B,), float("inf"), dtype=c.dtype,
                            device=c.device)
    best_x = x
    for _ in range(cfg.iterations):
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
    return polish_box_lp((x, y, zl, zu, best_score, best_x), c, b, l, u,
                         cfg, mv_fn=ops.mv, mtv_fn=ops.mtv,
                         gram_fn=ops.gram)
