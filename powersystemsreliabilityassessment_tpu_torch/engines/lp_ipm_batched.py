"""Batched box-LP interior-point pieces shared by the LP paths.

Port of ``powersystemsreliabilityassessment_tpu/engines/lp_ipm_batched.py``,
the parts the structured small-m path needs: ``LPBatchSolution``,
``_pos``, ``polish_box_lp`` and the backend choice ``_make_chol_ops``.
The reference picks its backend in several places (``on_tpu`` branches
here and in ``dcopf._solve_batch``); the port has one table,
:data:`_LP_KERNELS`, keyed by (device type, m <= 72), that every LP
caller reads. The generic materialized-A solver (``solve_box_lp_batched``,
``solve_box_lp_ops``, ``LinOps``) and the large-m rescue ladder are not
ported yet (ROADMAP.md Queue 1 items 5 and 12).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import (
    batched_chol as bc, ipm_fused)
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
    """The kernels one (device, m) route runs."""
    factor: Callable      # [B, m, m] -> Cholesky factor
    solve: Callable       # (factor, [B, m]) -> solution
    iterate: Callable     # fused Mehrotra loop (ops/ipm_fused.py)


# Largest m of the fused and batched-Cholesky kernels (reference
# _PALLAS_MAX_M = _FUSED_MAX_M = 72: a TPU VMEM budget, not yet measured
# again on the H100 — PERF.md, Open questions).
_PALLAS_MAX_M = bc.MAX_M

# (device type, m <= _PALLAS_MAX_M) -> kernels. CUDA runs the hand-written
# kernels (K1 fused IPM, K2 batched Cholesky); CPU runs their plain
# PyTorch versions.
_LP_KERNELS = {
    ("cuda", True): LPKernels(bc.cholesky, bc.cho_solve,
                              ipm_fused.fused_ipm_iterations),
    ("cpu", True): LPKernels(bc.cholesky_plain, bc.cho_solve_plain,
                             ipm_fused.fused_ipm_iterations_plain),
}


def lp_kernels(device: torch.device, m: int) -> LPKernels:
    """The LP kernels for ``device`` and row count ``m``."""
    key = (torch.device(device).type, m <= _PALLAS_MAX_M)
    if key in _LP_KERNELS:
        return _LP_KERNELS[key]
    if m > _PALLAS_MAX_M:
        raise NotImplementedError(
            f"LP with m = {m} > {_PALLAS_MAX_M} rows: the blocked "
            "Cholesky (K3) and large-m paths are not ported yet "
            "(ROADMAP.md Queue 1 items 11-12, Queue 2 K3)")
    raise NotImplementedError(f"no LP kernels for device {device}")


def _make_chol_ops(device: torch.device, m: int):
    """(factor, solve) for ``device`` and ``m``; mirrors reference
    ``lp_ipm_batched.py::_make_chol_ops`` through :func:`lp_kernels`."""
    k = lp_kernels(device, m)
    return k.factor, k.solve


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
    delta = cfg.regularization
    eye_m = torch.eye(m, dtype=x.dtype, device=x.device)

    def bdot(p, q):
        return (p * q).sum(-1)

    def equilibrated_chol(M):
        s = torch.rsqrt(torch.clamp_min(
            torch.diagonal(M, dim1=1, dim2=2), 1e-30))
        Ms = M * s[:, :, None] * s[:, None, :] + delta * eye_m
        return factor(Ms.contiguous()), s

    def eq_solve(chol_s, rhs):
        chol, s = chol_s
        return s * chol_solve(chol, (s * rhs).contiguous())

    chol_aat = equilibrated_chol(gram_fn(torch.ones_like(x)))

    def project(xv):
        return xv + mtv_fn(eq_solve(chol_aat, b - mv_fn(xv)))

    width = u - l
    # Final candidate vs best-ever, then one projection polish.
    sl = _pos(x - l)
    su = _pos(u - x)
    rp_f = b - mv_fn(x)
    mu_f = (bdot(sl, zl) + bdot(su, zu)) / (2 * n)
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
          & (bdot(c, xp) <= bdot(c, x)))
    x = torch.where(ok[:, None], xp, x)

    rp = b - mv_fn(x)
    sl = _pos(x - l)
    su = _pos(u - x)
    mu = (bdot(sl, zl) + bdot(su, zu)) / (2 * n)
    # Weak-duality certificate: for any y, g(y) = b'y + sum_j min(r_j l_j,
    # r_j u_j) with r = c - A'y lower-bounds the optimum; the |y|'|rp|
    # cross-term keeps it rigorous for slightly infeasible x. The
    # reported gap is the smaller of it and the 2n*mu surrogate.
    r = c - mtv_fn(y)
    gap_weak = (bdot(c, x) - bdot(b, y)
                - torch.minimum(r * l, r * u).sum(-1))
    gap_weak = gap_weak + (y.abs() * rp.abs()).sum(-1)
    gap = torch.minimum(mu, _pos(gap_weak) / (2 * n))
    return LPBatchSolution(x=x, objective=bdot(c, x),
                           primal_residual=rp.abs().amax(-1),
                           duality_gap=gap)
