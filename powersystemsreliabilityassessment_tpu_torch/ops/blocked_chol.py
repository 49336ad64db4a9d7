"""Blocked batched Cholesky for systems wider than the direct K2 kernel.

Port of ``powersystemsreliabilityassessment_tpu/ops/blocked_chol.py``
(``blocked_cholesky``, ``blocked_cho_solve``, ``explicit_spd_inv`` and the
K3 kernels ``trsm_fwd`` / ``trsm_bwd``) in batch-major layout, [B, m, m] and
[B, m]; ``to_batch_minor`` / ``from_batch_minor`` are not needed. A
left-looking panel factorization:

    for each diagonal panel j:                (panel width <= PANEL)
        S_jj = M_jj - sum_k L_jk L_jk'        (torch.matmul)
        L_jj = chol(S_jj + lift)              (K2, ops/batched_chol.py)
        for each i > j:
            B = M_ij - sum_k L_ik L_jk'       (torch.matmul)
            L_ij' = L_jj^-1 B'                (K3 forward, K = panel height)

Solves walk the panels forward, then backward, with K3 on one
right-hand side. The cross-panel products are plain ``torch.matmul``, as
the reference leaves them to XLA.

``trsm_fwd`` and ``trsm_bwd`` are the wrappers: on a CUDA tensor they
launch the hand-written kernel of ``csrc/blocked_trsm.cu`` (or raise); on
a CPU tensor they run ``trsm_fwd_plain`` / ``trsm_bwd_plain``, the same
row-by-row substitution in plain PyTorch. ``launches`` counts kernel
launches; ``rescues`` counts the probe's fragile-lane rescues.
``explicit_spd_inv`` (the large-m LP's block-Schur inverses) runs K3 on
identity right-hand sides.
"""
from __future__ import annotations

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import (
    batched_chol as bc, cuda_build)
from powersystemsreliabilityassessment_tpu_torch.utils.profiling import span

# Widest diagonal panel (reference PANEL = 56, sized for the TPU's VMEM;
# RTS-96's m = 191 splits 56 + 56 + 56 + 23). The kernels take P <= 64.
PANEL = 56
MAX_P = 64
# Largest m the blocked factor serves (reference _BLOCKED_MAX_M = 336, a
# TPU crossover): the LP route of 72 < m <= 336
# (engines/lp_ipm_batched.lp_route) and the explicit inverses of
# ops/xla_chol.inv_spd_equilibrated. Past it the dense factor takes over.
MAX_M = 336

# Relative diagonal lift of each panel's Schur complement, removed from
# the solution by REFINE_STEPS refinement steps against the unlifted M
# (reference ops/blocked_chol.py:113-127: float32 Schur updates of
# ill-conditioned normal matrices can lose positive definiteness).
LIFT = 1e-5
REFINE_STEPS = 2

# A factor whose probe solve M x = M 1 misses x = 1 by more than this
# (max |x - 1|) lost positive definiteness past the lift; its lane is
# re-factored by torch.linalg.cholesky_ex (reference :129-143).
PROBE_BAD_REL = 1e-2

launches = {"trsm_fwd": 0, "trsm_bwd": 0}
# Factorizations that took the rescue branch, lanes the probe flagged,
# lanes spliced from the rescue factor (a 0-d tensor on the device once a
# rescue ran: read it with int()), and lanes factored in all (the rescued
# share's denominator).
rescues = {"factorizations": 0, "lanes_flagged": 0, "lanes": 0,
           "lanes_factored": 0}


def trsm_fwd_plain(L: torch.Tensor, Bm: torch.Tensor) -> torch.Tensor:
    """X = L^-1 B per lane, L [B, P, P] lower, B [B, P, K]: row-by-row
    forward substitution dividing by l_ii (reference
    ``_trsm_fwd_kernel``)."""
    x = Bm.clone()
    for i in range(L.shape[-1]):
        s = (L[:, i, :i, None] * x[:, :i, :]).sum(1)
        x[:, i, :] = (x[:, i, :] - s) / L[:, i, i, None]
    return x


def trsm_bwd_plain(L: torch.Tensor, Bm: torch.Tensor) -> torch.Tensor:
    """X = L^-T B per lane: backward substitution on L's columns
    (reference ``_trsm_bwd_kernel``)."""
    x = Bm.clone()
    for i in range(L.shape[-1] - 1, -1, -1):
        s = (L[:, i + 1:, i, None] * x[:, i + 1:, :]).sum(1)
        x[:, i, :] = (x[:, i, :] - s) / L[:, i, i, None]
    return x


def _trsm(L: torch.Tensor, Bm: torch.Tensor, forward: bool) -> torch.Tensor:
    name = "trsm_fwd" if forward else "trsm_bwd"
    B, P, K = Bm.shape
    if P > MAX_P:
        raise ValueError(f"{name}: the kernel takes P <= {MAX_P}, got {P}")
    cuda_build.check_operand(L, "L", (B, P, P))
    cuda_build.check_operand(Bm, "B", (B, P, K))
    if L.device != Bm.device:
        raise ValueError(f"{name}: L and B are on different devices")
    X = torch.empty_like(Bm)
    err = cuda_build.library().psra_trsm(
        L.data_ptr(), Bm.data_ptr(), X.data_ptr(), B, P, K, int(forward),
        cuda_build.stream_handle(Bm))
    cuda_build.check_launch(err, name)
    launches[name] += 1
    return X


def trsm_fwd(L: torch.Tensor, Bm: torch.Tensor) -> torch.Tensor:
    """X = L^-1 B, L [B, P, P] lower, B [B, P, K]. Mirrors reference
    ``ops/blocked_chol.py::trsm_fwd`` in batch-major layout. CUDA: the K3
    kernel; CPU: :func:`trsm_fwd_plain`."""
    if L.device.type == "cpu" and Bm.device.type == "cpu":
        return trsm_fwd_plain(L, Bm)
    return _trsm(L, Bm, True)


def trsm_bwd(L: torch.Tensor, Bm: torch.Tensor) -> torch.Tensor:
    """X = L^-T B, L [B, P, P] lower, B [B, P, K]. Mirrors reference
    ``ops/blocked_chol.py::trsm_bwd`` in batch-major layout. CUDA: the K3
    kernel; CPU: :func:`trsm_bwd_plain`."""
    if L.device.type == "cpu" and Bm.device.type == "cpu":
        return trsm_bwd_plain(L, Bm)
    return _trsm(L, Bm, False)


def _panels(m: int):
    """Static panel split of m into widths <= PANEL; mirrors reference
    ``ops/blocked_chol.py::_panels``."""
    edges = list(range(0, m, PANEL)) + [m]
    return [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)]


def _matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[:, :, None])[:, :, 0]


def _factor_once(M: torch.Tensor):
    """One blocked panel-factorization pass with the standard lift;
    mirrors reference ``ops/blocked_chol.py::_factor_once``. Returns
    (panels, diagonal factors Ls[j] [B, pj, pj], off-diagonal blocks
    Loff[(i, j)] [B, pi, pj])."""
    panels = _panels(M.shape[-1])
    Ls: list = []
    Loff: dict = {}
    for j, (j0, j1) in enumerate(panels):
        S = M[:, j0:j1, j0:j1]
        for k in range(j):
            Ljk = Loff[(j, k)]
            S = S - Ljk @ Ljk.transpose(1, 2)
        lift = LIFT * torch.clamp_min(torch.diagonal(S, dim1=1, dim2=2),
                                      1e-30)
        Lj = bc.cholesky((S + torch.diag_embed(lift)).contiguous())
        Ls.append(Lj)
        for i in range(j + 1, len(panels)):
            i0, i1 = panels[i]
            Bij = M[:, i0:i1, j0:j1]
            for k in range(j):
                Bij = Bij - Loff[(i, k)] @ Loff[(j, k)].transpose(1, 2)
            # L_ij = B L_jj^-T  <=>  L_ij' = L_jj^-1 B'
            Xt = trsm_fwd(Lj, Bij.transpose(1, 2).contiguous())
            Loff[(i, j)] = Xt.transpose(1, 2)
    return panels, Ls, Loff


def _blocked_substitute(panels, Ls, Loff, r: torch.Tensor) -> torch.Tensor:
    """One forward and backward substitution pass through the panel
    factor; mirrors reference ``ops/blocked_chol.py::_blocked_substitute``.
    """
    n_p = len(panels)
    # forward: y_i = L_ii^-1 (r_i - sum_{k<i} L_ik y_k)
    ys = []
    for i, (i0, i1) in enumerate(panels):
        ri = r[:, i0:i1]
        for k in range(i):
            ri = ri - _matvec(Loff[(i, k)], ys[k])
        ys.append(trsm_fwd(Ls[i], ri[:, :, None].contiguous())[:, :, 0])
    # backward: x_i = L_ii^-T (y_i - sum_{k>i} L_ki' x_k)
    xs = [None] * n_p
    for i in range(n_p - 1, -1, -1):
        yi = ys[i]
        for k in range(i + 1, n_p):
            yi = yi - _matvec(Loff[(k, i)].transpose(1, 2), xs[k])
        xs[i] = trsm_bwd(Ls[i], yi[:, :, None].contiguous())[:, :, 0]
    return torch.cat(xs, dim=1)


def _probe(panels, Ls, Loff, M: torch.Tensor) -> torch.Tensor:
    """[B] bool: lanes whose factor misses x = 1 in M x = M 1, solved
    through the real refinement schedule, by more than PROBE_BAD_REL
    (reference ``blocked_cholesky``'s ``bad``)."""
    r = M.sum(2)
    x = _blocked_substitute(panels, Ls, Loff, r)
    for _ in range(REFINE_STEPS):
        x = x + _blocked_substitute(panels, Ls, Loff, r - _matvec(M, x))
    return (x - 1.0).abs().amax(1) > PROBE_BAD_REL


def blocked_cholesky(M: torch.Tensor):
    """Batched blocked Cholesky, M [B, m, m] -> (panels, Ls, Loff, M);
    mirrors reference ``ops/blocked_chol.py::blocked_cholesky``.

    ``M`` is kept for the refinement in :func:`blocked_cho_solve`. The
    probe (:func:`_probe`) flags lanes whose factor lost positive
    definiteness past the lift; their indices are read on the host (the
    one sync per factorization, in a ``psra.lp.wait`` span), and when
    there are any, those lanes are factored once more by
    ``torch.linalg.cholesky_ex``. Lanes whose
    ``cholesky_ex`` succeeded (info == 0) get their panels from that
    factor; a lane that fails both keeps the blocked factor, and the
    evaluator's quality guard downstream decides it, as in the reference.
    The reference re-factors the whole batch and selects the flagged
    lanes; factoring only those gives the same lanes the same factor.
    """
    panels, Ls, Loff = _factor_once(M)
    rescues["lanes_factored"] += M.shape[0]
    flagged = _probe(panels, Ls, Loff, M)
    with span("lp.wait"):
        idx = torch.nonzero(flagged).flatten()
    if idx.numel():
        Lx, info = torch.linalg.cholesky_ex(M[idx])
        ok = (info == 0)[:, None, None]
        rescues["factorizations"] += 1
        rescues["lanes_flagged"] += idx.numel()
        # Summed on the device, so counting costs no second sync.
        rescues["lanes"] = rescues["lanes"] + ok.sum()

        def splice(L, rows, cols):
            # cholesky_ex may return column-major factors; the K2/K3
            # kernels take row-major panels.
            Lx_rc = Lx[:, rows[0]:rows[1], cols[0]:cols[1]]
            return L.index_copy(0, idx, torch.where(ok, Lx_rc, L[idx])
                                .contiguous())

        Ls = [splice(Lj, p, p) for p, Lj in zip(panels, Ls)]
        Loff = {(i, j): splice(Lij, panels[i], panels[j])
                for (i, j), Lij in Loff.items()}
    return panels, Ls, Loff, M


def blocked_cho_solve(factor, r: torch.Tensor) -> torch.Tensor:
    """Solve M x = r, r [B, m], given ``blocked_cholesky(M)``; mirrors
    reference ``ops/blocked_chol.py::blocked_cho_solve``.

    The substitution solves the lifted system; REFINE_STEPS steps of
    iterative refinement against the unlifted M remove the lift, and the
    iterate with the smallest max-norm residual is returned (refinement
    can diverge on a lane whose factor lost positive definiteness).
    """
    panels, Ls, Loff, M = factor
    x = _blocked_substitute(panels, Ls, Loff, r)
    res = r - _matvec(M, x)
    best_x, best_rn = x, res.abs().amax(1)
    for _ in range(REFINE_STEPS):
        x = x + _blocked_substitute(panels, Ls, Loff, res)
        res = r - _matvec(M, x)
        rn = res.abs().amax(1)
        best_x = torch.where((rn < best_rn)[:, None], x, best_x)
        best_rn = torch.minimum(rn, best_rn)
    return best_x


def explicit_spd_inv(M: torch.Tensor) -> torch.Tensor:
    """Explicit M^-1 of an SPD batch [B, m, m] through the blocked factor;
    mirrors reference ``ops/blocked_chol.py::explicit_spd_inv``.

    :func:`blocked_cholesky` (K2a on the diagonal panels, K3 on the
    blocks below them, the probe and its rescue), then each panel's
    L_ii^-1 by K3 ``trsm_fwd`` on identity right-hand sides, L^-1
    assembled by block forward substitution in matmuls, and M^-1 =
    L^-T L^-1. The panel lift and the explicit inverse's rounding are
    left to the caller's refinement against the true operator.
    """
    panels, Ls, Loff, _ = blocked_cholesky(M)
    B = M.shape[0]
    inv_diag = []
    for (i0, i1), Li in zip(panels, Ls):
        p = i1 - i0
        eye = torch.eye(p, dtype=M.dtype, device=M.device)
        inv_diag.append(trsm_fwd(Li, eye.expand(B, p, p).contiguous()))
    Linv = torch.zeros_like(M)
    p0 = panels[0][1]
    Linv[:, :p0, :p0] = inv_diag[0]
    for i in range(1, len(panels)):
        i0, i1 = panels[i]
        slab = torch.cat([Loff[(i, k)] for k in range(i)], dim=2)
        S = slab @ Linv[:, :i0, :i0]
        Linv[:, i0:i1, :i0] = -(inv_diag[i] @ S)
        Linv[:, i0:i1, i0:i1] = inv_diag[i]
    return Linv.transpose(1, 2) @ Linv
