"""Minimum load shed of outage states: a plain batched interior-point LP.

The DC optimal power flow of one outage state, in per unit of the base
MVA: variables unit outputs Pg, load sheds s, branch flows f and bus
angles theta (bus 0 is the angle reference and has no column);

    minimize   sum(s)
    subject to Cg Pg + Cd s - Inc' f = d           (one row per bus)
               x_l f_l - up_l (theta_i - theta_j) = 0   (one row per branch)
               0 <= Pg <= pmax (down units: a zero column),
               0 <= s <= d, -rate <= f <= rate, |theta| <= S

with S the sum over branches of rate x, which no angle of a feasible flow
reaches. The loss of load is its optimum in MW. Shedding every load is
feasible, so the LP always has one.

The solver is Mehrotra's predictor-corrector on the normal equations,
dense and batched over lanes, written from the textbook and nothing
else. ``Precision("float64")`` is the reference. ``Precision("tf32")``
computes in float32 with every operand of a matrix product rounded to
TF32's 10-bit mantissa, as the H100's tensor cores round it; it is the
control of the benchmark's comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from psra_bench.reference.case import RefCase, incidence


class Precision:
    """Arithmetic of one evaluation: "float64" or "tf32"."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        self.tol = 1e-9 if name == "float64" else 1e-6
        # The normal matrix's diagonal lift, relative to its largest entry.
        self.reg = 1e-14 if name == "float64" else 1e-7

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a matrix product's operand sees it."""
        if self.name == "float64":
            return t
        bits = t.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(b))


def _structure(case: RefCase, prec: Precision, device):
    """Lane-independent pieces, p.u.: the balance block [Cg | Cd | -Inc'
    | 0], the branch rows' x and angle incidence, the column boxes."""
    nb, ng, nd, nl = case.n_bus, case.n_gen, case.n_load, case.n_branch
    base = case.base_mva
    inc = incidence(case)
    bal = np.zeros((nb, ng + nd + nl + nb - 1))
    bal[case.gen_bus, np.arange(ng)] = 1.0
    bal[case.load_bus, ng + np.arange(nd)] = 1.0
    bal[:, ng + nd:ng + nd + nl] = -inc.T
    rate = case.br_rate / base
    span = float(np.sum(rate * case.br_x)) + 1.0
    pmax = case.gen_pmax / base
    t = lambda a: torch.as_tensor(a, dtype=prec.dtype, device=device)  # noqa: E731
    return dict(bal=t(bal), x=t(case.br_x), inc_r=t(inc[:, 1:]),
                pmax=t(pmax), has_cap=t(pmax > 0), rate=t(rate), span=span)


def _lane_lp(case: RefCase, st: dict, down: torch.Tensor, d: torch.Tensor,
             prec: Precision):
    """(A [B, m, n], b [B, m], c [n], l [B, n], u [B, n]) of B states."""
    nb, ng, nd, nl = case.n_bus, case.n_gen, case.n_load, case.n_branch
    B = down.shape[0]
    dt = prec.dtype
    up = (~down).to(dt)
    gcol = up[:, :ng] * st["has_cap"]
    A = torch.zeros((B, nb + nl, ng + nd + nl + nb - 1), dtype=dt,
                    device=down.device)
    A[:, :nb] = st["bal"]
    A[:, :nb, :ng] *= gcol[:, None, :]
    f0, t0 = ng + nd, ng + nd + nl
    A[:, nb:, f0:t0] = torch.diag(st["x"])
    A[:, nb:, t0:] = -up[:, ng:, None] * st["inc_r"]
    b = torch.zeros((B, nb + nl), dtype=dt, device=down.device)
    b[:, :nb].index_add_(1, torch.as_tensor(case.load_bus, device=down.device),
                         d)
    c = torch.zeros(ng + nd + nl + nb - 1, dtype=dt, device=down.device)
    c[ng:ng + nd] = 1.0
    ones = lambda k: torch.ones((B, k), dtype=dt, device=down.device)  # noqa: E731
    # A unit out of service, or of no capacity, is a zero column in a
    # unit box.
    pmax = torch.where(gcol > 0, st["pmax"].expand(B, ng), ones(ng))
    l = torch.cat([0 * ones(ng), 0 * ones(nd), -st["rate"].expand(B, nl),
                   -st["span"] * ones(nb - 1)], dim=1)
    u = torch.cat([pmax, torch.clamp_min(d, 1e-9), st["rate"].expand(B, nl),
                   st["span"] * ones(nb - 1)], dim=1)
    return A, b, c, l, u


def solve_box_lp(A, b, c, l, u, prec: Precision, max_iter: int = 120):
    """min c'x, A x = b, l <= x <= u for every lane; returns (x [B, n],
    merit [B]), the merit of the iterate returned."""
    B, m, n = A.shape
    tau = 0.995
    x = (l + u) / 2
    zl = torch.ones_like(x)
    zu = torch.ones_like(x)
    y = torch.zeros((B, m), dtype=A.dtype, device=A.device)
    At = A.transpose(1, 2)
    mv = lambda M, v: prec.mm(M, v[:, :, None])[:, :, 0]  # noqa: E731
    bnorm = 1.0 + b.abs().amax(1)
    done = torch.zeros(B, dtype=torch.bool, device=A.device)
    # The iterate of least merit (worst of relative primal residual, dual
    # residual and complementarity) is the answer: past convergence the
    # normal equations lose their conditioning and the iterates wander.
    best = torch.full((B,), float("inf"), dtype=A.dtype, device=A.device)
    x_best = x

    def step_len(v, dv):
        # Largest a in (0, 1] with v + a dv >= 0.
        ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), 2.0)
        return torch.clamp(ratio.amin(1), max=1.0)

    # The slacks x - l and u - x are kept as variables of their own: taken
    # by subtraction near a bound they would round to 0.
    sl, su = x - l, u - x
    for _ in range(max_iter):
        rp = b - mv(A, x)
        rd = c - mv(At, y) - zl + zu
        mu = ((sl * zl).sum(1) + (su * zu).sum(1)) / (2 * n)
        merit = torch.maximum(torch.maximum(rp.abs().amax(1) / bnorm,
                                            rd.abs().amax(1)), mu)
        better = merit < best
        best = torch.where(better, merit, best)
        x_best = torch.where(better[:, None], x, x_best)
        done = done | (merit < prec.tol)
        if bool(done.all()):
            break
        D = 1.0 / (zl / sl + zu / su)
        M = prec.mm(A * D[:, None, :], At)
        diag = M.diagonal(dim1=1, dim2=2)
        M = M + torch.diag_embed(
            prec.reg * diag.amax(1, keepdim=True).expand_as(diag))
        L, _ = torch.linalg.cholesky_ex(M)

        def direction(gl, gu):
            r1 = rd - gl / sl + gu / su
            rhs = rp + mv(A, D * r1)
            dy = torch.cholesky_solve(rhs[:, :, None], L)[:, :, 0]
            dx = D * (mv(At, dy) - r1)
            return dx, dy, (gl - zl * dx) / sl, (gu + zu * dx) / su

        dx, dy, dzl, dzu = direction(-sl * zl, -su * zu)
        ap = torch.minimum(step_len(sl, dx), step_len(su, -dx))
        ad = torch.minimum(step_len(zl, dzl), step_len(zu, dzu))
        mu_aff = (((sl + ap[:, None] * dx) * (zl + ad[:, None] * dzl)).sum(1)
                  + ((su - ap[:, None] * dx) * (zu + ad[:, None] * dzu)
                     ).sum(1)) / (2 * n)
        sigma = (mu_aff / torch.clamp_min(mu, 1e-300)).clamp(0, 1) ** 3
        sm = (sigma * mu)[:, None]
        dx, dy, dzl, dzu = direction(sm - sl * zl - dx * dzl,
                                     sm - su * zu + dx * dzu)
        ap = tau * torch.minimum(step_len(sl, dx), step_len(su, -dx))
        ad = tau * torch.minimum(step_len(zl, dzl), step_len(zu, dzu))
        ok = ~done[:, None] & torch.isfinite(dx).all(1, keepdim=True) \
            & torch.isfinite(dzl + dzu).all(1, keepdim=True)
        move = lambda v, a, dv: torch.where(ok, v + a[:, None] * dv, v)  # noqa: E731
        x, sl, su = move(x, ap, dx), move(sl, ap, dx), move(su, ap, -dx)
        y = move(y, ad, dy)
        zl, zu = move(zl, ad, dzl), move(zu, ad, dzu)
    return x_best, best


def min_shed(case: RefCase, down: torch.Tensor, load_mw: torch.Tensor,
             prec: Precision, lanes_per_solve: int = 4096):
    """([B, nd] optimal shed (MW) of each state, the worst lane's merit):
    ``down`` bool [B, n_comp] (True = out of service), ``load_mw`` [B, nd]
    the loads of the hour."""
    st = _structure(case, prec, down.device)
    base = case.base_mva
    ng, nd = case.n_gen, case.n_load
    out, worst = [], 0.0
    for lo in range(0, down.shape[0], lanes_per_solve):
        dn = down[lo:lo + lanes_per_solve]
        d = load_mw[lo:lo + lanes_per_solve].to(prec.dtype) / base
        A, b, c, l, u = _lane_lp(case, st, dn, d, prec)
        x, merit = solve_box_lp(A, b, c, l, u, prec)
        out.append(x[:, ng:ng + nd] * base)
        worst = max(worst, float(merit.max()))
    if not out:
        return torch.zeros((0, nd), dtype=prec.dtype, device=down.device), 0.0
    return torch.cat(out), worst
