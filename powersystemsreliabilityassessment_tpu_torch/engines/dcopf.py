"""Batched DC-OPF minimum-load-shedding evaluator (HL2 state evaluation).

Port of ``powersystemsreliabilityassessment_tpu/engines/dcopf.py``, the
parts on the NSQ main path:

**Tier 1 — exact certificate (no LP).** The copper-sheet deficit
max(0, load - available capacity) lower-bounds DNS; a balanced
dispatch/shed candidate at exactly that bound whose post-outage flows
(PTDF, rank-1 LODF, rank-2 Woodbury) fit the ratings proves it optimal
(``certify_states``). A flow-repair descent rescues candidates that
overload a line.

**Tier 2 — interior-point LP in B-theta form** for everything else:

    variables  x = [Pg (ng), shed (nd), f (nl), theta (nb)]
    minimize   sum(shed)
    s.t.       Cg Pg + Cd shed - Minc' f = bus_load          (nb rows)
               (1/b_l) f_l - status_l (theta_i - theta_j) = 0 (nl rows)
               box bounds on every variable

solved on the lanes tier 1 leaves, compacted into a ``max_lp`` buffer
(``evaluate_states_screened``): for m <= 72 by
``lp_ipm_structured.solve_box_lp_structured`` (the fused K1 kernel on
CUDA), for 72 < m <= 336 by ``lp_ipm_batched.solve_box_lp_batched`` on
the materialized A (the blocked Cholesky, K2 + K3 on CUDA). For m > 336
(``case300s``, m = 792) ``evaluate_states`` solves every lane through
``lp_ipm_batched.solve_box_lp_ops`` on the structured operator
``make_dc_linops`` (block-Schur bulk pass on K2a and K3, dense rescue
ladder).

**Tier 1.5 — island-aware power-flow certificate**
(``certify_island_pf``): with ``pf_buffer`` the screened evaluator
compacts tier 1's misses into that many lanes and certifies the deep
multi-branch and islanding states among them on the reduced network
before the LP buffer is filled; ``default_pf_buffer`` turns it on at
m > 336.

The fused sampler-certificate path (``ops/fused_sampler_cert.py``)
hands tier 1's work to ``certify_finish`` and its result to
``evaluate_states_screened(pre=...)``; ``ops/certify_kernel.py`` is the
whole of ``certify_states`` as one kernel.

``baseline_report`` / ``print_baseline`` are the host-side sanity line
the studies print before their loop, and ``copper_sheet_bound`` the
network-free DNS lower bound.

``CompatFlags(island_blackout=True)`` sheds every load cut off from bus
0 outright and takes its island's generators out
(``apply_island_blackout``) before either evaluator certifies or solves.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core.system import System
from powersystemsreliabilityassessment_tpu_torch.engines import (
    lp_ipm_batched, lp_ipm_structured)
from powersystemsreliabilityassessment_tpu_torch.ops.ipm_fused import (
    build_structure)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig)
from powersystemsreliabilityassessment_tpu_torch.utils.profiling import (
    count, span, traced)


class EvalResult(NamedTuple):
    """Mirrors reference ``engines/dcopf.py::EvalResult``."""
    dns_mw: torch.Tensor           # [B] demand not supplied, MW
    nodal_mw: torch.Tensor         # [B, nb] per-bus shed, MW
    failure: torch.Tensor          # [B] bool: dns above the failure threshold
    primal_residual: torch.Tensor  # [B] LP lane-quality score
    gen_dispatch: torch.Tensor     # [B, ng] p.u.
    infeasible: torch.Tensor       # [B] bool: no feasible dispatch


class Certificate(NamedTuple):
    """Mirrors reference ``engines/dcopf.py::Certificate``."""
    certified: torch.Tensor  # [B] bool: deficit proven optimal
    deficit: torch.Tensor    # [B] p.u. copper-sheet DNS lower bound
    shed: torch.Tensor       # [B, nd] p.u. certificate shed pattern
    dispatch: torch.Tensor   # [B, ng] p.u. certificate dispatch


def _fdt(sys: System):
    return sys.bus_pd.dtype


def _lp_bounds(sys: System, compat: CompatFlags, theta_max: float):
    """Shared parts of the LP boxes: (pmin, pmax, theta box)."""
    pmin = sys.gen_pmin if compat.enforce_pmin else torch.zeros_like(
        sys.gen_pmin)
    pmax = torch.maximum(sys.gen_pmax, pmin + 1e-6)
    pmax = torch.where(sys.gen_pmax > 0, pmax, 1.0)   # zero-cap: dummy box
    tb = torch.clamp_max(sys.theta_bound, theta_max)
    return pmin, pmax, tb


def build_state_lp(sys: System, gen_up: torch.Tensor, br_up: torch.Tensor,
                   load_pu: torch.Tensor, compat: CompatFlags,
                   theta_max: float):
    """Batched (c, A, b, l, u) with A materialized as [B, m, n]; mirrors
    reference ``engines/dcopf.py::build_state_lp`` under the reference's
    ``vmap`` (``dcopf.py:1243-1246``): ``gen_up`` [B, ng], ``br_up``
    [B, nl], ``load_pu`` [B, nd]. Out-of-service and zero-capacity units
    are zeroed balance columns; the reference bus's theta column is zeroed
    (gauge fix). c, b, l, u are those of :func:`build_state_lp_vectors`;
    A is written block by block into one [B, m, n] tensor."""
    ng, nd, nl, nb = sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus
    c, b, l, u, colscale = build_state_lp_vectors(
        sys, gen_up, br_up, load_pu, compat, theta_max)
    f0, t0 = ng + nd, ng + nd + nl       # first flow / theta column
    A = torch.zeros((gen_up.shape[0], nb + nl, t0 + nb), dtype=_fdt(sys),
                    device=sys.device)
    A[:, :nb, :ng] = sys.gen_bus_onehot * colscale[:, None, :ng]
    A[:, :nb, ng:f0] = sys.load_onehot
    A[:, :nb, f0:t0] = -sys.incidence.T
    A[:, nb:, f0:t0] = torch.diag(1.0 / sys.b_susceptance)
    ref_mask = (torch.arange(nb, device=sys.device) != 0).to(_fdt(sys))
    A[:, nb:, t0:] = -br_up[:, :, None] * (sys.incidence * ref_mask)
    return c, A, b, l, u


def build_state_lp_vectors(sys: System, gen_up: torch.Tensor,
                           br_up: torch.Tensor, load_pu: torch.Tensor,
                           compat: CompatFlags, theta_max: float):
    """Batched (c, b, l, u, colscale) without materializing A; mirrors
    reference ``engines/dcopf.py::build_state_lp_vectors``. Across lanes
    A differs from the shared blocks (``ops/ipm_fused.LPStructure``) only
    by ``colscale`` (generator availability) and ``br_up``."""
    ng, nd, nl, nb = sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus
    dt, dev = _fdt(sys), sys.device
    B = gen_up.shape[0]
    bcast = lambda v: v[None, :].expand(B, v.shape[0])
    ones = torch.ones(nd + nl + nb, dtype=dt, device=dev)
    colscale = torch.cat([gen_up * (sys.gen_pmax > 0).to(dt)[None, :],
                          bcast(ones)], dim=1)
    c = bcast(torch.cat([torch.zeros(ng, dtype=dt, device=dev),
                         torch.ones(nd, dtype=dt, device=dev),
                         torch.zeros(nl + nb, dtype=dt, device=dev)]))
    b = torch.cat([load_pu @ sys.load_onehot.T,
                   torch.zeros((B, nl), dtype=dt, device=dev)], dim=1)
    pmin, pmax, tb = _lp_bounds(sys, compat, theta_max)
    l = bcast(torch.cat([pmin, torch.zeros(nd, dtype=dt, device=dev),
                         -sys.br_rate, -tb]))
    u = torch.cat([bcast(pmax), torch.clamp_min(load_pu, 1e-6),
                   bcast(sys.br_rate), bcast(tb)], dim=1)
    return (c.contiguous(), b.contiguous(), l.contiguous(), u.contiguous(),
            colscale.contiguous())


def _rebalance_shed(cand, caps, target):
    """Rebalance a nonnegative pattern to sum ``target`` within ``caps``:
    scale down multiplicatively, or up in proportion to the headroom.
    Mirrors reference ``dcopf.py::_rebalance_shed``."""
    total = cand.sum(1)
    resid = total - target
    down_scale = torch.where(
        total > 1e-9,
        torch.clamp_min(target, 0.0) / torch.clamp_min(total, 1e-9), 0.0)
    headroom = torch.clamp_min(caps - cand, 0.0)
    head_tot = torch.clamp_min(headroom.sum(1), 1e-9)
    up = cand + headroom * ((-resid) / head_tot)[:, None]
    return torch.where((resid >= 0)[:, None], cand * down_scale[:, None],
                       torch.minimum(up, caps))


def _unrolled_det(E: list) -> torch.Tensor:
    """Determinant of a k x k matrix of [B] tensors by Laplace expansion
    (k <= 4). Mirrors reference ``dcopf.py::_unrolled_det``."""
    k = len(E)
    if k == 1:
        return E[0][0]
    det = None
    for j in range(k):
        minor = [[E[r][c] for c in range(k) if c != j] for r in range(1, k)]
        term = E[0][j] * _unrolled_det(minor)
        term = term if j % 2 == 0 else -term
        det = term if det is None else det + term
    return det


def _cramer_solve(E: list, f: list, safe_det: torch.Tensor) -> list:
    """Solve E c = f by Cramer's rule (k <= 4). Mirrors reference
    ``dcopf.py::_cramer_solve``."""
    k = len(E)
    return [_unrolled_det([[f[r] if c == i else E[r][c] for c in range(k)]
                           for r in range(k)]) / safe_det for i in range(k)]


def _shed_candidate(sys: System, load_pu, deficit, load_tot, shed_hint):
    """Load-proportional (or hint-shaped) shed at exactly the copper bound,
    rebalanced within per-load caps. Mirrors reference
    ``dcopf.py::_shed_candidate``."""
    prop = load_pu * (deficit / torch.clamp_min(load_tot, 1e-9))[:, None]
    if shed_hint is None:
        cand = prop
    else:
        hint_sum = shed_hint.sum(1)
        scaled = shed_hint * (deficit / torch.clamp_min(hint_sum, 1e-9)
                              )[:, None]
        cand = torch.where((hint_sum > 1e-6)[:, None], scaled, prop)
    cand = torch.minimum(cand, load_pu)
    return _rebalance_shed(cand, load_pu, deficit)


def _dispatch_candidate(sys: System, gen_cap, load_pu, cand, served):
    """Locally self-balancing dispatch: each bus's units cover its own
    post-shed load first, the residual is pooled over the remaining
    headroom. Mirrors reference ``dcopf.py::_dispatch_candidate``."""
    served_bus = (load_pu - cand) @ sys.load_onehot.T
    cap_bus = gen_cap @ sys.gen_bus_onehot.T
    local_frac = torch.clamp_max(
        served_bus / torch.clamp_min(cap_bus, 1e-9), 1.0)
    disp_local = gen_cap * (local_frac @ sys.gen_bus_onehot)
    return _rebalance_shed(disp_local, gen_cap, served)


def _repair_descent(sys: System, repair_iters: int, rate_ok, ptdf_gen,
                    ptdf_load, lp_, cand_, disp_, gcap_, brd_, served_,
                    deficit_, post0_, ok0_):
    """Flow-repair descent on LODF-corrected post-outage flows: move shed
    and dispatch along their PTDF sensitivities, rebalance each to its
    exact total, re-check. Mirrors reference ``dcopf.py::_repair_descent``.
    """
    load_bus_ = lp_ @ sys.load_onehot.T

    def flows_full_(disp, shed):
        inj = (disp @ sys.gen_bus_onehot.T + shed @ sys.load_onehot.T
               - load_bus_)
        return inj @ sys.ptdf.T

    def post_flows_(f):
        return (f + (brd_ * f) @ sys.lodf.T) * (1.0 - brd_)

    best_ok_, best_shed_, best_disp_ = ok0_, cand_, disp_
    cur_shed, cur_disp, cur_post = cand_, disp_, post0_
    elig_ = brd_.sum(1) <= 1
    for _ in range(repair_iters):
        over = torch.clamp_min(cur_post.abs() - sys.br_rate[None, :], 0.0)
        sgn_over = torch.sign(cur_post) * over
        w = sgn_over + brd_ * (sgn_over @ sys.lodf)
        grad_g = w @ ptdf_gen
        grad_g = grad_g - grad_g.mean(1, keepdim=True)
        step_g = (over.sum(1) / torch.clamp_min(
            grad_g.abs().amax(1), 1e-9))[:, None]
        disp_t = torch.clamp(cur_disp - step_g * grad_g, min=0.0)
        disp_t = torch.minimum(disp_t, gcap_)
        disp_t = _rebalance_shed(disp_t, gcap_, served_)
        grad = w @ ptdf_load
        grad = grad - grad.mean(1, keepdim=True)
        step_sz = (deficit_ / torch.clamp_min(
            grad.abs().amax(1), 1e-9))[:, None]
        trial = torch.minimum(
            torch.clamp(cur_shed - step_sz * grad, min=0.0), lp_)
        trial = _rebalance_shed(trial, lp_, deficit_)
        post_t = post_flows_(flows_full_(disp_t, trial))
        ok_trial = (post_t.abs() <= rate_ok).all(1)
        # the rank-1-corrected check is exact only for n_out <= 1
        newly = ~best_ok_ & ok_trial & elig_
        best_shed_ = torch.where(newly[:, None], trial, best_shed_)
        best_disp_ = torch.where(newly[:, None], disp_t, best_disp_)
        best_ok_ = best_ok_ | ok_trial
        cur_shed, cur_disp, cur_post = trial, disp_t, post_t
    return best_ok_, best_shed_, best_disp_


def _woodbury_multi_ok(sys: System, flows, br_down, n_out, rate_ok,
                       woodbury_k: int):
    """Exact rank-k Woodbury post-outage flow check for outage sets of
    size 2..woodbury_k, gather-free through one-hot selectors, with an
    unrolled Cramer solve. Mirrors reference
    ``dcopf.py::_woodbury_multi_ok``."""
    kk = int(woodbury_k)
    multi = (n_out >= 2) & (n_out <= kk)
    rem = br_down
    iota = torch.arange(br_down.shape[1], device=br_down.device)
    hs, fk, rows = [], [], []
    for _ in range(kk):
        vi, ki = rem.max(1)
        hi = (ki[:, None] == iota[None, :]).to(flows.dtype) * vi[:, None]
        rem = rem * (1.0 - hi)
        hs.append(hi)
        rows.append(hi @ sys.br_transfer)
        fk.append((flows * hi).sum(1))
    E = [[(1.0 if i == j else 0.0) - (rows[i] * hs[j]).sum(1)
          for j in range(kk)] for i in range(kk)]
    det = _unrolled_det(E)
    nonsing = det.abs() > 1e-5
    safe_det = torch.where(nonsing, det, 1.0)
    cs = _cramer_solve(E, fk, safe_det)
    corr = cs[0][:, None] * hs[0]
    for ci, hi in zip(cs[1:], hs[1:]):
        corr = corr + ci[:, None] * hi
    post_m = (flows + corr @ sys.br_transfer.T) * (1.0 - br_down)
    return multi & nonsing & (post_m.abs() <= rate_ok).all(1)


def _topk_lanes(need: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` lanes with needy lanes first, each group
    in ascending lane order (the reference's top_k compaction: unique
    integer scores, so the selected set and order are exact)."""
    B = need.shape[0]
    score = need.to(torch.int32) * (2 * B) - torch.arange(
        B, dtype=torch.int32, device=need.device)
    return torch.topk(score, k).indices


@traced("tier1.certify")
def certify_states(sys: System, comp_down: torch.Tensor,
                   load_pu: torch.Tensor, shed_hint=None,
                   repair_iters: int = 3, repair_buffer: int | None = None,
                   woodbury_k: int = 2) -> Certificate:
    """Tier-1 exact bound certificate (batch); mirrors reference
    ``engines/dcopf.py::certify_states``.

    DNS >= deficit = max(0, load - cap). A balanced dispatch/shed
    candidate at exactly that bound whose post-outage flows fit the
    ratings proves the bound optimal: intact and single-outage lanes via
    the LODF rank-1 update (with the repair descent), 2..``woodbury_k``
    outages via the rank-k Woodbury update. ``repair_buffer`` compacts
    the repair descent onto that many needy lanes (same results while
    the buffer covers them; excess lanes stay uncertified).
    """
    ng = sys.n_gen
    dt = _fdt(sys)
    gen_up = 1.0 - comp_down[:, :ng].to(dt)
    cap = gen_up @ sys.gen_pmax
    load_tot = load_pu.sum(1)
    deficit = torch.clamp_min(load_tot - cap, 0.0)

    served = load_tot - deficit
    cand = _shed_candidate(sys, load_pu, deficit, load_tot, shed_hint)
    gen_cap = sys.gen_pmax[None, :] * gen_up
    dispatch = _dispatch_candidate(sys, gen_cap, load_pu, cand, served)

    def flows_of(shed):
        inj = (dispatch @ sys.gen_bus_onehot.T + shed @ sys.load_onehot.T
               - load_pu @ sys.load_onehot.T)
        return inj @ sys.ptdf.T

    rate_ok = sys.br_rate[None, :] + 1e-4
    ptdf_load = sys.ptdf @ sys.load_onehot
    flows = flows_of(cand)

    # Post-outage flows via the LODF rank-1 update as a shared matmul
    # ((br_down * f) @ lodf.T == lodf[:, k] f_k for one outage k), exact
    # for n_out <= 1; islanding columns carry the 1e6 sentinel.
    br_down = comp_down[:, ng:].to(dt)
    n_out = br_down.sum(1)
    eligible = n_out <= 1

    def post_flows(f):
        return (f + (br_down * f) @ sys.lodf.T) * (1.0 - br_down)

    best_ok = (post_flows(flows).abs() <= rate_ok).all(1)
    ptdf_gen = sys.ptdf @ sys.gen_bus_onehot

    def repair_loop(*lane_args):
        return _repair_descent(sys, repair_iters, rate_ok, ptdf_gen,
                               ptdf_load, *lane_args)

    if repair_iters > 0 and repair_buffer is not None:
        B = comp_down.shape[0]
        rbuf = min(int(repair_buffer), B)
        need = (~best_ok) & eligible
        ridx = _topk_lanes(need, rbuf)   # unique lanes: plain writes are exact
        rvalid = (torch.arange(rbuf, device=need.device) < need.sum()) \
            & need[ridx]
        okr, bshed_r, bdisp_r = repair_loop(
            load_pu[ridx], cand[ridx], dispatch[ridx], gen_cap[ridx],
            br_down[ridx], served[ridx], deficit[ridx],
            post_flows(flows)[ridx],
            torch.zeros(rbuf, dtype=torch.bool, device=need.device))
        upd = rvalid & okr
        best_ok = best_ok.clone()
        best_ok[ridx] = best_ok[ridx] | upd
        cand = cand.clone()
        cand[ridx] = torch.where(upd[:, None], bshed_r, cand[ridx])
        dispatch = dispatch.clone()
        dispatch[ridx] = torch.where(upd[:, None], bdisp_r, dispatch[ridx])
    elif repair_iters > 0:
        best_ok, cand, dispatch = repair_loop(
            load_pu, cand, dispatch, gen_cap, br_down, served, deficit,
            post_flows(flows), best_ok)
    certified = (eligible & best_ok) | _woodbury_multi_ok(
        sys, flows, br_down, n_out, rate_ok, woodbury_k)
    return Certificate(certified=certified, deficit=deficit, shed=cand,
                       dispatch=dispatch)


def _island_rebalance(R: torch.Tensor, x: torch.Tensor, caps: torch.Tensor,
                      target_bus: torch.Tensor,
                      onehot: torch.Tensor) -> torch.Tensor:
    """Per-island exact rebalance of a nonnegative pattern ``x`` (caps
    ``caps``) so that its island totals equal ``target_bus``'s; mirrors
    reference ``engines/dcopf.py::_island_rebalance``.

    ``R`` is the [B, nb, nb] island matrix (R[b, i, j] = 1 iff buses i
    and j are connected), ``onehot`` the [nb, k] bus scatter of x's
    entities. :func:`_rebalance_shed`'s down-scale / headroom up-scale,
    with every total an R product (no gathers). Needs each island's
    target <= its cap sum."""
    x_bus = x @ onehot.T                                   # [B, nb]
    tot_i = _bmv(R, x_bus)                                 # island totals
    tgt_i = _bmv(R, target_bus)
    resid_i = tot_i - tgt_i
    down = torch.clamp_min(tgt_i, 0.0) / torch.clamp_min(tot_i, 1e-9)
    head = torch.clamp_min(caps - x, 0.0)
    head_i = _bmv(R, head @ onehot.T)
    up_frac = (-resid_i) / torch.clamp_min(head_i, 1e-9)
    down_e = down @ onehot                                 # [B, k]
    up_e = up_frac @ onehot
    resid_e = resid_i @ onehot
    return torch.where(resid_e >= 0, x * down_e,
                       torch.minimum(x + head * up_e, caps))


# Repair steps of tier 1.5: the default of reference
# ``engines/dcopf.py::certify_island_pf``, the only value any caller uses.
_ISLAND_REPAIR_ITERS = 2


def island_matrix(sys: System, br_up: torch.Tensor) -> torch.Tensor:
    """[B, nb, nb] 0/1 float: 1 where two buses are connected through the
    in-service branches ``br_up`` [B, nl] (1 = up), by ``ceil(log2 nb)``
    boolean squarings of the adjacency with self-loops, which cover every
    path of up to nb - 1 hops (exact for any diameter). The entries are
    0/1 and the sums at most nb, so float32 products are exact while TF32
    is off (the package's ``__init__`` turns it off). The adjacency is
    one product of the branch-weighted from-bus and to-bus incidences,
    not the reference's dense [nl, nb, nb] pair tensor."""
    nb, dt = sys.n_bus, _fdt(sys)
    e_from = (sys.incidence > 0).to(dt)                    # [nl, nb]
    e_to = (sys.incidence < 0).to(dt)
    adj = (e_from.T[None] * br_up[:, None, :]) @ e_to     # [B, nb, nb]
    adj = adj + adj.transpose(1, 2) + torch.eye(nb, dtype=dt,
                                                device=sys.device)
    R = torch.clamp_max(adj, 1.0)
    for _ in range(int(np.ceil(np.log2(max(nb, 2))))):
        R = torch.clamp_max(R @ R, 1.0)
    return R


def connected_to_ref(sys: System, br_up: torch.Tensor) -> torch.Tensor:
    """[B, nb] bool: the bus lies in the island of the reference bus (bus
    0) under the in-service branches ``br_up`` [B, nl]. Mirrors reference
    ``engines/dcopf.py::connected_to_ref`` with the exact squaring count
    of :func:`island_matrix`: the reference's fixed 5 squarings cover
    paths of at most 32 hops, and report buses farther from bus 0 as cut
    off (ROADMAP.md, faults in the reference)."""
    return island_matrix(sys, br_up)[:, 0, :] > 0.5


def apply_island_blackout(sys: System, comp_down: torch.Tensor,
                          load_pu: torch.Tensor):
    """The ``island_blackout`` transform: loads cut off from bus 0 are
    shed outright, and generators cut off from it become unavailable.
    Returns ``(comp_down', load_pu', islanded_nodal_mw [B, nb])``.
    Mirrors reference ``engines/dcopf.py::apply_island_blackout``; a
    load's and a generator's bus are read through ``load_onehot`` and
    ``gen_bus_onehot`` (0/1 products, exact), not gathered."""
    ng, dt = sys.n_gen, _fdt(sys)
    br_up = 1.0 - comp_down[:, ng:].to(dt)
    reach = connected_to_ref(sys, br_up).to(dt)            # [B, nb]
    load_reach = (reach @ sys.load_onehot) > 0.5           # [B, nd]
    gen_reach = (reach @ sys.gen_bus_onehot) > 0.5         # [B, ng]
    comp_down = torch.cat([comp_down[:, :ng] | ~gen_reach,
                           comp_down[:, ng:]], dim=1)
    shed_pu = torch.where(load_reach, 0.0, load_pu)
    nodal = (shed_pu * sys.base_mva) @ sys.load_onehot.T
    return comp_down, torch.where(load_reach, load_pu, 0.0), nodal


@traced("tier1.island_pf")
def certify_island_pf(sys: System, comp_down: torch.Tensor,
                      load_pu: torch.Tensor,
                      theta_cap: float = 6.0) -> Certificate:
    """Tier-1.5 certificate: an exact, island-aware DC power-flow check
    on the reduced network, valid for any outage set; mirrors reference
    ``engines/dcopf.py::certify_island_pf``.

    Runs on the compacted buffer of tier-1 misses (deep multi-branch and
    islanding states). Per lane, batched and without gathers:

    1. **Islands.** R = 1 where two buses are connected
       (:func:`island_matrix`: ``ceil(log2 nb)`` exact boolean
       squarings).
    2. **Per-island copper bound.** The deficit is the sum over islands
       of max(0, island load - island capacity): a proven lower bound on
       the lane's DNS, at least Tier 1's.
    3. **Candidate at the bound.** An island-proportional shed and a
       dispatch that covers each bus's load locally first, pooled per
       island (:func:`_island_rebalance`).
    4. **Reduced power flow.** L theta = inj with L the lane's weighted
       Laplacian, grounded by the island projector: Lg = L + c R / size
       has the same solutions on island-balanced injections and is
       positive definite. Factored equilibrated (s = rsqrt(diag)) with
       ``cholesky_ex`` (a lane that fails the factor gets NaN, as the
       reference's ``jnp.linalg.cholesky`` gives), solved by two
       ``solve_triangular`` and refined twice against Lg. A lane certifies
       when its flows fit the ratings, the residual is within 3e-5 of
       the injection scale, the island-centred angles fit the LP's box
       and every flow is finite.
    5. **Repair descent** (``_ISLAND_REPAIR_ITERS`` steps): on overload,
       one adjoint solve on the retained factor gives the gradient; shed
       and dispatch move along it and are rebalanced per island.

    ``deficit`` / ``shed`` / ``dispatch`` are valid (bound, pattern) for
    uncertified lanes too. Nothing here reads the device on the host.
    """
    ng, nl, nb = sys.n_gen, sys.n_branch, sys.n_bus
    dt = _fdt(sys)
    gen_up = 1.0 - comp_down[:, :ng].to(dt)
    br_up = 1.0 - comp_down[:, ng:ng + nl].to(dt)
    minc = sys.incidence                                   # [nl, nb]

    # 1. Island matrix by exact boolean squaring.
    R = island_matrix(sys, br_up)                          # [B, nb, nb]
    size = R.sum(2)                                        # [B, nb]

    # 2. Per-island copper bound.
    gen_cap = sys.gen_pmax[None, :] * gen_up               # [B, ng]
    cap_bus = gen_cap @ sys.gen_bus_onehot.T               # [B, nb]
    load_bus = load_pu @ sys.load_onehot.T
    icap, iload = _bmv(R, cap_bus), _bmv(R, load_bus)
    idef = torch.clamp_min(iload - icap, 0.0)              # [B, nb]
    deficit = (idef / torch.clamp_min(size, 1.0)).sum(1)

    # 3. Candidate at the bound.
    frac = idef / torch.clamp_min(iload, 1e-9)
    shed = load_pu * (frac @ sys.load_onehot)              # [B, nd]
    served_bus = load_bus - shed @ sys.load_onehot.T
    local_frac = torch.clamp_max(
        served_bus / torch.clamp_min(cap_bus, 1e-9), 1.0)
    disp = gen_cap * (local_frac @ sys.gen_bus_onehot)
    disp = _island_rebalance(R, disp, gen_cap, served_bus,
                             sys.gen_bus_onehot)

    # 4. Reduced power flow, grounded by the island projector.
    w = sys.b_susceptance[None, :] * br_up                 # [B, nl]
    L = (minc.T[None] * w[:, None, :]) @ minc              # [B, nb, nb]
    c_gauge = (torch.diagonal(L, dim1=1, dim2=2).sum(1) / nb
               )[:, None, None] + 1e-3
    Lg = L + c_gauge * (R / torch.clamp_min(size, 1.0)[:, :, None])
    s = torch.rsqrt(torch.clamp_min(torch.diagonal(Lg, dim1=1, dim2=2),
                                    1e-30))
    chol, info = torch.linalg.cholesky_ex(Lg * s[:, :, None] * s[:, None, :])
    chol = torch.where((info == 0)[:, None, None], chol, float("nan"))

    def cs(rhs):                                           # s Lgs^-1 s rhs
        y = torch.linalg.solve_triangular(chol, (s * rhs)[:, :, None],
                                          upper=False)
        return s * torch.linalg.solve_triangular(
            chol.transpose(1, 2), y, upper=True)[:, :, 0]

    def pf_solve(rhs):                                     # [B, nb]
        th = cs(rhs)
        for _ in range(2):
            th = th + cs(rhs - _bmv(Lg, th))
        return th

    rate_ok = sys.br_rate[None, :] + 1e-4
    inj_scale = torch.clamp_min(load_bus.abs().amax(1), 1.0)
    # theta must fit the LP's angle boxes; it is gauge-free per island,
    # so it is centred mid-range per island (masked max / min through R)
    # before the check. A violation falls to the LP.
    tb = torch.clamp_max(sys.theta_bound, theta_cap)[None, :]
    neg_big = 1e30 * (1.0 - R)

    def center_theta(theta):
        imax = (theta[:, None, :] * R - neg_big).amax(2)
        imin = -(-theta[:, None, :] * R - neg_big).amax(2)
        return theta - 0.5 * (imax + imin)

    def check(disp_c, shed_c):
        inj = (disp_c @ sys.gen_bus_onehot.T + shed_c @ sys.load_onehot.T
               - load_bus)
        theta0 = pf_solve(inj)
        # The residual of the raw solution: centring adds c * shift.
        resid = (_bmv(Lg, theta0) - inj).abs().amax(1)
        theta = center_theta(theta0)
        f = w * (theta @ minc.T)
        ok = ((f.abs() <= rate_ok).all(1)
              & (resid <= 3e-5 * inj_scale)
              & (theta.abs() <= tb).all(1)
              & torch.isfinite(f).all(1))
        return ok, f

    best_ok, f = check(disp, shed)
    best_shed, best_disp = shed, disp

    # 5. Repair descent through the reduced network.
    cur_shed, cur_disp, cur_f = shed, disp, f
    for _ in range(_ISLAND_REPAIR_ITERS):
        over = torch.clamp_min(cur_f.abs() - sys.br_rate[None, :], 0.0)
        z = pf_solve((w * torch.sign(cur_f) * over) @ minc)    # [B, nb]
        grad_g = z @ sys.gen_bus_onehot
        grad_g = grad_g - grad_g.mean(1, keepdim=True)
        step_g = (over.sum(1) / torch.clamp_min(grad_g.abs().amax(1), 1e-9)
                  )[:, None]
        disp_t = torch.minimum(
            torch.clamp_min(cur_disp - step_g * grad_g, 0.0), gen_cap)
        grad_d = z @ sys.load_onehot
        grad_d = grad_d - grad_d.mean(1, keepdim=True)
        step_d = (deficit / torch.clamp_min(grad_d.abs().amax(1), 1e-9)
                  )[:, None]
        shed_t = torch.minimum(
            torch.clamp_min(cur_shed - step_d * grad_d, 0.0), load_pu)
        shed_t = _island_rebalance(R, shed_t, load_pu, load_bus * frac,
                                   sys.load_onehot)
        disp_t = _island_rebalance(R, disp_t, gen_cap,
                                   load_bus - shed_t @ sys.load_onehot.T,
                                   sys.gen_bus_onehot)
        ok_t, f_t = check(disp_t, shed_t)
        newly = ~best_ok & ok_t
        best_shed = torch.where(newly[:, None], shed_t, best_shed)
        best_disp = torch.where(newly[:, None], disp_t, best_disp)
        best_ok = best_ok | ok_t
        cur_shed, cur_disp, cur_f = shed_t, disp_t, f_t

    return Certificate(certified=best_ok, deficit=deficit, shed=best_shed,
                       dispatch=best_disp)


def calibrate_shed_hint(sys: System, batch: int = 8192, seed: int = 987,
                        margin_frac: float = 0.02) -> np.ndarray | None:
    """One-time static shed-direction calibration; mirrors reference
    ``engines/dcopf.py::calibrate_shed_hint``.

    Samples a calibration batch, collects the repaired sheds of lanes the
    first flow check fails but six repair steps rescue (against ratings
    tightened by ``margin_frac``, falling back to the real ratings when
    that rescues < 32 lanes), and returns their mean normalized pattern
    ([n_load] float32, sums to 1), or None. The hint only picks which
    optimal candidate is tried, so a different sampler stream (Philox
    here, threefry in the reference) moves LP routing, never results.
    """
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    sys_tight = dataclasses.replace(
        sys, br_rate=sys.br_rate * (1.0 - margin_frac))
    gen = torch.Generator(device=sys.device)
    gen.manual_seed(seed)
    down = sample_states(gen, sys.unavail, sys.always_up_nsq, batch)
    load = sys.load_pd[None, :].expand(batch, sys.n_load)
    r0 = certify_states(sys_tight, down, load, repair_iters=0)
    r3 = certify_states(sys_tight, down, load, repair_iters=6)
    rescued = (r3.certified & ~r0.certified).cpu().numpy()
    if int(rescued.sum()) < 32:
        if margin_frac > 0.0:
            return calibrate_shed_hint(sys, batch, seed, margin_frac=0.0)
        return None
    shed = r3.shed.cpu().numpy().astype(np.float64)[rescued]
    pat = (shed / np.maximum(shed.sum(axis=1, keepdims=True), 1e-9)
           ).mean(axis=0)
    s = float(pat.sum())
    if not np.isfinite(s) or s <= 0:
        # Every rescued lane had zero deficit (a dispatch-only repair
        # against the tightened ratings), so there is no shed pattern to
        # average: fall back to the real ratings as for too few lanes.
        # (The reference returns None here; ROADMAP.md Queue 3.)
        if margin_frac > 0.0:
            return calibrate_shed_hint(sys, batch, seed, margin_frac=0.0)
        return None
    return (pat / s).astype(np.float32)


def default_repair_buffer(batch: int, outage_boost: float = 1.0,
                          hinted: bool = False) -> int | None:
    """Compacted-repair buffer policy; mirrors reference
    ``engines/dcopf.py::default_repair_buffer``: ``batch // 8`` covers the
    ~7% of RTS-24 peak lanes that fail the first flow check; with a shed
    hint ~0.04% do, and ``batch // 64`` remains. Boosted sampling repairs
    full-batch (None)."""
    if outage_boost > 1.0:
        return None
    return min(batch, max(2048, batch // (64 if hinted else 8)))


def default_finish_buffer(batch: int, hinted: bool = False) -> int:
    """Lane buffer for :func:`certify_finish`; mirrors reference
    ``engines/dcopf.py::default_finish_buffer``: ``batch // 8`` without a
    shed hint (the fused first pass leaves the repair-needy deficit
    states, the guard band's lanes and the multi-branch lanes),
    ``batch // 32`` with one. Lanes the buffer cannot hold stay
    uncertified and fall to the LP buffer's own overflow accounting."""
    return min(batch, max(1024, batch // (32 if hinted else 8)))


def default_pf_buffer(sys: System, batch: int) -> int | None:
    """Tier-1.5 (:func:`certify_island_pf`) buffer policy; mirrors
    reference ``engines/dcopf.py::default_pf_buffer``: on only past the
    mid-m LP path (m > 336), where one LP lane costs milliseconds and the
    tier-1 misses are mostly deep multi-branch and islanding states that
    the island certificate closes (84% of them at case300s,
    results/r4_miss.json), with ``min(batch, 256)`` lanes. None below,
    where a miss is cheap to solve."""
    if sys.n_bus + sys.n_branch <= lp_ipm_batched._BLOCKED_MAX_M:
        return None
    return min(batch, 256)


@traced("tier1.finish")
def certify_finish(sys: System, comp_down: torch.Tensor,
                   load_pu: torch.Tensor, deficit: torch.Tensor,
                   shed: torch.Tensor, ok1: torch.Tensor, finish_buffer: int,
                   repair_iters: int = 3, woodbury_k: int = 2
                   ) -> Certificate:
    """Complete a first-pass certificate (``ops/fused_sampler_cert.py``)
    into the full ``certify_states`` result; mirrors reference
    ``engines/dcopf.py::certify_finish``.

    Everything the fused pass left out runs compacted onto
    ``finish_buffer`` lanes: a plain float32 re-check at the standard
    tolerance (recovers the guard band's lanes), the repair descent, and
    the rank-``woodbury_k`` Woodbury multi-outage check. Lanes the buffer
    cannot hold stay uncertified and fall to the LP. ``dispatch`` is
    zeros except on finish-repaired lanes: the screened evaluator reads
    it only as the dispatch of lanes that never reach the LP, and the
    study moments never read it. Nothing here waits for the device.
    """
    B = comp_down.shape[0]
    ng = sys.n_gen
    dt = _fdt(sys)
    br_down_full = comp_down[:, ng:].to(dt)
    n_out_full = br_down_full.sum(1)
    kk = int(woodbury_k)
    # Rescuable lanes: repair applies to n_out <= 1, Woodbury to 2..kk;
    # deeper outage sets can only be decided by the LP.
    need = ~ok1 & (n_out_full <= max(kk, 1))
    fbuf = min(int(finish_buffer), B)
    idx = _topk_lanes(need, fbuf)   # unique lanes
    valid = (torch.arange(fbuf, device=need.device) < need.sum()) \
        & need[idx]

    lp_ = load_pu[idx]
    gen_up_ = 1.0 - comp_down[idx, :ng].to(dt)
    brd_ = br_down_full[idx]
    deficit_ = deficit[idx]
    load_tot_ = lp_.sum(1)
    served_ = load_tot_ - deficit_
    cand_ = _shed_candidate(sys, lp_, deficit_, load_tot_, shed[idx])
    gen_cap_ = sys.gen_pmax[None, :] * gen_up_
    disp_ = _dispatch_candidate(sys, gen_cap_, lp_, cand_, served_)

    inj = (disp_ @ sys.gen_bus_onehot.T + cand_ @ sys.load_onehot.T
           - lp_ @ sys.load_onehot.T)
    flows_ = inj @ sys.ptdf.T
    post0_ = (flows_ + (brd_ * flows_) @ sys.lodf.T) * (1.0 - brd_)
    rate_ok = sys.br_rate[None, :] + 1e-4
    elig_ = brd_.sum(1) <= 1
    # Plain float32 re-check at the standard tolerance: recovers lanes
    # the kernel's guard band routed here (zero-flow islanding included).
    ok0_ = elig_ & (post0_.abs() <= rate_ok).all(1)
    okr, bshed_, bdisp_ = _repair_descent(
        sys, repair_iters, rate_ok, sys.ptdf @ sys.gen_bus_onehot,
        sys.ptdf @ sys.load_onehot, lp_, cand_, disp_, gen_cap_, brd_,
        served_, deficit_, post0_, ok0_)
    cert_ = (elig_ & okr) | _woodbury_multi_ok(
        sys, flows_, brd_, brd_.sum(1), rate_ok, kk)
    upd = valid & cert_

    certified = _scatter_valid(ok1, idx, valid, ok1[idx] | upd)
    shed = _scatter_valid(shed, idx, valid,
                          torch.where(upd[:, None], bshed_, shed[idx]))
    dispatch = _scatter_valid(
        torch.zeros((B, ng), dtype=dt, device=shed.device), idx, valid,
        torch.where(upd[:, None], bdisp_, 0.0))
    return Certificate(certified=certified, deficit=deficit, shed=shed,
                       dispatch=dispatch)


def overgen_infeasible(sys: System, comp_down, load_pu,
                       compat: CompatFlags) -> torch.Tensor:
    """[B] bool: committed minimum generation exceeds demand (only with
    ``compat.enforce_pmin``). Mirrors reference
    ``engines/dcopf.py::overgen_infeasible``."""
    if not compat.enforce_pmin:
        return torch.zeros(comp_down.shape[0], dtype=torch.bool,
                           device=comp_down.device)
    dt = _fdt(sys)
    gen_up = 1.0 - comp_down[:, :sys.n_gen].to(dt)
    pmin_committed = (gen_up * (sys.gen_pmax > 0).to(dt)) @ sys.gen_pmin
    return pmin_committed > load_pu.sum(1) + 1e-9


def baseline_report(sys: System) -> dict:
    """Intact-system sanity check before a study starts, on the host in
    float64; mirrors reference ``engines/dcopf.py::baseline_report``.

    The reference's MATLAB runs a full ``runopf`` on the intact network
    (nsqMain.m:188-198); this is the capacity margin against peak load
    and the largest intact line loading of the proportional (copper)
    dispatch through the PTDF. A congested proportional dispatch is only
    a warning (the OPF can redispatch); capacity below peak load means
    the system sheds even intact and is flagged.
    """
    f64 = lambda t: t.detach().cpu().double().numpy()
    cap, load = f64(sys.gen_pmax), f64(sys.load_pd)
    total_cap, total_load = cap.sum(), load.sum()
    disp = cap * (total_load / max(total_cap, 1e-12))
    inj = f64(sys.gen_bus_onehot) @ disp - f64(sys.load_onehot) @ load
    loading = np.abs(f64(sys.ptdf) @ inj) / np.maximum(f64(sys.br_rate),
                                                       1e-12)
    base = float(sys.base_mva)
    return {
        "capacity_mw": total_cap * base,
        "peak_load_mw": total_load * base,
        "margin_mw": (total_cap - total_load) * base,
        "max_line_loading": float(loading.max()),
        "capacity_feasible": bool(total_cap >= total_load),
    }


def print_baseline(sys: System) -> dict:
    """Print :func:`baseline_report` on one line and return it; mirrors
    reference ``engines/dcopf.py::print_baseline``."""
    r = baseline_report(sys)
    status = ("ok" if r["capacity_feasible"]
              else "INFEASIBLE (sheds even intact)")
    print(f"baseline: intact capacity {r['capacity_mw']:.0f} MW vs peak "
          f"{r['peak_load_mw']:.0f} MW (margin {r['margin_mw']:.0f} MW, "
          f"{status}); proportional-dispatch max line loading "
          f"{100 * r['max_line_loading']:.0f}%")
    return r


# Relative flow-block diagonal lift of the block-Schur normal solve
# (make_dc_linops.schur_factor; reference dcopf.py:199): bounds the 1/dphi
# cancellation on lanes whose flows sit at a bound, is compensated exactly
# in the Schur complement, and the IPM's refinement against the true
# operator removes it.
_SCHUR_LIFT = 1e-5


def _bvm(v, M):
    """Batched row vector times matrix: v [B, i], M [B, i, j] -> [B, j]."""
    return (v[:, None, :] @ M)[:, 0, :]


def _bmv(M, v):
    """Batched matrix times vector: M [B, i, j], v [B, j] -> [B, i]."""
    return (M @ v[:, :, None])[:, :, 0]


def make_dc_linops(sys: System, gen_col: torch.Tensor, br_up: torch.Tensor):
    """Structured ``lp_ipm_batched.LinOps`` for the DC-OPF LP; mirrors
    reference ``engines/dcopf.py::make_dc_linops``.

    Uses :func:`build_state_lp`'s block layout (variables [pg | shed | f
    | theta], rows [balance | flow]) so the IPM never materializes the
    [B, m, n] constraint tensor: A v and A' y are one-hot scatters and
    incidence products; A diag(w) A' is assembled by blocks (a
    wf-weighted Laplacian plus the scattered gen / shed weights, a scaled
    incidence, a diagonal plus the br_up-masked theta congruence). Lanes
    differ only by ``gen_col`` [B, ng] (gen_up * (pmax > 0)) and
    ``br_up`` [B, nl].

    ``schur_factor(w, ridge, delta)`` factors A diag(w) A' + ridge I by
    two exact reductions to [nb, nb] systems: Woodbury through the flow
    block, with K = diag(1/wt) + mref' diag(br_up^2 / dphi) mref, then a
    Schur complement onto the balance block, S = diag(dbal) + G K^-1 G'
    + lap(gamma), where the Laplacian term cancels analytically (gamma
    is zero at ridge = lift = 0). K^-1 and S^-1 are explicit inverses
    (``ops/xla_chol.inv_spd_equilibrated``: K2a and K3 on the card).
    ``schur_solve(F, r)`` is one block-elimination pass, each inverse
    refined once against its matrix; the caller refines the whole solve
    against the matrix-free operator.
    """
    from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_batched import (
        LinOps)
    from powersystemsreliabilityassessment_tpu_torch.ops import xla_chol
    ng, nd, nl, nb = sys.n_gen, sys.n_load, sys.n_branch, sys.n_bus
    dt, dev = _fdt(sys), sys.device
    cg = sys.gen_bus_onehot          # [nb, ng]
    cd = sys.load_onehot             # [nb, nd]
    minc = sys.incidence             # [nl, nb]
    ref_mask = (torch.arange(nb, device=dev) != 0).to(dt)
    mref = minc * ref_mask[None, :]  # gauge-fixed theta columns
    inv_b = 1.0 / sys.b_susceptance  # [nl]
    inv_b2 = inv_b * inv_b
    eye_nb = torch.eye(nb, dtype=dt, device=dev)
    eye_nl = torch.eye(nl, dtype=dt, device=dev)
    f_lo, f_hi = ng + nd, ng + nd + nl

    def split(v):
        return v[:, :ng], v[:, ng:f_lo], v[:, f_lo:f_hi], v[:, f_hi:]

    def congruence(left, wts, right):
        """left' diag(wts[b]) right per lane: [nl, i], [B, nl], [nl, j]
        -> [B, i, j] (the reference's einsum "lb,Bl,lc->Bbc")."""
        return (left.T[None] * wts[:, None, :]) @ right

    def mv(v):
        vg, vs, vf, vt = split(v)
        bal = (gen_col * vg) @ cg.T + vs @ cd.T - vf @ minc
        flow = vf * inv_b[None, :] - br_up * (vt @ mref.T)
        return torch.cat([bal, flow], dim=1)

    def mtv(y):
        yb, yf = y[:, :nb], y[:, nb:]
        return torch.cat([gen_col * (yb @ cg), yb @ cd,
                          inv_b[None, :] * yf - yb @ minc.T,
                          -(br_up * yf) @ mref], dim=1)

    def gram(w):
        wg, ws, wf, wt = split(w)
        dbal = (wg * gen_col * gen_col) @ cg.T + ws @ cd.T   # [B, nb]
        mbb = congruence(minc, wf, minc) + dbal[:, :, None] * eye_nb
        mbf = -minc.T[None] * (wf * inv_b[None, :])[:, None, :]
        k = (mref[None] * wt[:, None, :]) @ mref.T
        mff = (br_up[:, :, None] * k * br_up[:, None, :]
               + (wf * inv_b2[None, :])[:, :, None] * eye_nl)
        return torch.cat([torch.cat([mbb, mbf], dim=2),
                          torch.cat([mbf.transpose(1, 2), mff], dim=2)],
                         dim=1)

    def normal(d):
        return gram(1.0 / d)

    def schur_factor(w, ridge: float = 0.0, delta: float = 1e-6):
        wg, ws, wf, wt = split(w)
        dbal = (wg * gen_col * gen_col) @ cg.T + ws @ cd.T + ridge
        alpha = wf * inv_b[None, :]                      # [B, nl]
        # The flow block's lift: a small fraction of the theta
        # congruence's row scale q, compensated exactly in S (gamma).
        q = br_up * br_up * (wt @ (mref * mref).T)       # [B, nl]
        dphi = wf * inv_b2 + ridge + _SCHUR_LIFT * q
        K = (congruence(mref, br_up * br_up / dphi, mref)
             + (1.0 / wt)[:, :, None] * eye_nb)
        Kinv = xla_chol.inv_spd_equilibrated(K, delta)
        G = congruence(minc, alpha * br_up / dphi, mref)
        Gt = G.transpose(1, 2)
        Z = Kinv @ Gt                                    # K^-1 G', refined
        Z = Z + Kinv @ (Gt - K @ Z)
        S = G @ Z
        S = 0.5 * (S + S.transpose(1, 2))
        # The balance block's exact residue lap(wf) - minc' diag(alpha^2 /
        # dphi) minc = lap(gamma), in a form without cancellation.
        gam = wf * (ridge + _SCHUR_LIFT * q) / dphi
        S = S + congruence(minc, gam, minc) + dbal[:, :, None] * eye_nb
        Sinv = xla_chol.inv_spd_equilibrated(S, delta)
        return alpha, dphi, K, Kinv, S, Sinv

    def schur_solve(F, r):
        alpha, dphi, K, Kinv, S, Sinv = F
        rb, rf = r[:, :nb], r[:, nb:]

        def kvec(v):                                     # K^-1 v, refined
            z = _bvm(v, Kinv)
            return z + _bvm(v - _bmv(K, z), Kinv)

        def ff_inv(v):                                   # N_ff^-1 v
            # Subtract in v's scale before the 1/dphi division.
            h = kvec((br_up * (v / dphi)) @ mref)
            return (v - br_up * (h @ mref.T)) / dphi

        u = ff_inv(rf)
        rhs_b = rb + (alpha * u) @ minc                  # rb - N_bf u
        yb = _bvm(rhs_b, Sinv)
        yb = yb + _bvm(rhs_b - _bmv(S, yb), Sinv)
        yf = ff_inv(rf + alpha * (yb @ minc.T))          # rf - N_fb yb
        return torch.cat([yb, yf], dim=1)

    def take(idx):
        return make_dc_linops(sys, gen_col[idx], br_up[idx])

    return LinOps(mv, mtv, gram, normal, take, schur_factor=schur_factor,
                  schur_solve=schur_solve)


def copper_sheet_bound(sys: System, comp_down: torch.Tensor,
                       load_pu: torch.Tensor) -> torch.Tensor:
    """Lower bound on DNS (MW): the generation-capacity deficit ignoring
    the network; mirrors reference ``engines/dcopf.py::copper_sheet_bound``
    (the tests' invariant: LP shed >= this bound)."""
    up = 1.0 - comp_down[..., :sys.n_gen].to(sys.gen_pmax.dtype)
    cap = up @ sys.gen_pmax
    return torch.clamp_min(load_pu.sum(-1) - cap, 0.0) * sys.base_mva


def _solve_batch(sys: System, comp_down, load_pu, compat: CompatFlags,
                 ipm: IPMConfig):
    """LP tier on every lane; mirrors reference
    ``engines/dcopf.py::_solve_batch`` (any batch size, no padding): m <=
    72 takes the structured route (K1 + polish); m > 336 with
    ``ipm.structured_gram`` the structured operator
    (:func:`make_dc_linops`) through ``solve_box_lp_ops`` (block-Schur
    bulk pass on K2a and K3, then the rescue ladder); otherwise the
    materialized-A solver ``solve_box_lp_batched`` (blocked Cholesky, K2
    + K3, at 72 < m <= 336). Returns (shed, pg, quality)."""
    ng, nd, nl = sys.n_gen, sys.n_load, sys.n_branch
    n_vars = ng + nd + nl + sys.n_bus
    structured = sys.n_bus + nl <= lp_ipm_batched._PALLAS_MAX_M
    large_ops = (not structured and ipm.structured_gram
                 and sys.n_bus + nl > lp_ipm_batched._BLOCKED_MAX_M)
    with span("lp.build"):
        up = 1.0 - comp_down.to(_fdt(sys))
        gen_up, br_up = up[:, :ng], up[:, ng:ng + nl].contiguous()
        if structured or large_ops:
            c, b, l, u, colscale = build_state_lp_vectors(
                sys, gen_up, br_up, load_pu, compat, ipm.theta_max)
        else:
            c, A, b, l, u = build_state_lp(sys, gen_up, br_up, load_pu,
                                           compat, ipm.theta_max)
        if large_ops:
            lops = make_dc_linops(sys, colscale[:, :ng], br_up)
    if structured:
        sol = lp_ipm_structured.solve_box_lp_structured(
            build_structure(sys), colscale, br_up, c, b, l, u, ipm)
    elif large_ops:
        sol = lp_ipm_batched.solve_box_lp_ops(c, b, l, u, lops, ipm)
    else:
        sol = lp_ipm_batched.solve_box_lp_batched(c, A, b, l, u, ipm)
    # Lane quality: primal infeasibility plus the duality-gap bound 2n*mu.
    quality = sol.primal_residual + 2 * n_vars * sol.duality_gap
    return sol.x[:, ng:ng + nd], sol.x[:, :ng], quality


@traced("lp.finalize")
def _finalize(sys: System, compat: CompatFlags, shed, pg, res, comp_down,
              load_pu, woodbury_k: int = 2, valid=None) -> EvalResult:
    """Certificate override, quality guard and noise floors; mirrors
    reference ``engines/dcopf.py::_finalize``, as the segment
    :func:`_finalize_lanes` (a CUDA graph where
    ``lp_ipm_structured.lp_chain`` gives one: the card, m <= 72). The
    counter ``lp.guard_fallback`` takes the lanes the guard sends back to
    the certificate's bound among ``valid`` ([B] bool: a padded buffer's
    real lanes; None: every lane)."""
    chain = lp_ipm_structured.lp_chain(
        ("finalize", id(sys), compat, woodbury_k), comp_down.device,
        sys.n_bus + sys.n_branch, comp_down.shape[0], sys)
    *out, bad = chain.run("finalize", functools.partial(
        _finalize_lanes, sys, compat, woodbury_k),
        shed, pg, res, comp_down, load_pu)
    count("lp.guard_fallback", bad, valid, reduce=_real_lanes,
          copy=chain.graphed)
    dns, nodal, failure, pg, infeasible = map(chain.fresh, out)
    return EvalResult(dns_mw=dns, nodal_mw=nodal, failure=failure,
                      primal_residual=res, gen_dispatch=pg,
                      infeasible=infeasible)


def _finalize_lanes(sys: System, compat: CompatFlags, woodbury_k: int,
                    shed, pg, res, comp_down, load_pu) -> tuple:
    """:func:`_finalize`'s work: (dns, nodal, failure, dispatch,
    infeasible, and the lanes the guard sent back)."""
    cert = certify_states(sys, comp_down, load_pu, shed_hint=shed,
                          woodbury_k=woodbury_k)
    shed = torch.where(cert.certified[:, None], cert.shed, shed)
    pg = torch.where(cert.certified[:, None], cert.dispatch, pg)
    base = sys.base_mva
    dns = torch.where(cert.certified, cert.deficit * base, shed.sum(1) * base)
    # Untrustworthy LP lanes (large residual or gap, NaN included) fall
    # back to the copper-sheet bound and the certificate's pattern.
    bad = (~cert.certified) & ~(res <= 5e-3)
    dns = torch.where(bad, cert.deficit * base, dns)
    shed = torch.where(bad[:, None], cert.shed, shed)
    nodal = (shed * base) @ sys.load_onehot.T
    dns = torch.where(dns < compat.dns_noise_floor_mw, 0.0, dns)
    nodal = torch.where((nodal > compat.nodal_noise_threshold_mw)
                        & (dns[:, None] > 0), nodal, 0.0)
    return (dns, nodal, dns > compat.nsq_fail_flag_threshold_mw, pg,
            overgen_infeasible(sys, comp_down, load_pu, compat), bad)


def _real_lanes(flags: torch.Tensor, valid) -> int:
    """Lanes of ``flags`` among ``valid`` (None: every lane)."""
    return int((flags if valid is None else flags & valid).sum())


def _clamped(n: torch.Tensor, cap: int) -> int:
    return min(int(n), cap)


def evaluate_states(sys: System, comp_down: torch.Tensor,
                    load_pu: torch.Tensor,
                    compat: CompatFlags = CompatFlags(),
                    ipm: IPMConfig = IPMConfig(),
                    woodbury_k: int = 2, valid=None) -> EvalResult:
    """Evaluate a batch of states: the LP on every lane plus the
    certificate override; mirrors reference
    ``engines/dcopf.py::evaluate_states``.

    ``comp_down`` [B, n_comp] bool (True = failed); ``load_pu`` [B, n_load].
    With ``compat.island_blackout`` the states first go through
    :func:`apply_island_blackout`, and the islanded loads are added to
    DNS and nodal shed. ``valid`` ([B] bool, for a padded buffer) names
    the real lanes, which alone the guard's counter counts.
    """
    extra_nodal = None
    if compat.island_blackout:
        comp_down, load_pu, extra_nodal = apply_island_blackout(
            sys, comp_down, load_pu)
    shed, pg, res = _solve_batch(sys, comp_down, load_pu, compat, ipm)
    out = _finalize(sys, compat, shed, pg, res, comp_down, load_pu,
                    woodbury_k, valid=valid)
    if extra_nodal is not None:
        dns = out.dns_mw + extra_nodal.sum(1)
        dns = torch.where(dns < compat.dns_noise_floor_mw, 0.0, dns)
        out = out._replace(dns_mw=dns, nodal_mw=out.nodal_mw + extra_nodal,
                           failure=dns > compat.nsq_fail_flag_threshold_mw)
    return out


def _scatter_valid(dst, idx, valid, src):
    """dst[idx[j]] = src[j] for every valid slot j, without a host sync.
    Invalid slots (which may repeat lane indices) are sent to a scratch
    row past the end, so the valid, unique indices are the only writes
    that land and no write has an undefined winner."""
    B = dst.shape[0]
    buf = torch.cat([dst, dst[:1]], dim=0)
    buf[torch.where(valid, idx, B)] = src
    return buf[:B]


def _needs_lp(pre: Certificate, nodal_mode: str) -> torch.Tensor:
    """[B] bool: the lanes the screened evaluator sends to the LP
    ("proportional": uncertified lanes; "lp": every lane not certified at
    zero deficit)."""
    if nodal_mode == "proportional":
        return ~pre.certified
    return ~(pre.certified & (pre.deficit <= 0))


def evaluate_states_screened(sys: System, comp_down: torch.Tensor,
                             load_pu: torch.Tensor, max_lp: int,
                             compat: CompatFlags = CompatFlags(),
                             ipm: IPMConfig = IPMConfig(),
                             nodal_mode: str = "lp",
                             repair_buffer: int | None = None,
                             woodbury_k: int = 2, shed_hint=None,
                             pre: Certificate | None = None,
                             pf_buffer: int | None = None):
    """Screened evaluation: the LP only on lanes that need it; mirrors
    reference ``engines/dcopf.py::evaluate_states_screened``.

    Lanes certified at zero deficit are resolved by tier 1; the rest
    (``nodal_mode="lp"``: every uncertified or positive-deficit lane;
    ``"proportional"``: uncertified lanes only) are compacted into a
    ``max_lp`` buffer and solved by ``evaluate_states``. Lanes that do
    not fit keep the tier-1 bound and are counted in ``n_overflow``.
    ``shed_hint`` [n_load] is the ``calibrate_shed_hint`` pattern.
    ``pre``: a ``Certificate`` computed by the caller (the fused
    sampler-certificate path: ``ops/fused_sampler_cert.py`` then
    :func:`certify_finish`) replaces the internal tier-1 pass;
    ``shed_hint`` is then ignored (the kernel applied its own
    candidate).

    ``pf_buffer``: tier 1.5. That many of the lanes tier 1 leaves for the
    LP go through :func:`certify_island_pf` first; a lane it certifies
    leaves the LP's queue, and on every valid buffer lane its deficit
    (the larger of the two bounds), shed and dispatch replace tier 1's.
    None (the default) skips it; ``default_pf_buffer`` sizes it.

    Returns ``(EvalResult, n_overflow)``, both on the device. At m <= 336
    nothing in here waits for the device when ``shed_hint`` is already a
    tensor on it (a host array is copied, which synchronizes the
    stream). At m > 336 the LP buffer's large-m solve reads on the host
    (``lp_ipm_batched.solve_box_lp_ops``: each Schur inverse's probe and
    the rescue ladder's gates), ~40 times a call on case300s.

    ``compat.island_blackout``: the states go through
    :func:`apply_island_blackout` before certification, and the islanded
    loads are added to DNS and nodal shed before the noise floors; with
    ``pre`` it raises ValueError (the certificate must see the changed
    states).
    """
    B = comp_down.shape[0]
    extra_nodal = None
    if compat.island_blackout:
        if pre is not None:
            raise ValueError(
                "island_blackout changes the states before certification; "
                "compute the certificate inside (pre=None)")
        comp_down, load_pu, extra_nodal = apply_island_blackout(
            sys, comp_down, load_pu)
        compat = dataclasses.replace(compat, island_blackout=False)
    if pre is None:
        hint_b = None
        if shed_hint is not None:
            hint = torch.as_tensor(shed_hint, dtype=load_pu.dtype,
                                   device=load_pu.device)
            hint_b = hint[None, :].expand(load_pu.shape)
        pre = certify_states(sys, comp_down, load_pu, shed_hint=hint_b,
                             repair_buffer=repair_buffer,
                             woodbury_k=woodbury_k)
    need_lp = _needs_lp(pre, nodal_mode)

    if pf_buffer:
        # Tier 1.5 on the compacted tier-1 misses (unique lanes, so plain
        # index writes are exact).
        kpf = min(int(pf_buffer), B)
        pidx = _topk_lanes(need_lp, kpf)
        pvalid = (torch.arange(kpf, device=pidx.device) < need_lp.sum()) \
            & need_lp[pidx]
        isl = certify_island_pf(sys, comp_down[pidx], load_pu[pidx],
                                theta_cap=ipm.theta_max)
        vc = pvalid[:, None]
        certified, deficit = pre.certified.clone(), pre.deficit.clone()
        shed, dispatch = pre.shed.clone(), pre.dispatch.clone()
        certified[pidx] = certified[pidx] | (pvalid & isl.certified)
        deficit[pidx] = torch.where(
            pvalid, torch.maximum(isl.deficit, deficit[pidx]), deficit[pidx])
        shed[pidx] = torch.where(vc, isl.shed, shed[pidx])
        dispatch[pidx] = torch.where(vc, isl.dispatch, dispatch[pidx])
        pre = Certificate(certified=certified, deficit=deficit, shed=shed,
                          dispatch=dispatch)
        need_lp = _needs_lp(pre, nodal_mode)

    with span("loop.compact"):
        n_need = need_lp.sum()
        idx = _topk_lanes(need_lp, min(max_lp, B))
        if idx.shape[0] < max_lp:
            idx = torch.cat([idx, torch.zeros(max_lp - idx.shape[0],
                                              dtype=idx.dtype,
                                              device=idx.device)])
        valid = (torch.arange(max_lp, device=idx.device) < n_need) \
            & need_lp[idx]
        down_lp, load_lp = comp_down[idx], load_pu[idx]
    count("lp.buffer_lanes", max_lp)
    count("lp.real_lanes", n_need, max_lp, reduce=_clamped)

    sub = evaluate_states(sys, down_lp, load_lp, compat, ipm, woodbury_k,
                          valid=valid)

    with span("loop.scatter"):
        base = sys.base_mva
        dns = _scatter_valid(pre.deficit * base, idx, valid, sub.dns_mw)
        nodal = _scatter_valid((pre.shed * base) @ sys.load_onehot.T, idx,
                               valid, sub.nodal_mw)
        pg = _scatter_valid(pre.dispatch, idx, valid, sub.gen_dispatch)
        res = _scatter_valid(torch.zeros_like(dns), idx, valid,
                             sub.primal_residual)
    if extra_nodal is not None:
        dns = dns + extra_nodal.sum(1)
        nodal = nodal + extra_nodal

    dns = torch.where(dns < compat.dns_noise_floor_mw, 0.0, dns)
    nodal = torch.where((nodal > compat.nodal_noise_threshold_mw)
                        & (dns[:, None] > 0), nodal, 0.0)
    n_overflow = torch.clamp_min(n_need - max_lp, 0)
    return EvalResult(dns_mw=dns, nodal_mw=nodal,
                      failure=dns > compat.nsq_fail_flag_threshold_mw,
                      primal_residual=res, gen_dispatch=pg,
                      infeasible=overgen_infeasible(sys, comp_down, load_pu,
                                                    compat)), n_overflow
