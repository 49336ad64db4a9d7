"""Fused interior-point iterations for the structured DC-OPF LP (K1).

Port of ``powersystemsreliabilityassessment_tpu/ops/ipm_fused.py``. The
DC-OPF LP of ``engines/dcopf.py::build_state_lp`` differs across lanes
only by elementwise scalings of shared blocks:

    A_lane = [ A0_bal * colscale[lane]                              ]
             [ 0 | 0 | diag(1/b) | -br_up[lane] * Mref              ]

with A0_bal = [Cg | Cd | -Minc' | 0] and Mref the incidence with the
reference bus's column zeroed. So every A-product is two small shared
products, and the normal matrix A diag(1/d) A' is formed from A0 and
Mref directly:

    M_bal,bal = A0 diag(colscale^2 / d) A0'
    M_bal,f   = -Minc'[i,l] * (1/d_f)_l * (1/b)_l
    M_f,f     = (Mref diag(1/d_theta) Mref') o (bru bru') + diag(1/(b^2 d_f))

``fused_ipm_iterations`` is the wrapper: on CUDA tensors it launches the
hand-written kernel of ``csrc/ipm_fused.cu`` (one warp per LP lane,
several lanes a block, the whole Mehrotra loop in one launch, A and the
normal matrix taken from the structure's incidence lists); on CPU
tensors it runs :func:`fused_ipm_iterations_plain`, the same algorithm
in plain PyTorch.
The reference's pair-product matrices (``p_bal``, ``q_theta``) and its
profiling-only ``ABLATE`` hook are not ported.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build
from powersystemsreliabilityassessment_tpu_torch.ops.batched_chol import (
    MAX_M, cho_solve_plain, cholesky_plain)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)

launches = {"fused_ipm_iterations": 0}

# Launch shape of the kernel: at most this many LP lanes share a block,
# within the 227 KB of shared memory a block can use.
MAX_LANES_PER_BLOCK = 4
SMEM_PER_BLOCK = 232448
MAX_N = 256   # columns the kernel's instances take (m <= MAX_M rows)
# A lane runs on two warps (the instance for m <= 64, n <= 128) while
# the batch leaves every SM's four schedulers at most one warp; else on
# one. On an NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_k1_bench.py,
# RTS-24 lanes): 256 lanes 0.84 ms on two warps against 1.08 on one;
# 2,048 lanes 2.45 against 1.56.
SCHEDULERS_PER_SM = 4
TWO_WARP_MAX = (64, 128)   # (m, n)


@dataclasses.dataclass(frozen=True)
class LPStructure:
    """Shared (lane-independent) LP blocks; mirrors reference
    ``ops/ipm_fused.py::LPStructure`` without the pair products."""
    a0_bal: torch.Tensor    # [nb, n] balance block [Cg | Cd | -Minc' | 0]
    minc_ref: torch.Tensor  # [nl, nb] incidence * reference-bus mask
    inv_b: torch.Tensor     # [nl] branch reactance 1/b_l
    # The same blocks as incidence lists (int32), which the kernel forms
    # A-products and the normal matrix from: each generator's and load's
    # bus, each branch's ends, and A0's nonzero columns of each bus row
    # (CSR, ascending).
    gen_bus: torch.Tensor   # [ng]
    load_bus: torch.Tensor  # [nd]
    br_from: torch.Tensor   # [nl]
    br_to: torch.Tensor     # [nl]
    bus_ptr: torch.Tensor   # [nb + 1]
    bus_col: torch.Tensor   # [ng + nd + 2 nl]
    ng: int
    nd: int
    nl: int
    nb: int

    @property
    def n(self) -> int:
        return self.ng + self.nd + self.nl + self.nb

    @property
    def m(self) -> int:
        return self.nb + self.nl


# id(System) -> (weak reference to it, its LPStructure).
_structures: dict = {}


def build_structure(sys) -> LPStructure:
    """Shared LP structure of a ``System``; mirrors reference
    ``ops/ipm_fused.py::build_structure``: balance block
    [Cg | Cd | -Minc' | 0], flow block [0 | 0 | diag(1/b) | -br_up*Mref]
    with the reference bus's theta column zeroed (gauge fix), and the
    incidence lists of the same blocks. Built once per ``System`` (a
    frozen dataclass) and then reused: the LP tier asks for it every
    step, and building it takes dozens of small kernels."""
    key = id(sys)
    hit = _structures.get(key)
    if hit is not None and hit[0]() is sys:
        return hit[1]
    st = _build_structure(sys)
    _structures[key] = (weakref.ref(sys, lambda _: _structures.pop(key, None)),
                        st)
    return st


def _build_structure(sys) -> LPStructure:
    nb, ng, nl, nd = sys.n_bus, sys.n_gen, sys.n_branch, sys.n_load
    inc = sys.incidence
    a0 = torch.cat([sys.gen_bus_onehot, sys.load_onehot, -inc.T,
                    torch.zeros((nb, nb), dtype=inc.dtype,
                                device=inc.device)], dim=1)
    dev = inc.device
    ref_mask = (torch.arange(nb, device=dev) != 0).to(inc.dtype)
    gen_bus = sys.gen_bus_onehot.argmax(0)
    load_bus = sys.load_onehot.argmax(0)
    br_from = (inc == 1).to(torch.uint8).argmax(1)
    br_to = (inc == -1).to(torch.uint8).argmax(1)
    # A0's nonzeros, one per generator and load column, two per branch
    # column, sorted by (bus, column): fixed-size ops only, so building
    # the structure inside a step never waits for the device.
    rows = torch.cat([gen_bus, load_bus, br_from, br_to])
    f = ng + nd + torch.arange(nl, device=dev)
    cols = torch.cat([torch.arange(ng + nd, device=dev), f, f])
    order = torch.argsort(rows * (ng + nd + nl) + cols)
    index = lambda t: t.to(torch.int32).contiguous()
    return LPStructure(
        a0_bal=a0.contiguous(),
        minc_ref=(inc * ref_mask[None, :]).contiguous(),
        inv_b=(1.0 / sys.b_susceptance).contiguous(),
        gen_bus=index(gen_bus), load_bus=index(load_bus),
        br_from=index(br_from), br_to=index(br_to),
        bus_ptr=index(torch.searchsorted(
            rows[order], torch.arange(nb + 1, device=dev))),
        bus_col=index(cols[order]),
        ng=ng, nd=nd, nl=nl, nb=nb)


def launch_shape(st: LPStructure, batch: int, n_sms: int) -> tuple:
    """``(lanes per block, warps per lane, dynamic shared bytes)`` of a
    K1 launch, in the layout of ``csrc/ipm_fused.cu``
    (``ipm_struct_words`` once per block, ``ipm_lane_words`` per lane):
    as many lanes a block as still leave every one of the ``n_sms`` SMs
    a block, at most ``MAX_LANES_PER_BLOCK``, within
    ``SMEM_PER_BLOCK``; two warps a lane while that leaves each
    scheduler at most one warp. Raises for a shape no kernel instance
    takes (m > 72 or n > 256)."""
    n, m, nl = st.n, st.m, st.nl
    if m > MAX_M or n > MAX_N:
        raise ValueError(f"fused IPM kernel takes m <= {MAX_M} and "
                         f"n <= {MAX_N}, got m = {m}, n = {n}")
    lane = 4 * (m * (m + 1) // 2 + 6 * n + 2 * m + 2 * nl + 6)
    shared = 4 * (2 * st.ng + 2 * st.nd + 5 * nl + st.nb + 1)
    fit = (SMEM_PER_BLOCK - shared) // lane
    lpb = max(1, min(MAX_LANES_PER_BLOCK, batch // max(n_sms, 1), fit))
    wpl = 2 if (2 * batch <= SCHEDULERS_PER_SM * n_sms
                and m <= TWO_WARP_MAX[0] and n <= TWO_WARP_MAX[1]) else 1
    return lpb, wpl, shared + lpb * lane


def mv(st: LPStructure, colscale, bru, v):
    """Batched A v: [B, n] -> [B, m]; mirrors reference
    ``engines/lp_ipm_structured.py::mv`` (the kernel's ``apply_a``)."""
    f_lo, f_hi = st.ng + st.nd, st.ng + st.nd + st.nl
    top = (colscale * v) @ st.a0_bal.T
    bot = st.inv_b[None, :] * v[:, f_lo:f_hi] - bru * (
        v[:, f_hi:] @ st.minc_ref.T)
    return torch.cat([top, bot], dim=1)


def mtv(st: LPStructure, colscale, bru, y):
    """Batched A' y: [B, m] -> [B, n]; mirrors reference
    ``engines/lp_ipm_structured.py::mtv`` (the kernel's ``apply_at``)."""
    yb, yf = y[:, :st.nb], y[:, st.nb:]
    r = colscale * (yb @ st.a0_bal)
    f_lo, f_hi = st.ng + st.nd, st.ng + st.nd + st.nl
    return torch.cat([
        r[:, :f_lo],
        r[:, f_lo:f_hi] + st.inv_b[None, :] * yf,
        r[:, f_hi:] - (bru * yf) @ st.minc_ref], dim=1)


def normal_matrix(st: LPStructure, wb, bru):
    """Batched A diag(cw) A' with wb = colscale^2 * cw: [B, n] -> [B, m, m];
    mirrors reference ``engines/lp_ipm_structured.py::normal_matrix``,
    formed from A0 and Mref as the K1 kernel forms it.

    PRECONDITION (as in the reference): colscale is 1.0 on every
    non-generator column, so the column scaling folds into wb uniformly.
    """
    nb = st.nb
    f_lo, f_hi = st.ng + st.nd, st.ng + st.nd + st.nl
    a0 = st.a0_bal
    g = wb[:, f_lo:f_hi] * st.inv_b[None, :]                    # [B, nl]
    mbb = (a0[None] * wb[:, None, :]) @ a0.T                    # [B, nb, nb]
    mbf = a0[None, :, f_lo:f_hi] * g[:, None, :]                # [B, nb, nl]
    mref = st.minc_ref
    mtt = ((mref[None] * wb[:, None, f_hi:]) @ mref.T
           * bru[:, :, None] * bru[:, None, :])
    mtt = mtt + torch.diag_embed(st.inv_b[None, :] * g)
    return torch.cat([torch.cat([mbb, mbf], dim=2),
                      torch.cat([mbf.transpose(1, 2), mtt], dim=2)], dim=1)


def fused_ipm_iterations_plain(st: LPStructure, colscale, br_up, c, b, l, u,
                               cfg: IPMConfig = IPMConfig()):
    """Plain PyTorch version of the K1 kernel (the reference kernel's
    algorithm): ``cfg.iterations`` Mehrotra predictor-corrector steps on
    every lane, with the reference's per-lane freeze (``mu < mu_tol`` or a
    non-finite step keeps the state) and best-iterate tracking. Each
    iteration forms the equilibrated, regularized normal matrix, factors
    it with the pivot-floored right-looking Cholesky and solves by
    forward and back substitution.

    Returns batch-major ``(x, y, zl, zu, best_score, best_x)``.
    """
    B, n = c.shape
    tau, delta = cfg.tau, cfg.regularization
    margin = 1e-9 * torch.clamp_min(u - l, 1e-12)
    eye_m = torch.eye(st.m, dtype=c.dtype, device=c.device)
    A = lambda v: mv(st, colscale, br_up, v)
    At = lambda w: mtv(st, colscale, br_up, w)

    def factor(d):
        M = normal_matrix(st, colscale * colscale / d, br_up)
        s = torch.rsqrt(torch.clamp_min(
            torch.diagonal(M, dim1=1, dim2=2), 1e-30))
        return cholesky_plain(M * s[:, :, None] * s[:, None, :]
                              + delta * eye_m), s

    def newton(fs, d, sl, su, zl, zu, rd, rp, rcl, rcu):
        chol, s = fs
        rhat = rd - rcl / sl + rcu / su
        dy = s * cho_solve_plain(chol, s * (rp + A(rhat / d)))
        dx = (At(dy) - rhat) / d
        return dx, dy, (rcl - zl * dx) / sl, (rcu + zu * dx) / su

    def max_step(sl, su, zl, zu, dx, dzl, dzu):
        big = c.new_full((), 1e30)
        ap = torch.minimum(
            torch.where(dx < 0, -sl / torch.clamp_max(dx, -1e-30), big
                        ).amin(1),
            torch.where(dx > 0, su / torch.clamp_min(dx, 1e-30), big
                        ).amin(1))
        ad = torch.minimum(
            torch.where(dzl < 0, -zl / torch.clamp_max(dzl, -1e-30), big
                        ).amin(1),
            torch.where(dzu < 0, -zu / torch.clamp_max(dzu, -1e-30), big
                        ).amin(1))
        return (torch.clamp_max(tau * ap, 1.0)[:, None],
                torch.clamp_max(tau * ad, 1.0)[:, None])

    x = 0.5 * (l + u)
    y = torch.zeros_like(b)
    zl = torch.ones_like(c)
    zu = torch.ones_like(c)
    best_x = x.clone()
    best_score = torch.full((B,), float("inf"), dtype=c.dtype,
                            device=c.device)
    done = torch.zeros((B,), dtype=torch.bool, device=c.device)
    for _ in range(cfg.iterations):
        sl = torch.clamp_min(x - l, 1e-12)
        su = torch.clamp_min(u - x, 1e-12)
        rp = b - A(x)
        rd = c - At(y) - zl + zu
        mu = (sl * zl + su * zu).sum(1) / (2 * n)
        score = mu + rp.abs().amax(1)
        better = score < best_score
        best_score = torch.where(better, score, best_score)
        best_x = torch.where(better[:, None], x, best_x)
        done = done | (mu < cfg.mu_tol)

        d = torch.clamp(zl / sl + zu / su, 1e-6, 1e10)
        fs = factor(d)
        centering = (mu < cfg.center_tol)[:, None]
        dxa, _, dzla, dzua = newton(fs, d, sl, su, zl, zu, rd, rp,
                                    -sl * zl, -su * zu)
        apa, ada = max_step(sl, su, zl, zu, dxa, dzla, dzua)
        mu_aff = ((sl + apa * dxa) * (zl + ada * dzla)
                  + (su - apa * dxa) * (zu + ada * dzua)).sum(1) / (2 * n)
        ratio = mu_aff / torch.clamp_min(mu, 1e-12)
        sigma = torch.where(centering[:, 0], 0.5,
                            torch.clamp(ratio * ratio * ratio, 0.0, 1.0)
                            )[:, None]
        gate = torch.where(centering, 0.0, 1.0)
        rcl = sigma * mu[:, None] - sl * zl - gate * dxa * dzla
        rcu = sigma * mu[:, None] - su * zu + gate * dxa * dzua
        dx, dy, dzl, dzu = newton(fs, d, sl, su, zl, zu, rd, rp, rcl, rcu)
        ap, ad = max_step(sl, su, zl, zu, dx, dzl, dzu)
        damp = torch.where(centering, 0.9, 1.0)
        ap, ad = damp * ap, damp * ad

        xn = torch.minimum(torch.maximum(x + ap * dx, l + margin), u - margin)
        yn = y + ad * dy
        zln = torch.clamp_min(zl + ad * dzl, 1e-12)
        zun = torch.clamp_min(zu + ad * dzu, 1e-12)
        finite = (torch.isfinite(xn).all(1) & torch.isfinite(yn).all(1)
                  & torch.isfinite(zln).all(1) & torch.isfinite(zun).all(1))
        done = done | ~finite
        keep = done[:, None]
        x = torch.where(keep, x, xn)
        y = torch.where(keep, y, yn)
        zl = torch.where(keep, zl, zln)
        zu = torch.where(keep, zu, zun)
    return x, y, zl, zu, best_score, best_x


def fused_ipm_iterations(st: LPStructure, colscale, br_up, c, b, l, u,
                         cfg: IPMConfig = IPMConfig()):
    """Run the whole Mehrotra iteration loop; mirrors reference
    ``ops/ipm_fused.py::fused_ipm_iterations``.

    Inputs are batch-major float32 ([B, n] / [B, nl] / [B, m]); any B.
    Returns batch-major ``(x, y, zl, zu, best_score, best_x)`` — the state
    ``lp_ipm_batched.polish_box_lp`` consumes. CUDA: the K1 kernel;
    CPU: :func:`fused_ipm_iterations_plain`.
    """
    if c.device.type == "cpu":
        return fused_ipm_iterations_plain(st, colscale, br_up, c, b, l, u,
                                          cfg)
    B, n, m, nl = c.shape[0], st.n, st.m, st.nl
    lpb, wpl, smem = launch_shape(
        st, B, torch.cuda.get_device_properties(c.device).multi_processor_count)
    ops = {"colscale": (colscale, (B, n)), "br_up": (br_up, (B, nl)),
           "c": (c, (B, n)), "b": (b, (B, m)), "l": (l, (B, n)),
           "u": (u, (B, n)), "inv_b": (st.inv_b, (nl,))}
    lists = {"gen_bus": (st.gen_bus, (st.ng,)),
             "load_bus": (st.load_bus, (st.nd,)),
             "br_from": (st.br_from, (nl,)), "br_to": (st.br_to, (nl,)),
             "bus_ptr": (st.bus_ptr, (st.nb + 1,)),
             "bus_col": (st.bus_col, (st.ng + st.nd + 2 * nl,))}
    for dtype, group in ((torch.float32, ops), (torch.int32, lists)):
        for name, (t, shape) in group.items():
            cuda_build.check_operand(t, name, shape, dtype)
            if t.device != c.device:
                raise ValueError(f"{name} is on {t.device}, c on {c.device}")
    x = torch.empty_like(c)
    y = torch.empty_like(b)
    zl = torch.empty_like(c)
    zu = torch.empty_like(c)
    best_x = torch.empty_like(c)
    best_score = torch.empty((B,), dtype=c.dtype, device=c.device)
    err = cuda_build.library().psra_fused_ipm(
        colscale.data_ptr(), br_up.data_ptr(), c.data_ptr(), b.data_ptr(),
        l.data_ptr(), u.data_ptr(), st.inv_b.data_ptr(),
        *(t.data_ptr() for t, _ in lists.values()),
        x.data_ptr(), y.data_ptr(), zl.data_ptr(), zu.data_ptr(),
        best_x.data_ptr(), best_score.data_ptr(),
        B, st.ng, st.nd, st.nl, st.nb, int(cfg.iterations), lpb, wpl, smem,
        float(cfg.tau), float(cfg.regularization), float(cfg.mu_tol),
        float(cfg.center_tol), cuda_build.stream_handle(c))
    cuda_build.check_launch(err, "fused_ipm_iterations")
    launches["fused_ipm_iterations"] += 1
    return x, y, zl, zu, best_score, best_x
