#!/usr/bin/env python3
"""Times the large-m dense factor of the PyTorch port on one CUDA card,
route by route, and runs the stress lanes through each route.

Run from the root of a checkout:  python3 scripts/torch_xla_chol_bench.py

1. The dense factor of the large-m LP at m = 792 (case300s) on
   equilibrated normal matrices A diag(w) A' of the 128 stress lanes of
   scripts/parity_case300.py (log-uniform barrier weights 1e-2..1e2, seed
   0), tiled to 32 (the rescue sub-buffer), 128 and 2,048 lanes: the
   explicit inverse factor L^-1 in one block (``ops/xla_chol.factor``:
   one cholesky_ex and one solve_triangular) and in the reference's
   panels of 128 and 256 with an identity-padded corner
   (:func:`panel_factor`, kept here only), and the port's route,
   ``lp_ipm_batched._large_factor`` (cholesky_ex) with its substitutions
   (two solve_triangular), and the same with cholesky_solve. Per route:
   ms of the factor and of one solve refined twice against M, CUDA
   events, median of five runs; the refined solve's max relative
   residual in float64.
2. The two [B, 300, 300] Schur inverses' route,
   ``ops/blocked_chol.explicit_spd_inv`` (K2a and K3), beside
   ``xla_chol.factor`` at m = 300.
3. ``dcopf.evaluate_states`` on the 128 stress lanes (chip_smoke.py
   lp300's states) once for each route the rescue ladder's dense solves
   could take: the port's ``_large_factor`` / ``_large_solve`` with
   ``xla_chol.chol`` and ``xla_chol.cho_solve`` swapped for each route's
   factor and solve, so the refinement is the port's own. Per route:
   wall ms, the lanes past the evaluator's guard with their quality
   scores, and the float64 HiGHS error over every shed or tripped lane
   and 64 zero-shed ones (chip_smoke.py's oracle).

One JSON line a configuration.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def _ms(fn, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def panel_factor(M, bs: int):
    """The reference's explicit inverse factor (``xla_chol.py::factor``):
    M [B, m, m] padded to a multiple of ``bs`` with an identity corner,
    each bs-wide diagonal block factored and inverted once, the panel
    below it a matmul by that inverse, and L^-1 filled by block forward
    substitution. Returns L^-1 [B, mp, mp]."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import xla_chol
    m = M.shape[1]
    mp = -(-m // bs) * bs
    A = torch.nn.functional.pad(M, (0, mp - m, 0, mp - m))
    idx = torch.arange(m, mp, device=M.device)
    A[:, idx, idx] = 1.0
    nblk = mp // bs
    L = torch.zeros_like(A)
    inv_diag = []
    for k in range(nblk):
        lo, hi = k * bs, (k + 1) * bs
        inv_diag.append(xla_chol.factor(A[:, lo:hi, lo:hi]))
        L[:, lo:hi, lo:hi] = xla_chol.chol(A[:, lo:hi, lo:hi])
        if hi < mp:
            Pk = A[:, hi:, lo:hi] @ inv_diag[k].transpose(1, 2)
            L[:, hi:, lo:hi] = Pk
            A[:, hi:, hi:] -= Pk @ Pk.transpose(1, 2)
    Linv = torch.zeros_like(L)
    Linv[:, :bs, :bs] = inv_diag[0]
    for i in range(1, nblk):
        lo, hi = i * bs, (i + 1) * bs
        S = L[:, lo:hi, :lo] @ Linv[:, :lo, :lo]
        Linv[:, lo:hi, :lo] = -(inv_diag[i] @ S)
        Linv[:, lo:hi, lo:hi] = inv_diag[i]
    return Linv


def panel_solve(Linv, r):
    """M^-1 r with :func:`panel_factor`'s padded L^-1."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import xla_chol
    m = r.shape[1]
    r = torch.nn.functional.pad(r, (0, Linv.shape[1] - m))
    return xla_chol.solve(Linv, r)[:, :m]


def _routes():
    """name -> (factor, solve) of every dense route."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import xla_chol
    routes = {"inverse_one_block": (xla_chol.factor, xla_chol.solve)}
    for bs in (128, 256):
        routes[f"inverse_panels{bs}"] = (
            lambda M, bs=bs: panel_factor(M, bs), panel_solve)
    routes["substitution"] = (xla_chol.chol, xla_chol.cho_solve)
    routes["substitution_potrs"] = (
        xla_chol.chol,
        lambda L, r: torch.cholesky_solve(r[:, :, None], L)[:, :, 0])
    return routes


@contextlib.contextmanager
def _dense_route(factor, solve):
    """The port's large-m dense solve (lp_ipm_batched._large_factor /
    _large_solve, refinement included) with the ``xla_chol.chol`` and
    ``xla_chol.cho_solve`` it calls swapped for ``factor`` and ``solve``:
    lp_ipm_batched's name ``xla_chol`` is pointed at a namespace of the
    two, and the module itself stays as it is."""
    import types
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb)
    saved = lpb.xla_chol
    lpb.xla_chol = types.SimpleNamespace(chol=factor, cho_solve=solve)
    try:
        yield
    finally:
        lpb.xla_chol = saved


def _stress_routes(routes) -> None:
    import numpy as np
    import torch
    import chip_smoke
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    case = cases.case300s()
    sys_ = build_system(case, device="cuda")
    states = chip_smoke._stress300_states(case)
    down = torch.as_tensor(states, device="cuda").bool()
    load = sys_.load_pd[None, :].expand(128, sys_.n_load)
    cert = dcopf.certify_states(sys_, down, load).certified.cpu().numpy()
    for name, (fac, sol) in routes.items():
        with _dense_route(fac, sol):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = dcopf.evaluate_states(sys_, down, load)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        q = res.primal_residual.double().cpu().numpy()
        dns = res.dns_mw.double().cpu().numpy()
        trip = (q > chip_smoke.LP_QUALITY_GUARD) & ~cert
        n, worst = chip_smoke._oracle300(case, states, dns, trip)
        print(json.dumps(dict(
            stress_lanes=128, route=name, wall_ms=wall,
            tripped=np.nonzero(trip)[0].tolist(),
            quality_tripped=q[trip].tolist(), oracle_lanes=n,
            oracle_max_err_mw=worst)), flush=True)


def _normal_matrices(n: int, which: str):
    """[n, m, m] equilibrated A diag(w) A' + 1e-7 I of the stress lanes,
    tiled; ``which`` "dense" is the m = 792 normal matrix, "schur" the
    [300, 300] K of its block-Schur factor (xla_chol's m <= 336 input)."""
    import torch
    import chip_smoke
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags)
    case = cases.case300s()
    sys_ = build_system(case, device="cuda")
    states = torch.as_tensor(chip_smoke._stress300_states(case),
                             device="cuda")
    up = 1.0 - states
    load = sys_.load_pd[None, :].expand(128, sys_.n_load)
    ng = sys_.n_gen
    *_, cs = dcopf.build_state_lp_vectors(sys_, up[:, :ng],
                                          up[:, ng:].contiguous(), load,
                                          CompatFlags(), 6.0)
    ops = dcopf.make_dc_linops(sys_, cs[:, :ng], up[:, ng:].contiguous())
    g = torch.Generator(device="cuda").manual_seed(0)
    n_var = ng + sys_.n_load + sys_.n_branch + sys_.n_bus
    w = 10.0 ** (4 * torch.rand((128, n_var), generator=g,
                                device="cuda") - 2)
    if which == "dense":
        M = ops.gram(w)
    else:
        store = []
        from powersystemsreliabilityassessment_tpu_torch.ops import xla_chol
        orig = xla_chol.inv_spd_equilibrated
        xla_chol.inv_spd_equilibrated = lambda K, d: store.append(K) or \
            orig(K, d)
        try:
            ops.schur_factor(w, 0.0, 1e-7)
        finally:
            xla_chol.inv_spd_equilibrated = orig
        M = store[0]
    s = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2).clamp_min(1e-30))
    eye = torch.eye(M.shape[-1], device="cuda")
    M = M * s[:, :, None] * s[:, None, :] + 1e-7 * eye
    return M.repeat(-(-n // 128), 1, 1)[:n].contiguous()


def main() -> int:
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb)
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        blocked_chol, cuda_build, xla_chol)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    cuda_build.library()
    for n in (32, 128, 2048):
        M = _normal_matrices(n, "dense")
        r = torch.randn(M.shape[:2], device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))

        def refined(solve, F):
            x = solve(F, r)
            for _ in range(lpb.LARGE_REFINE_STEPS):
                x = x + solve(F, r - (M @ x[:, :, None])[:, :, 0])
            return x

        for name, (fac, sol) in _routes().items():
            F = fac(M)
            x = refined(sol, F)
            res = ((M.double() @ x.double()[:, :, None])[:, :, 0]
                   - r.double()).abs().amax(1) / r.abs().amax(1).double()
            print(json.dumps(dict(
                m=M.shape[-1], lanes=n, route=name,
                factor_ms=_ms(lambda: fac(M)),
                refined_solve_ms=_ms(lambda: refined(sol, F)),
                max_rel_residual=float(res.max()),
                finite=bool(torch.isfinite(x).all()))), flush=True)
        del M
        torch.cuda.empty_cache()
    for n in (128, 2048):
        K = _normal_matrices(n, "schur")
        print(json.dumps(dict(
            m=K.shape[-1], lanes=n,
            explicit_spd_inv_ms=_ms(lambda: blocked_chol.explicit_spd_inv(K)),
            xla_chol_factor_ms=_ms(lambda: xla_chol.factor(K)),
            xla_chol_inverse_ms=_ms(lambda: (lambda L: L.transpose(1, 2) @ L)(
                xla_chol.factor(K))))), flush=True)
        del K
        torch.cuda.empty_cache()
    _stress_routes(_routes())
    return 0


if __name__ == "__main__":
    sys.exit(main())
