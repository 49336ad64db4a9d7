#!/usr/bin/env python3
"""SEQ LP lanes of the PyTorch port against the JAX reference and HiGHS.

Run from the root of a checkout, with the file that
scripts/torch_seq_lanes_dump.py wrote on the card:

    JAX_PLATFORMS=cpu python3 scripts/torch_seq_lane_faults.py DUMP.npz \
        [--seeds 11,12,13] [--golden]

On the CPU, for the dumped 4,096 lanes (and for 4,096 lanes the port's
SEQ sampler draws on the CPU at each of ``--seeds``):
* the float64 HiGHS optimum of every lane's LP;
* the lanes whose polished objective is more than 5e-3 p.u. from it, and
  the lanes past the evaluator's 5e-3 guard, for the reference's K1
  (Pallas, interpret mode), the port's plain K1, and the plain K1 with
  other solve orders (the reference kernel's 8 x 8 block inverses, the
  port's K1 kernel's column sweep) or with its factor and solve in
  float64; on the dump, also the card's K1;
* on the dump: the first Mehrotra iteration at which the plain K1 and
  the reference part (max |x| difference after k = 1..16 iterations);
  ``evaluate_states`` of the reference, of the port on the CPU and (from
  the dump) of the port's K1 on the card: uncertified lanes past the
  guard, the hours the reference solves and the port bounds, and the LP
  lanes' EENS with those hours bounded and solved; and the K2a
  synthetic-weight lanes (kernel - plain > 1e-4 on the card) against the
  reference's own factor (Pallas, interpret mode) and float64.
``--golden`` writes tests/golden/seq_hard_lanes.npz and
tests/golden/k2_synthetic_lanes.npz from the dump.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

GUARD = 5e-3
YEARS, HOURS = 16, 8736


def _ref_state(ref, down, load):
    """The reference's polished structured solve of the lanes (Pallas K1
    in interpret mode), in 512-lane pieces: (objective, quality)."""
    import jax.numpy as jnp
    rdc, rls, rf, rsys, RC, RI = ref
    obj, q = [], []
    st = rf.build_structure(rsys)
    for s in range(0, len(down), 512):
        d, ld = down[s:s + 512], load[s:s + 512]
        gu = jnp.asarray(1.0 - d[:, :rsys.n_gen], jnp.float32)
        bu = jnp.asarray(1.0 - d[:, rsys.n_gen:], jnp.float32)
        c, b, l, u, cs = rdc.build_state_lp_vectors(
            rsys, gu, bu, jnp.asarray(ld), RC(), RI().theta_max)
        sol = rls.solve_box_lp_structured(st, cs, bu, c, b, l, u, RI())
        obj.append(np.asarray(sol.objective))
        q.append(np.asarray(sol.primal_residual)
                 + 2 * st.n * np.asarray(sol.duality_gap))
    return np.concatenate(obj), np.concatenate(q)


def _port_lp(sys_, down, load):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags)
    up = 1.0 - torch.as_tensor(down).float()
    c, b, l, u, cs = dcopf.build_state_lp_vectors(
        sys_, up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous(),
        torch.as_tensor(load), CompatFlags(), 6.0)
    return cs, up[:, sys_.n_gen:].contiguous(), c, b, l, u


def _highs(st, args):
    import torch
    from scipy.optimize import linprog
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    cs, bu, c, b, l, u = args
    eye = torch.eye(st.n)
    out = np.zeros(c.shape[0])
    for i in range(c.shape[0]):
        A = ipm_fused.mv(st, cs[i].expand(st.n, -1), bu[i].expand(st.n, -1),
                         eye).T
        f = lambda t: t.double().numpy()
        r = linprog(f(c[i]), A_eq=f(A), b_eq=f(b[i]),
                    bounds=list(zip(f(l[i]), f(u[i]))), method="highs")
        out[i] = r.fun if r.status == 0 else np.nan
    return out


def _inv_lower(D):
    import torch
    k = D.shape[-1]
    if k == 1:
        return 1.0 / D
    h = k // 2
    Ai, Bi = _inv_lower(D[:, :h, :h]), _inv_lower(D[:, h:, h:])
    mm = lambda a, b: sum(a[:, :, p:p + 1] * b[:, p:p + 1, :]
                          for p in range(a.shape[2]))
    off = -mm(Bi, mm(D[:, h:, :h], Ai))
    top = torch.cat([Ai, Ai.new_zeros(D.shape[0], h, k - h)], dim=2)
    return torch.cat([top, torch.cat([off, Bi], dim=2)], dim=1)


def _block_inverse_solve(L, r, q=8):
    """The reference kernel's solve_M: 8 x 8 diagonal-block inverses."""
    B, m = r.shape
    mp = -(-m // q) * q
    Lp = L.new_zeros(B, mp, mp)
    Lp[:, :m, :m] = L
    pad = list(range(m, mp))
    Lp[:, pad, pad] = 1.0
    dinv = [_inv_lower(Lp[:, i:i + q, i:i + q]) for i in range(0, mp, q)]
    y = r.new_zeros(B, mp)
    y[:, :m] = r
    for j, i in enumerate(range(0, mp, q)):
        v = y[:, i:i + q]
        if i:
            v = v - (Lp[:, i:i + q, :i] * y[:, None, :i]).sum(2)
        y[:, i:i + q] = (dinv[j] * v[:, None, :]).sum(2)
    for j, i in reversed(list(enumerate(range(0, mp, q)))):
        v = y[:, i:i + q]
        if i + q < mp:
            v = v - (Lp[:, i + q:, i:i + q] * y[:, i + q:, None]).sum(1)
        y[:, i:i + q] = (dinv[j] * v[:, :, None]).sum(1)
    return y[:, :m]


def _sweep_solve(L, r):
    """The port's K1 kernel's order: column sweeps, reciprocal pivots."""
    rec = 1.0 / L.diagonal(dim1=1, dim2=2)
    z = r.clone()
    m = r.shape[1]
    for k in range(m):
        z[:, k] = z[:, k] * rec[:, k]
        z[:, k + 1:] -= L[:, k + 1:, k] * z[:, k, None]
    for k in range(m - 1, -1, -1):
        z[:, k] = z[:, k] * rec[:, k]
        z[:, :k] -= L[:, k, :k] * z[:, k, None]
    return z


def _plain_variants(sys_, st, args):
    """Polished (objective, quality) of the plain K1 with each solve."""
    from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_structured import (
        polish_structured)
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    chol, solve = ipm_fused.cholesky_plain, ipm_fused.cho_solve_plain
    variants = {
        "plain": (chol, solve),
        "plain, block-inverse solve": (chol, _block_inverse_solve),
        "plain, K1's sweep solve": (chol, _sweep_solve),
        "plain, float64 factor and solve": (
            lambda M: chol(M.double()),
            lambda L, r: solve(L, r.double()).float()),
    }
    out = {}
    try:
        for name, (f, s) in variants.items():
            ipm_fused.cholesky_plain, ipm_fused.cho_solve_plain = f, s
            state = tuple(t.float() for t in
                          ipm_fused.fused_ipm_iterations_plain(st, *args))
            ipm_fused.cholesky_plain, ipm_fused.cho_solve_plain = chol, solve
            pol = polish_structured(st, state, *args)
            out[name] = (pol.objective.numpy(),
                         (pol.primal_residual
                          + 2 * st.n * pol.duality_gap).numpy())
    finally:
        ipm_fused.cholesky_plain, ipm_fused.cho_solve_plain = chol, solve
    return out


def _report(tag, results, opt):
    for name, (obj, q) in results.items():
        off = np.nonzero(np.abs(obj - opt) > GUARD)[0]
        print(f"[{tag}] {name}: past the guard {int((q > GUARD).sum())}, "
              f"> 5e-3 from HiGHS {len(off)} {off.tolist()}", flush=True)


def _cpu_lanes(sys_, seed, n=4096):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], HOURS)
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(HOURS),
                                   YEARS)
    downs, loads, got, block = [], [], 0, 0
    while got < n:
        flat = hl2_seq.sample_years(
            hl2_nsq.batch_generator(seed, block, "cpu"), sys_, YEARS, HOURS,
            k).transpose(1, 2).reshape(YEARS * HOURS, -1)
        cert = dcopf.certify_states(sys_, flat, load,
                                    repair_buffer=YEARS * HOURS // 16)
        idx = torch.nonzero((~cert.certified) | (cert.deficit > 0)).flatten()
        downs.append(flat[idx])
        loads.append(load[idx])
        got += idx.numel()
        block += 1
    return (torch.cat(downs)[:n].numpy(), torch.cat(loads)[:n].numpy())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dump")
    ap.add_argument("--seeds", default="11,12,13")
    ap.add_argument("--golden", action="store_true")
    a = ap.parse_args()
    import jax.numpy as jnp
    import torch
    from powersystemsreliabilityassessment_tpu.core import cases as rcases
    from powersystemsreliabilityassessment_tpu.core.system import (
        build_system as rbuild)
    from powersystemsreliabilityassessment_tpu.engines import (
        dcopf as rdc, lp_ipm_structured as rls)
    from powersystemsreliabilityassessment_tpu.ops import (
        batched_chol as rbc, ipm_fused as rf)
    from powersystemsreliabilityassessment_tpu.utils.config import (
        CompatFlags as RC, IPMConfig as RI)
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        from_reference)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, ipm_fused)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    torch.set_num_threads(8)
    rsys = rbuild(rcases.rts24())
    sys_ = from_reference(rsys, device="cpu")
    st = ipm_fused.build_structure(sys_)
    ref = (rdc, rls, rf, rsys, RC, RI)
    d = np.load(a.dump)
    down, load = d["down"], d["load"]
    args = _port_lp(sys_, down, load)
    opt = _highs(st, args)
    results = {"reference K1 (interpret)": _ref_state(ref, down, load),
               "K1 (card)": (d["kernel_obj"], d["kernel_q"]),
               "plain (card)": (d["plain_obj"], d["plain_q"]),
               **_plain_variants(sys_, st, args)}
    _report("card lanes", results, opt)

    # Fault A: where the plain K1 and the reference part, on the lanes
    # the plain version leaves off the optimum (padded to 128 lanes).
    plain_obj = results["plain"][0]
    hard = np.nonzero(np.abs(plain_obj - opt) > GUARD)[0][:16].tolist()
    sel = np.array(hard + [i for i in range(128 + len(hard))
                           if i not in hard][:128 - len(hard)])
    sub = tuple(t[sel] for t in args)
    bu = jnp.asarray(1.0 - down[sel, rsys.n_gen:], jnp.float32)
    rc_, rb, rl, ru, rcs = rdc.build_state_lp_vectors(
        rsys, jnp.asarray(1.0 - down[sel, :rsys.n_gen], jnp.float32), bu,
        jnp.asarray(load[sel]), RC(), 6.0)
    for k in range(1, 17):
        r_ = rf.fused_ipm_iterations(rf.build_structure(rsys), rcs, bu, rc_,
                                     rb, rl, ru, RI(iterations=k))
        g_ = ipm_fused.fused_ipm_iterations_plain(st, *sub,
                                                  IPMConfig(iterations=k))
        dx = np.abs(np.asarray(r_[0]) - g_[0].numpy()).max(1)
        print(f"[parting] iteration {k}: max |x_ref - x_plain| on the "
              f"{len(hard)} off lanes {dx[:len(hard)].max():.2e}, on the "
              f"others {dx[len(hard):].max():.2e}", flush=True)

    # Fault B: evaluate_states of the three, the hours only the reference
    # solves, and the LP lanes' EENS (MWh a year over the years drawn).
    r_dns, r_q, p_dns, p_q = [], [], [], []
    for s in range(0, len(down), 512):
        sl = slice(s, s + 512)
        r = rdc.evaluate_states(rsys, jnp.asarray(down[sl]),
                                jnp.asarray(load[sl]))
        r_dns.append(np.asarray(r.dns_mw))
        r_q.append(np.asarray(r.primal_residual))
        p = dcopf.evaluate_states(sys_, torch.as_tensor(down[sl]),
                                  torch.as_tensor(load[sl]))
        p_dns.append(p.dns_mw.numpy())
        p_q.append(p.primal_residual.numpy())
    cert, years = d["cert"], int(d["years"])
    evals = {"reference (CPU)": (np.concatenate(r_dns), np.concatenate(r_q)),
             "port plain (CPU)": (np.concatenate(p_dns), np.concatenate(p_q)),
             "port K1 (card)": (d["dns"], d["q"])}
    rdns, rq = evals["reference (CPU)"]
    rtrip = (rq > GUARD) & ~cert
    for name, (dns, q) in evals.items():
        trip = (q > GUARD) & ~cert
        only = np.nonzero(trip & ~rtrip)[0]
        states = len({tuple(x) for x in down[only].astype(int).tolist()})
        solved = dns.copy()
        solved[only] = rdns[only]
        print(f"[eens] {name}: past the guard {int(trip.sum())}; the "
              f"reference solves {len(only)} of them ({states} states); "
              f"LP-lane EENS {dns.sum() / years:.4f} MWh/yr as is, "
              f"{solved.sum() / years:.4f} with those solved ({years} "
              f"years)", flush=True)

    # Fault D: the synthetic-weight lanes, the reference's own factor.
    lanes = np.nonzero(d["awa_kp"] > 1e-4)[0]
    up = 1.0 - torch.as_tensor(down[lanes]).float()
    cs = args[0][lanes]
    w = torch.where(torch.as_tensor(d["wmask"][lanes]), 1e2, 1e-4)
    M = ipm_fused.normal_matrix(st, cs * cs / w, up[:, sys_.n_gen:]) \
        + torch.eye(st.m)
    s = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2))
    M = (M * s[:, :, None] * s[:, None, :] + 1e-7 * torch.eye(st.m)).numpy()
    n = len(lanes)
    padded = np.concatenate([M, np.tile(np.eye(st.m, dtype=np.float32),
                                        (128 - n % 128, 1, 1))])
    L_ref = np.asarray(rbc.from_batch_minor(rbc.cholesky_bm(
        rbc.to_batch_minor(jnp.asarray(padded)))))[:n]
    L_plain = bc.cholesky_plain(torch.as_tensor(M)).numpy()
    L64 = np.linalg.cholesky(M.astype(np.float64))
    lane = lambda t: np.abs(t).reshape(n, -1).max(1)
    rel = lambda t: lane(t - L64) / np.maximum(lane(L64), 1.0)
    print(f"[k2] {n} lanes with kernel - plain > 1e-4 on the card (max "
          f"{d['awa_kp'][lanes].max():.3e}), cond "
          f"{d['awa_cond'][lanes].min():.3e}-{d['awa_cond'][lanes].max():.3e}"
          f": kernel - f64 {d['awa_k64'][lanes].max():.3e}, plain (card) - "
          f"f64 {d['awa_p64'][lanes].max():.3e}, plain (CPU) - f64 "
          f"{rel(L_plain).max():.3e}, reference (CPU) - f64 "
          f"{rel(L_ref).max():.3e}; all 4,096 lanes: kernel - f64 > 1e-4 on "
          f"{int((d['awa_k64'] > 1e-4).sum())}, plain - f64 on "
          f"{int((d['awa_p64'] > 1e-4).sum())}", flush=True)

    if a.golden:
        hard = sorted(set(np.nonzero(np.abs(d["kernel_obj"] - d["plain_obj"])
                                     > 1e-3)[0].tolist())
                      | set(np.nonzero(np.abs(plain_obj - opt) > GUARD)[0]
                            .tolist()))
        golden = ROOT / "tests" / "golden"
        np.savez_compressed(golden / "seq_hard_lanes.npz", down=down[hard],
                            load=load[hard].astype(np.float32),
                            lane=np.array(hard, np.int32))
        np.savez_compressed(golden / "k2_synthetic_lanes.npz",
                            down=down[lanes],
                            load=load[lanes].astype(np.float32),
                            wmask=d["wmask"][lanes],
                            lane=lanes.astype(np.int32),
                            kernel_vs_plain=d["awa_kp"][lanes]
                            .astype(np.float32))
        print(f"[golden] {len(hard)} hard lanes, {n} K2a lanes", flush=True)

    # The same counts on lanes the port's SEQ sampler draws on the CPU.
    for seed in (int(x) for x in a.seeds.split(",") if x):
        down_c, load_c = _cpu_lanes(sys_, seed)
        args_c = _port_lp(sys_, down_c, load_c)
        opt_c = _highs(st, args_c)
        _report(f"CPU lanes, seed {seed}", {
            "reference K1 (interpret)": _ref_state(ref, down_c, load_c),
            **_plain_variants(sys_, st, args_c)}, opt_c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
