"""The case300s study's LP lanes past the evaluator's guard, port against
reference (ROADMAP.md Queue 3, fault E).

Two modes:

  python3 scripts/torch_case300_guard_lanes.py dump OUT.npz
      On the card: redraws the given batches of the case300s NSQ study
      (``chip_smoke.py`` study300: batch 16,384, seed 3, proportional
      nodal mode, tier 1.5 on) with the study's own generators, runs the
      screened evaluator on each, and saves the lanes it sends to the LP
      (the needy ones, in buffer order) with the card's DNS and quality
      score.

  JAX_PLATFORMS=cpu python3 scripts/torch_case300_guard_lanes.py compare IN.npz
      On the CPU: float64 HiGHS, the reference's ``evaluate_states`` and
      the port's on each batch's dumped lanes (padded with intact states
      to a multiple of PAD_LANES lanes); prints every lane past the
      guard or more than 1.5 MW off on either side, and per batch the
      lanes past the guard and the summed DNS of each.

``--batches`` (dump) picks the study batches: ``all`` (the default) is
every batch of the 262,144-sample study, 0-15, chosen by neither side's
outcome; a comma list picks some. ``--seed`` (dump) is the study's seed:
3 is ``chip_smoke.py`` study300's, 4 the replicate's in
results/case300_scaleup.json. ``--threads`` sets the port's intra-op
CPU threads (compare): these lanes' outcome moves with the summation
order, so the CPU counts move with it. compare ends with the totals
over every file it is given: the lanes past the guard on each side,
and the float64 HiGHS shed of those lanes, which the evaluator then
takes from the certificate's bound instead.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

BATCH = 16384
STUDY_SAMPLES = 262144
GUARD = 5e-3
ORACLE_TOL_MW = 1.5
# compare: the LP lanes of a batch (at most 25 in the study's 32
# batches at seeds 3 and 4) are padded with intact states to a multiple
# of this.
PAD_LANES = 32


def dump(out: str, batches, seed: int) -> None:
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    sys_ = build_system(cases.case300s(), device="cuda")
    # The study's step: no shed hint at case300s (too few repairable
    # lanes), the unhinted repair buffer, rank 4, tier 1.5 on.
    assert dcopf.calibrate_shed_hint(sys_) is None
    rbuf = dcopf.default_repair_buffer(BATCH)
    kpf = dcopf.default_pf_buffer(sys_, BATCH)
    max_lp = hl2_nsq.default_max_lp(BATCH, "proportional", pf_tier=True)
    load = sys_.load_pd[None].expand(BATCH, sys_.n_load)
    seen = {}
    orig_eval, orig_pf = dcopf.evaluate_states, dcopf.certify_island_pf

    def evaluate_states(s, d, l, *a, **k):
        r = orig_eval(s, d, l, *a, **k)
        seen["sub"] = (d.cpu().numpy(), r)
        return r

    def certify_island_pf(*a, **k):
        r = orig_pf(*a, **k)
        seen["pf"] = r.certified.cpu().numpy()
        return r

    dcopf.evaluate_states = evaluate_states
    dcopf.certify_island_pf = certify_island_pf
    out_arrays = {}
    for i in batches:
        down = sample_states(hl2_nsq.batch_generator(seed, i, "cuda"),
                             sys_.unavail, sys_.always_up_nsq, BATCH)
        n1 = int((~dcopf.certify_states(sys_, down, load, repair_buffer=rbuf,
                                        woodbury_k=4).certified).sum())
        res, over = dcopf.evaluate_states_screened(
            sys_, down, load, max_lp, nodal_mode="proportional",
            repair_buffer=rbuf, woodbury_k=4, pf_buffer=kpf)
        torch.cuda.synchronize()
        left = n1 - int(seen["pf"][:min(n1, kpf)].sum())
        d_sub, r = seen["sub"]
        q = r.primal_residual.cpu().numpy()
        out_arrays[f"b{i}_states"] = d_sub[:left]
        out_arrays[f"b{i}_dns"] = r.dns_mw.cpu().numpy()[:left]
        out_arrays[f"b{i}_q"] = q[:left]
        print(f"seed {seed} batch {i}: tier-1 misses {n1}, LP lanes {left}, "
              f"past the guard {int((q[:left] > GUARD).sum())} (buffer "
              f"{int((q > GUARD).sum())}), overflow {int(over)}", flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **out_arrays)


def _systems():
    from powersystemsreliabilityassessment_tpu.core import cases as rc
    from powersystemsreliabilityassessment_tpu.core.system import (
        build_system as rb)
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        from_reference)
    ref_sys = rb(rc.case300s())
    return ref_sys, from_reference(ref_sys, device="cpu")


def _highs(sys_, states):
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from scipy.optimize import linprog
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    ng, nd = sys_.n_gen, sys_.n_load
    up = torch.as_tensor(1.0 - states)
    load = sys_.load_pd[None].expand(len(states), nd)
    c, A, b, l, u = (t.double().numpy() for t in dcopf.build_state_lp(
        sys_, up[:, :ng], up[:, ng:].contiguous(), load, CompatFlags(),
        IPMConfig().theta_max))

    def dns(j):
        r = linprog(c[j], A_eq=A[j], b_eq=b[j], bounds=list(zip(l[j], u[j])),
                    method="highs")
        v = float(r.x[ng:ng + nd].sum()) * sys_.base_mva
        return 0.0 if v < CompatFlags().dns_noise_floor_mw else v

    with ThreadPoolExecutor(6) as pool:
        return np.asarray(list(pool.map(dns, range(len(states)))))


def _both(ref_sys, sys_, states):
    """(DNS, quality) of the reference's and the port's evaluate_states.
    Both take the lanes padded with intact states to a multiple of
    PAD_LANES, so the reference compiles one shape for every batch."""
    import jax.numpy as jnp
    import torch
    from powersystemsreliabilityassessment_tpu.engines import dcopf as rd
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    k = len(states)
    n = -(-k // PAD_LANES) * PAD_LANES
    states = np.concatenate([states, np.zeros((n - k, states.shape[1]),
                                              states.dtype)])
    ref = rd.evaluate_states(
        ref_sys, jnp.asarray(states),
        jnp.asarray(np.tile(np.asarray(ref_sys.load_pd)[None], (n, 1))),
        woodbury_k=4)
    got = dcopf.evaluate_states(sys_, torch.as_tensor(states),
                                sys_.load_pd[None].expand(n, sys_.n_load),
                                woodbury_k=4)
    return ((np.asarray(ref.dns_mw)[:k], np.asarray(ref.primal_residual)[:k]),
            (got.dns_mw.numpy()[:k], got.primal_residual.numpy()[:k]))


def compare(paths) -> None:
    ref_sys, sys_ = _systems()
    total = dict(oracle=0.0, card=0.0, reference=0.0, port_cpu=0.0)
    sides = ("card", "reference", "port_cpu")
    past = dict.fromkeys(sides, 0)
    lost = dict.fromkeys(sides, 0.0)
    n_lanes = 0
    batches = []
    for path in paths:
        z = np.load(path)
        for key in sorted((k[:-len("_states")] for k in z.files
                           if k.endswith("_states")),
                          key=lambda k: int(k[1:])):
            batches.append((f"{os.path.basename(path)}:{key}", z, key))
    for bi, z, key in batches:
        states = z[f"{key}_states"].astype(np.float32)
        card, q = z[f"{key}_dns"], z[f"{key}_q"]
        oracle = _highs(sys_, states)
        (rdns, rq), (cdns, cq) = _both(ref_sys, sys_, states)
        for j in np.nonzero((q > GUARD) | (rq > GUARD) | (cq > GUARD)
                            | (np.abs(card - oracle) > ORACLE_TOL_MW)
                            | (np.abs(rdns - oracle) > ORACLE_TOL_MW))[0]:
            print(f"  {bi} lane {j}: HiGHS {oracle[j]:.3f} | card "
                  f"{card[j]:.3f} q {q[j]:.2e} | reference {rdns[j]:.3f} q "
                  f"{rq[j]:.2e} | port on the CPU {cdns[j]:.3f} q "
                  f"{cq[j]:.2e}")
        print(f"{bi}: {len(states)} LP lanes; past the guard: card "
              f"{int((q > GUARD).sum())}, reference {int((rq > GUARD).sum())}"
              f", port on the CPU {int((cq > GUARD).sum())}; DNS sums (MW) "
              f"HiGHS {oracle.sum():.2f} card {card.sum():.2f} reference "
              f"{rdns.sum():.2f} port on the CPU {cdns.sum():.2f}",
              flush=True)
        for name, v in (("oracle", oracle), ("card", card),
                        ("reference", rdns), ("port_cpu", cdns)):
            total[name] += float(v.sum())
        n_lanes += len(states)
        for name, score in (("card", q), ("reference", rq),
                            ("port_cpu", cq)):
            past[name] += int((score > GUARD).sum())
            lost[name] += float(oracle[score > GUARD].sum())
    print("totals (MW):", {k: round(v, 1) for k, v in total.items()})
    print(f"over {n_lanes} LP lanes: past the guard {past}; float64 HiGHS "
          f"shed of those lanes (MW) "
          f"{ {k: round(v, 3) for k, v in lost.items()} }")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("dump", "compare"))
    ap.add_argument("path", nargs="+",
                    help="the .npz file dump writes, or those compare reads")
    ap.add_argument("--batches", default="all")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args()
    if args.mode != "dump":
        import torch
        if args.threads:
            torch.set_num_threads(args.threads)
        print(f"port on the CPU: {torch.get_num_threads()} threads")
    if args.mode == "dump":
        batches = (range(STUDY_SAMPLES // BATCH) if args.batches == "all"
                   else [int(b) for b in args.batches.split(",")])
        dump(args.path[0], batches, args.seed)
    else:
        compare(args.path)


if __name__ == "__main__":
    main()
