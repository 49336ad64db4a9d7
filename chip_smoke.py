#!/usr/bin/env python3
"""Smoke run of the PyTorch port's HL2 NSQ main path on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each (any failure raises, so the exit code is not 0):
  1. device   the card's name and power limit (nvidia-smi); no card, no run
  2. build    nvcc builds the kernels of csrc/ for sm_90a
  3. k2       K2 batched Cholesky / solve kernels vs their plain PyTorch
              versions on equilibrated normal matrices of real RTS-24 LP
              lanes at the polish shape [256, 62, 62], plus a lane that
              hits the pivot floor
  4. k1       K1 fused IPM kernel vs its plain version on 256 real LP
              lanes (states with a deficit or a failed certificate)
  5. bench    the bench-shaped step: batch 262144, proportional nodal
              mode, max_lp 256, the calibrated shed hint, 8 segments of
              16 steps with fresh generator seeds
  6. study    run_nsq_study(rts24(), MCSConfig(max_samples=106496)) held
              against results/nsq_results.json (EDNS and PLC within 4
              combined standard errors)
Then one JSON line of per-kernel results and, last, the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

``--phases`` runs a subset (e.g. ``--phases build,k2,k1``); the default
runs all of them. ``--phases profile`` runs only the opt-in breakdown of
the bench-shaped step: per-layer times, the device-busy share and the
kernels that take the most device time (torch.profiler).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "powersystemsreliabilityassessment_tpu_torch"
ALL_PHASES = ("build", "k2", "k1", "bench", "study")
# Not run by default: a per-layer and per-kernel breakdown of the
# bench-shaped step (for PERF.md), not part of the smoke contract.
EXTRA_PHASES = ("profile",)

# Bounds of the kernel-vs-plain checks. Both sides run the same
# algorithm in float32; they differ in summation order and in rsqrtf,
# so differences are rounding, amplified by each matrix's conditioning.
K2_L_BOUND = 1e-4       # max |L_kernel - L_plain| / max(1, |L|) per lane
K2_X_BOUND = 1e-3       # max |x_kernel - x_plain| / max(1, |x|) per lane
# Objectives after the polish: the tests' parity bound between two f32
# IPM paths (1e-3 p.u. = 0.1 MW, the reference's DNS noise floor).
K1_OBJ_BOUND = 1e-3
K1_SCORE_BOUND = 1e-3   # best_score = mu + max|rp|, absolute


def _line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _time_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _reset_counts():
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol, ipm_fused)
    for d in (batched_chol.launches, ipm_fused.launches):
        for k in d:
            d[k] = 0


def _counts() -> dict:
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol, ipm_fused)
    return {**ipm_fused.launches, **batched_chol.launches}


def _lp_lanes(sys_, n_lanes: int, seed: int):
    """LP inputs of ``n_lanes`` real RTS-24 lanes: sampled states whose
    tier-1 certificate fails or whose deficit is positive (the lanes the
    screened evaluator sends to the LP in "lp" nodal mode)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    gen = torch.Generator(device=sys_.device)
    gen.manual_seed(seed)
    down = sample_states(gen, sys_.unavail, sys_.always_up_nsq, 65536)
    load = sys_.load_pd[None, :].expand(down.shape[0], sys_.n_load)
    cert = dcopf.certify_states(sys_, down, load)
    need = (~cert.certified) | (cert.deficit > 0)
    idx = torch.nonzero(need).flatten()[:n_lanes]
    if idx.numel() < n_lanes:
        raise RuntimeError(f"only {idx.numel()} LP lanes sampled")
    down = down[idx]
    up = 1.0 - down.float()
    gen_up, br_up = up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous()
    c, b, l, u, colscale = dcopf.build_state_lp_vectors(
        sys_, gen_up, br_up, load[idx], CompatFlags(), IPMConfig().theta_max)
    return colscale, br_up, c, b, l, u


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    if not (ROOT / PKG).is_dir():
        raise SystemExit(f"chip_smoke: {PKG}/ not found beside this script")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _line("device", name=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return smi


def phase_build():
    from powersystemsreliabilityassessment_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    info = cuda_build.build_info
    for ln in info.get("ptxas", "").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("  ptxas: " + ln.strip())
    _line("build", seconds=f"{time.perf_counter() - t0:.2f}",
          nvcc_seconds=f"{info['seconds']:.2f}", library=info["library"])


def phase_k2(sys_, results):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, ipm_fused)
    colscale, br_up, c, b, l, u = _lp_lanes(sys_, 256, seed=5)
    st = ipm_fused.build_structure(sys_)
    m = st.m
    # The two matrices polish_box_lp factors: A A' and A W^-1 A' + I.
    w = torch.where(torch.rand(c.shape, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda") < 0.5, 1e2, 1e-4)
    mats = []
    for wt, add in ((torch.ones_like(c), 0.0), (1.0 / w, 1.0)):
        M = ipm_fused.normal_matrix(st, colscale * colscale * wt, br_up)
        M = M + add * torch.eye(m, device="cuda")
        s = torch.rsqrt(torch.clamp_min(
            torch.diagonal(M, dim1=1, dim2=2), 1e-30))
        mats.append(M * s[:, :, None] * s[:, None, :]
                    + 1e-7 * torch.eye(m, device="cuda"))
    M = torch.cat(mats)[:256].contiguous()
    # Lane 0 has lost positive definiteness: its second pivot is
    # 1 - 1.0005^2 < 0, which the pivot floor turns into L_11 = -1
    # (an unfloored rsqrt would give NaN).
    M[0] = torch.eye(m, device="cuda")
    M[0, 0, 1] = M[0, 1, 0] = 1.0005
    r = torch.randn((256, m), generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    Lk, Lp = bc.cholesky(M), bc.cholesky_plain(M)
    xk, xp = bc.cho_solve(Lp, r), bc.cho_solve_plain(Lp, r)
    torch.cuda.synchronize()
    floor_hit = bool(torch.isfinite(Lk[0]).all() and Lk[0, 1, 1] < 0)
    l_err = float(((Lk - Lp).abs().amax((1, 2))
                   / torch.clamp_min(Lp.abs().amax((1, 2)), 1.0)).max())
    x_err = float(((xk - xp).abs().amax(1)
                   / torch.clamp_min(xp.abs().amax(1), 1.0)).max())
    ms = {"chol": _time_ms(lambda: bc.cholesky(M)),
          "chol_plain": _time_ms(lambda: bc.cholesky_plain(M), reps=3),
          "solve": _time_ms(lambda: bc.cho_solve(Lp, r)),
          "solve_plain": _time_ms(lambda: bc.cho_solve_plain(Lp, r), reps=3)}
    _line("k2", shape=tuple(M.shape), pivot_floor_lane=floor_hit,
          chol_rel_err=f"{l_err:.3e}<={K2_L_BOUND}",
          solve_rel_err=f"{x_err:.3e}<={K2_X_BOUND}",
          **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()})
    if not floor_hit:
        raise RuntimeError("k2: the pivot-floor lane did not floor")
    if not (l_err <= K2_L_BOUND and x_err <= K2_X_BOUND):
        raise RuntimeError("k2: kernel disagrees with the plain version")
    # The bounds are relative to each lane's scale (solutions of these
    # ill-conditioned systems reach ~1e3), so both errors are reported.
    src = f"{PKG}/csrc/batched_chol.cu"
    results["cholesky"] = dict(
        name="cholesky", route="cuda", source=src,
        replaces="powersystemsreliabilityassessment_tpu/ops/batched_chol.py:143",
        max_abs_err=float((Lk - Lp).abs().max()), max_rel_err=l_err,
        tolerance=K2_L_BOUND, ms=ms["chol"], plain_ms=ms["chol_plain"])
    results["cho_solve"] = dict(
        name="cho_solve", route="cuda", source=src,
        replaces="powersystemsreliabilityassessment_tpu/ops/batched_chol.py:161",
        max_abs_err=float((xk - xp).abs().max()), max_rel_err=x_err,
        tolerance=K2_X_BOUND, ms=ms["solve"], plain_ms=ms["solve_plain"])


def phase_k1(sys_, results):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_structured import (
        polish_structured)
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    cfg = IPMConfig()
    args = _lp_lanes(sys_, 256, seed=7)
    st = ipm_fused.build_structure(sys_)
    ker = ipm_fused.fused_ipm_iterations(st, *args, cfg)
    pla = ipm_fused.fused_ipm_iterations_plain(st, *args, cfg)
    torch.cuda.synchronize()
    c = args[2]
    obj_k = polish_structured(st, ker, *args, cfg).objective
    obj_p = polish_structured(st, pla, *args, cfg).objective
    finite = all(bool(torch.isfinite(t).all()) for t in ker)
    obj_err = float((obj_k - obj_p).abs().max())
    score_err = float((ker[4] - pla[4]).abs().max())
    x_err = float((ker[5] - pla[5]).abs().max())
    ms = _time_ms(lambda: ipm_fused.fused_ipm_iterations(st, *args, cfg))
    plain_ms = _time_ms(
        lambda: ipm_fused.fused_ipm_iterations_plain(st, *args, cfg), reps=2)
    _line("k1", lanes=c.shape[0], finite=finite,
          objective_err_pu=f"{obj_err:.3e}<={K1_OBJ_BOUND}",
          best_score_err=f"{score_err:.3e}<={K1_SCORE_BOUND}",
          best_x_err=f"{x_err:.3e}", kernel_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}",
          shed_lanes=int((obj_p > 1e-3).sum()))
    if not (finite and obj_err <= K1_OBJ_BOUND
            and score_err <= K1_SCORE_BOUND):
        raise RuntimeError("k1: kernel disagrees with the plain version")
    # The checked quantities: polished objective (p.u.) and best_score.
    # best_x is reported in the k1 line but not bounded: on degenerate
    # optimal faces two float32 paths reach different optimal points.
    results["fused_ipm_iterations"] = dict(
        name="fused_ipm_iterations", route="cuda",
        source=f"{PKG}/csrc/ipm_fused.cu",
        replaces="powersystemsreliabilityassessment_tpu/ops/ipm_fused.py:459",
        max_abs_err=max(obj_err, score_err), tolerance=K1_OBJ_BOUND,
        ms=ms, plain_ms=plain_ms)


def phase_bench(sys_, results):
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    batch, max_lp = 262144, 256
    t0 = time.perf_counter()
    hint = dcopf.calibrate_shed_hint(sys_)
    hint_s = time.perf_counter() - t0
    step = hl2_nsq.make_nsq_batch_step(
        sys_, batch, CompatFlags(), IPMConfig(), max_lp=max_lp,
        nodal_mode="proportional", shed_hint=hint)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    m, n_over, _ = step(hl2_nsq.batch_generator(0, 10**6, "cuda"))
    n_over_warm = int(n_over)
    if not bool(torch.isfinite(m.sum_dns)):
        raise RuntimeError("bench: non-finite DNS sum")
    seg_iters, n_segments, it = 16, 8, 0
    rates = []
    for _ in range(n_segments):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # The step must never wait for the device: any synchronizing
        # call inside it raises here.
        torch.cuda.set_sync_debug_mode("error")
        for _ in range(seg_iters):
            out = step(hl2_nsq.batch_generator(0, it, "cuda"))
            it += 1
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rates.append(batch * seg_iters / (time.perf_counter() - t0))
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    edns = float(out[0].sum_dns) / batch
    _line("bench", hinted=hint is not None,
          hint_seconds=f"{hint_s:.2f}",
          scen_per_s_best=f"{max(rates):.1f}",
          scen_per_s_median=f"{statistics.median(rates):.1f}",
          segment_rates=[round(r, 1) for r in rates],
          overflow_warmup=n_over_warm, peak_mem_bytes=peak,
          last_batch_edns_mw=f"{edns:.4f}",
          launches=json.dumps(counts).replace(" ", ""))
    if min(counts.values()) <= 0:
        raise RuntimeError(f"bench: a kernel was never launched: {counts}")
    if not np.isfinite(edns):
        raise RuntimeError("bench: non-finite DNS")
    for name, n in counts.items():
        results.setdefault(name, {})["launches"] = n


def phase_study():
    import math
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        MCSConfig)
    ref = json.loads((ROOT / "results" / "nsq_results.json").read_text())
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = hl2_nsq.run_nsq_study(cases.rts24(), MCSConfig(max_samples=106496),
                                device="cuda", log_every=0)
    wall = time.perf_counter() - t0
    counts = _counts()
    se_e = math.hypot(ref["beta"] * ref["edns_mw"], res.beta * res.edns_mw)
    se_p = math.hypot(
        math.sqrt(ref["plc"] * (1 - ref["plc"]) / ref["samples"]),
        math.sqrt(res.plc * (1 - res.plc) / res.samples))
    z_e = abs(res.edns_mw - ref["edns_mw"]) / se_e
    z_p = abs(res.plc - ref["plc"]) / se_p
    _line("study", samples=res.samples, edns_mw=f"{res.edns_mw:.4f}",
          lole_hr_yr=f"{res.lole_hr_yr:.2f}", plc=f"{res.plc:.5f}",
          beta=f"{res.beta:.5f}", edns_z=f"{z_e:.2f}<=4",
          plc_z=f"{z_p:.2f}<=4", overflow=res.overflow_states,
          wall_s=f"{wall:.2f}",
          peak_mem_bytes=torch.cuda.max_memory_allocated(),
          launches=json.dumps(counts).replace(" ", ""))
    if min(counts.values()) <= 0:
        raise RuntimeError(f"study: a kernel was never launched: {counts}")
    if not (z_e <= 4 and z_p <= 4):
        raise RuntimeError("study: estimates outside 4 combined standard "
                           "errors of results/nsq_results.json")


def phase_profile(sys_):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    batch, max_lp = 262144, 256
    hint = dcopf.calibrate_shed_hint(sys_)
    rbuf = dcopf.default_repair_buffer(batch, hinted=hint is not None)
    step = hl2_nsq.make_nsq_batch_step(
        sys_, batch, CompatFlags(), IPMConfig(), max_lp=max_lp,
        nodal_mode="proportional", shed_hint=hint)
    seeds = iter(range(10**7))
    gen = lambda: hl2_nsq.batch_generator(1, next(seeds), "cuda")
    load = sys_.load_pd[None, :].expand(batch, sys_.n_load)
    hint_b = torch.as_tensor(hint, device="cuda")[None, :].expand(
        batch, sys_.n_load)

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))

    def measure(fn, reps=16):
        """(host wall ms, device kernel ms, kernel launches, kernel
        events) per call. Only kernel events are summed: a CPU op's
        self device time repeats the kernels it launched."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if "cuda" in str(getattr(e, "device_type", "")).lower()
                   and dev_us(e) > 0]
        dev = sum(dev_us(e) for e in kernels) / 1e3 / reps
        return wall, dev, sum(e.count for e in kernels) / reps, kernels

    down = sample_states(gen(), sys_.unavail, sys_.always_up_nsq, batch)
    pre = dcopf.certify_states(sys_, down, load, shed_hint=hint_b,
                               repair_buffer=rbuf)
    idx = dcopf._topk_lanes(~pre.certified, max_lp)
    layers = {
        "step": lambda: step(gen()),
        "sampling": lambda: sample_states(
            gen(), sys_.unavail, sys_.always_up_nsq, batch),
        "tier1": lambda: dcopf.certify_states(
            sys_, down, load, shed_hint=hint_b, repair_buffer=rbuf),
        "lp_tier": lambda: dcopf.evaluate_states(sys_, down[idx], load[idx]),
    }
    step_kernels = None
    for name, fn in layers.items():
        wall, dev, n, kernels = measure(fn)
        step_kernels = step_kernels or kernels
        _line("profile", layer=name, wall_ms=f"{wall:.3f}",
              device_ms=f"{dev:.3f}", device_busy_share=f"{dev / wall:.3f}",
              kernel_launches=f"{n:.0f}")
    for e in sorted(step_kernels, key=dev_us, reverse=True)[:12]:
        print(f"  step kernel {dev_us(e) / 1e3 / 16:8.3f} ms/step "
              f"{e.count / 16:6.0f}x  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of "
                    + ",".join(ALL_PHASES + EXTRA_PHASES))
    phases = ap.parse_args().phases.split(",")
    unknown = set(phases) - set(ALL_PHASES + EXTRA_PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    phase_device()
    sys.path.insert(0, str(ROOT))
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    results: dict = {}
    phase_build()
    sys_ = build_system(cases.rts24(), device="cuda")
    if "k2" in phases:
        phase_k2(sys_, results)
    if "k1" in phases:
        phase_k1(sys_, results)
    if "bench" in phases:
        phase_bench(sys_, results)
    if "study" in phases:
        phase_study()
    if "profile" in phases:
        phase_profile(sys_)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
