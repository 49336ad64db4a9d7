#!/usr/bin/env python3
"""Smoke run of the PyTorch port's HL2 NSQ and SEQ paths, its HL1 and
planning studies, the multi-area HL1.5 engine, the multilevel-splitting
SEQ study, the command line and the scenario mesh on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each (any failure raises, so the exit code is not 0):
  1. device   the card's name and power limit (nvidia-smi); no card, no run
  2. build    nvcc builds the kernels of csrc/ for sm_90a
  3. k2       K2 batched Cholesky / solve kernels vs their plain PyTorch
              versions at the four path shapes: the RTS-24 polish's
              equilibrated normal matrices of real LP lanes [256, 62, 62]
              (plus a lane that hits the pivot floor) and their solve
              [256, 62], and RTS-96's diagonal panels [2048, 56, 56] and
              [2048, 23, 23], and the multi-area curtailment LP's
              normal matrices at m = 2 (the two-area demo, [70080, 2, 2])
              and m = 3 (RTS-96's three areas, [69888, 3, 3]) with their
              solves; per shape the kernel's device time (CUDA graph),
              wrapper, plain and library times, bound and bound share,
              K2a's launch shape and the inputs' asymmetry
  4. k1       K1 fused IPM kernel vs its plain version on 256 and on
              2,048 real LP lanes (states with a deficit or a failed
              certificate): errors, times, launch shape, bound; then the
              warm rescue's launch from a start point (16 lanes, its own
              inputs for the hard lanes of tests/golden/
              seq_hard_lanes.npz; guarded as in seq); and K1 with no
              start point on fixed lanes at 16, 256 and 2,048 giving
              the bits tests/golden/k1_null_start_digests.json records
              for the kernel before it took a start point, and the same
              bits as K1 started at the box midpoint
  4b. faulta fault A: the hard lanes through the LP tier
              (solve_box_lp_structured: K1, polish, warm rescue) against
              float64 HiGHS with the rescue off and on: lanes more than
              5e-3 p.u. off, lanes past the guard, off lanes not flagged
              (must be 0), the largest errors; the seed-8 maintenance
              hour of tests/test_torch_seq.py through evaluate_states
  5. bench    the bench-shaped step: batch 262144, proportional nodal
              mode, max_lp 256, the calibrated shed hint, 8 segments of
              16 steps with fresh generator seeds
  6. study    run_nsq_study(rts24(), MCSConfig(max_samples=106496)) held
              against results/nsq_results.json (EDNS and PLC within 4
              combined standard errors)
  7. k3       K3 triangular-solve kernels vs their plain versions on
              equilibrated normal matrices of 256 real RTS-96 LP lanes
              [256, 191, 191] (a fourth-iteration barrier weight and the
              polish's A A'): forward at K = 56, 23 and 1, backward at
              K = 1, and the blocked Cholesky route on the kernels vs the
              same route on the plain versions; at ragged edges (batch 1
              and 2,047, P 1-64, K 1-65, NaN above the diagonal); times
              at 2048 lanes per path shape, warm and with a cold L2,
              beside solve_triangular's and the bound
  8. study96  run_nsq_study(rts96(), MCSConfig(max_samples=40960)) held
              against results/study_sweep.json["rts96"] (EDNS and LOLE
              within 4 combined standard errors), with the K2/K3 launch
              counts and the probe's rescued share of factored lanes
  9. k6       K6 Philox Bernoulli sampler bit-equal to its plain version
              at [262144, 71] for two seed pairs; per-component failure
              rates of 2^22 draws within 5 sigma, pinned never failing;
              the rng_impl="hw" sampling path must launch K6 and give
              the plain version's bits for its own key; its time through
              the wrapper and on the device (CUDA graph), bound and share
 10. k4       K4 fused sampler + first-pass certificate at 262144 lanes
              (the fused bench step) and at 8192 (the fused study's
              batch), each with its launch shape and times, with the
              calibrated hint: states bit-equal to K6's and to
              the plain version's, deficit and shed within 1e-5, first-
              pass mask within 0.1% of the plain version's and inside
              certify_states' certified set; certify_finish with a
              buffer holding every needy lane equal to certify_states on
              >= 99.99% of lanes; the guard band's routed share; the
              same mask checks at the reference's wider band 2^-14,
              which must route > 1% of lanes
 11. k5       K5 whole-certificate kernel vs certify_states(woodbury_k=2)
              on a 262144-lane RTS-24 batch, the stressed batch of
              tests/test_torch_gpu.py and 8192 RTS-96 lanes at 10x
              unavailability, each with its launch shape and the lanes
              the kernel queues for repair; times through the wrapper and
              on the device (CUDA graph), bounds and bound shares; the
              certify_states_fused path must launch K5
 12. studyfused  run_nsq_study(rts24(), MCSConfig(max_samples=106496,
              fused_tier1=True)) held against results/nsq_results.json as
              in 6; K4 launches once per batch, K1 and K2 as before
 13. seq      run_seq_study(rts24(), MCSConfig(seed=1)) to its CoV stop (16
              years x 8,736 hours a step, max_lp 256 a year) held against
              results/seq_results.json (EENS, LOLE and LOLF within 4
              combined standard errors; the JSON keeps no per-year DLC or
              NLC, so their reference standard error is the port's), K1,
              K2a and K2b launched on every step; K1 at 4,096 real SEQ LP
              lanes and K2a / K2b at [4096, 62, 62] (the polish's own
              matrices of those lanes) / [4096, 62] against
              their plain versions, with launch shapes, CUDA-graph,
              wrapper, plain and library times and bounds; the SEQ step's
              wall and device ms, hour-states a second and device busy
              share under the sync check at 16 and at 64 years a step
 14. lp300    the large-m LP path on case300s (m = 792): evaluate_states
              on scripts/parity_case300.py's 128 stress lanes (block-Schur
              bulk pass on K2a and K3, dense rescue ladder), guard-tripped
              lanes (must be 0), every shed lane and 64 zero-shed lanes
              against float64 HiGHS on the host (within 1.5 MW), quality
              median and max, wall and device ms and launches of the call;
              the same call at 2,048 lanes (the 128 tiled 16 times): wall
              ms, guard-tripped and shed lanes and the lanes more than 1.5
              MW from the 128-lane call's DNS, printed, not checked; K2a
              at the Schur inverses' panels [B, 56, 56] / [B, 20, 20] and
              K3 on identity right-hand sides at (56, 56) / (20, 20)
              against their plain versions at B = 128 and 2,048, with
              times, library calls and bounds; the seconds of each step
 15. pf300    tier 1.5 on the card: certify_states(woodbury_k=4) on
              16,384 plain-MC case300s states from the port's sampler
              (seed 300), the misses compacted into default_pf_buffer's
              256 lanes and certify_island_pf on them under the sync
              check; every certified lane within 0.05 MW of float64
              HiGHS and the island bound at most 0.05 MW above it on
              every valid lane; the same certified mask and the bound
              within 1e-4 p.u. as the port on CPU tensors; the miss and
              certified shares, the call's wall and device ms, launches,
              peak memory, bound and bound share
 16. study300 run_nsq_study(case300s(), MCSConfig(batch_size=16384,
              max_samples=262144, beta_limit=0, seed=3,
              nodal_mode="proportional")) through the screened evaluator
              with tier 1.5, held against results/case300_scaleup.json
              (EDNS and LOLE within 4 combined standard errors; z against
              the seed-4 replicate printed), overflow 0, K2a and K3
              launched on every batch with LP work, at most 8 LP lanes
              past the guard over the study (7 measured, fault E); per
              screened call the tier-1 misses, the lanes tier 1.5 leaves,
              the LP lanes, the lanes past the guard and the lanes over
              escalate_tol that enter the rescue ladder (beside
              restart_compact); wall and
              samples/s; the wall and peak memory of study batches 1
              and 0 alone at max_lp 128, and batch 0's host syncs, device
              ms and launches; evaluate_states' wall and peak memory at
              the 2,048-lane cap
 17. anti     run_nsq_study(rts24(), MCSConfig(batch_size=2048,
              max_samples=40960, beta_limit=0, antithetic=True)) held
              against results/study_sweep.json["antithetic"]
 18. is24     run_nsq_study(rts24(), MCSConfig(batch_size=8192,
              max_samples=16384, beta_limit=0, seed=3, is_boost=2.0))
              held against results/enum_hybrid.json["study_ab"]["boost2"];
              then one step of it under set_sync_debug_mode("error"): wall
              and device ms, launches, busy share and LP lanes
 19. mix300   make_nsq_batch_step(mix=(gen_area_masks(case300s()), 2.0,
              0.5)), proportional mode, batch 8,192, seed 7, for ~90 s,
              held against results/mixture_ab.json["arms"]["mix_b2"];
              the largest weight within 1 / alpha0
 20. ce300    run_nsq_study(case300s(), MCSConfig(is_ce=True,
              batch_size=8192, max_samples=262144, seed=7,
              nodal_mode="proportional"), max_lp=256): the CE pilot
              (32,768 samples, 2 rounds, seed 7 + 90210; its rounds
              beside results/ce_sparse.json's) and sparsify_ce_proposal
              (8, 0.05) inside it, held against its sparse_k8_c05 arm
              Phases 17-20 print the estimate, its standard error, the
              record's and the z-score against the two combined (fail
              above 4 or on any overflow), samples/s, wall time and the
              card's name and power limit.
 21. enum24   sampling.enumeration.enumerate_exact(rts24, order=5) at a
              chunk of 65,536 against results/enum_hybrid.json
              ["exact_order5"] (13,077,135 states exactly, mass within
              1e-9, exact EDNS within 0.1%, PLC within 0.5%): wall,
              states/s and K1 launches; on 65,536 real order-5 LP
              lanes (the pass's grown buffer) K1 against its plain
              version (guarded as in seq; on kept lanes best scores
              within 2.5e-3, objectives too or else within the guard of
              the float64 optimum; K1's lanes off it flagged), K2a against
              the float64 factor (per lane within max(1e-4, twice the
              plain version's error)), K2b against its plain version,
              with times and bounds; then
              run_nsq_study(rts24,
              batch 8,192, 16,384 samples, seed 3, enum_order=4) against
              ["study_ab"]["enum4"] (974,121 states, mass within 1e-6,
              exact part within 0.1%, EDNS within 4 combined standard
              errors)
 22. cv24     run_nsq_study(rts24) at 106,496 samples, plain and
              control_variate=True, at seed 0: the copper means equal
              14.693678 MW and 0.0845781 to 1e-6, beta_cv below half the
              plain beta, EDNS_cv within 4 combined standard errors of
              results/nsq_results.json; the control-variate step under
              set_sync_debug_mode("error")
 23. cvseq    run_seq_study(rts24, 512 years, load_scale 0.8, seed 7),
              stationary plain and control_variate=True, each arm's EENS
              within 4 combined standard errors of its arm of
              results/cv_rare_event.json; the same two arms at seeds
              8-14, and the per-year variance ratio of plain over CV
              over the 4,096 years of seeds 7-14 at least 10 (one arm's
              ratio is printed per seed; seed 7's alone, 6.72 on an
              NVIDIA H100, misses 10: PERF.md §6)
 24. seqib    run_seq_study(rts24, CompatFlags(island_blackout=True),
              seed 0) to CoV 0.05 against results/seq_compat_parity.json
              ["island_blackout"] (EENS within 4 combined standard errors;
              the CoV at most 0.05 at the last batch or the one before,
              the batch then in flight; LOLE, LOLF z and the years
              printed); one blackout SEQ step
              under set_sync_debug_mode("error")
 25. hl1      hl1_rts24.run() at 20,000 samples and 2,000 years against
              results/study_sweep.json["hl1_rts24"] (analytical within
              1e-4; each Monte Carlo pair within 4 combined standard
              errors, taken from the port's own batch means), then a
              2,000,000-sample NSQ Monte Carlo against the analytical
              value (within 4 of its standard error), and the float32
              COPT on the card against the float64 host table
 26. plan     run_planning_analytical at 600 and 50 hydro hours (LOLE
              within 1e-3 of results/study_sweep.json's "elu_600h" /
              "tail_risk_50h" analytical values), run_elu_comparison
              (1,000 years, seed 3) and run_tail_risk_study (2,000 years,
              seed 4), each Monte Carlo LOLE within 4 combined standard
              errors of its record (the record's taken equal to the
              port's per-year one), VaR / CVaR printed; the ELU hour loop
              at 2,000 years: its wall under set_sync_debug_mode
              ("error"), and its device ms and launches on a tenth of
              the year (876 hours); the four educational
              studies on the card, and the Markov chain's down share
              against its stationary value
 27. seqmaint run_seq_study(rts24, MCSConfig(max_years=512, seed=11),
              years_per_device=8, max_lp=1024, scheduled_maintenance=
              True) against study_sweep.json["seq_with_maintenance"]
              (EENS, LOLE, LOLF within 4 combined standard errors, the
              record's taken equal to the port's; no overflow left; the
              redo count printed); K1 at the step's own 8,192-lane buffer
              (guarded as in seq) and K2a / K2b at its polish shape
              against their plain versions
 28. multi    multiarea_demo.run_demo(n_years=200, seed=5) against
              study_sweep.json["multiarea"] (each area's LOLE and EUE,
              both policies, within 4 combined standard errors from the
              per-batch partials); interconnected EUE at most isolated
              in every area of the demo, run_rts96_hl15 and a 4-area
              ring (50 years each); the interconnected step's wall and
              device ms, launches and K2 launches, under the sync check;
              the loss hours whose curtailment is float32 noise
 29. split    run_seq_split_study(rts24) at the CLI's defaults (level
              auto: entry 0.10, 256-year pilot; K 4, max_split 8, 16 years
              a step, max_lp 256, 8,736-hour years) for 512 years, its
              EENS, LOLE and LOLF within 4 combined standard errors of the
              same study never splitting (level -1e9, another seed) and of
              results/seq_results.json (its LOLE / LOLF standard errors
              the port's); K = 1 at -100 MW and 1.2x load equal to the
              never-split run on one seed (EENS to 1e-6, LOLE and LOLF
              exactly); the step at the calibrated level under the sync
              check: wall and device ms, launches, K1 lanes, entered and
              split-overflow parents; K1 on the step's 6,144-lane clone
              buffer (guarded as in seq) and K2a / K2b at its polish
              shape against their plain versions, with times and bounds
 30. cli      the command line on the card: rts24 / rts96 written by
              save_matpower_case and loaded back field for field;
              main([...]) in this process for nsq at 65,536 samples on
              rts24 and on rts24.m (the same JSON line), seq --split-level
              auto --years 32, scaleup --case rts96, multiarea --system
              case on rts96.m, and bench (exit 2), each with its wall,
              peak CUDA memory and launches; the figure line on stderr
              exactly when matplotlib is absent; one python -m
              multiarea --system demo in a subprocess
 31. seq300   the case300s SEQ year block and study: the stress block of
              tests/golden/seq_stress_case300s.npz (rebuilt with numpy
              from its recipe) through evaluate_years against the
              reference's golden output (per-year ENS, DLC, NLC, nodal
              ENS, component counts; hours the two part on judged by
              float64 HiGHS; the LP queue and n_over, and n_over at least
              8 times larger without tier 1.5); then run_seq_study(
              case300s, two years a step, the study's defaults) for 64
              years against results/case300_seq_results.json (EENS, LOLE,
              LOLF within 4 combined standard errors, overflow and
              infeasible hours 0, K2a and K3 launched on every batch, LP
              lanes past the guard at most 5% of the LP lanes), a line
              per batch (tier-1 misses and LP queue, tier 1.5's certified
              share, LP lanes, lanes past the guard, launches), redos,
              promotions and the buffer it ended at; one step alone:
              wall, device ms, launches, host reads, peak memory
 32. seq96    the same block check on tests/golden/seq_stress_rts96.npz;
              run_seq_study(rts96, 16 years a step, seed 5) for 1,024
              years: every year's ENS at least its copper-sheet ENS less
              0.15 MW a deficit hour, RTS96_KERNELS launched on every
              step, overflow 0; the first block's kept LP lanes (up to
              256) within 0.15 MW of float64 HiGHS; one step alone
 33. mesh     the scenario mesh (parallel/mesh.py): one NCCL rank in
              this process (a world of one) runs the bench-shaped step
              on the mesh bit-equal to the one-device step on 8 seeds
              under the sync check, with the all_reduce's time a call and
              both steps' wall, device ms and launches, and the
              106,496-sample RTS-24 study bit-equal to the one-device
              study; two gloo ranks sharing the card, each launch the CLI
              under torchrun: that study (EDNS and PLC within 4 combined
              standard errors of results/nsq_results.json), the seq
              phase's study (8 years a rank a step, EENS within 4 of
              results/seq_results.json), one 16-year multi-area block and
              one 4,096-state case300s batch side by side; NCCL across
              cards on min(count, 4) ranks where there are two or more,
              else a line saying it was not run
Extra (not run by default): seq300full, seq300's study over all 256
years of its record, held the same way.
The bench phase also times the fused step (fused_tier1) at its shape,
under the same sync check, and prints it on a line of its own. seq,
seqmaint, split and enum24 print their LP lanes past the evaluator's
guard over the study, before and after the warm rescue
(lp_lanes_past_guard=before->after), and each guarded K1 line the
lanes the LP path on the same buffer leaves past it
(guard_failed_path).
Then one JSON line of per-kernel results and, last, the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

``--phases`` runs a subset (e.g. ``--phases build,k2,k1``); the default
runs all of them. ``--phases profile`` runs only the opt-in breakdown of
the RTS-24 bench-shaped step and of the RTS-96 study step: per-layer
times, the device-busy share, the kernels that take the most device
time (torch.profiler) and K1's, K2's (``layer=step_k2``), K3's and K4's
device time and launches per step; ``--phases profileseq`` the same for
the SEQ step (16 years a step). Both also run each step and its LP
tier with the warm rescue off and on (off, on, on, off in one process):
wall ms, device ms, launches, and the rescue's own cost per call.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "powersystemsreliabilityassessment_tpu_torch"
ALL_PHASES = ("build", "k2", "k1", "faulta", "bench", "study", "k3", "study96", "k6",
              "k4", "k5", "studyfused", "seq", "lp300", "pf300", "study300",
              "anti", "is24", "mix300", "ce300", "enum24", "cv24", "cvseq",
              "seqib", "hl1", "plan", "seqmaint", "multi", "split", "cli",
              "seq300", "seq96", "mesh")
# Not run by default: a per-layer and per-kernel breakdown of the
# bench-shaped step and of the RTS-96 step (for PERF.md), and the whole
# 256-year case300s SEQ record (seq300full); not part of the smoke
# contract.
EXTRA_PHASES = ("profile", "profileseq", "seq300full")
# The kernels each main path must launch.
RTS24_KERNELS = ("fused_ipm_iterations", "cholesky", "cho_solve")
RTS96_KERNELS = ("cholesky", "trsm_fwd", "trsm_bwd")
FUSED_KERNELS = ("sample_certify_quick", "fused_ipm_iterations", "cholesky",
                 "cho_solve")

# Published peaks of one H100 SXM (NVIDIA's H100 datasheet):
# float32 outside the tensor cores, and HBM3 bandwidth. A kernel's bound
# is the larger of its operations and its bytes (each input read once,
# each output written once) over these.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Bounds of the kernel-vs-plain checks. Both sides run the same
# algorithm in float32; they differ in summation order and in rsqrtf,
# so differences are rounding, amplified by each matrix's conditioning.
K2_L_BOUND = 1e-4       # max |L_kernel - L_plain| / max(1, |L|) per lane
K2_X_BOUND = 1e-3       # max |x_kernel - x_plain| / max(1, |x|) per lane
# Objectives after the polish: the tests' parity bound between two f32
# IPM paths (1e-3 p.u. = 0.1 MW, the reference's DNS noise floor).
K1_OBJ_BOUND = 1e-3
K1_SCORE_BOUND = 1e-3   # best_score = mu + max|rp|, absolute
# Deep multi-branch lanes (the enumeration's order-5 states, up to 5
# branches out): K1 and its plain version run the same Mehrotra steps in
# another float32 summation order, and on ill-conditioned normal
# matrices the two part further (ROADMAP.md Queue 3 A). Where both pass
# the guard, best scores are held to 2.5e-3 (1.95e-3 measured on 65,536
# such lanes, NVIDIA H100, PERF.md §6), and objectives too, but a lane
# past it is judged by the float64 optimum instead of by the plain
# version: there both float32 ends measured up to 4.3e-3 (K1) and
# 3.6e-3 (plain) off it, each the closer on half the lanes. Every lane
# K1 leaves more than the guard off the optimum must be flagged by the
# guard (the evaluator then takes the certificate's bound), so a kept
# lane judged so must be within the guard of it.
K1_DEEP_BOUND = 2.5e-3
# The screened evaluator keeps an LP lane's answer only where its quality
# (primal residual + 2 n duality gap) is within this (engines/dcopf.py
# _finalize); elsewhere it takes the certificate's bound. Of 4,096 SEQ LP
# lanes ~5% fail it on both paths, and on ~0.6% the two float32 IPMs'
# objectives then differ by up to 0.12 p.u. (NVIDIA H100, PERF.md §6):
# the float64 optimum judges those lanes.
LP_QUALITY_GUARD = 5e-3
# K3: max |X_kernel - X_plain| / max(1, |X|) per lane. The same
# substitution in another summation order: each element's rounding is
# ~P eps cond(L_panel), and a lifted panel of an equilibrated matrix has
# cond(L) <= ~1/sqrt(LIFT) ~ 316, so 56 * 6e-8 * 316 ~ 1e-3.
K3_BOUND = 1e-3
# Blocked route, kernels vs plain versions: per lane
# max |x_kernel - x_plain| / max(1, |x|) against max(1e-3, 4 cond(M) eps).
# Each refined f32 solve of these matrices (cond up to ~3e6) lands within
# ~cond(M) eps of the exact solution (measured against float64 solves),
# so two of them differ by at most ~2 cond(M) eps; 1e-3 is K2's solve
# bound for well-conditioned lanes.
BLOCKED_X_FLOOR = 1e-3
BLOCKED_X_COND = 4.0
EPS_F32 = 2.0 ** -24
L2_BYTES = 50e6         # the H100's L2 cache
# Lanes whose probe decision is borderline (max|x - 1| within rounding of
# PROBE_BAD_REL) can take the rescue on one route and not on the other;
# at most this share of lanes may differ in the rescue count or exceed
# the blocked bound.
RESCUE_DIFF_BOUND = 0.01
# K4 and K5 against their plain versions: deficits and shed / dispatch
# are float32 sums of <= 33 terms of up to ~34 p.u. (RTS-24) in another
# order, a few ulps; RTS-96's ~90 p.u. capacity sums get the reference's
# own tolerance (tests/test_certify_kernel.py:112, rtol = atol = 1e-4).
CERT_DEF_BOUND = 1e-5       # absolute, p.u.
CERT_DEF_BOUND_96 = 1e-4    # absolute and relative
CERT_PATTERN_BOUND = 1e-4   # K5 shed / dispatch on lanes both certify
QUICK_PATTERN_BOUND = 1e-5  # K4 shed candidate
# Lanes whose certificate flips between two float32 summation orders:
# flow checks bind at exactly zero margin on deficit optima.
CERT_AGREE = 0.9999         # K5 masks, and K4 + finish vs certify_states
QUICK_AGREE = 0.999         # K4 first-pass mask vs its plain version
K6_MAX_Z = 5.0
# The reference's band constant (its TPU dots): wider than the port's
# guard_eps, it routes lanes to the finish, so the band's arithmetic is
# held to its plain version there too, with a floor on the routed share.
K4_WIDE_EPS = 2.0 ** -14
K4_WIDE_MIN_ROUTED = 0.01
# The card's name and power limit (nvidia-smi), set by the device phase.
CARD = {"smi": None}


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


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for ``flops`` float32
    operations moving ``nbytes`` bytes, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes")


# The least bytes each function must move: a symmetric M and a triangular
# L carry only their lower triangles, n (n + 1) / 2 floats.
def _tri(n):
    return n * (n + 1) // 2


def _chol_work(B, m):
    return B * m ** 3 / 3, 4 * B * 2 * _tri(m)             # M in, L out


def _solve_work(B, m):
    return B * 2 * m * m, 4 * B * (_tri(m) + 2 * m)        # L, r in; x out


def _trsm_work(B, P, K):
    return B * P * P * K, 4 * B * (_tri(P) + 2 * P * K)    # L, B in; X out


def _launch_dicts():
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol, blocked_chol, certify_kernel, fused_sampler_cert,
        hw_sampler, ipm_fused)
    return (ipm_fused.launches, batched_chol.launches, blocked_chol.launches,
            hw_sampler.launches, fused_sampler_cert.launches,
            certify_kernel.launches)


def _reset_counts():
    from powersystemsreliabilityassessment_tpu_torch.ops import blocked_chol
    for d in (*_launch_dicts(), blocked_chol.rescues):
        for k in d:
            d[k] = 0


def _counts() -> dict:
    return {k: v for d in _launch_dicts() for k, v in d.items()}


def _check_launched(phase: str, counts: dict, names) -> None:
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise RuntimeError(f"{phase}: kernels never launched: {missing}")


def _lp_states(sys_, n_lanes: int, seed: int):
    """(comp_down, load) of ``n_lanes`` real lanes of ``sys_``: sampled
    states whose tier-1 certificate fails or whose deficit is positive
    (the lanes the screened evaluator sends to the LP in "lp" nodal
    mode)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    gen = torch.Generator(device=sys_.device)
    gen.manual_seed(seed)
    down = sample_states(gen, sys_.unavail, sys_.always_up_nsq, 65536)
    load = sys_.load_pd[None, :].expand(down.shape[0], sys_.n_load)
    cert = dcopf.certify_states(sys_, down, load)
    need = (~cert.certified) | (cert.deficit > 0)
    idx = torch.nonzero(need).flatten()[:n_lanes]
    if idx.numel() < n_lanes:
        raise RuntimeError(f"only {idx.numel()} LP lanes sampled")
    return down[idx], load[idx]


def _lp_lanes(sys_, n_lanes: int, seed: int):
    """Structured LP inputs (colscale, br_up, c, b, l, u) of
    :func:`_lp_states` lanes (the K1 route, m <= 72)."""
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    down, load = _lp_states(sys_, n_lanes, seed)
    up = 1.0 - down.float()
    gen_up, br_up = up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous()
    c, b, l, u, colscale = dcopf.build_state_lp_vectors(
        sys_, gen_up, br_up, load, CompatFlags(), IPMConfig().theta_max)
    return colscale, br_up, c, b, l, u


def _dense_lp(sys_, n_lanes: int, seed: int):
    """Materialized-A LP inputs (c, A, b, l, u) of :func:`_lp_states`
    lanes (the blocked route, 72 < m <= 336)."""
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    down, load = _lp_states(sys_, n_lanes, seed)
    up = 1.0 - down.float()
    return dcopf.build_state_lp(
        sys_, up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous(), load,
        CompatFlags(), IPMConfig().theta_max)


@contextlib.contextmanager
def _capturing_blocked_factor(store: list):
    """While active, every matrix the CUDA blocked route factors is
    appended to ``store`` (a copy) before it is factored."""
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb)
    orig = lpb._BLOCKED_KERNELS

    def factor(M):
        store.append(M.clone())
        return orig.factor(M)

    lpb._BLOCKED_KERNELS = orig._replace(factor=factor)
    try:
        yield
    finally:
        lpb._BLOCKED_KERNELS = orig


@contextlib.contextmanager
def _capturing_panels(store: list, keep: int | None = None):
    """While active, every diagonal panel the blocked factor hands to K2
    (the lifted Schur complement), or the first ``keep``, is appended to
    ``store`` (a copy)."""
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc)
    orig = bc.cholesky

    def cholesky(S):
        if keep is None or len(store) < keep:
            store.append(S.clone())
        return orig(S)

    bc.cholesky = cholesky
    try:
        yield
    finally:
        bc.cholesky = orig


@contextlib.contextmanager
def _plain_blocked_kernels():
    """While active, the blocked Cholesky runs the plain PyTorch versions
    of K2 and K3 on CUDA tensors (the reference the kernels are held
    against); the main path never does."""
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, blocked_chol as bl)
    saved = (bc.cholesky, bl.trsm_fwd, bl.trsm_bwd)
    bc.cholesky, bl.trsm_fwd, bl.trsm_bwd = (
        bc.cholesky_plain, bl.trsm_fwd_plain, bl.trsm_bwd_plain)
    try:
        yield
    finally:
        bc.cholesky, bl.trsm_fwd, bl.trsm_bwd = saved


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


def _graph_ms(call, sets, calls: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``call(*s)``: ``calls`` calls cycling
    through ``sets`` captured once in a CUDA graph, replayed ``replays``
    times, so the time holds no Python or launch cost."""
    import torch
    for s in sets:
        call(*s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            call(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * calls)


def _polish_matrices(sys_):
    """[256, 62, 62]: the two matrices polish_box_lp factors (A A' and
    A W^-1 A' + I, equilibrated, plus the 1e-7 ridge) on 256 real RTS-24
    LP lanes (K2a's polish shape)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    colscale, br_up, c, b, l, u = _lp_lanes(sys_, 256, seed=5)
    st = ipm_fused.build_structure(sys_)
    m = st.m
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
    return torch.cat(mats)[:256].contiguous()


def _polish_factor_inputs(st, lanes):
    """[B, 62, 62]: the matrices K2a factors in the polish of K1's
    iterates on the structured ``lanes`` (captured on the path):
    equilibrated A A' on the first half of the lanes, A W^-1 A' + I on
    the second."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb)
    from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_structured import (
        polish_structured)
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    store: list = []
    kernels = lpb._DIRECT_KERNELS["cuda"]
    lpb._DIRECT_KERNELS["cuda"] = kernels._replace(
        factor=lambda M: store.append(M.clone()) or kernels.factor(M))
    try:
        polish_structured(st, ipm_fused.fused_ipm_iterations(st, *lanes),
                          *lanes)
    finally:
        lpb._DIRECT_KERNELS["cuda"] = kernels
    half = lanes[2].shape[0] // 2
    return torch.cat([store[0][:half], store[1][half:]]).contiguous()


def _rts96_normal(sys96):
    """[256, 191, 191]: equilibrated normal matrices of 256 real RTS-96 LP
    lanes as the blocked route factors them. Of the factored matrices,
    in order (four IPM iterations' equilibrated A D^-1 A', then the
    polish's A A' and A W^-1 A' + I): lanes 0-127 at the fourth
    iteration's barrier weights, lanes 128-255 the polish's A A'."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    c, A, b, l, u = _dense_lp(sys96, 256, seed=9)
    mats: list = []
    with _capturing_blocked_factor(mats):
        lpb.solve_box_lp_batched(c, A, b, l, u, IPMConfig(iterations=4))
    return torch.cat([mats[3][:128], mats[4][128:]]).contiguous()


def _tile(t, n: int):
    """``t`` repeated along the batch to ``n`` lanes."""
    return t.repeat(n // t.shape[0], *([1] * (t.dim() - 1))).contiguous()


def _rts96_panels(M, n: int = 2048):
    """The first (56-wide) and last (23-wide) diagonal panels K2a factors
    in one blocked factorization of ``M`` (the lifted Schur complements),
    tiled to ``n`` lanes: the RTS-96 path's K2a shapes at the study's
    max_lp."""
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        blocked_chol as bl)
    panels: list = []
    with _capturing_panels(panels):
        bl._factor_once(M)
    return _tile(panels[0], n), _tile(panels[-1], n)


def _asymmetry(M) -> float:
    """max over lanes of max|M - M'| / max|M|: how far the path's inputs
    are from the symmetry K2a's reading of a_jk for a_kj assumes."""
    lane = lambda t: t.abs().flatten(1).amax(1)
    return float((lane(M - M.transpose(1, 2)) / lane(M).clamp_min(1e-30))
                 .max())


def _k2_inputs(sys_, sys96):
    """K2's four path shapes, ``name: (kernel, operands)``, on real
    matrices: the RTS-24 polish's [256, 62, 62] and its solve [256, 62]
    (the plain factor of those matrices, fresh right-hand sides), and
    RTS-96's diagonal panels [2048, 56, 56] and [2048, 23, 23]."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc)
    M62 = _polish_matrices(sys_)
    S56, S23 = _rts96_panels(_rts96_normal(sys96))
    gen = torch.Generator(device="cuda").manual_seed(2)
    r = torch.randn(M62.shape[:2], generator=gen, device="cuda")
    shapes = {"chol_polish": ("cholesky", (M62,)),
              "solve_polish": ("cho_solve", (bc.cholesky_plain(M62), r)),
              "chol_p56": ("cholesky", (S56,)),
              "chol_p23": ("cholesky", (S23,))}
    for m, M in _multiarea_normals().items():
        r = torch.randn(M.shape[:2], generator=gen, device="cuda")
        shapes[f"chol_ma{m}"] = ("cholesky", (M,))
        shapes[f"solve_ma{m}"] = ("cho_solve", (bc.cholesky_plain(M), r))
    return shapes


def _multiarea_systems():
    """The multi-area phase's systems: the two-area demo (8,760 hours)
    and RTS-96's three areas (8,736)."""
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        multiarea_demo)
    return {2: multiarea_demo.demo_system(),
            3: multiarea_demo.rts96_three_area_system()}


def _multiarea_margins(sys_ma, generator, years: int = 8):
    """Margins [years H, A] of one block of ``sys_ma`` drawn as the
    study's step draws it: the curtailment LP's inputs."""
    from powersystemsreliabilityassessment_tpu_torch.engines import multiarea
    areas = multiarea.device_areas(sys_ma, "cuda")
    return multiarea.block_margins(
        multiarea.draw_block(areas, years, generator), areas.caps,
        areas.load)


def _multiarea_normals() -> dict:
    """m -> [8 H, m, m]: the equilibrated normal matrices K2a factors in
    solve_curtailment on one 8-year block of each multi-area system (the
    study's step), captured on the path: the tenth IPM iteration's on the
    first half of the lanes, the twentieth's on the second."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb, multiarea)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    out = {}
    for m, sys_ma in _multiarea_systems().items():
        margins = _multiarea_margins(sys_ma,
                                     hl2_nsq.batch_generator(5, 0, "cuda"))
        store: list = []
        kernels = lpb._DIRECT_KERNELS["cuda"]
        lpb._DIRECT_KERNELS["cuda"] = kernels._replace(
            factor=lambda M: store.append(M.clone()) or kernels.factor(M))
        try:
            multiarea.solve_curtailment(margins, sys_ma.tie_from,
                                        sys_ma.tie_to, sys_ma.tie_cap)
        finally:
            lpb._DIRECT_KERNELS["cuda"] = kernels
        half = margins.shape[0] // 2
        out[m] = torch.cat([store[9][:half], store[19][half:]]).contiguous()
    return out


def _k2_fns(kind):
    """(kernel wrapper, plain version, one library call) of K2a or K2b."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc)
    if kind == "cholesky":
        return (bc.cholesky, bc.cholesky_plain,
                lambda M: torch.linalg.cholesky_ex(M)[0])
    return (bc.cho_solve, bc.cho_solve_plain,
            lambda L, r: torch.cholesky_solve(r[:, :, None], L)[:, :, 0])


def _k2_work(kind, args):
    if kind == "cholesky":
        return _chol_work(*args[0].shape[:2])
    return _solve_work(*args[1].shape)


def _k2_row(tag, name, kind, args, checked, tol=None):
    """One K2 path shape: the kernel against its plain version on
    ``checked``, and on ``args`` its device time in a CUDA graph, wrapper,
    plain and library times, bound and bound share, K2a's launch shape
    and the inputs' asymmetry; printed as one ``tag`` line beside ``tol``
    (None: the kind's bound against the plain version)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc)
    kern, plain, library = _k2_fns(kind)
    got, want = kern(*checked), plain(*checked)
    torch.cuda.synchronize()
    bound = _bound(*_k2_work(kind, args))
    row = dict(kind=kind, shape=list(args[-1].shape),
               rel_err=_rel_err(got, want),
               abs_err=float((got - want).abs().max()),
               finite=bool(torch.isfinite(got).all()),
               asymmetry=_asymmetry(args[0]) if kind == "cholesky" else None,
               device_ms=_graph_ms(kern, [args]),
               ms=_time_ms(lambda: kern(*args)),
               plain_ms=_time_ms(lambda: plain(*args), reps=3),
               library_ms=_time_ms(lambda: library(*args)), **bound)
    row["bound_share"] = bound["bound_ms"] / row["device_ms"]
    if kind == "cholesky":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row["launch_shape"] = dict(zip(
            ("warps_per_lane", "lanes_per_block", "smem_bytes"),
            bc.launch_shape(args[0].shape[0], args[0].shape[-1], sms)))
    if tol is None:
        tol = K2_L_BOUND if kind == "cholesky" else K2_X_BOUND
    _line(tag, path_shape=name, **{
        k: (f"{v:.3e}<={tol}" if k == "rel_err" else
            f"{v:.4f}" if isinstance(v, float) and k.endswith("ms")
            else f"{v:.3e}" if isinstance(v, float)
            else json.dumps(v).replace(" ", "") if isinstance(v, dict)
            else v) for k, v in row.items()})
    return row


def _k2_vs_float64(tag, M) -> dict:
    """K2a on ill-conditioned matrices ``M`` against the float64 factor:
    per lane e = max|L - L64| / max(1, max|L64|), the kernel's within
    max(K2_L_BOUND, 2 e_plain). Each float32 factor stands about cond(M)
    eps from the exact one (ROADMAP.md Queue 3 D), so there the kernel is
    held to the plain version's accuracy rather than to its rounding.
    Returns the errors and the lanes past the bound."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc)
    L64 = torch.linalg.cholesky_ex(M.double())[0]
    lane = lambda t: t.abs().flatten(1).amax(1)
    scale = lane(L64).clamp_min(1.0)
    err_k = lane(bc.cholesky(M).double() - L64) / scale
    err_p = lane(bc.cholesky_plain(M).double() - L64) / scale
    over = int((~(err_k <= torch.clamp_min(2 * err_p, K2_L_BOUND))).sum())
    out = dict(kernel_vs_float64=float(err_k.max()),
               plain_vs_float64=float(err_p.max()),
               lanes_past_float64_bound=over)
    _line(tag, k2a_vs_float64=f"{out['kernel_vs_float64']:.3e}",
          plain_vs_float64=f"{out['plain_vs_float64']:.3e}",
          lanes_past_bound=f"{over}<=0",
          bound=f"max({K2_L_BOUND},2*plain_vs_float64)_a_lane")
    return out


def _check_k2_rows(tag, rows):
    bad = [k for k, r in rows.items() if not r["finite"] or r["rel_err"] > (
        K2_L_BOUND if r["kind"] == "cholesky" else K2_X_BOUND)]
    if bad:
        raise RuntimeError(f"{tag}: K2 disagrees with the plain version at "
                           f"{bad}")


def phase_k2(sys_, sys96, results):
    """K2a and K2b against their plain versions at the four path shapes
    (a pivot-floor lane in the polish's factor), with times: the kernel
    alone (CUDA graph), through the wrapper, the plain version, one
    library call (cholesky_ex / cholesky_solve), bound and bound share,
    K2a's launch shape, and the inputs' asymmetry."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc)
    shapes = _k2_inputs(sys_, sys96)
    # Lane 0 of the polish check has lost positive definiteness: its
    # second pivot is 1 - 1.0005^2 < 0, which the pivot floor turns into
    # L_11 = -1 (an unfloored rsqrt would give NaN).
    M0 = shapes["chol_polish"][1][0].clone()
    m = M0.shape[-1]
    M0[0] = torch.eye(m, device="cuda")
    M0[0, 0, 1] = M0[0, 1, 0] = 1.0005
    L0 = bc.cholesky(M0)
    torch.cuda.synchronize()
    floor_hit = bool(torch.isfinite(L0[0]).all() and L0[0, 1, 1] < 0)
    rows = {name: _k2_row("k2", name, kind, args,
                          (M0,) if name == "chol_polish" else args)
            for name, (kind, args) in shapes.items()}
    _line("k2", pivot_floor_lane=floor_hit,
          pivot_floor_l11=f"{float(L0[0, 1, 1]):.5f}")
    if not floor_hit:
        raise RuntimeError("k2: the pivot-floor lane did not floor")
    _check_k2_rows("k2", rows)
    # The bounds are relative to each lane's scale (solutions of these
    # ill-conditioned systems reach ~1e3), so both errors are reported.
    # The top-level numbers are the polish shapes (K2a's main RTS-24
    # shape), every path shape under path_shapes.
    src = f"{PKG}/csrc/batched_chol.cu"
    ref = "powersystemsreliabilityassessment_tpu/ops/batched_chol.py"
    for kind, line, main in (("cholesky", 143, "chol_polish"),
                             ("cho_solve", 161, "solve_polish")):
        mine = {k: r for k, r in rows.items() if r["kind"] == kind}
        top = rows[main]
        results.setdefault(kind, {}).update(
            name=kind, route="cuda", source=src, replaces=f"{ref}:{line}",
            max_abs_err=max(r["abs_err"] for r in mine.values()),
            max_rel_err=max(r["rel_err"] for r in mine.values()),
            tolerance=K2_L_BOUND if kind == "cholesky" else K2_X_BOUND,
            shape=top["shape"], ms=top["ms"], device_ms=top["device_ms"],
            plain_ms=top["plain_ms"], library_ms=top["library_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            path_shapes=mine)


# K1 is checked and timed at the bench's LP buffer (max_lp 256) and at
# the RTS-24 "lp" study's (2,048 lanes, default_max_lp of batch 8192).
K1_LANES = (256, 2048)
# The hard SEQ lanes of fault A (ROADMAP.md Queue 3): RTS-24 outage
# states and hourly loads where the float32 IPMs stall off the optimum.
HARD_LANES = ROOT / "tests" / "golden" / "seq_hard_lanes.npz"
# SHA-256 of K1's outputs with no start point on fixed lanes
# (:func:`_k1_identity_lanes`), taken on an NVIDIA H100 from the kernel
# as it was before it took a start point (scripts/torch_k1_bench.py
# --digest): the kernel must still give those bits.
K1_DIGESTS = ROOT / "tests" / "golden" / "k1_null_start_digests.json"
K1_IDENTITY_LANES = (16, 256, 2048)
# The maintenance hour of fault A: hour 2,384 of tests/test_torch_seq.py's
# seed-8 two-year block of 2,016-hour years with scheduled maintenance,
# five units out; the LP tier without the warm rescue keeps 0 MW there,
# the reference 10.03 MW, float64 HiGHS 9.92 MW.
MAINT_HOUR, MAINT_DOWN = 2384, (17, 22, 23, 28, 30)


def _lp_oracle(st, args, lanes) -> list:
    """Float64 optima (HiGHS, scipy) of the structured LPs ``lanes`` of
    ``args``: A is built column by column from the structure's A v."""
    import numpy as np
    import torch
    from scipy.optimize import linprog
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    colscale, br_up, c, b, l, u = args
    eye = torch.eye(st.n, device=c.device)
    out = []
    for i in lanes:
        A = ipm_fused.mv(st, colscale[i].expand(st.n, -1),
                         br_up[i].expand(st.n, -1), eye).T
        f64 = lambda t: t.double().cpu().numpy()
        r = linprog(f64(c[i]), A_eq=f64(A), b_eq=f64(b[i]),
                    bounds=list(zip(f64(l[i]), f64(u[i]))), method="highs")
        out.append(r.fun if r.success else float("nan"))
    return np.asarray(out)


def _hard_lanes(sys_):
    """Structured LP inputs (colscale, br_up, c, b, l, u) of the hard SEQ
    lanes of HARD_LANES on the system's device."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    d = np.load(HARD_LANES)
    dev = sys_.load_pd.device
    up = 1.0 - torch.as_tensor(d["down"], device=dev).float()
    gen_up, br_up = up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous()
    c, b, l, u, colscale = dcopf.build_state_lp_vectors(
        sys_, gen_up, br_up, torch.as_tensor(d["load"], device=dev),
        CompatFlags(), IPMConfig().theta_max)
    return colscale, br_up, c, b, l, u


def _k1_identity_lanes() -> dict:
    """{lanes: structured LP inputs on the card} at K1_IDENTITY_LANES,
    built on the CPU from numpy draws so that they are the same bits in
    every run: the hard lanes of HARD_LANES first, then states at three
    times the outage rates (seed 2017), at peak load."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    sys_ = build_system(cases.rts24(), device="cpu")
    hard = _hard_lanes(sys_)
    rng = np.random.default_rng(2017)
    n = max(K1_IDENTITY_LANES)
    down = rng.uniform(size=(n, sys_.n_comp)) < \
        3 * sys_.unavail.numpy()[None, :]
    down[:, sys_.always_up_nsq.numpy()] = False
    up = 1.0 - torch.as_tensor(down).float()
    br_up = up[:, sys_.n_gen:].contiguous()
    c, b, l, u, cs = dcopf.build_state_lp_vectors(
        sys_, up[:, :sys_.n_gen], br_up,
        sys_.load_pd[None, :].expand(n, sys_.n_load), CompatFlags(),
        IPMConfig().theta_max)
    drawn = (cs, br_up, c, b, l, u)
    k = hard[0].shape[0]
    out = {}
    for B in K1_IDENTITY_LANES:
        out[B] = tuple(torch.cat([h, t[:max(B - k, 0)]])[:B].contiguous()
                       .to("cuda") for h, t in zip(hard, drawn))
    return out


def _digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _k1_null_start_bits(st, cfg) -> dict:
    """K1 with no start point against K1_DIGESTS at K1_IDENTITY_LANES,
    and against K1 started at the box midpoint (the kernel's own default
    start, so the two must be bit-equal)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    want = json.loads(K1_DIGESTS.read_text())["lanes"]
    rows = {}
    for B, args in _k1_identity_lanes().items():
        null = ipm_fused.fused_ipm_iterations(st, *args, cfg)
        mid = ipm_fused.fused_ipm_iterations(
            st, *args, cfg, x_init=0.5 * (args[4] + args[5]))
        torch.cuda.synchronize()
        rec = want[str(B)]
        rows[str(B)] = dict(
            inputs_as_recorded=_digest(args) == rec["inputs"],
            bits_as_recorded=_digest(null) == rec["outputs"],
            midpoint_start_bit_equal=_digest(mid) == _digest(null))
    _line("k1", null_start_bits=json.dumps(rows).replace(" ", ""),
          recorded_on=repr(json.loads(K1_DIGESTS.read_text())["card"]))
    if not all(v for r in rows.values() for v in r.values()):
        raise RuntimeError("k1: the kernel with no start point does not "
                           f"give the recorded bits: {rows}")
    return rows


def _rescue_inputs(sys_, st, cfg):
    """(lanes, start) of the warm rescue's first K1 launch on the hard
    lanes, captured on the LP path (``solve_box_lp_structured``)."""
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_structured as ls)
    store: list = []
    hard = _hard_lanes(sys_)
    with _capturing_k1(store, warm=True):
        ls.solve_box_lp_structured(st, *hard, cfg)
    if len(store) != sum(f is not None for f in cfg.rescue_stages):
        raise RuntimeError(f"k1: the rescue launched K1 {len(store)} times")
    lanes, start = store[0][:6], store[0][6]
    if lanes[2].shape[0] != min(ls.RESCUE_LANES, hard[2].shape[0]):
        raise RuntimeError("k1: the rescue's buffer is not RESCUE_LANES")
    return lanes, start


@contextlib.contextmanager
def _guard_counter():
    """While active, each m <= 72 LP solve adds to a [2] int64 tensor on
    the card its lanes past the evaluator's guard before and after the
    warm rescue (``lp_ipm_structured._warm_rescue``; a NaN score counts
    as past). Nothing is read on the host until the caller reads it."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb, lp_ipm_structured as ls)
    orig = ls._warm_rescue
    acc = torch.zeros(2, dtype=torch.int64, device="cuda")

    def rescue(st, iterate, cfg, chain, sol, pick):
        out = orig(st, iterate, cfg, chain, sol, pick)
        acc.add_(torch.stack([(~(lpb._quality(s) <= LP_QUALITY_GUARD)).sum()
                              for s in (sol, out)]))
        return out

    ls._warm_rescue = rescue
    try:
        yield acc
    finally:
        ls._warm_rescue = orig


def _guard_text(acc) -> str:
    before, after = (int(v) for v in acc.tolist())
    return f"{before}->{after}"


def _k1_guarded_check(st, args, pol_k, pol_p, ker_score, pla_score,
                      deep=False, path=None):
    """K1 against its plain version where the screened evaluator keeps
    both answers (lane quality, primal residual + 2 n gap, within the
    evaluator's LP_QUALITY_GUARD on both sides), and against the float64
    optimum where one side fails the guard and the two objectives differ
    by more than K1_OBJ_BOUND: there the kernel must be within
    LP_QUALITY_GUARD of the optimum, or no farther from it than the plain
    version. Returns the objective and best_score errors on the kept
    lanes and the counts. ``deep``: kept lanes whose objectives differ
    by more than K1_DEEP_BOUND go to the float64 optimum too, and the
    counts add K1's lanes off it by more than the guard, flagged by the
    guard and not. ``path``: the LP path's solution of the same lanes
    (K1, the polish, the warm rescue); the counts add its lanes past the
    guard and, of the judged lanes, those it leaves off the optimum by
    more than the guard, flagged and not."""
    import numpy as np
    import torch
    q = lambda sol: sol.primal_residual + 2 * st.n * sol.duality_gap
    kept = (q(pol_k) <= LP_QUALITY_GUARD) & (q(pol_p) <= LP_QUALITY_GUARD)
    diff = (pol_k.objective - pol_p.objective).abs()
    judged = ~kept & (diff > K1_OBJ_BOUND)
    if deep:
        judged |= kept & (diff > K1_DEEP_BOUND)
    lanes = torch.nonzero(judged).flatten().tolist()
    opt = _lp_oracle(st, args, lanes)
    err_k = np.abs(pol_k.objective[lanes].double().cpu().numpy() - opt)
    err_p = np.abs(pol_p.objective[lanes].double().cpu().numpy() - opt)
    info = dict(
        kept_lanes=int(kept.sum()),
        guard_failed_kernel=int((q(pol_k) > LP_QUALITY_GUARD).sum()),
        guard_failed_plain=int((q(pol_p) > LP_QUALITY_GUARD).sum()),
        objective_err_all_lanes_pu=float(diff.max()),
        oracle_lanes=len(lanes),
        oracle_kernel_closer=int((err_k < err_p).sum()),
        oracle_kernel_err_max=float(err_k.max()) if lanes else 0.0,
        oracle_plain_err_max=float(err_p.max()) if lanes else 0.0,
        oracle_plain_closer=int((err_k > err_p + K1_OBJ_BOUND).sum()),
        oracle_kernel_off=int((err_k > np.maximum(err_p, LP_QUALITY_GUARD))
                              .sum() + np.isnan(opt).sum()))
    if path is not None:
        err_path = np.abs(path.objective[lanes].double().cpu().numpy() - opt)
        flagged = ~(q(path)[lanes] <= LP_QUALITY_GUARD).cpu().numpy()
        off = ~(err_path <= LP_QUALITY_GUARD)
        info.update(guard_failed_path=int((~(q(path) <= LP_QUALITY_GUARD))
                                          .sum()),
                    oracle_path_off_flagged=int((off & flagged).sum()),
                    oracle_path_off_unflagged=int((off & ~flagged).sum()))
    if deep:
        flagged_k = (q(pol_k)[lanes] > LP_QUALITY_GUARD).cpu().numpy()
        off_k = ~(err_k <= LP_QUALITY_GUARD)
        info.update(kept_lanes_past_deep_bound=int(
                        (kept & (diff > K1_DEEP_BOUND)).sum()),
                    oracle_kernel_off_flagged=int((off_k & flagged_k).sum()),
                    oracle_kernel_off_unflagged=int((off_k & ~flagged_k)
                                                    .sum()))
    return (float(diff[kept].max()),
            float((ker_score - pla_score).abs()[kept].max()), info)


def _k1_shape(sys_, st, n_lanes, cfg, args=None, tag="k1", guarded=False,
              deep=False, x_init=None):
    """K1 against its plain version on ``n_lanes`` real RTS-24 LP lanes
    (``args``, or :func:`_lp_lanes`' peak-load lanes): errors, times,
    launch shape and the work this run's lanes need. ``guarded``: the
    errors are taken where the evaluator keeps both answers, and the
    float64 optimum judges the other lanes (:func:`_k1_guarded_check`).
    ``deep`` (guarded, deep multi-branch lanes): K1_DEEP_BOUND bounds
    the kept lanes, and K1's off lanes must be flagged. ``x_init``: both
    start there (the warm rescue's launch); else, where guarded, the LP
    path on the same lanes (K1, the polish and the warm rescue) adds its
    lanes past the guard."""
    import ctypes
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines.lp_ipm_structured import (
        polish_structured)
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        cuda_build, ipm_fused)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_structured as ls)
    if args is None:
        args = _lp_lanes(sys_, n_lanes, seed=7)
    ker = ipm_fused.fused_ipm_iterations(st, *args, cfg, x_init=x_init)
    pla = ipm_fused.fused_ipm_iterations_plain(st, *args, cfg, x_init)
    torch.cuda.synchronize()
    pol_k = polish_structured(st, ker, *args, cfg)
    pol_p = polish_structured(st, pla, *args, cfg)
    obj_k, obj_p = pol_k.objective, pol_p.objective
    finite = all(bool(torch.isfinite(t).all()) for t in ker)
    guard = {}
    if guarded:
        path = (None if x_init is not None
                else ls.solve_box_lp_structured(st, *args, cfg))
        obj_err, score_err, guard = _k1_guarded_check(
            st, args, pol_k, pol_p, ker[4], pla[4], deep, path)
    else:
        obj_err = float((obj_k - obj_p).abs().max())
        score_err = float((ker[4] - pla[4]).abs().max())
    x_err = float((ker[5] - pla[5]).abs().max())
    ms = statistics.median(
        _time_ms(lambda: ipm_fused.fused_ipm_iterations(
            st, *args, cfg, x_init=x_init)) for _ in range(5))
    plain_ms = _time_ms(lambda: ipm_fused.fused_ipm_iterations_plain(
        st, *args, cfg, x_init), reps=2)
    # The work this run's lanes need: a lane frozen at mu < mu_tol never
    # changes again, and the kernel stops its lane. Count the lane-
    # iterations that moved x by replaying the loop 1..16 iterations; each
    # needs at least the m x m factor and two solves (the normal-matrix
    # assembly and the elementwise work are not counted).
    c = args[2]
    prev, active = c.new_full(c.shape, float("nan")), 0
    for k in range(1, cfg.iterations + 1):
        xk = ipm_fused.fused_ipm_iterations(
            st, *args, IPMConfig(iterations=k), x_init=x_init)[0]
        active += int((xk != prev).any(1).sum())
        prev = xk
    B, n, m = c.shape[0], st.n, st.m
    n_in = 4 * n + st.nl + m + (0 if x_init is None else n)
    bound = _bound(active * (m ** 3 / 3 + 4 * m * m),
                   4 * B * (n_in + (4 * n + m + 1)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lpb, wpl, smem = ipm_fused.launch_shape(st, B, sms)
    blocks = ctypes.c_int(0)
    cuda_build.check_launch(cuda_build.library().psra_fused_ipm_occupancy(
        m, n, lpb, wpl, smem, ctypes.byref(blocks)), "occupancy")
    row = dict(lanes=B, start="midpoint" if x_init is None else "warm",
               finite=finite, objective_err_pu=obj_err,
               best_score_err=score_err, best_x_err=x_err, ms=ms,
               plain_ms=plain_ms, active_lane_iterations=active,
               lanes_per_block=lpb, warps_per_lane=wpl, smem_bytes=smem,
               resident_lanes_per_sm=blocks.value * lpb,
               shed_lanes=int((obj_p > 1e-3).sum()), **bound,
               bound_share=bound["bound_ms"] / ms, **guard)
    obj_bound, score_bound = ((K1_DEEP_BOUND, K1_DEEP_BOUND) if deep
                              else (K1_OBJ_BOUND, K1_SCORE_BOUND))
    obj_text = (f"<={obj_bound}_or_float64_judged" if deep
                else f"<={obj_bound}")
    _line(tag, lanes=B, start=row["start"], finite=finite,
          objective_err_pu=f"{obj_err:.3e}{obj_text}",
          best_score_err=f"{score_err:.3e}<={score_bound}",
          best_x_err=f"{x_err:.3e}", kernel_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", shed_lanes=row["shed_lanes"],
          active_lane_iterations=active, lanes_per_block=lpb,
          warps_per_lane=wpl, smem_bytes=smem, resident_lanes_per_sm=row["resident_lanes_per_sm"],
          bound_ms=f"{bound['bound_ms']:.4f}({bound['bound_by']})",
          bound_share=f"{row['bound_share']:.4f}",
          **{k: (f"{v:.3e}" if isinstance(v, float) else v)
             for k, v in guard.items()})
    if deep:
        # Judged lanes (kept ones past K1_DEEP_BOUND among them): every
        # lane K1 leaves more than the guard off the float64 optimum is
        # flagged by the guard, so a kept lane must be within it.
        ok = guard["oracle_kernel_off_unflagged"] == 0
        obj_bound = float("inf")
    else:
        ok = guard.get("oracle_kernel_off", 0) == 0
    # The LP path may leave a lane off the optimum only where the guard
    # flags it (the evaluator then keeps the certificate's bound).
    ok = ok and guard.get("oracle_path_off_unflagged", 0) == 0
    if not (finite and ok and obj_err <= obj_bound
            and score_err <= score_bound):
        raise RuntimeError(f"{tag}: K1 disagrees with the plain version at "
                           f"{B} lanes")
    return row


def phase_k1(sys_, results):
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    cfg = IPMConfig()
    st = ipm_fused.build_structure(sys_)
    shapes = {str(n): _k1_shape(sys_, st, n, cfg) for n in K1_LANES}
    # The warm rescue's launch: RESCUE_LANES lanes from a start point,
    # on the rescue's own inputs for the hard lanes (guarded: these are
    # the lanes where two float32 IPMs part).
    lanes, start = _rescue_inputs(sys_, st, cfg)
    shapes["warm"] = _k1_shape(sys_, st, lanes[2].shape[0], cfg, args=lanes,
                               guarded=True, x_init=start)
    _k1_null_start_bits(st, cfg)
    # The checked quantities: polished objective (p.u.) and best_score.
    # best_x is reported in the k1 lines but not bounded: on degenerate
    # optimal faces two float32 paths reach different optimal points.
    # The top-level numbers are the bench's shape (256 lanes).
    first = shapes[str(K1_LANES[0])]
    results["fused_ipm_iterations"] = dict(
        name="fused_ipm_iterations", route="cuda",
        source=f"{PKG}/csrc/ipm_fused.cu",
        replaces="powersystemsreliabilityassessment_tpu/ops/ipm_fused.py:459",
        max_abs_err=max(max(r["objective_err_pu"], r["best_score_err"])
                        for r in shapes.values()),
        tolerance=K1_OBJ_BOUND, shape=[first["lanes"], st.m, st.n],
        ms=first["ms"], plain_ms=first["plain_ms"], library_ms=None,
        active_lane_iterations=first["active_lane_iterations"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        shapes=shapes)


def phase_faulta(sys_, results):
    """Fault A on the card: the hard SEQ lanes of HARD_LANES through the
    LP tier (``solve_box_lp_structured``: K1, the polish, then the warm
    rescue) against float64 HiGHS, with the rescue off (RESCUE_LANES 0)
    and on: lanes more than LP_QUALITY_GUARD p.u. off the optimum, lanes
    past the guard, off lanes the guard does not flag (which must be
    none), the largest errors and K1's launches. Fails on a non-finite
    objective or an off lane left unflagged."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb, lp_ipm_structured as ls)
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    st = ipm_fused.build_structure(sys_)
    args = _hard_lanes(sys_)
    n = args[2].shape[0]
    opt = _lp_oracle(st, args, range(n))
    lane_ids = np.load(HARD_LANES)["lane"]
    saved, rows = ls.RESCUE_LANES, {}
    try:
        for k in (0, saved):
            ls.RESCUE_LANES = k
            _reset_counts()
            sol = ls.solve_box_lp_structured(st, *args, IPMConfig())
            torch.cuda.synchronize()
            counts = _counts()
            obj = sol.objective.double().cpu().numpy()
            q = lpb._quality(sol).cpu().numpy()
            err = np.abs(obj - opt)
            off = ~(err <= LP_QUALITY_GUARD)
            flagged = ~(q <= LP_QUALITY_GUARD)
            rows[k] = row = dict(
                rescue_lanes=k, lanes=n, off=int(off.sum()),
                flagged=int(flagged.sum()),
                off_unflagged=int((off & ~flagged).sum()),
                max_err_pu=float(err.max()),
                max_err_kept_pu=float(err[~flagged].max())
                if (~flagged).any() else 0.0,
                finite=bool(np.isfinite(obj).all()),
                k1_launches=counts["fused_ipm_iterations"],
                off_lanes={int(lane_ids[i]): round(float(err[i]), 6)
                           for i in np.flatnonzero(off)})
            _line("faulta", **{key: (f"{v:.3e}" if isinstance(v, float)
                                     else json.dumps(v).replace(" ", "")
                                     if isinstance(v, dict) else v)
                               for key, v in row.items()},
                  tolerance_pu=LP_QUALITY_GUARD)
    finally:
        ls.RESCUE_LANES = saved
    on = rows[saved]
    on["maint_hour"] = _faulta_maint_hour(sys_)
    results.setdefault("fused_ipm_iterations", {})["fault_a"] = on
    if not on["finite"] or on["off_unflagged"]:
        raise RuntimeError(f"faulta: {on['off_unflagged']} lanes off the "
                           "float64 optimum and not flagged, or a "
                           "non-finite objective")


def _faulta_maint_hour(sys_) -> dict:
    """The maintenance hour MAINT_HOUR through ``evaluate_states`` on the
    card with the warm rescue off and on, beside its float64 optimum:
    DNS in MW and the lane's quality score."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import load_profile
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        dcopf, lp_ipm_structured as ls)
    from powersystemsreliabilityassessment_tpu_torch.ops import ipm_fused
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_seq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(2016),
                                   2)[MAINT_HOUR:MAINT_HOUR + 1]
    down = torch.zeros((1, sys_.n_comp), dtype=torch.bool, device="cuda")
    down[0, list(MAINT_DOWN)] = True
    st = ipm_fused.build_structure(sys_)
    up = 1.0 - down.float()
    vec = dcopf.build_state_lp_vectors(
        sys_, up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous(), load,
        CompatFlags(), IPMConfig().theta_max)
    args = (vec[4], up[:, sys_.n_gen:].contiguous(), *vec[:4])
    row = dict(oracle_mw=float(_lp_oracle(st, args, [0])[0])
               * sys_.base_mva)
    saved = ls.RESCUE_LANES
    try:
        for k in (0, saved):
            ls.RESCUE_LANES = k
            res = dcopf.evaluate_states(sys_, down, load)
            row[f"rescue_{k}"] = dict(dns_mw=float(res.dns_mw[0]),
                                      quality=float(res.primal_residual[0]))
    finally:
        ls.RESCUE_LANES = saved
    _line("faulta", maint_hour=MAINT_HOUR,
          units_down=json.dumps(list(MAINT_DOWN)).replace(" ", ""),
          **{k: (json.dumps(v).replace(" ", "") if isinstance(v, dict)
                 else f"{v:.4f}") for k, v in row.items()})
    return row


def _bench_run(step, batch):
    """Warm-up step, then 8 segments of 16 steps with fresh generator
    seeds, each under torch.cuda.set_sync_debug_mode("error"). Returns
    (segment rates, last output, warm-up overflow, peak bytes)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    torch.cuda.reset_peak_memory_stats()
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
    return rates, out, n_over_warm, torch.cuda.max_memory_allocated()


def phase_bench(sys_, results):
    import numpy as np
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    batch, max_lp = 262144, 256
    t0 = time.perf_counter()
    hint = dcopf.calibrate_shed_hint(sys_)
    hint_s = time.perf_counter() - t0
    # The default step, then the fused one (fused_tier1) at the same
    # shape: information beside the default, each with its own counts.
    for tag, fused, names in (("bench", False, RTS24_KERNELS),
                              ("bench_fused", True, FUSED_KERNELS)):
        step = hl2_nsq.make_nsq_batch_step(
            sys_, batch, CompatFlags(), IPMConfig(), max_lp=max_lp,
            nodal_mode="proportional", shed_hint=hint, fused_tier1=fused)
        _reset_counts()
        rates, out, n_over_warm, peak = _bench_run(step, batch)
        counts = _counts()
        edns = float(out[0].sum_dns) / batch
        _line(tag, hinted=hint is not None,
              hint_seconds=f"{hint_s:.2f}",
              scen_per_s_best=f"{max(rates):.1f}",
              scen_per_s_median=f"{statistics.median(rates):.1f}",
              segment_rates=[round(r, 1) for r in rates],
              overflow_warmup=n_over_warm, peak_mem_bytes=peak,
              last_batch_edns_mw=f"{edns:.4f}",
              launches=json.dumps(counts).replace(" ", ""))
        _check_launched(tag, counts, names)
        if not np.isfinite(edns):
            raise RuntimeError(f"{tag}: non-finite DNS")
        if not fused:
            for name in RTS24_KERNELS:
                results.setdefault(name, {})["launches"] = counts[name]
        else:
            results.setdefault("sample_certify_quick", {})[
                "launches_bench_fused"] = counts["sample_certify_quick"]


def _nsq_z(ref, edns, beta, plc, samples):
    """(EDNS z, PLC z) of an NSQ estimate against the record ``ref``
    (results/nsq_results.json), each over the two runs' combined
    standard error."""
    import math
    se_e = math.hypot(ref["beta"] * ref["edns_mw"], beta * edns)
    se_p = math.hypot(
        math.sqrt(ref["plc"] * (1 - ref["plc"]) / ref["samples"]),
        math.sqrt(plc * (1 - plc) / samples))
    return abs(edns - ref["edns_mw"]) / se_e, abs(plc - ref["plc"]) / se_p


def phase_study(tag="study", fused=False, kernels=RTS24_KERNELS):
    """The 106,496-sample RTS-24 study (default, or ``fused_tier1``) held
    against results/nsq_results.json; returns the launch counts."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        MCSConfig)
    ref = json.loads((ROOT / "results" / "nsq_results.json").read_text())
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = hl2_nsq.run_nsq_study(
        cases.rts24(), MCSConfig(max_samples=106496, fused_tier1=fused),
        device="cuda", log_every=0)
    wall = time.perf_counter() - t0
    counts = _counts()
    z_e, z_p = _nsq_z(ref, res.edns_mw, res.beta, res.plc, res.samples)
    _line(tag, samples=res.samples, edns_mw=f"{res.edns_mw:.4f}",
          lole_hr_yr=f"{res.lole_hr_yr:.2f}", plc=f"{res.plc:.5f}",
          beta=f"{res.beta:.5f}", edns_z=f"{z_e:.2f}<=4",
          plc_z=f"{z_p:.2f}<=4", overflow=res.overflow_states,
          wall_s=f"{wall:.2f}",
          peak_mem_bytes=torch.cuda.max_memory_allocated(),
          launches=json.dumps(counts).replace(" ", ""))
    _check_launched(tag, counts, kernels)
    if not (z_e <= 4 and z_p <= 4):
        raise RuntimeError(f"{tag}: estimates outside 4 combined standard "
                           "errors of results/nsq_results.json")
    if fused:
        batches = res.samples // MCSConfig().batch_size
        if res.overflow_states or counts["sample_certify_quick"] < batches:
            raise RuntimeError(f"{tag}: overflow {res.overflow_states}, or "
                               f"K4 launched on fewer than {batches} "
                               "batches")
    return counts


def _rel_err(a, b) -> float:
    """max over lanes of max|a - b| / max(1, max|b|)."""
    lane = lambda t: t.abs().flatten(1).amax(1)
    return float((lane(a - b) / lane(b).clamp_min(1.0)).max())


def _time_cold_ms(fn, sets, rounds: int = 4) -> float:
    """Mean time of ``fn(*s)`` over ``rounds`` passes through ``sets``,
    copies of one input whose pass moves more bytes than the L2 holds:
    each call finds its operands in device memory, as on the path, where
    the refinement streams M (299 MB at [2048, 191, 191]) between K3
    calls."""
    import torch
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(rounds):
        for s in sets:
            fn(*s)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (rounds * len(sets))


def _k3_times(nx, shapes) -> dict:
    """Per path shape ``name: (forward, L, B)``: K3 and
    torch.linalg.solve_triangular warm (the same operands every call) and
    cold (rotating over enough copies that a pass moves > 1.25 x the
    50 MB L2: 5 at P 56, K 1; 2 at K 56), the plain version warm, the
    bound and the share of it each time reaches. Kernel and library times
    are the median of five runs of _time_ms / _time_cold_ms: at K = 1 a
    call costs the host more than the card (~15-20 us through the
    wrapper against ~10 us on the card), so a single run of 20 calls
    reads the host's stalls."""
    import math
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        blocked_chol as bl)
    lib = torch.linalg.solve_triangular
    out = {}
    for name, (fwd, L, B) in shapes.items():
        kern = bl.trsm_fwd if fwd else bl.trsm_bwd
        plain = bl.trsm_fwd_plain if fwd else bl.trsm_bwd_plain
        library = ((lambda L_, B_: lib(L_, B_, upper=False)) if fwd else
                   (lambda L_, B_: lib(L_.transpose(1, 2), B_, upper=True)))
        P, K = B.shape[1:]
        bound = _bound(*_trsm_work(nx, P, K))
        n_sets = max(2, math.ceil(1.25 * L2_BYTES / _trsm_work(nx, P, K)[1]))
        sets = [(L.clone(), B.clone()) for _ in range(n_sets)]
        med = lambda timer: statistics.median(timer() for _ in range(5))
        t = dict(P=P, K=K, cold_sets=n_sets,
                 ms=med(lambda: _time_ms(lambda: kern(L, B))),
                 ms_cold=med(lambda: _time_cold_ms(kern, sets)),
                 library_ms=med(lambda: _time_ms(lambda: library(L, B))),
                 library_ms_cold=med(lambda: _time_cold_ms(library, sets)),
                 plain_ms=_time_ms(lambda: plain(L, B), 3), **bound)
        del sets
        t.update(bound_share=t["bound_ms"] / t["ms"],
                 bound_share_cold=t["bound_ms"] / t["ms_cold"],
                 library_over_kernel=t["library_ms"] / t["ms"],
                 library_over_kernel_cold=t["library_ms_cold"] / t["ms_cold"])
        out[name] = t
    return out


def _k3_edges() -> dict:
    """K3 against its plain version at ragged edges: batch 1 and 2,047
    (not a multiple of the lanes a block takes), P in (1, 7, 23, 56, 64),
    K in (1, 23, 56, 65), forward and backward, on factors of
    well-conditioned SPD matrices with NaN above the diagonal (only the
    lower triangle may be read). The worst per-lane error, the cases and
    the launches they made."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        blocked_chol as bl)
    gen = torch.Generator(device="cuda").manual_seed(11)
    before = dict(bl.launches)
    errs = []
    for batch in (1, 2047):
        for P in (1, 7, 23, 56, 64):
            G = torch.randn((batch, P, P), generator=gen, device="cuda")
            eye = torch.eye(P, device="cuda")
            L = (torch.linalg.cholesky(G @ G.transpose(1, 2) / P + eye)
                 + torch.full_like(eye, float("nan")).triu(1)).contiguous()
            for K in (1, 23, 56, 65):
                B = torch.randn((batch, P, K), generator=gen, device="cuda")
                for fn, plain in ((bl.trsm_fwd, bl.trsm_fwd_plain),
                                  (bl.trsm_bwd, bl.trsm_bwd_plain)):
                    errs.append(_rel_err(fn(L, B), plain(L, B)))
    torch.cuda.synchronize()
    worst = max(errs) if all(e == e for e in errs) else float("nan")
    return dict(cases=len(errs), max_rel_err=worst,
                launches={k: bl.launches[k] - before[k] for k in before})


def phase_k3(sys96, results):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, blocked_chol as bl)
    M = _rts96_normal(sys96)
    m, P = M.shape[-1], bl.PANEL
    # Kernels against plain versions at the main path's shapes: 2048
    # lanes (the study's max_lp), tiled from the 256 real lanes, with
    # fresh right-hand sides. The diagonal panels K2 factors (56, 56, 56
    # and 23 wide) are the lifted Schur complements one blocked
    # factorization of these lanes builds.
    nx = 2048
    tile = lambda t: _tile(t, nx)
    gen = torch.Generator(device="cuda").manual_seed(3)
    S56x, S23x = _rts96_panels(M, nx)
    P23 = S23x.shape[-1]
    L56x, L23x = bc.cholesky(S56x), bc.cholesky(S23x)
    # Real off-diagonal blocks of the first panel column: block (1, 0) is
    # 56 x 56, block (3, 0) 23 x 56; K3 takes their transposes.
    B56x = tile(M[:, P:2 * P, :P].transpose(1, 2))
    B23x = tile(M[:, 3 * P:, :P].transpose(1, 2))
    r56 = torch.randn((nx, P, 1), generator=gen, device="cuda")
    r23 = torch.randn((nx, P23, 1), generator=gen, device="cuda")
    k2_pairs = {"chol_p56": (L56x, bc.cholesky_plain(S56x)),
                "chol_p23": (L23x, bc.cholesky_plain(S23x))}
    fwd, bwd = (bl.trsm_fwd, bl.trsm_fwd_plain), (bl.trsm_bwd,
                                                 bl.trsm_bwd_plain)
    k3_pairs = {name: (fn[0](L, X), fn[1](L, X)) for name, fn, L, X in (
        ("fwd_p56_k56", fwd, L56x, B56x), ("fwd_p56_k23", fwd, L56x, B23x),
        ("fwd_p56_k1", fwd, L56x, r56), ("bwd_p56_k1", bwd, L56x, r56),
        ("fwd_p23_k1", fwd, L23x, r23), ("bwd_p23_k1", bwd, L23x, r23))}
    torch.cuda.synchronize()
    pairs = {**k2_pairs, **k3_pairs}
    errs = {k: _rel_err(a, b_) for k, (a, b_) in pairs.items()}
    abs_errs = {k: float((a - b_).abs().max()) for k, (a, b_) in pairs.items()}
    finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())

    # The blocked route end to end on the 256 real lanes: kernels against
    # plain versions.
    r = torch.randn((256, m), generator=gen, device="cuda")
    n0 = bl.rescues["lanes_flagged"]
    xk = bl.blocked_cho_solve(bl.blocked_cholesky(M), r)
    resc_k = bl.rescues["lanes_flagged"] - n0
    with _plain_blocked_kernels():
        n0 = bl.rescues["lanes_flagged"]
        xp = bl.blocked_cho_solve(bl.blocked_cholesky(M), r)
        resc_p = bl.rescues["lanes_flagged"] - n0
    ev = torch.linalg.eigvalsh(M.double())
    cond = ev[:, -1] / ev[:, 0].clamp_min(1e-300)
    tol = torch.clamp_min(BLOCKED_X_COND * cond * EPS_F32, BLOCKED_X_FLOOR)
    lane = lambda t: t.abs().amax(1)
    x_rel = lane(xk - xp) / lane(xp).clamp_min(1.0)
    n_over = int((x_rel > tol.float()).sum())
    res_k = lane((M.double() @ xk.double()[:, :, None])[:, :, 0] - r) \
        / lane(r)
    res_p = lane((M.double() @ xp.double()[:, :, None])[:, :, 0] - r) \
        / lane(r)

    edge = _k3_edges()

    # Times at the same 2048-lane shapes: K3 and solve_triangular at every
    # shape the path launches, warm and cold (_k3_times).
    shape_ms = _k3_times(nx, {
        "fwd_p56_k56": (True, L56x, B56x), "fwd_p56_k23": (True, L56x, B23x),
        "fwd_p56_k1": (True, L56x, r56), "bwd_p56_k1": (False, L56x, r56),
        "fwd_p23_k1": (True, L23x, r23), "bwd_p23_k1": (False, L23x, r23)})
    ms = {f"{d}_k{k}{suffix}": shape_ms[f"{d}_p56_k{k}"][key]
          for d, k in (("fwd", 56), ("fwd", 1), ("bwd", 1))
          for suffix, key in (("", "ms"), ("_plain", "plain_ms"),
                              ("_library", "library_ms"))}
    ms.update({
        "chol_panel": _time_ms(lambda: bc.cholesky(S56x)),
        "chol_panel_plain": _time_ms(lambda: bc.cholesky_plain(S56x), 3),
        "chol_panel_library": _time_ms(lambda: torch.linalg.cholesky_ex(S56x)),
        "blocked": _time_ms(
            lambda: bl.blocked_cho_solve(bl.blocked_cholesky(M), r), 5),
        "blocked_library": _time_ms(lambda: torch.cholesky_solve(
            r[:, :, None], torch.linalg.cholesky_ex(M)[0]), 5),
    })
    with _plain_blocked_kernels():
        ms["blocked_plain"] = _time_ms(
            lambda: bl.blocked_cho_solve(bl.blocked_cholesky(M), r), 2)
    bounds = {"fwd_k56": _bound(*_trsm_work(nx, P, P)),
              "fwd_k1": _bound(*_trsm_work(nx, P, 1)),
              "bwd_k1": _bound(*_trsm_work(nx, P, 1)),
              "chol_panel": _bound(*_chol_work(nx, P))}
    k2_errs = {k: errs[k] for k in k2_pairs}
    k3_errs = {k: errs[k] for k in k3_pairs}
    _line("k3", shape=tuple(M.shape), checked_lanes=nx, finite=finite,
          **{f"{k}_rel_err": f"{v:.3e}<={K2_L_BOUND}"
             for k, v in k2_errs.items()},
          **{f"{k}_rel_err": f"{v:.3e}<={K3_BOUND}"
             for k, v in k3_errs.items()},
          blocked_lanes_over_bound=f"{n_over}<={int(RESCUE_DIFF_BOUND * 256)}",
          blocked_x_rel_err_max=f"{float(x_rel.max()):.3e}",
          blocked_bound_max=f"{float(tol.max()):.3e}",
          cond_median=f"{float(cond.median()):.3e}",
          cond_max=f"{float(cond.max()):.3e}",
          residual_kernel_max=f"{float(res_k.max()):.3e}",
          residual_plain_max=f"{float(res_p.max()):.3e}",
          flagged_lanes_kernel=resc_k, flagged_lanes_plain=resc_p,
          flagged_share=f"{resc_k / 256:.4f}")
    _line("k3", timed_lanes=nx,
          **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
          **{f"{k}_bound_ms": f"{v['bound_ms']:.4f}({v['bound_by']})"
             for k, v in bounds.items()})
    for name, t in shape_ms.items():
        _line("k3", path_shape=name, **{
            k: f"{v:.4f}" if isinstance(v, float) else v
            for k, v in t.items()})
    _line("k3", edge_cases=edge["cases"],
          edge_rel_err_max=f"{edge['max_rel_err']:.3e}<={K3_BOUND}",
          edge_launches=json.dumps(edge["launches"]).replace(" ", ""),
          edge_launches_expected=edge["cases"] // 2)
    if not (finite and max(k2_errs.values()) <= K2_L_BOUND
            and max(k3_errs.values()) <= K3_BOUND):
        raise RuntimeError("k3: kernel disagrees with the plain version")
    if not (edge["max_rel_err"] <= K3_BOUND and all(
            n == edge["cases"] // 2 for n in edge["launches"].values())):
        raise RuntimeError("k3: kernel disagrees with the plain version at "
                           "a ragged edge, or a call did not launch it")
    if n_over > RESCUE_DIFF_BOUND * 256 \
            or abs(resc_k - resc_p) > RESCUE_DIFF_BOUND * 256:
        raise RuntimeError("k3: the blocked route on the kernels disagrees "
                           "with the same route on the plain versions")
    src = f"{PKG}/csrc/blocked_trsm.cu"
    ref_file = "powersystemsreliabilityassessment_tpu/ops/blocked_chol.py"
    fwd_keys = [k for k in k3_pairs if k.startswith("fwd")]
    bwd_keys = [k for k in k3_pairs if k.startswith("bwd")]
    results["trsm_fwd"] = dict(
        name="trsm_fwd", route="cuda", source=src, replaces=f"{ref_file}:97",
        max_abs_err=max(abs_errs[k] for k in fwd_keys),
        max_rel_err=max(errs[k] for k in fwd_keys),
        tolerance=K3_BOUND, shape=[nx, P, P], ms=ms["fwd_k56"],
        plain_ms=ms["fwd_k56_plain"], library_ms=ms["fwd_k56_library"],
        **bounds["fwd_k56"], k1_ms=ms["fwd_k1"],
        k1_plain_ms=ms["fwd_k1_plain"], k1_library_ms=ms["fwd_k1_library"],
        k1_bound_ms=bounds["fwd_k1"]["bound_ms"],
        ms_cold=shape_ms["fwd_p56_k56"]["ms_cold"],
        library_ms_cold=shape_ms["fwd_p56_k56"]["library_ms_cold"],
        edge_cases=edge["cases"], edge_max_rel_err=edge["max_rel_err"],
        path_shapes={k: v for k, v in shape_ms.items()
                     if k.startswith("fwd")})
    results["trsm_bwd"] = dict(
        name="trsm_bwd", route="cuda", source=src, replaces=f"{ref_file}:102",
        max_abs_err=max(abs_errs[k] for k in bwd_keys),
        max_rel_err=max(errs[k] for k in bwd_keys),
        tolerance=K3_BOUND, shape=[nx, P, 1], ms=ms["bwd_k1"],
        plain_ms=ms["bwd_k1_plain"], library_ms=ms["bwd_k1_library"],
        **bounds["bwd_k1"], ms_cold=shape_ms["bwd_p56_k1"]["ms_cold"],
        library_ms_cold=shape_ms["bwd_p56_k1"]["library_ms_cold"],
        path_shapes={k: v for k, v in shape_ms.items()
                     if k.startswith("bwd")})
    results.setdefault("cholesky", {}).update(
        panel_shape=[nx, P, P], panel_ms=ms["chol_panel"],
        panel_plain_ms=ms["chol_panel_plain"],
        panel_library_ms=ms["chol_panel_library"],
        panel_bound_ms=bounds["chol_panel"]["bound_ms"],
        panel_max_rel_err=max(k2_errs.values()))


def _rts96_step(sys96, seed: int) -> dict:
    """One RTS-96 study step's LP buffer as ``run_nsq_study`` builds it:
    batch 8192, "lp" nodal mode, the default max_lp (2048) and
    woodbury_k, the calibrated shed hint, and the states that need the
    LP compacted first (``dcopf.evaluate_states_screened``)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    batch = 8192
    max_lp = hl2_nsq.default_max_lp(batch, "lp")
    wk = hl2_nsq.default_woodbury_k(sys96)
    hint = dcopf.calibrate_shed_hint(sys96)
    rbuf = dcopf.default_repair_buffer(batch, hinted=hint is not None)
    load = sys96.load_pd[None, :].expand(batch, sys96.n_load)
    hint_b = None if hint is None else torch.as_tensor(
        hint, device="cuda")[None, :].expand(batch, sys96.n_load)
    down = sample_states(hl2_nsq.batch_generator(seed, 0, "cuda"),
                         sys96.unavail, sys96.always_up_nsq, batch)
    pre = dcopf.certify_states(sys96, down, load, shed_hint=hint_b,
                               repair_buffer=rbuf, woodbury_k=wk)
    need = ~(pre.certified & (pre.deficit <= 0))
    idx = dcopf._topk_lanes(need, max_lp)
    up = 1.0 - down[idx].float()
    lp = dcopf.build_state_lp(
        sys96, up[:, :sys96.n_gen], up[:, sys96.n_gen:].contiguous(),
        load[idx], CompatFlags(), IPMConfig().theta_max)
    return dict(batch=batch, max_lp=max_lp, wk=wk, hint=hint, rbuf=rbuf,
                load=load, hint_b=hint_b, down=down, need=need, idx=idx,
                lp=lp, n_need=min(int(need.sum()), max_lp))


def phase_study96(sys96, results):
    import math
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        blocked_chol as bl)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        MCSConfig)
    ref = json.loads((ROOT / "results" / "study_sweep.json")
                     .read_text())["rts96"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = hl2_nsq.run_nsq_study(
        cases.rts96(), MCSConfig(max_samples=40960, beta_limit=0.0),
        device="cuda", log_every=0)
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    resc = {k: int(v) for k, v in bl.rescues.items()}
    # The reference ran with antithetic pairing (same expectation); its
    # EDNS standard error is beta * EDNS, its PLC's binomial.
    se_e = math.hypot(ref["beta"] * ref["edns_mw"], res.beta * res.edns_mw)
    plc_ref = ref["lole_hr_yr"] / 8760
    se_p = math.hypot(
        math.sqrt(plc_ref * (1 - plc_ref) / ref["samples"]),
        math.sqrt(res.plc * (1 - res.plc) / res.samples))
    z_e = abs(res.edns_mw - ref["edns_mw"]) / se_e
    z_l = abs(res.plc - plc_ref) / se_p
    share = resc["lanes"] / max(resc["lanes_factored"], 1)
    _line("study96", samples=res.samples, edns_mw=f"{res.edns_mw:.4f}",
          lole_hr_yr=f"{res.lole_hr_yr:.2f}", beta=f"{res.beta:.5f}",
          edns_z=f"{z_e:.2f}<=4", lole_z=f"{z_l:.2f}<=4",
          overflow=res.overflow_states, wall_s=f"{wall:.2f}",
          peak_mem_bytes=peak,
          launches=json.dumps(counts).replace(" ", ""),
          rescue_factorizations=resc["factorizations"],
          flagged_lanes=resc["lanes_flagged"], rescued_lanes=resc["lanes"],
          lanes_factored=resc["lanes_factored"],
          rescued_share_all_lanes=f"{share:.4f}")
    _check_launched("study96", counts, RTS96_KERNELS)
    if not (z_e <= 4 and z_l <= 4):
        raise RuntimeError("study96: estimates outside 4 combined standard "
                           "errors of results/study_sweep.json['rts96']")
    for name in ("trsm_fwd", "trsm_bwd"):
        results.setdefault(name, {})["launches"] = counts[name]
    results.setdefault("cholesky", {})["launches_rts96"] = counts["cholesky"]
    _rescue_check(sys96)


def _rescue_check(sys96):
    """The rescued share at the reference's level on the same matrices
    (after the counted study run): every matrix one study-shaped LP
    buffer factors, probed on the kernels and on the plain versions,
    whose probe tests/test_torch_blocked_chol.py holds to the
    reference's lane for lane. Shares over the lanes that need the LP
    (the first n_need of the buffer) and over all factored lanes."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb)
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        blocked_chol as bl)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    st = _rts96_step(sys96, seed=5)
    mats: list = []
    with _capturing_blocked_factor(mats):
        lpb.solve_box_lp_batched(*st["lp"], IPMConfig())
    flag_k, flag_p = [], []
    for M in mats:
        flag_k.append(bl._probe(*bl._factor_once(M), M))
        with _plain_blocked_kernels():
            flag_p.append(bl._probe(*bl._factor_once(M), M))
    del mats
    fk, fp = torch.stack(flag_k), torch.stack(flag_p)  # [factor., lanes]
    nn = st["n_need"]
    share = lambda f: (float(f[:, :nn].float().mean()),
                       float(f.float().mean()))
    (need_k, all_k), (need_p, all_p) = share(fk), share(fp)
    split = fk != fp
    split_need, split_all = int(split[:, :nn].sum()), int(split.sum())
    lim_need = RESCUE_DIFF_BOUND * fk.shape[0] * nn
    lim_all = RESCUE_DIFF_BOUND * fk.numel()
    _line("rescue96", factorizations=fk.shape[0],
          lanes=fk.shape[1], needy_lanes=nn,
          flagged_share_needy_kernel=f"{need_k:.4f}",
          flagged_share_needy_plain=f"{need_p:.4f}",
          flagged_share_all_kernel=f"{all_k:.4f}",
          flagged_share_all_plain=f"{all_p:.4f}",
          split_needy=f"{split_need}<={lim_need:.0f}",
          split_all=f"{split_all}<={lim_all:.0f}")
    if split_need > lim_need or split_all > lim_all:
        raise RuntimeError("rescue96: the probe on the kernels flags other "
                           "lanes than the probe on the plain versions")


def _cert_work(sys_, n_lanes, n_elig, flow_lanes=0, repair_steps=0,
               single=0, pairs=0):
    """Float32 operations a certificate kernel needs for this run's data
    (csrc/lane_common.cuh; K4's draws are counted apart,
    :func:`_philox_ops`): per lane the deficit, the candidate and the
    dispatch; per lane with a flow check (n_out <= 1) the injections and
    one [nb] x [nb, nl] PTDF product (``flow_lanes`` counts a second, the
    K4 guard band's); per executed repair step the gradient's PTDF
    product, the moves and a new flow check; per single or double outage
    lane its LODF / Woodbury update. The one-hot products are gathers and
    sums, counted as adds."""
    ng, nd, nl, nb = sys_.n_gen, sys_.n_load, sys_.n_branch, sys_.n_bus
    base = 2 * ng + 10 * nd + 11 * ng + 3 * nb
    check = (ng + nd + 2 * nb) + 2 * nb * nl + 3 * nl
    step = 2 * nb * nl + 12 * (ng + nd) + 8 * nl + check
    return (n_lanes * base + n_elig * check + flow_lanes * 2 * nb * nl
            + repair_steps * step + single * 6 * nl + pairs * (30 + 6 * nl))


# 32-bit integer operations of one Philox4x32-10 call and its four draws
# (csrc/philox.cuh): per round 2 umulhi, 2 multiplies and 4 xors (two
# three-way xors), the two key adds of rounds 1-9, then a shift and a
# compare per draw. A row of n_comp components makes ceil(n_comp / 4)
# calls. The bound counts them at the float32 rate: the data sheet gives
# no INT32 rate outside the tensor cores, and an integer operation is no
# faster than a float32 one.
PHILOX_CALL_OPS = 10 * (2 + 2 + 4) + 9 * 2 + 4 * 2


def _philox_ops(n_rows, n_comp):
    """Integer operations of ``n_rows`` rows of K6's / K4's draws."""
    return n_rows * ((n_comp + 3) // 4) * PHILOX_CALL_OPS


def phase_k6(sys_, results):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        hw_sampler as hw)
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    B, nc = 262144, sys_.n_comp
    thresh = hw.bernoulli_thresholds(sys_.unavail, sys_.always_up_nsq)
    diffs = []
    for seed in (0, 1):
        seeds = hw.seed_words(hl2_nsq.batch_generator(seed, 0, "cuda"),
                              "cuda")
        k, p = hw.launch(seeds, thresh, B), hw.sample_states_hw_plain(
            seeds, thresh, B)
        diffs.append(int((k != p).sum()))
    # The law: 2^22 rows against P(fail) = thresh / 2^24.
    big = hw.launch(seeds, thresh, 1 << 22)
    prob = thresh.double() / 2.0 ** 24
    rate = big.sum(0).double() / big.shape[0]
    sd = torch.sqrt(prob * (1 - prob) / big.shape[0])
    z = torch.where(prob > 0, (rate - prob) / sd.clamp_min(1e-300), 0.0)
    max_z = float(z.abs().max())
    pinned = int(big[:, sys_.always_up_nsq].sum())
    del big
    gen = torch.Generator(device="cuda").manual_seed(4)
    u, up = sys_.unavail, sys_.always_up_nsq
    ms = _time_ms(lambda: hw.launch(seeds, thresh, B))
    dev_ms = _graph_ms(lambda: hw.launch(seeds, thresh, B), [()])
    plain_ms = _time_ms(lambda: hw.sample_states_hw_plain(seeds, thresh, B),
                        reps=3)
    lib_ms = _time_ms(lambda: (torch.rand((B, nc), generator=gen,
                                          device="cuda") < u) & ~up)
    # The path: rng_impl="hw" sampling at the bench shape.
    _reset_counts()
    down = sample_states(hl2_nsq.batch_generator(0, 5, "cuda"), u, up, B,
                         rng_impl="hw")
    torch.cuda.synchronize()
    counts = _counts()
    # The wrapper's own key drawing and thresholds against the plain bits.
    path_diff = int((down != hw.sample_states_hw_plain(hw.seed_words(
        hl2_nsq.batch_generator(0, 5, "cuda"), "cuda"), thresh, B)).sum())
    # bool out, thresholds, key; the draws' integer operations
    bound = _bound(_philox_ops(B, nc), B * nc + 4 * nc + 8)
    _line("k6", shape=(B, nc), differing_entries=diffs,
          max_abs_z=f"{max_z:.2f}<={K6_MAX_Z}", pinned_failures=pinned,
          draws=1 << 22, kernel_ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}",
          library_ms=f"{lib_ms:.4f}",
          bound_ms=f"{bound['bound_ms']:.4f}({bound['bound_by']})",
          bound_share=f"{bound['bound_ms'] / dev_ms:.4f}",
          path_launches=counts["sample_states_hw"],
          path_differing_entries=path_diff,
          path_fail_rate=f"{float(down.float().mean()):.5f}")
    _check_launched("k6", counts, ("sample_states_hw",))
    if any(diffs) or path_diff or max_z > K6_MAX_Z or pinned:
        raise RuntimeError("k6: kernel differs from its plain version, or "
                           "its failure rates miss the law")
    results["sample_states_hw"] = dict(
        name="sample_states_hw", route="cuda",
        source=f"{PKG}/csrc/hw_sampler.cu",
        replaces="powersystemsreliabilityassessment_tpu/ops/hw_sampler.py:89",
        launches=counts["sample_states_hw"], max_abs_err=0.0,
        differing_entries=sum(diffs) + path_diff, tolerance=0, shape=[B, nc], ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_z=max_z, **bound)


# K4's shapes: the fused bench step's batch and the fused study's
# (MCSConfig.batch_size).
K4_LANES = (262144, 8192)


def phase_k4(sys_, results):
    """K4 at both of its path's shapes; the first is the kernel's entry
    in the JSON line, the second's times ride along under ``*_8192``."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    hint = torch.as_tensor(dcopf.calibrate_shed_hint(sys_), device="cuda")
    entry = {}
    for B in K4_LANES:
        got = _k4_check(sys_, B, hint)
        if not entry:
            entry = got
        else:
            entry.update({f"{k}_{B}": got[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "first_pass_agree", "lanes_per_block", "threads_per_lane")})
    results["sample_certify_quick"] = dict(
        results.get("sample_certify_quick", {}), **entry)


def _k4_check(sys_, B, hint):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        certify_kernel as ck, fused_sampler_cert as ff, hw_sampler as hw)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    nc, ng = sys_.n_comp, sys_.n_gen
    gen = lambda: hl2_nsq.batch_generator(0, 7, "cuda")
    down, ok1, deficit, shed = ff.sample_certify_quick(gen(), sys_, B,
                                                       shed_hint=hint)
    seeds = hw.seed_words(gen(), "cuda")
    thresh = hw.bernoulli_thresholds(sys_.unavail, sys_.always_up_nsq)
    k6_down = hw.launch(seeds, thresh, B)
    p_down, p_ok1, p_def, p_shed = ff.sample_certify_quick_plain(
        sys_, B, seeds, thresh, hint=hint)
    ops = ff.kernel_operands(sys_, hint)
    e_down, e_ok1, _, _ = ff.launch(sys_, B, None, down, ops)
    w_ok1 = ff.launch(sys_, B, seeds, None, ops, eps=K4_WIDE_EPS)[1]
    w_p_ok1 = ff.sample_certify_quick_plain(sys_, B, seeds, thresh,
                                            hint=hint, eps=K4_WIDE_EPS)[1]
    load = sys_.load_pd[None, :].expand(B, sys_.n_load)
    hint_b = hint[None, :].expand(B, sys_.n_load)
    cert = dcopf.certify_states(sys_, down, load, shed_hint=hint_b)
    first = dcopf.certify_states(sys_, down, load, shed_hint=hint_b,
                                 repair_iters=0).certified
    n_out = down[:, ng:].sum(1)
    first = first & (n_out <= 1)
    fin = dcopf.certify_finish(sys_, down, load, deficit, shed, ok1, B)
    torch.cuda.synchronize()
    states_equal = bool(torch.equal(down, k6_down)
                        and torch.equal(down, p_down)
                        and torch.equal(e_down, down))
    explicit_equal = bool(torch.equal(e_ok1, ok1))
    def_err = float((deficit - p_def).abs().max())
    shed_err = float((shed - p_shed).abs().max())
    agree = float((ok1 == p_ok1).float().mean())
    unsound = int((ok1 & ~cert.certified).sum())
    fin_diff = int((fin.certified != cert.certified).sum())
    routed = int((first & ~ok1).sum())
    wide_agree = float((w_ok1 == w_p_ok1).float().mean())
    wide_routed = int((first & ~w_ok1).sum())
    wide_unsound = int((w_ok1 & ~cert.certified).sum())
    # Times: the kernel alone (prepared operands), its plain version, and
    # certify_states' first pass (context: no library call computes K4).
    ms = _time_ms(lambda: ff.launch(sys_, B, seeds, None, ops))
    plain_ms = _time_ms(lambda: ff.sample_certify_quick_plain(
        sys_, B, seeds, thresh, hint=hint), reps=3)
    first_ms = _time_ms(lambda: dcopf.certify_states(
        sys_, down, load, shed_hint=hint_b, repair_iters=0), reps=5)
    n_elig = int((n_out <= 1).sum())
    flops = _cert_work(sys_, B, n_elig, flow_lanes=n_elig,
                       single=int((n_out == 1).sum())) + _philox_ops(B, nc)
    nbytes = B * nc + B * (1 + 4 + 4 * sys_.n_load) + 4 * ops[0].numel() \
        + 4 * ops[1].numel() + 4 * nc + 8
    bound = _bound(flops, nbytes)
    lanes, stage, smem = ff.launch_shape(
        ng, sys_.n_load, sys_.n_branch, sys_.n_bus, B,
        torch.cuda.get_device_properties(0).multi_processor_count)
    _line("k4", lanes=B, states_equal_k6_and_plain=states_equal,
          explicit_mode_mask_equal=explicit_equal,
          deficit_err=f"{def_err:.3e}<={CERT_DEF_BOUND}",
          shed_err=f"{shed_err:.3e}<={QUICK_PATTERN_BOUND}",
          first_pass_agree=f"{agree:.6f}>={QUICK_AGREE}",
          first_pass_certified=int(ok1.sum()),
          first_pass_outside_certify_states=f"{unsound}==0",
          finish_lanes_differing=f"{fin_diff}<={int((1 - CERT_AGREE) * B)}",
          band_routed_lanes=routed,
          band_routed_share=f"{routed / B:.6f}",
          band_routed_share_of_first_pass=f"{routed / max(int(first.sum()), 1):.6f}",
          wide_band_eps=f"{K4_WIDE_EPS:.4e}",
          wide_band_agree=f"{wide_agree:.6f}>={QUICK_AGREE}",
          wide_band_routed_share=f"{wide_routed / B:.6f}>{K4_WIDE_MIN_ROUTED}",
          wide_band_outside_certify_states=f"{wide_unsound}==0",
          eps=f"{ff.guard_eps(sys_):.4e}",
          lanes_per_block=lanes,
          threads_per_lane=1 << (stage >> ff.SPLIT_SHIFT),
          lodf_staged=bool(stage & ck.STAGE_LODF), smem_bytes=smem,
          kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          certify_states_first_pass_ms=f"{first_ms:.4f}",
          bound_ms=f"{bound['bound_ms']:.4f}({bound['bound_by']})",
          bound_share=f"{bound['bound_ms'] / ms:.4f}")
    if not (states_equal and explicit_equal and def_err <= CERT_DEF_BOUND
            and shed_err <= QUICK_PATTERN_BOUND and agree >= QUICK_AGREE
            and unsound == 0 and fin_diff <= (1 - CERT_AGREE) * B
            and wide_agree >= QUICK_AGREE and wide_unsound == 0
            and wide_routed > K4_WIDE_MIN_ROUTED * B):
        raise RuntimeError(f"k4 ({B} lanes): kernel disagrees with its "
                           "plain version, with K6, or with "
                           "certify_states, or the wide band routes too "
                           "few lanes to test it")
    return dict(
        name="sample_certify_quick", route="cuda",
        source=f"{PKG}/csrc/fused_sampler_cert.cu",
        replaces="powersystemsreliabilityassessment_tpu/ops/fused_sampler_cert.py:259",
        max_abs_err=max(def_err, shed_err), tolerance=CERT_DEF_BOUND,
        first_pass_agree=agree, band_routed_share=routed / B,
        wide_band_agree=wide_agree, wide_band_routed_share=wide_routed / B,
        finish_lanes_differing=fin_diff, shape=[B, nc], ms=ms,
        plain_ms=plain_ms, library_ms=None,
        certify_states_first_pass_ms=first_ms, lanes_per_block=lanes,
        threads_per_lane=1 << (stage >> ff.SPLIT_SHIFT), **bound)


def _stressed_states(n, seed):
    """tests/test_torch_gpu.py::_stressed_states: 3x unavailability, three
    branch outages on every 32nd lane (numpy)."""
    import numpy as np
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    case = cases.rts24()
    u = twostate.unavailability(case)
    rng = np.random.default_rng(seed)
    down = rng.uniform(size=(n, case.n_comp)) < 3 * u[None, :]
    down[:, 14] = False
    for lane in range(0, n, 32):
        down[lane, case.n_gen + rng.choice(case.n_branch, 3,
                                           replace=False)] = True
    return down


def _k5_check(tag, sys_, down, def_bound, def_rtol=0.0):
    """K5 against certify_states(woodbury_k=2) on one batch; returns the
    errors, the launch shape, the lanes the kernel queues for repair and
    the work this batch's data needs."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        certify_kernel as ck)
    B, ng = down.shape[0], sys_.n_gen
    load = sys_.load_pd[None, :].expand(B, sys_.n_load)
    ops = ck.kernel_operands(sys_)
    got = dcopf.Certificate(*ck.launch(sys_, down, load, 3, ops))
    want = dcopf.certify_states(sys_, down, load, woodbury_k=2)
    # Repair steps this batch's data runs: an eligible lane the first
    # check fails (the kernel queues it) runs steps until one passes, at
    # most three.
    n_out = down[:, ng:].sum(1)
    elig = n_out <= 1
    failing = [elig & ~dcopf.certify_states(
        sys_, down, load, repair_iters=k, woodbury_k=2).certified
        for k in range(3)]
    steps = sum(int(f.sum()) for f in failing)
    queued = int(failing[0].sum())
    repaired = int((failing[0] & want.certified).sum())
    torch.cuda.synchronize()
    differ = int((got.certified != want.certified).sum())
    # max over lanes of |delta| - rtol |deficit|, against def_bound
    def_err = float(((got.deficit - want.deficit).abs()
                     - def_rtol * want.deficit.abs()).max())
    both = got.certified & want.certified
    pat_err = max(float((a - b).abs()[both].max())
                  for a, b in ((got.shed, want.shed),
                               (got.dispatch, want.dispatch)))
    flops = _cert_work(sys_, B, int(elig.sum()), repair_steps=steps,
                       single=int((n_out == 1).sum()),
                       pairs=int((n_out == 2).sum()))
    nbytes = B * (sys_.n_comp + 4 * sys_.n_load + 1 + 4
                  + 4 * sys_.n_load + 4 * ng) + 4 * ops[0].numel() \
        + 4 * ops[1].numel()
    lanes, stage, smem = ck.launch_shape(
        ng, sys_.n_load, sys_.n_branch, sys_.n_bus, B,
        ck.sm_count(down.device))
    shape = dict(lanes_per_block=lanes,
                 threads_per_lane=1 << (stage >> ck.SPLIT_SHIFT & 3),
                 lodf_staged=bool(stage & ck.STAGE_LODF),
                 transfer_staged=bool(stage & ck.STAGE_TRANSFER),
                 smem_bytes=smem)
    _line("k5", batch=tag, lanes=B,
          lanes_differing=f"{differ}<={int((1 - CERT_AGREE) * B)}",
          certified=int(got.certified.sum()),
          deficit_err=f"{def_err:.3e}<={def_bound}(rtol={def_rtol})",
          pattern_err=f"{pat_err:.3e}<={CERT_PATTERN_BOUND}",
          queued_for_repair=queued, repaired=repaired,
          queued_share=f"{queued / B:.5f}", repair_steps=steps,
          double_outage_lanes=int((n_out == 2).sum()), **shape)
    if differ > (1 - CERT_AGREE) * B or def_err > def_bound \
            or pat_err > CERT_PATTERN_BOUND:
        raise RuntimeError(f"k5 ({tag}): kernel disagrees with "
                           "certify_states")
    return dict(ops=ops, load=load, flops=flops, nbytes=nbytes,
                differ=differ, def_err=def_err, pat_err=pat_err,
                queued=queued, **shape)


def phase_k5(sys_, sys96, results):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        certify_kernel as ck)
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    B = 262144
    down = sample_states(hl2_nsq.batch_generator(0, 11, "cuda"),
                         sys_.unavail, sys_.always_up_nsq, B)
    main = _k5_check("rts24_plain_mc", sys_, down, CERT_DEF_BOUND)
    stressed = torch.as_tensor(_stressed_states(65536, 23), device="cuda")
    checks = [main, _k5_check("rts24_stressed", sys_, stressed,
                              CERT_DEF_BOUND)]
    gen = torch.Generator(device="cuda").manual_seed(96)
    u96 = torch.clamp(sys96.unavail * 10.0, max=0.5)
    down96 = (torch.rand((8192, sys96.n_comp), generator=gen,
                         device="cuda") < u96) & ~sys96.always_up_nsq
    c96 = _k5_check("rts96_10x", sys96, down96, CERT_DEF_BOUND_96,
                    CERT_DEF_BOUND_96)
    checks.append(c96)
    load = main["load"]
    call = lambda: ck.launch(sys_, down, load, 3, main["ops"])
    call96 = lambda: ck.launch(sys96, down96, c96["load"], 3, c96["ops"])
    ms, ms96 = _time_ms(call), _time_ms(call96)
    dev_ms, dev96 = _graph_ms(call, [()]), _graph_ms(call96, [()])
    plain_ms = _time_ms(lambda: dcopf.certify_states(
        sys_, down, load, woodbury_k=2), reps=5)
    plain96 = _time_ms(lambda: dcopf.certify_states(
        sys96, down96, c96["load"], woodbury_k=2), reps=3)
    bound, bound96 = (_bound(c["flops"], c["nbytes"]) for c in (main, c96))
    # The path: the public entry point on the plain-MC batch.
    _reset_counts()
    ck.certify_states_fused(sys_, down, load)
    torch.cuda.synchronize()
    counts = _counts()
    _line("k5", kernel_ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}",
          bound_ms=f"{bound['bound_ms']:.4f}({bound['bound_by']})",
          bound_share=f"{bound['bound_ms'] / dev_ms:.4f}",
          rts96_kernel_ms=f"{ms96:.4f}", rts96_device_ms=f"{dev96:.4f}",
          rts96_plain_ms=f"{plain96:.4f}",
          rts96_bound_ms=f"{bound96['bound_ms']:.4f}({bound96['bound_by']})",
          rts96_bound_share=f"{bound96['bound_ms'] / dev96:.4f}",
          path_launches=counts["certify_states_fused"])
    _check_launched("k5", counts, ("certify_states_fused",))
    results["certify_states_fused"] = dict(
        name="certify_states_fused", route="cuda",
        source=f"{PKG}/csrc/certify_kernel.cu",
        replaces="powersystemsreliabilityassessment_tpu/ops/certify_kernel.py:208",
        launches=counts["certify_states_fused"],
        max_abs_err=max(max(c["def_err"], c["pat_err"]) for c in checks),
        lanes_differing=[c["differ"] for c in checks],
        queued_for_repair=[c["queued"] for c in checks],
        tolerance=CERT_PATTERN_BOUND, shape=[B, sys_.n_comp], ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, library_ms=None, **bound,
        lanes_per_block=main["lanes_per_block"],
        threads_per_lane=main["threads_per_lane"], rts96_ms=ms96,
        rts96_device_ms=dev96, rts96_plain_ms=plain96,
        rts96_bound_ms=bound96["bound_ms"])


def _seq_lp_lanes(sys_, n_lanes: int, seed: int):
    """Structured LP inputs (colscale, br_up, c, b, l, u) of ``n_lanes``
    real SEQ LP lanes: hour-states of the port's own 16-year blocks
    (``hl2_seq.sample_years``, the study's load profile) that the
    certificate leaves uncertified or with a deficit, the lanes
    ``evaluate_years`` sends to the LP in "lp" nodal mode; then the
    years drawn and the lanes' (outage states, loads)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    years, hours = 16, 8736
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(hours),
                                   years)
    downs, loads, got, block = [], [], 0, 0
    while got < n_lanes:
        flat = hl2_seq.sample_years(
            hl2_nsq.batch_generator(seed, block, "cuda"), sys_, years, hours,
            k).transpose(1, 2).reshape(years * hours, -1)
        cert = dcopf.certify_states(sys_, flat, load,
                                    repair_buffer=years * hours // 16)
        idx = torch.nonzero((~cert.certified) | (cert.deficit > 0)).flatten()
        downs.append(flat[idx])
        loads.append(load[idx])
        got += idx.numel()
        block += 1
    down, load = torch.cat(downs)[:n_lanes], torch.cat(loads)[:n_lanes]
    up = 1.0 - down.float()
    gen_up, br_up = up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous()
    c, b, l, u, colscale = dcopf.build_state_lp_vectors(
        sys_, gen_up, br_up, load, CompatFlags(), IPMConfig().theta_max)
    return (colscale, br_up, c, b, l, u), block * years, (down, load)


def _seq_step_line(sys_, years: int, reps: int = 8):
    """The SEQ step at ``years`` years a step: wall ms (the steps run
    under torch.cuda.set_sync_debug_mode("error"), so any host sync in
    the step raises), device ms (the sum of kernel events of
    torch.profiler), hour-states a second and the device busy share."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    hours, max_lp = 8736, 256
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    step = hl2_seq.make_seq_batch_step(
        sys_, years, CompatFlags(), IPMConfig(), hours, k, max_lp,
        load_profile.load_factors(hours))
    seeds = iter(range(10**6))
    gen = lambda: hl2_nsq.batch_generator(3, next(seeds), "cuda")
    torch.cuda.reset_peak_memory_stats()
    out = step(gen())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(reps):
            out = step(gen())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    _, dev, n_kernels, _ = _measure(lambda: step(gen()), reps=4)
    if not bool(torch.isfinite(out[0]).all()) or int(out[8]) != 0:
        raise RuntimeError(f"seq: step at {years} years: non-finite ENS or "
                           f"{int(out[8])} overflow hours")
    row = dict(years=years, hour_states=years * hours,
               lp_lanes=years * max_lp, wall_ms=wall, device_ms=dev,
               hour_states_per_s=years * hours / wall * 1e3,
               device_busy_share=dev / wall, kernel_launches=n_kernels,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    _line("seq", step_years=years, **{
        k: (f"{v:.4f}" if isinstance(v, float) else v)
        for k, v in row.items() if k != "years"})
    return row


def phase_seq(sys_, results):
    """The SEQ study on RTS-24 to its CoV stop, held against
    results/seq_results.json; K1, K2a and K2b at the study's LP buffer
    (4,096 real SEQ lanes) against their plain versions; the SEQ step's
    times at 16 years a step (the default) and at 64."""
    import math
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, ipm_fused)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_seq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig, MCSConfig)
    ref = json.loads((ROOT / "results" / "seq_results.json").read_text())
    years_per_step = 16
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with _guard_counter() as guard:
        res = hl2_seq.run_seq_study(cases.rts24(), MCSConfig(seed=1),
                                    device="cuda", log_every=0,
                                    years_per_device=years_per_step)
    wall = time.perf_counter() - t0
    counts = _counts()
    steps = res.years // years_per_step
    se = lambda v: float(np.std(v, ddof=1) / math.sqrt(len(v)))
    z = {"eens": abs(res.eens_mwh_yr - ref["eens_mwh_yr"]) / math.hypot(
        se(ref["annual_ens"]), se(res.annual_ens))}
    # results/seq_results.json keeps no per-year DLC or NLC: their
    # reference standard error is taken equal to the port's.
    for key, field, per_year in (("lole", "lole_hr_yr", res.annual_dlc),
                                 ("lolf", "lolf_occ_yr", res.annual_nlc)):
        z[key] = abs(getattr(res, field) - ref[field]) / (
            math.sqrt(2.0) * se(per_year))
    _line("seq", study_years=res.years, steps=steps,
          converged=res.converged, eens_mwh_yr=f"{res.eens_mwh_yr:.4f}",
          lole_hr_yr=f"{res.lole_hr_yr:.4f}",
          lolf_occ_yr=f"{res.lolf_occ_yr:.4f}", cov=f"{res.cov:.5f}",
          eens_z=f"{z['eens']:.2f}<=4", lole_z=f"{z['lole']:.2f}<=4",
          lolf_z=f"{z['lolf']:.2f}<=4",
          lole_lolf_ref_se="port's", overflow_hours=res.overflow_hours,
          infeasible_hours=res.infeasible_hours, wall_s=f"{wall:.2f}",
          peak_mem_bytes=torch.cuda.max_memory_allocated(),
          lp_lanes_past_guard=_guard_text(guard),
          launches=json.dumps(counts).replace(" ", ""))
    _check_launched("seq", counts, RTS24_KERNELS)
    low = [k for k, per in (("fused_ipm_iterations", 1), ("cholesky", 2),
                            ("cho_solve", 3)) if counts[k] < per * steps]
    if low:
        raise RuntimeError(f"seq: {low} launched on fewer than every one of "
                           f"{steps} steps")
    if not (res.converged and all(v <= 4 for v in z.values())
            and np.isfinite(res.nodal_eens_mwh_yr).all()):
        raise RuntimeError("seq: the study did not converge, or EENS / LOLE "
                           "/ LOLF fall outside 4 combined standard errors "
                           "of results/seq_results.json")
    for name in RTS24_KERNELS:
        results.setdefault(name, {})["launches_seq_study"] = counts[name]

    # The kernels at the SEQ step's LP buffer: 256 lanes a year x 16.
    n = 256 * years_per_step
    lanes, years_drawn, _ = _seq_lp_lanes(sys_, n, seed=11)
    _line("seq", lp_lanes=n, years_drawn=years_drawn,
          lanes_per_year=f"{n / years_drawn:.2f}")
    st = ipm_fused.build_structure(sys_)
    cfg = IPMConfig()
    k1 = _k1_shape(sys_, st, n, cfg, args=lanes, tag="seq", guarded=True)
    k1["device_ms"] = _graph_ms(
        lambda *a: ipm_fused.fused_ipm_iterations(st, *a, cfg), [lanes],
        calls=4, replays=3)
    k1["bound_share"] = k1["bound_ms"] / k1["device_ms"]
    _line("seq", k1_lanes=n, device_ms=f"{k1['device_ms']:.4f}",
          bound_share_of_device=f"{k1['bound_share']:.4f}", library_ms=None)
    M = _polish_factor_inputs(st, lanes)
    r = torch.randn(M.shape[:2], generator=torch.Generator(
        device="cuda").manual_seed(12), device="cuda")
    rows = {"chol_seq": _k2_row("seq", "chol_seq", "cholesky", (M,), (M,))}
    solve = (bc.cholesky_plain(M), r)
    rows["solve_seq"] = _k2_row("seq", "solve_seq", "cho_solve", solve,
                                solve)
    _check_k2_rows("seq", rows)
    k1_err = max(k1["objective_err_pu"], k1["best_score_err"])
    entry = results.setdefault("fused_ipm_iterations", {})
    entry["seq_shape"] = k1
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), k1_err)
    for kind, name in (("cholesky", "chol_seq"), ("cho_solve", "solve_seq")):
        entry = results.setdefault(kind, {})
        entry.setdefault("path_shapes", {})[name] = rows[name]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                                   rows[name]["abs_err"])
        entry["max_rel_err"] = max(entry.get("max_rel_err", 0.0),
                                   rows[name]["rel_err"])

    # The step: the default 16 years, and 64 as a measurement.
    for years in (years_per_step, 64):
        _seq_step_line(sys_, years)


# The large-m path (case300s, m = 792): scripts/parity_case300.py's 128
# stress lanes (seed 5: 64 spread, 64 concentrated), every shed and
# guard-tripped lane plus LP300_ZERO_LANES zero-shed ones held against
# float64 HiGHS within LP300_ORACLE_MW (tests/test_case300.py's bound;
# the reference: 0.033 MW over 76 lanes, results/case300_parity.json).
# No lane may stay past the evaluator's guard. 2,048 lanes (the
# reference's large-m buffer cap) is timed only.
LP300_ORACLE_MW = 1.5
LP300_ZERO_LANES = 64
LP300_LANES = (128, 2048)
LP300_KERNELS = ("cholesky", "trsm_fwd", "trsm_bwd")


def _stress300_states(case, seed: int = 5):
    """[128, n_comp] float32 outage states of scripts/parity_case300.py's
    ``make_states``: 64 spread (2-4 lines, 3-8 units anywhere), then 64
    concentrated (6-14 units and 0-3 lines inside one RTS-24 area)."""
    import numpy as np
    ng, nl = case.n_gen, case.n_branch
    rng = np.random.default_rng(seed)
    states = np.zeros((128, ng + nl), np.float32)
    for i in range(64):
        for j in rng.choice(nl, rng.integers(2, 5), replace=False):
            states[i, ng + j] = 1.0
        for j in rng.choice(ng, rng.integers(3, 9), replace=False):
            states[i, j] = 1.0
    area_ng, area_nl, n_areas = 33, 38, 12
    for i in range(64, 128):
        a = int(rng.integers(n_areas))
        gs = rng.choice(area_ng, rng.integers(6, 15), replace=False)
        states[i, a * area_ng + gs] = 1.0
        nlo = int(rng.integers(0, 4))
        if nlo:
            ls = rng.choice(area_nl, nlo, replace=False)
            states[i, ng + a * area_nl + ls] = 1.0
    return states


def _oracle300(case, states, dns, tripped):
    """Float64 HiGHS DNS (MW, the 0.1 MW noise floor applied) of every
    shed or guard-tripped lane and LP300_ZERO_LANES zero-shed lanes
    (scripts/probe_oracle_diff.py's choice): (lanes, max |error| MW)."""
    import numpy as np
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags)
    idx = list(np.nonzero(dns > 0)[0]) + list(np.nonzero(tripped)[0])
    zeros = np.nonzero(dns == 0)[0]
    rng = np.random.default_rng(1)
    idx += list(rng.choice(zeros, min(LP300_ZERO_LANES, len(zeros)),
                           replace=False))
    idx = list(dict.fromkeys(int(i) for i in idx))
    ref = _highs300(build_system(case, device="cpu"), states, idx)
    ref = np.where(ref < CompatFlags().dns_noise_floor_mw, 0.0, ref)
    return len(idx), float(np.abs(ref - dns[idx]).max())


def _highs300(sys_cpu, states, ids, loads=None, shed=None, slack=0.0):
    """Float64 HiGHS DNS (MW, no noise floor) of ``states[ids]`` at peak
    load, or at ``loads[ids]`` (p.u. [B, n_load]) where given, on the
    host in four threads (HiGHS releases the interpreter lock). With
    ``shed`` (p.u. [len(ids), n_load]) each load's shed is held within
    ``slack`` p.u. of it, and a lane with no such dispatch gives NaN."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from scipy.optimize import linprog
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    ng, nd = sys_cpu.n_gen, sys_cpu.n_load
    up = torch.as_tensor(1.0 - states[ids])
    load = (sys_cpu.load_pd[None, :].expand(len(ids), nd) if loads is None
            else torch.as_tensor(loads[ids]))
    c, A, b, l, u = (t.double().numpy() for t in dcopf.build_state_lp(
        sys_cpu, up[:, :ng], up[:, ng:].contiguous(), load, CompatFlags(),
        IPMConfig().theta_max))

    def dns(j):
        lo, hi = l[j].copy(), u[j].copy()
        if shed is not None:
            sl = slice(ng, ng + nd)
            hi[sl] = np.minimum(hi[sl], shed[j] + slack)
            lo[sl] = np.minimum(np.maximum(lo[sl], shed[j] - slack), hi[sl])
        r = linprog(c[j], A_eq=A[j], b_eq=b[j], bounds=list(zip(lo, hi)),
                    method="highs")
        if r.status == 2 and shed is not None:
            return float("nan")
        if r.status != 0:
            raise RuntimeError(f"HiGHS failed on lane {ids[j]}")
        return float(r.x[ng:ng + nd].sum()) * sys_cpu.base_mva

    with ThreadPoolExecutor(4) as pool:
        return np.asarray(list(pool.map(dns, range(len(ids)))))


def _schur_kernel_rows(panels):
    """K2a at the Schur inverses' panels [B, 56, 56] and [B, 20, 20], and
    K3 on identity right-hand sides at (P, K) = (56, 56) and (20, 20),
    each against its plain version, timed beside its plain version,
    one library call (cholesky_ex; solve_triangular) and its bound, at
    B = 128 (the captured lanes) and 2,048 (tiled)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, blocked_chol as bl)
    S = {p.shape[-1]: p for p in panels}     # the last panel of each width
    rows = {}
    for B in LP300_LANES:
        for P in (bl.PANEL, min(S)):
            Sp = _tile(S[P], B)
            L = bc.cholesky_plain(Sp)
            eye = torch.eye(P, device="cuda").expand(B, P, P).contiguous()
            for kind, args, kern, plain, lib, work, tol in (
                    ("cholesky", (Sp,), bc.cholesky, bc.cholesky_plain,
                     lambda M: torch.linalg.cholesky_ex(M)[0],
                     _chol_work(B, P), K2_L_BOUND),
                    ("trsm_fwd", (L, eye), bl.trsm_fwd, bl.trsm_fwd_plain,
                     lambda L_, E: torch.linalg.solve_triangular(
                         L_, E, upper=False), _trsm_work(B, P, P),
                     K3_BOUND)):
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                row = dict(kind=kind, shape=[B, P, P],
                           rel_err=_rel_err(got, want),
                           abs_err=float((got - want).abs().max()),
                           finite=bool(torch.isfinite(got).all()),
                           ms=_time_ms(lambda: kern(*args)),
                           plain_ms=_time_ms(lambda: plain(*args), reps=2),
                           library_ms=_time_ms(lambda: lib(*args)),
                           tolerance=tol, **_bound(*work))
                name = f"{'chol' if kind == 'cholesky' else 'inv'}_p{P}_b{B}"
                rows[name] = row
                _line("lp300", path_shape=name, **{
                    k: (f"{v:.3e}<={tol}" if k == "rel_err" else
                        f"{v:.4f}" if isinstance(v, float) and
                        k.endswith("ms") else
                        f"{v:.3e}" if isinstance(v, float) else v)
                    for k, v in row.items() if k != "tolerance"})
    bad = [k for k, r in rows.items()
           if not r["finite"] or r["rel_err"] > r["tolerance"]]
    if bad:
        raise RuntimeError(f"lp300: kernels disagree with their plain "
                           f"versions at {bad}")
    return rows


def _device_once(fn):
    """(device kernel ms, kernel launches, kernel events) of one call of
    ``fn`` under torch.profiler, CUDA activity only: a large-m call
    launches ~1.1e5 kernels, and host-op events would double what the
    profiler keeps and sorts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if "cuda" in str(getattr(e, "device_type", "")).lower()
               and _dev_us(e) > 0]
    if not kernels:
        raise RuntimeError("the profiler saw no device kernel")
    return (sum(_dev_us(e) for e in kernels) / 1e3,
            sum(e.count for e in kernels), kernels)


def phase_lp300(results):
    """The large-m LP path on case300s: evaluate_states on the 128 stress
    lanes (guard, HiGHS oracle, quality, wall and device ms, launches),
    the same call at 2,048 lanes (the 128 lanes tiled: wall time, and its
    guard and DNS beside the 128-lane call's, unchecked), and K2a /
    K3 at the Schur inverses' shapes against their plain versions; the
    seconds each step of the phase took."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        blocked_chol as bl)
    seconds: dict = {}
    clock = time.perf_counter()

    def lap(name):
        nonlocal clock
        now = time.perf_counter()
        seconds[name] = round(now - clock, 2)
        clock = now

    case = cases.case300s()
    sys_ = build_system(case, device="cuda")
    states = _stress300_states(case)
    panels: list = []
    rows = {}
    lap("setup")
    for B in LP300_LANES:
        tile = B // 128
        down = torch.as_tensor(np.tile(states, (tile, 1)),
                               device="cuda").bool()
        load = sys_.load_pd[None, :].expand(B, sys_.n_load)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with _capturing_panels(panels, 12 if B == 128 else 0):
            res = dcopf.evaluate_states(sys_, down, load)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        resc = {k: int(v) for k, v in bl.rescues.items()}
        _check_launched("lp300", counts, LP300_KERNELS)
        lap(f"first_call_b{B}")
        q = res.primal_residual.double().cpu().numpy()
        dns = res.dns_mw.double().cpu().numpy()
        cert = dcopf.certify_states(sys_, down, load).certified
        tripped = (q > LP_QUALITY_GUARD) & ~cert.cpu().numpy()
        row = dict(lanes=B, first_wall_ms=wall)
        if B == 128:
            # One more call for a warm wall time (the first call above
            # also captures the panels), and one under the profiler for
            # the device time. At 2,048 lanes the call is timed only: its
            # first call is warm to within 1%, and the profiler takes
            # ~25 s over the ~1.1e5 kernels of a call.
            t0 = time.perf_counter()
            dcopf.evaluate_states(sys_, down, load)
            torch.cuda.synchronize()
            row["wall_ms"] = (time.perf_counter() - t0) * 1e3
            lap(f"warm_call_b{B}")
            dev, n_kernels, kernels = _device_once(
                lambda: dcopf.evaluate_states(sys_, down, load))
            lap(f"profiled_call_b{B}")
            # K2a's and K3's device ms in the call, and the kernels that
            # take the most of it.
            mine = {name: sum(_dev_us(e) for e in kernels
                              if any(k in e.key for k in keys)) / 1e3
                    for name, keys in (
                        ("cholesky", ("cholesky_lanes_kernel",)),
                        ("trsm", ("trsm_vec_kernel", "trsm_cols_kernel")))}
            for e in sorted(kernels, key=_dev_us, reverse=True)[:8]:
                print(f"  lp300 lanes={B} kernel {_dev_us(e) / 1e3:9.3f} "
                      f"ms {e.count:6.0f}x  {e.key[:90]}")
            row.update(device_ms=dev, device_kernels=n_kernels,
                       kernel_device_ms=mine)
        row.update(finite=bool(np.isfinite(dns).all()),
                   quality_median=float(np.median(q)),
                   quality_max=float(q.max()),
                   shed_lanes=int((dns > 0).sum()),
                   guard_tripped=int(tripped.sum()),
                   launches={k: counts[k] for k in LP300_KERNELS},
                   probe_rescued_lanes=resc["lanes"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated())
        if B == 128:
            n_oracle, worst = _oracle300(case, states, dns, tripped)
            row.update(tripped_lanes=np.nonzero(tripped)[0].tolist(),
                       oracle_lanes=n_oracle, oracle_max_err_mw=worst)
            dns128 = dns
            lap("oracle_b128")
        else:
            # The same lanes tiled: what the 128-lane call solves and
            # this one does not (more hard lanes than restart_compact).
            diff = np.abs(dns - np.tile(dns128, tile))
            row.update(shed_lanes_tiled_128=int((dns128 > 0).sum()) * tile,
                       lanes_off_128_call=int(
                           (diff > LP300_ORACLE_MW).sum()),
                       max_diff_from_128_call_mw=float(diff.max()))
        rows[B] = row
        _line("lp300", **{k: (f"{v:.4e}" if k.startswith("quality") else
                              f"{v:.4f}" if isinstance(v, float) else
                              json.dumps(v).replace(" ", "")
                              if isinstance(v, (dict, list)) else v)
                          for k, v in row.items()})
        del res, down
        torch.cuda.empty_cache()
    main = rows[128]
    if not (main["finite"] and rows[2048]["finite"]
            and main["guard_tripped"] == 0
            and main["oracle_max_err_mw"] <= LP300_ORACLE_MW):
        raise RuntimeError(
            f"lp300: guard_tripped {main['guard_tripped']} (must be 0) or "
            f"oracle error {main['oracle_max_err_mw']:.4f} MW > "
            f"{LP300_ORACLE_MW}")
    kernel_rows = _schur_kernel_rows(panels)
    lap("kernel_rows")
    _line("lp300", seconds=json.dumps(seconds).replace(" ", ""),
          total_s=round(sum(seconds.values()), 2))
    src = f"{PKG}/csrc/"
    ref = "powersystemsreliabilityassessment_tpu/ops/"
    for name, kind, source, line, tol in (
            ("cholesky", "cholesky", "batched_chol.cu",
             "batched_chol.py:143", K2_L_BOUND),
            ("trsm_fwd", "trsm_fwd", "blocked_trsm.cu",
             "blocked_chol.py:97", K3_BOUND)):
        mine = {k: r for k, r in kernel_rows.items() if r["kind"] == kind}
        top = next(iter(mine.values()))
        entry = results.setdefault(name, dict(
            name=name, route="cuda", source=src + source,
            replaces=ref + line, launches=main["launches"][name],
            max_abs_err=0.0, tolerance=tol, shape=top["shape"],
            ms=top["ms"], plain_ms=top["plain_ms"],
            library_ms=top["library_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"]))
        entry["launches_lp300"] = main["launches"][name]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   *(r["abs_err"] for r in mine.values()))
        entry.setdefault("path_shapes", {}).update(mine)
    results.setdefault("trsm_bwd", dict(
        name="trsm_bwd", route="cuda", source=src + "blocked_trsm.cu",
        replaces=ref + "blocked_chol.py:102",
        launches=main["launches"]["trsm_bwd"], max_abs_err=0.0,
        ms=None, plain_ms=None, library_ms=None, bound_ms=None,
        bound_by=None))["launches_lp300"] = main["launches"]["trsm_bwd"]


PF300_BATCH = 16384
PF300_SEED = 300
PF300_ORACLE_MW = 0.05     # tests/test_island_pf.py's bound against HiGHS
PF300_DEFICIT_PU = 1e-4    # the card against the port on CPU tensors
STUDY300_SAMPLES = 262144
STUDY300_MEM_LANES = 2048  # hl2_nsq.PF_TIER_LP_CAP
# LP lanes the study may leave past the evaluator's guard, summed over its
# screened calls: 7 in two runs on the card (fault E, ROADMAP Queue 3),
# and one lane of room for the rounding order.
STUDY300_PAST_GUARD_MAX = 8
# The case300s SEQ study (seq300, seq300full) may leave at most this share
# of its LP lanes past the guard: the NSQ study's 17 of 563 (3.0%) on the
# card (fault E), with room; the SEQ lanes measured 0 of 55,076 over the
# 256-year record (seq300full, NVIDIA H100 80GB HBM3).
SEQ300_PAST_GUARD_SHARE = 0.05
# Study batches timed alone: 1 takes the rescue ladder and the
# escalation passes (a lane stays past escalate_tol after the ladder), 0
# the ladder only, as 12 of the study's 16 batches do; the last one is
# also profiled.
STUDY300_STEPS = (1, 0)


def _island_pf_work(B, nb, nl):
    """Operations one certify_island_pf call on B lanes needs, per lane:
    the ceil(log2 nb) boolean squarings (2 nb^3 each) and the Cholesky
    factor (nb^3 / 3); the O(nb^2) work of its five refined solves (three
    substitution pairs and two Lg products, 10 nb^2 each), three residual
    products and three centrings (6 nb^2 a check) and 17 island sums
    through R (2 nb^2 each); and the adjacency and Laplacian, which need
    8 nl operations since the incidence has two nonzeros a row (the code
    forms them as dense products, which this bound does not charge)."""
    import math
    squarings = math.ceil(math.log2(max(nb, 2)))
    return B * (squarings * 2 * nb ** 3 + nb ** 3 / 3
                + (5 * 10 + 3 * 6 + 17 * 2) * nb ** 2 + 8 * nl)


def phase_pf300():
    """Tier 1.5 on the card: certify_states(woodbury_k=4) on 16,384
    plain-MC case300s states, the misses compacted into
    default_pf_buffer's 256 lanes and certified by certify_island_pf;
    soundness against float64 HiGHS, the mask and bound against the port
    on CPU tensors, the miss and certified shares, and the call's wall
    and device ms, launches, bound and bound share."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags)
    t_phase = time.perf_counter()
    case = cases.case300s()
    sys_ = build_system(case, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PF300_SEED)
    down = sample_states(gen, sys_.unavail, sys_.always_up_nsq, PF300_BATCH)
    load = sys_.load_pd[None, :].expand(PF300_BATCH, sys_.n_load)
    woodbury_k = hl2_nsq.default_woodbury_k(sys_)
    miss = ~dcopf.certify_states(sys_, down, load,
                                 woodbury_k=woodbury_k).certified
    kpf = dcopf.default_pf_buffer(sys_, PF300_BATCH)
    pidx = dcopf._topk_lanes(miss, kpf)
    n_miss = int(miss.sum())
    d_buf = down[pidx].contiguous()
    l_buf = load[:kpf]

    def call():
        return dcopf.certify_island_pf(sys_, d_buf, l_buf)

    call()                                             # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        cert = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms = _time_ms(call, reps=10)
    dev, n_kernels, kernels = _device_once(call)
    for e in sorted(kernels, key=_dev_us, reverse=True)[:8]:
        print(f"  pf300 kernel {_dev_us(e) / 1e3:9.3f} ms {e.count:6.0f}x  "
              f"{e.key[:90]}")
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    valid = np.arange(kpf) < n_miss
    certified = cert.certified.cpu().numpy()
    deficit = cert.deficit.double().cpu().numpy()
    # The port on CPU tensors, the same lanes.
    sys_cpu = build_system(case, device="cpu")
    states = d_buf.float().cpu().numpy()
    cpu = dcopf.certify_island_pf(
        sys_cpu, torch.as_tensor(states),
        sys_cpu.load_pd[None, :].expand(kpf, sys_cpu.n_load))
    same_mask = bool((cpu.certified.numpy() == certified).all())
    def_diff = float(np.abs(cpu.deficit.double().numpy() - deficit).max())
    ids = np.nonzero(valid)[0]
    oracle = _highs300(sys_cpu, states, ids)
    bound_mw = deficit[ids] * sys_.base_mva
    cert_ids = certified[ids]
    cert_err = (float(np.abs(bound_mw - oracle)[cert_ids].max())
                if cert_ids.any() else 0.0)
    over_bound = float((bound_mw - oracle).max())
    n_cert = int(cert_ids.sum())
    # Bytes: the bool states and float32 loads in; the bool mask and the
    # float32 deficit, shed and dispatch out.
    b = _bound(_island_pf_work(kpf, sys_.n_bus, sys_.n_branch),
               kpf * (sys_.n_comp + 4 * sys_.n_load + 1
                      + 4 * (1 + sys_.n_load + sys_.n_gen)))
    _line("pf300", batch=PF300_BATCH, woodbury_k=woodbury_k,
          tier1_misses=n_miss, miss_share=f"{n_miss / PF300_BATCH:.5f}",
          pf_buffer=kpf, certified=n_cert,
          certified_share=f"{n_cert / max(n_miss, 1):.4f}",
          oracle_lanes=len(ids),
          oracle_shed_lanes=int((oracle > CompatFlags().dns_noise_floor_mw
                                 ).sum()),
          certified_max_err_mw=f"{cert_err:.4f}<={PF300_ORACLE_MW}",
          bound_over_oracle_max_mw=f"{over_bound:.4f}<={PF300_ORACLE_MW}",
          cpu_same_mask=same_mask,
          cpu_deficit_max_diff=f"{def_diff:.3e}<={PF300_DEFICIT_PU}",
          wall_ms_sync_checked=f"{wall:.3f}", ms=f"{ms:.3f}",
          device_ms=f"{dev:.3f}", device_kernels=n_kernels,
          device_busy_share=f"{dev / ms:.3f}",
          bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
          bound_share=f"{b['bound_ms'] / ms:.4f}", peak_mem_bytes=peak,
          seconds=round(time.perf_counter() - t_phase, 2))
    if not (n_miss <= kpf and cert_err <= PF300_ORACLE_MW
            and over_bound <= PF300_ORACLE_MW and same_mask
            and def_diff <= PF300_DEFICIT_PU
            and np.isfinite(deficit).all()):
        raise RuntimeError(
            "pf300: tier 1.5 unsound against HiGHS, or the card's mask or "
            f"bound off the CPU's (misses {n_miss} of buffer {kpf})")


class _Study300Probe:
    """Per-batch accounting of the case300s study, read after it: the
    wrappers keep device tensors and host counters only, so they add no
    host sync. Tier-1 misses (certify_states on a whole batch), tier-1.5
    certified lanes among the valid buffer slots (the needy lanes come
    first in the buffer), the LP lanes past the evaluator's guard, the
    lanes over escalate_tol that enter the rescue ladder, and K2a / K3
    launches per screened call."""

    def __init__(self, batch):
        self.batch = batch
        self.tier1, self.pf, self.guard, self.rescue = [], [], [], []
        self.k2a, self.k3 = [], []

    @contextlib.contextmanager
    def installed(self):
        from powersystemsreliabilityassessment_tpu_torch.engines import (
            dcopf, lp_ipm_batched)
        from powersystemsreliabilityassessment_tpu_torch.ops import (
            batched_chol as bc, blocked_chol as bl)
        orig = (dcopf.certify_states, dcopf.certify_island_pf,
                dcopf.evaluate_states_screened, lp_ipm_batched._rescue)

        def certify_states(sys_, down, *a, **kw):
            cert = orig[0](sys_, down, *a, **kw)
            if down.shape[0] == self.batch:
                self.tier1.append((~cert.certified).sum())
            return cert

        def certify_island_pf(*a, **kw):
            cert = orig[1](*a, **kw)
            self.pf.append(cert.certified.cumsum(0))
            return cert

        def screened(*a, **kw):
            k2a, k3 = bc.launches["cholesky"], bl.launches["trsm_fwd"]
            self.rescue.append(None)       # set by the rescue, if it runs
            res, over = orig[2](*a, **kw)
            self.guard.append((res.primal_residual > LP_QUALITY_GUARD).sum())
            self.k2a.append(bc.launches["cholesky"] - k2a)
            self.k3.append(bl.launches["trsm_fwd"] - k3)
            return res, over

        def rescue(c, b, l, u, ops, cfg, sol, score, k):
            self.rescue[-1] = (score > cfg.escalate_tol).sum()
            return orig[3](c, b, l, u, ops, cfg, sol, score, k)

        dcopf.certify_states, dcopf.certify_island_pf = (certify_states,
                                                         certify_island_pf)
        dcopf.evaluate_states_screened = screened
        lp_ipm_batched._rescue = rescue
        try:
            yield self
        finally:
            (dcopf.certify_states, dcopf.certify_island_pf,
             dcopf.evaluate_states_screened, lp_ipm_batched._rescue) = orig

    def rows(self, max_lp):
        """One dict per screened call, in call order."""
        out = []
        for t1, pf, g, r, k2a, k3 in zip(self.tier1, self.pf, self.guard,
                                         self.rescue, self.k2a, self.k3):
            t1 = int(t1)
            n_valid = min(t1, pf.shape[0])
            left = t1 - (int(pf[n_valid - 1]) if n_valid else 0)
            out.append(dict(tier1_misses=t1, left_after_pf=left,
                            lp_lanes=min(left, max_lp),
                            past_guard=int(g),
                            rescue_lanes_over_tol=(None if r is None
                                                   else int(r)),
                            k2a=k2a, k3=k3))
        return out


def _count_syncs(fn) -> int:
    """Host syncs PyTorch reports in one call of ``fn``
    (set_sync_debug_mode("warn"))."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_study300(results):
    """The case300s NSQ study through the screened evaluator with tier
    1.5 (plain MC, proportional nodal mode, batch 16,384, seed 3, 262,144
    samples) held against results/case300_scaleup.json: EDNS and LOLE
    within 4 combined standard errors, overflow 0, K2a and K3 launched on
    every batch, at most STUDY300_PAST_GUARD_MAX LP lanes past the guard
    in all; per batch the tier-1 misses, the lanes tier 1.5 leaves,
    the LP lanes, the lanes past the guard and the lanes over
    escalate_tol entering the rescue (beside restart_compact); the
    study's wall time and samples/s; the wall and peak memory of two
    study batches alone at max_lp 128, the second one's host syncs,
    device ms and launches; evaluate_states' wall and peak memory at the
    2,048-lane cap."""
    import math
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig, MCSConfig)
    t_phase = time.perf_counter()
    ref = json.loads((ROOT / "results" / "case300_scaleup.json").read_text())
    cfg = MCSConfig(batch_size=PF300_BATCH, max_samples=STUDY300_SAMPLES,
                    beta_limit=0.0, seed=3, nodal_mode="proportional")
    case = cases.case300s()
    probe = _Study300Probe(cfg.batch_size)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with probe.installed():
        res = hl2_nsq.run_nsq_study(case, cfg, device="cuda", log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    sys_ = build_system(case, device="cuda")
    max_lp = hl2_nsq.default_max_lp(
        cfg.batch_size, cfg.nodal_mode,
        pf_tier=dcopf.default_pf_buffer(sys_, cfg.batch_size) is not None)
    rows = probe.rows(max_lp)
    for i, r in enumerate(rows):
        _line("study300", call=i, **r)
    hours = CompatFlags().hours_per_year_annualize

    def z_scores(r):
        # The artifact's standard errors: beta * EDNS, and the binomial
        # one of PLC times the hours of a year for LOLE.
        se_e = math.hypot(r["beta"] * r["edns_mw"], res.beta * res.edns_mw)
        se_l = hours * math.hypot(
            math.sqrt(r["plc"] * (1 - r["plc"]) / r["samples"]),
            math.sqrt(res.plc * (1 - res.plc) / res.samples))
        return (abs(res.edns_mw - r["edns_mw"]) / se_e,
                abs(res.lole_hr_yr - r["lole_hr_yr"]) / se_l)

    z_e, z_l = z_scores(ref)
    z_e4, z_l4 = z_scores(ref["replicates"][0])
    rescue = [r["rescue_lanes_over_tol"] for r in rows
              if r["rescue_lanes_over_tol"] is not None]
    # Steps of the study's shape, alone: the wall and peak memory of
    # batches STUDY300_STEPS (the study's own draws), and the host syncs
    # and device time of the last of them.
    step = hl2_nsq.make_nsq_batch_step(
        sys_, cfg.batch_size, CompatFlags(), IPMConfig(),
        nodal_mode=cfg.nodal_mode, shed_hint=dcopf.calibrate_shed_hint(sys_))
    gen_of = lambda i: hl2_nsq.batch_generator(cfg.seed, i, "cuda")
    step_wall, step_peak = {}, {}
    for i in STUDY300_STEPS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        step(gen_of(i))
        torch.cuda.synchronize()
        step_wall[i] = round((time.perf_counter() - t1) * 1e3, 1)
        step_peak[i] = torch.cuda.max_memory_allocated()
    last = STUDY300_STEPS[-1]
    syncs = _count_syncs(lambda: step(gen_of(last)))
    step_dev, step_kernels, kernels = _device_once(lambda: step(gen_of(last)))
    mine = {name: sum(_dev_us(e) for e in kernels
                      if any(k in e.key for k in keys)) / 1e3
            for name, keys in (("cholesky", ("cholesky_lanes_kernel",)),
                               ("trsm", ("trsm_vec_kernel",
                                         "trsm_cols_kernel")))}
    for e in sorted(kernels, key=_dev_us, reverse=True)[:8]:
        print(f"  study300 batch={last} kernel {_dev_us(e) / 1e3:9.3f} ms "
              f"{e.count:6.0f}x  {e.key[:90]}")
    # evaluate_states at the grow-and-redo cap, on a batch's first lanes.
    down = sample_states(gen_of(0), sys_.unavail, sys_.always_up_nsq,
                         cfg.batch_size)[:STUDY300_MEM_LANES]
    load = sys_.load_pd[None, :].expand(STUDY300_MEM_LANES, sys_.n_load)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    dcopf.evaluate_states(sys_, down, load)
    torch.cuda.synchronize()
    cap_wall = (time.perf_counter() - t1) * 1e3
    cap_peak = torch.cuda.max_memory_allocated()
    batches_lp = [r for r in rows if r["lp_lanes"] > 0]
    past_guard = sum(r["past_guard"] for r in rows)
    _line("study300", samples=res.samples, edns_mw=f"{res.edns_mw:.5f}",
          lole_hr_yr=f"{res.lole_hr_yr:.3f}", plc=f"{res.plc:.6f}",
          beta=f"{res.beta:.5f}", edns_z=f"{z_e:.2f}<=4",
          lole_z=f"{z_l:.2f}<=4", edns_z_seed4=f"{z_e4:.2f}",
          lole_z_seed4=f"{z_l4:.2f}", overflow=res.overflow_states,
          wall_s=f"{wall:.2f}", samples_per_s=f"{res.samples / wall:.0f}",
          max_lp=max_lp, screened_calls=len(rows),
          batches_with_lp_work=len(batches_lp),
          max_rescue_lanes_over_tol=max(rescue) if rescue else 0,
          rescue_calls=len(rescue), restart_compact=IPMConfig().restart_compact,
          past_guard=f"{past_guard}<={STUDY300_PAST_GUARD_MAX}",
          max_past_guard=max(r["past_guard"] for r in rows),
          launches=json.dumps(counts).replace(" ", ""))
    _line("study300", step_batch=last,
          step_wall_ms=json.dumps(step_wall).replace(" ", ""),
          step_peak_mem_bytes=json.dumps(step_peak).replace(" ", ""),
          step_device_ms=f"{step_dev:.1f}", step_kernels=step_kernels,
          step_device_busy_share=f"{step_dev / step_wall[last]:.3f}",
          step_k2a_device_ms=f"{mine['cholesky']:.3f}",
          step_k3_device_ms=f"{mine['trsm']:.3f}",
          host_syncs_per_step=syncs,
          evaluate_states_lanes=STUDY300_MEM_LANES,
          evaluate_states_wall_ms=f"{cap_wall:.1f}",
          evaluate_states_peak_mem_bytes=cap_peak,
          seconds=round(time.perf_counter() - t_phase, 2))
    if not (z_e <= 4 and z_l <= 4):
        raise RuntimeError("study300: estimates outside 4 combined standard "
                           "errors of results/case300_scaleup.json")
    if res.overflow_states or not rows or any(
            r["k2a"] <= 0 or r["k3"] <= 0 for r in batches_lp):
        raise RuntimeError(f"study300: overflow {res.overflow_states}, or "
                           "K2a / K3 not launched on a batch with LP work")
    if past_guard > STUDY300_PAST_GUARD_MAX:
        raise RuntimeError(f"study300: {past_guard} LP lanes past the guard, "
                           f"more than {STUDY300_PAST_GUARD_MAX}")
    for name, key in (("cholesky", "cholesky"), ("trsm_fwd", "trsm_fwd")):
        results.setdefault(name, {})["launches_study300"] = counts[key]


# The SEQ stress blocks (seq300 and seq96): a year block of each system,
# rebuilt with numpy alone from the recipe its golden keeps, beside the
# reference's outputs on it (tests/golden/seq_stress_*.npz, written and
# checked against the JAX package by tests/test_torch_seq_large.py).
SEQ_GOLDEN = {name: ROOT / "tests" / "golden" / f"seq_stress_{name}.npz"
              for name in ("case300s", "rts96")}
SEQ_GOLDEN_RECIPE = ("seed", "years", "hours", "dwells",
                     "branch_repair_scale", "forced", "window", "max_lp")


def stress_block(mean_times, n_gen: int, recipe):
    """bool ``[years, n_comp, hours]`` (True = DOWN): every component
    starts up and alternates ``dwells`` exponential up and down dwells
    (means ``mean_times`` [n_comp, 2] hours, the branches' repair times
    scaled by ``branch_repair_scale``) drawn from numpy's generator at
    ``seed`` as -log(1 - u); then the ``forced`` components are held
    down over the hours ``window``. ``recipe`` is a mapping with the
    keys of SEQ_GOLDEN_RECIPE."""
    import numpy as np
    years, hours = int(recipe["years"]), int(recipe["hours"])
    k = int(recipe["dwells"])
    mt = np.asarray(mean_times, np.float64).copy()
    mt[n_gen:, 1] *= float(recipe["branch_repair_scale"])
    rng = np.random.default_rng(int(recipe["seed"]))
    u = rng.random((years, len(mt), k, 2))
    dwell = -np.log1p(-u) * mt[None, :, None, :]
    bounds = np.cumsum(dwell.reshape(years, len(mt), 2 * k), -1)
    down = (bounds[..., None] <= np.arange(hours) + 0.5).sum(2) % 2 == 1
    w0, w1 = (int(w) for w in recipe["window"])
    down[:, np.asarray(recipe["forced"], np.int64), w0:w1] = True
    return down


def block_digest(down) -> str:
    """SHA-256 of a bool block's packed bits and shape."""
    import hashlib
    import numpy as np
    return hashlib.sha256(np.asarray(down.shape, np.int64).tobytes()
                          + np.packbits(down).tobytes()).hexdigest()


# A stress block's hour on which the port and the reference part by more
# than this is judged by float64 HiGHS (tests/test_torch_seq.py's
# ORACLE_TOL_MW); a kept LP lane must lie within SEQ_ORACLE_TOL_MW[system]
# of the optimum, a lane past the guard at most that far above it.
SEQ_APART_MW = 0.15
SEQ_ORACLE_TOL_MW = {"rts96": 0.15, "case300s": LP300_ORACLE_MW}
# Hours whose tier-1 or tier-1.5 verdict may differ between the card and
# the reference's CPU run (float32 rounding at a certificate's margin).
SEQ_NEED_MOVED_MAX = 4


def evaluate_block(sys_, down, max_lp: int, pf: bool = True) -> dict:
    """The port's ``hl2_seq.evaluate_years`` on a year block ``down``
    (bool numpy [years, n_comp, hours]) at the study's load profile and a
    ``max_lp``-lane buffer, as numpy: the per-year ``ens``, ``dlc``,
    ``nlc``, ``nodal``, ``comp_fail`` and the block's ``n_over``, with the
    screened evaluator's per-hour ``dns`` and quality score ``q``, its
    LP queue ``need_lp`` (the mask it compacts into the buffer) and the
    nodal shed ``nodal_h`` [k, nb] MW of its ``shed_hours`` (the k hours
    with DNS > 0) read from inside the call, and the loads ``load``.
    ``pf=False`` runs the evaluator without tier 1.5."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import load_profile
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_seq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    years, _, hours = down.shape
    load = hl2_seq.year_block_load(sys_, load_profile.load_factors(hours),
                                   years)
    seen, queues = [], []
    orig = dcopf.evaluate_states_screened, dcopf._topk_lanes

    def screened(*a, **kw):
        if not pf:
            kw["pf_buffer"] = None
        out = orig[0](*a, **kw)
        seen.append(out[0])
        return out

    def topk(need, k):
        queues.append(need.clone())
        return orig[1](need, k)

    dcopf.evaluate_states_screened, dcopf._topk_lanes = screened, topk
    try:
        out = hl2_seq.evaluate_years(
            sys_, CompatFlags(), IPMConfig(), load,
            torch.as_tensor(down, device=sys_.device), max_lp)
    finally:
        dcopf.evaluate_states_screened, dcopf._topk_lanes = orig
    np_ = lambda t: t.double().cpu().numpy()
    ens, _, nlc, dlc, _, nodal, comp_fail = (np_(t) for t in out[:7])
    dns = np_(seen[-1].dns_mw)
    shed_hours = np.flatnonzero(dns > 0)
    return dict(ens=ens, dlc=dlc, nlc=nlc, nodal=nodal, comp_fail=comp_fail,
                n_over=int(out[8]), dns=dns,
                q=np_(seen[-1].primal_residual),
                need_lp=queues[-1].cpu().numpy(),
                load=load.cpu().numpy(), shed_hours=shed_hours,
                nodal_h=np_(seen[-1].nodal_mw[torch.as_tensor(
                    shed_hours, device=sys_.device)]))


def judge_block(sys_cpu, down, want: dict, got: dict, oracle_tol: float,
                tag: str) -> dict:
    """Hold ``got`` (:func:`evaluate_block`) against ``want``, the
    reference's evaluation of the same block at the same buffer (the
    same keys): every hour on which the two DNS part by more than
    SEQ_APART_MW is judged by float64 HiGHS (at least one side past the
    5e-3 guard; a side past it at most ``oracle_tol`` above the optimum,
    a kept side within ``oracle_tol`` of it); on the other hours the
    curtailment flags agree, so DLC and the component counts differ by
    the judged hours' flags alone and ENS and nodal ENS by at most
    SEQ_APART_MW a loss hour plus the judged hours' moves. A year whose
    nodal ENS parts further is held to the LP's degeneracy (the shed may
    split over the buses in more than one optimal way): every shed hour
    of that year must be within ``oracle_tol`` of the HiGHS optimum, and
    its nodal shed, each load within SEQ_APART_MW, a float64 dispatch's
    (``got["nodal_h"]``). The LP queues may differ on at most
    SEQ_NEED_MOVED_MAX hours, each printed, and ``n_over`` by no more
    than they do. Raises RuntimeError; returns a summary."""
    import numpy as np
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags)
    years, _, hours = down.shape
    flat = np.swapaxes(down, 1, 2).reshape(years * hours, -1)
    gap = np.abs(got["dns"] - want["dns"])
    apart = np.flatnonzero(gap > SEQ_APART_MW)
    bad = []
    if len(apart):
        oracle = _highs300(sys_cpu, flat.astype(np.float32), list(apart),
                           got["load"])
        for i, o in zip(apart, oracle):
            sides = [(got["dns"][i], got["q"][i]),
                     (want["dns"][i], want["q"][i])]
            print(f"  {tag} hour {i}: port {sides[0][0]:.4f} MW "
                  f"(q {sides[0][1]:.2e}), reference {sides[1][0]:.4f} MW "
                  f"(q {sides[1][1]:.2e}), HiGHS {o:.4f} MW")
            if not any(q > LP_QUALITY_GUARD for _, q in sides) or any(
                    (d > o + oracle_tol) if q > LP_QUALITY_GUARD
                    else abs(d - o) > oracle_tol for d, q in sides):
                bad.append(int(i))
    thr = CompatFlags().seq_curtail_threshold_mw
    flag_p = (got["dns"] > thr).reshape(years, hours)
    flag_r = (want["dns"] > thr).reshape(years, hours)
    same = np.ones(years * hours, bool)
    same[apart] = False
    same = same.reshape(years, hours)
    dflag = flag_p.astype(float) - flag_r.astype(float)
    moved = np.where(same, 0.0, gap.reshape(years, hours)).sum(1)
    tol = SEQ_APART_MW * np.maximum(want["dlc"], 1.0) + moved
    moved_need = np.flatnonzero(got["need_lp"] != want["need_lp"])
    for i in moved_need:
        print(f"  {tag} hour {i}: LP queue port {bool(got['need_lp'][i])}, "
              f"reference {bool(want['need_lp'][i])}")
    checks = {
        "judged hours within HiGHS": not bad,
        "flags on agreeing hours": bool((flag_p[same] == flag_r[same]).all()),
        "dlc": bool((got["dlc"] - want["dlc"] == dflag.sum(1)).all()),
        "comp_fail": bool(np.array_equal(
            got["comp_fail"] - want["comp_fail"],
            np.einsum("yh,yhc->yc", dflag,
                      flat.reshape(years, hours, -1).astype(float)))),
        "nlc": bool(len(apart) or np.array_equal(got["nlc"], want["nlc"])),
        "ens": bool((np.abs(got["ens"] - want["ens"]) <= tol).all()),
        "nodal": bool((np.abs(got["nodal"] - want["nodal"])
                       <= tol[:, None]).all()),
        "LP queue": len(moved_need) <= SEQ_NEED_MOVED_MAX,
        "n_over": abs(got["n_over"] - want["n_over"]) <= len(moved_need),
    }
    split = []
    if not checks["nodal"]:
        years_off = np.flatnonzero((np.abs(got["nodal"] - want["nodal"])
                                    > tol[:, None]).any(1))
        rows = np.flatnonzero(np.isin(got["shed_hours"] // hours,
                                      years_off))
        hrs = got["shed_hours"][rows]
        base = sys_cpu.base_mva
        opt = _highs300(sys_cpu, flat.astype(np.float32), list(hrs),
                        got["load"])
        # Bus nodal shed to load shed: one load a bus on these systems.
        onehot = sys_cpu.load_onehot.double().numpy()
        pattern = got["nodal_h"][rows] @ onehot / base
        fixed = _highs300(sys_cpu, flat.astype(np.float32), list(hrs),
                          got["load"], shed=pattern,
                          slack=SEQ_APART_MW / base)
        split = [int(h) for h, o, f in zip(hrs, opt, fixed)
                 if abs(got["dns"][h] - o) > oracle_tol or not np.isfinite(f)]
        print(f"  {tag}: nodal ENS of years {[int(y) for y in years_off]} "
              f"part from the reference's; {len(hrs)} shed hours, each an "
              f"optimum of its LP unless listed: {split}")
        checks["nodal"] = bool(len(hrs)) and not split
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{tag}: the block disagrees with the reference "
                           f"on {failed} (HiGHS-judged hours off: {bad})")
    return dict(apart_hours=len(apart), queue_moved=len(moved_need),
                nodal_max_diff_mwh=float(np.abs(got["nodal"]
                                                - want["nodal"]).max()),
                ens_max_diff_mwh=float(np.abs(got["ens"] - want["ens"]).max()),
                n_over=got["n_over"], n_over_reference=want["n_over"])


class _SeqProbe:
    """Per screened call of a SEQ study, read after it: the probe keeps
    device tensors and host counters only, so it adds no host sync. The
    block's hours and LP buffer; tier 1's misses (uncertified hours) and
    its LP queue (misses and positive-deficit hours, nodal mode "lp"),
    the LP queue after tier 1.5 (the screened evaluator's two
    ``_needs_lp`` masks; one when tier 1.5 is off), the LP lanes past the
    5e-3 guard, and the kernel launches of the call."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def installed(self):
        from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
        orig = dcopf.evaluate_states_screened, dcopf._needs_lp
        queues = []

        def needs_lp(pre, nodal_mode):
            need = orig[1](pre, nodal_mode)
            queues.append(((~pre.certified).sum(), need.sum()))
            return need

        def screened(sys_, down, load, max_lp, *a, **kw):
            queues.clear()
            before = _counts()
            res, over = orig[0](sys_, down, load, max_lp, *a, **kw)
            after = _counts()
            self.calls.append(dict(
                hours=down.shape[0], max_lp=max_lp, misses=queues[0][0],
                tier1_queue=queues[0][1], lp_queue=queues[-1][1],
                past_guard=(res.primal_residual > LP_QUALITY_GUARD).sum(),
                launches={k: after[k] - before[k] for k in after}))
            return res, over

        dcopf.evaluate_states_screened, dcopf._needs_lp = screened, needs_lp
        try:
            yield self
        finally:
            dcopf.evaluate_states_screened, dcopf._needs_lp = orig

    def rows(self) -> list:
        out = []
        for c in self.calls:
            t1, lp = int(c["tier1_queue"]), int(c["lp_queue"])
            out.append(dict(
                hours=c["hours"], lp_buffer=c["max_lp"],
                tier1_misses=int(c["misses"]), tier1_queue=t1,
                tier15_certified_share=(f"{(t1 - lp) / t1:.4f}" if t1
                                        else None),
                lp_queue=lp, lp_lanes=min(lp, c["max_lp"]),
                past_guard=int(c["past_guard"]),
                k2a=c["launches"]["cholesky"],
                k3_fwd=c["launches"]["trsm_fwd"],
                k3_bwd=c["launches"]["trsm_bwd"]))
        return out


def _study_log(tag, fn):
    """``fn()``'s result with what it printed, which is echoed line by
    line under ``tag``: the SEQ study prints each redo and promotion."""
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        lines = buf.getvalue().splitlines()
        for ln in lines:
            print(f"  {tag}: {ln}")
    return out, lines


def _seq_step_costs(tag, case, sys_, years, max_lp, factors, seed,
                    probe=None) -> dict:
    """One SEQ step of the study's shape (``years`` years, ``max_lp``
    lanes a year, the first batch of ``seed``) on its own: wall ms with
    the step synchronized, device ms and kernel launches
    (torch.profiler), the host reads PyTorch reports
    (set_sync_debug_mode("warn")), the peak memory, and the block's
    overflow hours; then one more call under ``probe`` (a
    :class:`_SeqProbe`), if given."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    hours = len(factors)
    mt = twostate.mean_times(case)
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    step = hl2_seq.make_seq_batch_step(sys_, years, CompatFlags(),
                                       IPMConfig(), hours, k, max_lp,
                                       factors)
    gen = lambda: hl2_nsq.batch_generator(seed, 0, "cuda")
    step(gen())                                            # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(gen())
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    reads = _count_syncs(lambda: step(gen()))
    dev, launches, _ = _device_once(lambda: step(gen()))
    if probe is not None:
        with probe.installed():
            step(gen())
    if not bool(torch.isfinite(out[0]).all()):
        raise RuntimeError(f"{tag}: the step's ENS is not finite")
    return dict(years=years, max_lp=max_lp, wall_ms=round(wall, 1),
                device_ms=round(dev, 1), launches=launches,
                host_reads=reads, peak_mem_bytes=peak,
                n_over=int(out[8]))


# seq300: the case300s SEQ study at its record's configuration
# (results/case300_seq_results.json: 256 years, two years a step, the
# study's defaults, nodal mode "lp"), cut in depth to SEQ300_YEARS;
# seq300full runs all 256.
SEQ300_Y = 2
SEQ300_YEARS = 64
SEQ300_FULL_YEARS = 256
# A stress block without tier 1.5 must overflow at least this many times
# as many hours as with it (the CPU block: 78 against 3).
SEQ300_NO_PF_RATIO = 8
# seq96: a short RTS-96 SEQ study (16 years a step, the study's default
# buffer of 256 lanes a year).
SEQ96_Y = 16
SEQ96_YEARS = 1024
SEQ96_SEED = 5
SEQ96_HIGHS_LANES = 256


def _golden_block(name):
    """(block, golden) of SEQ_GOLDEN[name]: the block rebuilt with numpy
    from the golden's recipe, which must give the golden's digest."""
    import numpy as np
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    golden = dict(np.load(SEQ_GOLDEN[name]))
    case = getattr(cases, name)()
    down = stress_block(twostate.mean_times(case), case.n_gen, golden)
    if block_digest(down) != str(golden["digest"]):
        raise RuntimeError(f"{name}: numpy rebuilt another block than the "
                           f"golden's ({SEQ_GOLDEN[name].name})")
    golden["n_over"] = int(golden["n_over"])
    return down, golden


def _golden_block_check(tag, name, sys_, sys_cpu) -> dict:
    """The stress block of SEQ_GOLDEN[name] through evaluate_years on
    the card, held against the reference's golden (:func:`judge_block`);
    at case300s also the block without tier 1.5, whose overflow must be
    SEQ300_NO_PF_RATIO times larger."""
    down, golden = _golden_block(name)
    max_lp = int(golden["max_lp"])
    _reset_counts()
    got = evaluate_block(sys_, down, max_lp)
    counts = _counts()
    summary = judge_block(sys_cpu, down, golden, got,
                          SEQ_ORACLE_TOL_MW[name], tag)
    row = dict(block=name, hours=int(down.shape[0] * down.shape[2]),
               max_lp=max_lp, lp_queue=int(got["need_lp"].sum()),
               lp_queue_reference=int(golden["need_lp"].sum()), **summary,
               ens=json.dumps([round(float(e), 4) for e in got["ens"]]),
               ens_reference=json.dumps([round(float(e), 4)
                                         for e in golden["ens"]]),
               launches=json.dumps({k: v for k, v in counts.items() if v}
                                   ).replace(" ", ""))
    if name == "case300s":
        none = evaluate_block(sys_, down, max_lp, pf=False)
        row["n_over_without_tier15"] = none["n_over"]
        if none["n_over"] < SEQ300_NO_PF_RATIO * max(
                got["n_over"], golden["n_over"], 1):
            raise RuntimeError(f"{tag}: the block overflows {got['n_over']} "
                               f"hours with tier 1.5 and {none['n_over']} "
                               "without: tier 1.5 did not run")
    _line(tag, **row)


def _loss_year_se(annual_ens, total) -> float:
    """Standard error of a per-year count whose study keeps only its
    total (``total`` = mean x years): the count spread evenly over the
    study's loss years (its years with ENS > 0), 0 elsewhere."""
    import math
    import numpy as np
    ens = np.asarray(annual_ens)
    per = np.where(ens > 0, total / max(int((ens > 0).sum()), 1), 0.0)
    return float(np.std(per, ddof=1) / math.sqrt(len(per)))


def _seq300_run(tag, years, results) -> dict:
    """run_seq_study(case300s(), two years a step, the study's defaults)
    for ``years`` years, held against results/case300_seq_results.json:
    EENS, LOLE and LOLF within 4 combined standard errors (the record
    keeps only annual ENS: its LOLE / LOLF standard errors spread its
    loss hours and events evenly over its loss years), overflow and
    infeasible hours 0, K2a and K3 launched by every screened call, LP
    lanes past the guard at most SEQ300_PAST_GUARD_SHARE of the LP
    lanes; one line per screened call, the study's wall, redos,
    promotions and the buffer it ended at."""
    import math
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_seq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        MCSConfig)
    rec = json.loads((ROOT / "results" / "case300_seq_results.json"
                      ).read_text())
    cfg = MCSConfig(max_years=years, cov_threshold=0.0)
    probe = _SeqProbe()
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with probe.installed():
        res, log = _study_log(tag, lambda: hl2_seq.run_seq_study(
            cases.case300s(), cfg, device="cuda", log_every=0,
            years_per_device=SEQ300_Y))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _counts()
    rows = probe.rows()
    for i, r in enumerate(rows):
        _line(tag, call=i, **r)
    se = lambda v: float(np.std(v, ddof=1) / math.sqrt(len(v)))
    n = rec["years"]
    z = {"eens": abs(res.eens_mwh_yr - rec["eens_mwh_yr"]) / math.hypot(
        se(rec["annual_ens"]), se(res.annual_ens))}
    for key, field, per_year in (("lole", "lole_hr_yr", res.annual_dlc),
                                 ("lolf", "lolf_occ_yr", res.annual_nlc)):
        z[key] = abs(getattr(res, field) - rec[field]) / math.hypot(
            _loss_year_se(rec["annual_ens"], rec[field] * n), se(per_year))
    redos = sum("redoing batch" in ln for ln in log)
    promotions = [ln for ln in log if "promoting max_lp" in ln]
    lp_lanes = sum(r["lp_lanes"] for r in rows)
    past_guard = sum(r["past_guard"] for r in rows)
    by_buffer = {}
    for r in rows:
        b = by_buffer.setdefault(r["lp_buffer"], dict(
            calls=0, lp_lanes=0, past_guard=0))
        b["calls"] += 1
        b["lp_lanes"] += r["lp_lanes"]
        b["past_guard"] += r["past_guard"]
    row = dict(years=res.years, screened_calls=len(rows), redos=redos,
               promotions=len(promotions),
               final_max_lp=rows[-1]["lp_buffer"] // SEQ300_Y,
               largest_max_lp=max(r["lp_buffer"] for r in rows) // SEQ300_Y,
               eens_mwh_yr=f"{res.eens_mwh_yr:.4f}",
               lole_hr_yr=f"{res.lole_hr_yr:.4f}",
               lolf_occ_yr=f"{res.lolf_occ_yr:.4f}", cov=f"{res.cov:.4f}",
               eens_z=f"{z['eens']:.2f}<=4", lole_z=f"{z['lole']:.2f}<=4",
               lolf_z=f"{z['lolf']:.2f}<=4", loss_years=int(
                   (np.asarray(res.annual_ens) > 0).sum()),
               overflow_hours=res.overflow_hours,
               infeasible_hours=res.infeasible_hours,
               lp_lanes=lp_lanes, past_guard=f"{past_guard}<="
               f"{SEQ300_PAST_GUARD_SHARE}x{lp_lanes}",
               tier1_misses=sum(r["tier1_misses"] for r in rows),
               tier1_queue=sum(r["tier1_queue"] for r in rows),
               lp_queue=sum(r["lp_queue"] for r in rows),
               by_buffer=json.dumps(by_buffer).replace(" ", ""),
               wall_s=f"{wall:.2f}",
               wall_per_block_s=f"{wall / max(len(rows), 1):.3f}",
               peak_mem_bytes=peak,
               launches=json.dumps(counts).replace(" ", ""))
    _line(tag, **row)
    if not all(v <= 4 for v in z.values()):
        raise RuntimeError(f"{tag}: EENS / LOLE / LOLF outside 4 combined "
                           "standard errors of "
                           "results/case300_seq_results.json")
    if res.overflow_hours or res.infeasible_hours:
        raise RuntimeError(f"{tag}: {res.overflow_hours} overflow and "
                           f"{res.infeasible_hours} infeasible hours")
    if any(r["k2a"] <= 0 or r["k3_fwd"] <= 0 for r in rows):
        raise RuntimeError(f"{tag}: K2a / K3 not launched on every batch")
    if past_guard > SEQ300_PAST_GUARD_SHARE * lp_lanes:
        raise RuntimeError(f"{tag}: {past_guard} of {lp_lanes} LP lanes "
                           "past the guard")
    for name in ("cholesky", "trsm_fwd", "trsm_bwd"):
        results.setdefault(name, {})[f"launches_{tag}"] = counts[name]
    return row


def phase_seq300(results):
    """The case300s SEQ year block and study on the card: (a) the
    golden stress block against the reference (tier 1.5 in the block:
    fault F); (b) the study at its record's configuration for
    SEQ300_YEARS years; then one step of it alone (two years, 256 lanes
    a year): wall, device ms, launches, host reads, peak memory."""
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    t_phase = time.perf_counter()
    case = cases.case300s()
    sys_ = build_system(case, device="cuda")
    sys_cpu = build_system(case, device="cpu")
    _golden_block_check("seq300", "case300s", sys_, sys_cpu)
    _seq300_run("seq300", SEQ300_YEARS, results)
    step = _seq_step_costs("seq300", case, sys_, SEQ300_Y, 256,
                           load_profile.load_factors(8736), seed=0)
    _line("seq300", step=json.dumps(step).replace(" ", ""),
          seconds=round(time.perf_counter() - t_phase, 2))


def phase_seq300full(results):
    """All SEQ300_FULL_YEARS years of the case300s SEQ record, held as
    seq300's study."""
    t_phase = time.perf_counter()
    _seq300_run("seq300full", SEQ300_FULL_YEARS, results)
    _line("seq300full", seconds=round(time.perf_counter() - t_phase, 2))


def phase_seq96(results):
    """The RTS-96 SEQ year block and a short study on the card: (a) the
    golden stress block against the reference; (b) SEQ96_YEARS years at
    SEQ96_Y years a step: every year's ENS at least its copper-sheet ENS
    (evaluate_years' control-variate outputs of the same years) less
    SEQ_APART_MW a deficit hour, RTS96_KERNELS launched by every step,
    overflow 0; the kept LP lanes of the first block (up to
    SEQ96_HIGHS_LANES) within SEQ_ORACLE_TOL_MW of float64 HiGHS; the
    step's wall, device ms, launches and LP lanes."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        MCSConfig)
    t_phase = time.perf_counter()
    case = cases.rts96()
    sys_ = build_system(case, device="cuda")
    sys_cpu = build_system(case, device="cpu")
    _golden_block_check("seq96", "rts96", sys_, sys_cpu)

    # The study, with the copper-sheet ENS of every year read beside it.
    hours = 8736
    factors = load_profile.load_factors(hours)
    total_mw = float(np.sum(np.asarray(case.bus_pd, np.float64)))
    cv = (torch.as_tensor((np.asarray(factors, np.float64) * total_mw
                           ).astype(np.float32), device="cuda"),
          torch.as_tensor(np.asarray(case.gen_pmax, np.float32),
                          device="cuda"))
    years_seen = []
    orig = hl2_seq.evaluate_years

    def evaluate_years(sys__, compat, ipm, load, down, max_lp,
                       nodal_mode="lp", cv_arrays=None, maint_down=None):
        out = orig(sys__, compat, ipm, load, down, max_lp, nodal_mode, cv,
                   maint_down)
        years_seen.append((out[0], out[10], out[11]))
        return out[:10]

    probe = _SeqProbe()
    cfg = MCSConfig(max_years=SEQ96_YEARS, cov_threshold=0.0,
                    seed=SEQ96_SEED)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hl2_seq.evaluate_years = evaluate_years
    try:
        with probe.installed():
            res, log = _study_log("seq96", lambda: hl2_seq.run_seq_study(
                case, cfg, device="cuda", log_every=0,
                years_per_device=SEQ96_Y))
    finally:
        hl2_seq.evaluate_years = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    rows = probe.rows()
    for i, r in enumerate(rows):
        _line("seq96", call=i, **r)
    ens, copper, copper_h = (torch.cat(v).double().cpu().numpy()
                             for v in zip(*years_seen))
    # Each hour with a copper deficit may round by SEQ_APART_MW (the LP's
    # float32 answer, the 0.1 MW noise floor).
    shortfall = float((copper - ens).max())
    low = int((ens < copper - SEQ_APART_MW * np.maximum(copper_h, 1.0)
               ).sum())

    # The first block's kept LP lanes against float64 HiGHS.
    mt = twostate.mean_times(case)
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    down = hl2_seq.sample_years(hl2_nsq.batch_generator(SEQ96_SEED, 0,
                                                        "cuda"),
                                sys_, SEQ96_Y, hours, k).cpu().numpy()
    got = evaluate_block(sys_, down, 256 * SEQ96_Y)
    kept = np.flatnonzero((got["q"] > 0) & (got["q"] <= LP_QUALITY_GUARD))
    lanes = kept[np.argsort(-got["dns"][kept], kind="stable")][
        :SEQ96_HIGHS_LANES]
    flat = np.swapaxes(down, 1, 2).reshape(SEQ96_Y * hours, -1)
    oracle = _highs300(sys_cpu, flat.astype(np.float32), list(lanes),
                       got["load"])
    highs_err = float(np.abs(got["dns"][lanes] - oracle).max()
                      ) if len(lanes) else 0.0
    step = _seq_step_costs("seq96", case, sys_, SEQ96_Y, 256, factors,
                           seed=SEQ96_SEED)
    _line("seq96", years=res.years, steps=len(rows),
          redos=sum("redoing batch" in ln for ln in log),
          eens_mwh_yr=f"{res.eens_mwh_yr:.4f}",
          lole_hr_yr=f"{res.lole_hr_yr:.4f}",
          lolf_occ_yr=f"{res.lolf_occ_yr:.4f}", cov=f"{res.cov:.4f}",
          copper_eens_mwh_yr=f"{copper.mean():.4f}",
          years_below_copper=f"{low}<=0",
          largest_copper_shortfall_mwh=f"{shortfall:.4f}",
          overflow_hours=res.overflow_hours,
          infeasible_hours=res.infeasible_hours,
          lp_lanes_per_step=json.dumps([r["lp_lanes"] for r in rows]),
          past_guard=sum(r["past_guard"] for r in rows),
          highs_lanes=len(lanes), highs_kept_lanes=len(kept),
          highs_max_err_mw=f"{highs_err:.4f}<="
          f"{SEQ_ORACLE_TOL_MW['rts96']}",
          wall_s=f"{wall:.2f}", step=json.dumps(step).replace(" ", ""),
          launches=json.dumps(counts).replace(" ", ""),
          seconds=round(time.perf_counter() - t_phase, 2))
    if low or res.overflow_hours or highs_err > SEQ_ORACLE_TOL_MW["rts96"]:
        raise RuntimeError(f"seq96: {low} years below their copper ENS, "
                           f"{res.overflow_hours} overflow hours, or a kept "
                           f"LP lane {highs_err:.4f} MW off HiGHS")
    missing = [(i, k_) for i, r in enumerate(rows)
               for k_ in ("k2a", "k3_fwd", "k3_bwd") if r[k_] <= 0]
    if missing:
        raise RuntimeError(f"seq96: RTS96_KERNELS not launched on every "
                           f"step: {missing}")
    for name in RTS96_KERNELS:
        results.setdefault(name, {})["launches_seq96"] = counts[name]


# The samplers' phases: a record's estimate and standard error, held
# within RARE_MAX_Z combined standard errors.
RARE_MAX_Z = 4.0
# mix300 runs batches for about this long (at least two), and at most
# the record's sample count.
RARE300_SECONDS = 90.0
RARE300_BATCH = 8192
RARE300_SEED = 7
RARE300_MAX_BATCHES = 32


def _z_line(tag, res_edns, res_se, ref_edns, ref_se, **kv):
    """Print the estimate beside the record's; fail above RARE_MAX_Z."""
    import math
    z = abs(res_edns - ref_edns) / math.hypot(res_se, ref_se)
    _line(tag, edns_mw=f"{res_edns:.5f}", edns_se_mw=f"{res_se:.5f}",
          record_edns_mw=ref_edns, record_se_mw=f"{ref_se:.5f}",
          edns_z=f"{z:.2f}<={RARE_MAX_Z:g}", card=repr(CARD["smi"]), **kv)
    if not z <= RARE_MAX_Z:
        raise RuntimeError(f"{tag}: EDNS {res_edns:.5f} MW is {z:.2f} "
                           "combined standard errors from its record")


def _rare_study(tag, cfg, ref_edns, ref_beta, results, **kv):
    """An RTS-24 study through run_nsq_study with ``cfg``, held against a
    record's EDNS and beta; K1 and K2 must launch. Returns the result."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hl2_nsq.run_nsq_study(cases.rts24(), cfg, device="cuda",
                                log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    _z_line(tag, res.edns_mw, res.beta * res.edns_mw, ref_edns,
            ref_beta * ref_edns, beta=f"{res.beta:.5f}",
            record_beta=ref_beta, lole_hr_yr=f"{res.lole_hr_yr:.2f}",
            samples=res.samples, overflow=res.overflow_states,
            wall_s=f"{wall:.2f}", samples_per_s=f"{res.samples / wall:.0f}",
            launches=json.dumps(counts).replace(" ", ""), **kv)
    _check_launched(tag, counts, RTS24_KERNELS)
    if res.overflow_states:
        raise RuntimeError(f"{tag}: {res.overflow_states} overflow states")
    for name in RTS24_KERNELS:
        results.setdefault(name, {})[f"launches_{tag}"] = counts[name]
    return res


def phase_anti(results):
    """RTS-24 antithetic study (batch 2,048, 40,960 samples) against
    results/study_sweep.json["antithetic"]."""
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        MCSConfig)
    ref = json.loads((ROOT / "results" / "study_sweep.json").read_text())
    rec = ref["antithetic"]["antithetic"]
    _rare_study("anti", MCSConfig(batch_size=2048, max_samples=40960,
                                  beta_limit=0.0, antithetic=True),
                rec["edns"], rec["beta"], results)


def phase_is24(sys_, results):
    """RTS-24 importance-sampled study (boost 2 on every component, "lp"
    mode, batch 8,192, 16,384 samples, seed 3) against
    results/enum_hybrid.json["study_ab"]["boost2"]; then one step of it
    under set_sync_debug_mode("error"): wall and device ms, launches,
    busy share and the lanes it sends to the LP."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig, MCSConfig)
    ref = json.loads((ROOT / "results" / "enum_hybrid.json").read_text())
    rec = ref["study_ab"]["boost2"]
    cfg = MCSConfig(batch_size=8192, max_samples=16384, beta_limit=0.0,
                    seed=3, is_boost=2.0)
    _rare_study("is24", cfg, rec["edns"], rec["beta"], results,
                record_lole_hr_yr=rec["lole"])
    step = hl2_nsq.make_nsq_batch_step(
        sys_, cfg.batch_size, CompatFlags(), IPMConfig(),
        is_boost=cfg.is_boost, shed_hint=dcopf.calibrate_shed_hint(sys_))
    gen = lambda: hl2_nsq.batch_generator(cfg.seed, 0, "cuda")
    need, orig = [], dcopf._needs_lp

    def needs_lp(pre, mode):
        lanes = orig(pre, mode)
        need.append(lanes.sum())
        return lanes

    dcopf._needs_lp = needs_lp
    try:
        out = step(gen())
    finally:
        dcopf._needs_lp = orig
    lp_lanes = int(need[-1])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(gen())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    dev_ms, n_kernels, _ = _device_once(lambda: step(gen()))
    max_lp = hl2_nsq.default_max_lp(cfg.batch_size, "lp", cfg.is_boost)
    _line("is24", step_batch=cfg.batch_size, step_wall_ms=f"{wall_ms:.2f}",
          step_device_ms=f"{dev_ms:.2f}", step_kernels=n_kernels,
          step_device_busy_share=f"{dev_ms / wall_ms:.3f}",
          lp_lanes=lp_lanes, max_lp=max_lp, overflow=int(out[1]),
          sync_check="error", card=repr(CARD["smi"]),
          launches=json.dumps(counts).replace(" ", ""))
    _check_launched("is24 step", counts, RTS24_KERNELS)


def _weighted_run(tag, make_step, max_lp):
    """Batches of a case300s step ``make_step(max_lp)`` on the study's
    generators (seed RARE300_SEED) for about RARE300_SECONDS (at least
    two, at most RARE300_MAX_BATCHES); an overflow doubles the buffer up
    to the study's cap and redoes the batch, as run_nsq_study does.
    Returns (RunningStats, batches, redos, overflow, wall s, max_lp)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.parallel import (
        accumulators)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    stats = accumulators.RunningStats()
    step = make_step(max_lp)
    i = redos = overflow = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while i < RARE300_MAX_BATCHES and (
            i < 2 or time.perf_counter() - t0 < RARE300_SECONDS):
        m, n_over, _ = step(hl2_nsq.batch_generator(RARE300_SEED, i, "cuda"))
        n_over = int(n_over)
        if n_over and 2 * max_lp <= min(RARE300_BATCH,
                                        hl2_nsq.PF_TIER_LP_CAP):
            max_lp *= 2
            redos += 1
            step = make_step(max_lp)
            print(f"  {tag}: overflow {n_over}, max_lp {max_lp}, redo "
                  f"batch {i}", flush=True)
            continue
        overflow += n_over
        stats.update(m)
        i += 1
    torch.cuda.synchronize()
    return stats, i, redos, overflow, time.perf_counter() - t0, max_lp


@contextlib.contextmanager
def _max_weight(name, store):
    """Record the largest weight of each call of hl2_nsq's sampler
    ``name`` (a device tensor, so no host sync)."""
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    orig = getattr(hl2_nsq, name)

    def sampler(*a, **kw):
        down, w = orig(*a, **kw)
        store.append(w.max())
        return down, w

    setattr(hl2_nsq, name, sampler)
    try:
        yield
    finally:
        setattr(hl2_nsq, name, orig)


def _rare300_line(tag, rec, edns, beta, samples, plc, overflow, wall,
                  counts, w_max, **kv):
    """The case300s phases' line: the weighted estimate against the
    record's; K2a and K3 must launch, and no lane may overflow."""
    _z_line(tag, edns, beta * edns, rec["edns_mw"], rec["edns_se_mw"],
            samples=samples, record_samples=rec["n"],
            beta=f"{beta:.5f}", plc=f"{plc:.7f}",
            record_plc=rec["plc_weighted"], max_weight=f"{w_max:.5f}",
            overflow=overflow, wall_s=f"{wall:.2f}",
            samples_per_s=f"{samples / wall:.0f}",
            record_tpu_samples_per_s=rec["warm_samples_per_s"],
            launches=json.dumps(counts).replace(" ", ""), **kv)
    if samples < rec["n"]:
        print(f"  {tag}: {samples} samples of the record's {rec['n']}: "
              "the standard error is the wider for it", flush=True)
    _check_launched(tag, counts, ("cholesky", "trsm_fwd"))
    if overflow:
        raise RuntimeError(f"{tag}: {overflow} overflow states")


def phase_mix300(results):
    """case300s defensive mixture over its 12 areas' generators (boost 2,
    alpha0 0.5, proportional mode, batch 8,192, seed 7, the calibrated
    shed hint) against results/mixture_ab.json["arms"]["mix_b2"]; the
    largest weight must stay within 1 / alpha0."""
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    ref = json.loads((ROOT / "results" / "mixture_ab.json").read_text())
    rec = ref["arms"]["mix_b2"]
    case = cases.case300s()
    sys_ = build_system(case, device="cuda")
    masks = hl2_nsq.gen_area_masks(case)
    alpha0 = 0.5
    mix = (masks, 2.0, alpha0)
    hint = dcopf.calibrate_shed_hint(sys_)
    make = lambda lp: hl2_nsq.make_nsq_batch_step(
        sys_, RARE300_BATCH, CompatFlags(), IPMConfig(), max_lp=lp,
        nodal_mode="proportional", shed_hint=hint, mix=mix)
    weights = []
    _reset_counts()
    with _max_weight("sample_states_mixture", weights):
        out = _weighted_run("mix300", make,
                            min(max(RARE300_BATCH // 16, 128), 2048))
    counts = _counts()
    w_max = max(float(w) for w in weights)
    stats, n_batches, redos, overflow, wall, max_lp = out
    _rare300_line("mix300", rec, stats.edns, stats.beta, int(stats.n),
                  stats.plc, overflow, wall, counts, w_max,
                  weight_bound=1 / alpha0, batches=n_batches, redos=redos,
                  max_lp=max_lp, areas=masks.shape[0])
    if not w_max <= (1 / alpha0) * (1 + 1e-6):
        raise RuntimeError(f"mix300: weight {w_max} above 1 / alpha0")
    for name in ("cholesky", "trsm_fwd"):
        results.setdefault(name, {})["launches_mix300"] = counts[name]


def phase_ce300(results):
    """run_nsq_study(case300s(), MCSConfig(is_ce=True, batch_size=8192,
    max_samples=262144, seed=7, proportional mode), max_lp=256): the CE
    pilot (32,768 samples, 2 rounds, seed 7 + 90210) and
    sparsify_ce_proposal(q, sys, 8, 0.05) inside it, held against
    results/ce_sparse.json["arms"]["sparse_k8_c05"]; the pilot's rounds
    beside the record's."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        MCSConfig)
    ref = json.loads((ROOT / "results" / "ce_sparse.json").read_text())
    rec = ref["arms"]["sparse_k8_c05"]
    cfg = MCSConfig(batch_size=RARE300_BATCH, max_samples=rec["n"],
                    beta_limit=0.0, seed=RARE300_SEED,
                    nodal_mode="proportional", is_ce=True)
    seen = {}
    orig = hl2_nsq.calibrate_ce_proposal, hl2_nsq.sparsify_ce_proposal

    def calibrate(*a, **kw):
        t0 = time.perf_counter()
        seen["q"], seen["diag"] = orig[0](*a, **kw)
        torch.cuda.synchronize()
        seen["pilot_s"] = time.perf_counter() - t0
        return seen["q"], seen["diag"]

    def sparsify(*a, **kw):
        seen["sparse"] = orig[1](*a, **kw)
        return seen["sparse"]

    weights = []
    hl2_nsq.calibrate_ce_proposal = calibrate
    hl2_nsq.sparsify_ce_proposal = sparsify
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with _max_weight("sample_states_importance", weights):
            res = hl2_nsq.run_nsq_study(cases.case300s(), cfg, device="cuda",
                                        log_every=0, max_lp=256)
    finally:
        hl2_nsq.calibrate_ce_proposal, hl2_nsq.sparsify_ce_proposal = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    for r, r_ref in zip(seen["diag"]["rounds"], ref["ce_diag"]["rounds"]):
        _line("ce300", pilot_round=r["round"], events=r["events"],
              record_events=r_ref["events"], rel_var_wf=r["rel_var_wf"],
              record_rel_var_wf=r_ref["rel_var_wf"],
              sum_q_branches=r["sum_q_branches"],
              record_sum_q_branches=r_ref["sum_q_branches"],
              overflow=r["overflow"])
    if seen["q"] is None:
        raise RuntimeError("ce300: the pilot saw fewer than 8 deficit events")
    q = seen["sparse"]
    u = build_system(cases.case300s(), device="cpu").unavail.numpy()
    # The pilot's draws are weighted too: the largest weight of the
    # study's own batches is the last res.samples / batch of them.
    w_study = weights[-(res.samples // cfg.batch_size):]
    _rare300_line("ce300", rec, res.edns_mw, res.beta, res.samples, res.plc,
                  res.overflow_states, wall - seen["pilot_s"], counts,
                  max(float(w) for w in w_study),
                  pilot_s=f"{seen['pilot_s']:.2f}",
                  record_pilot_tpu_s=ref["pilot_wall_s"],
                  tilted_components=int((q != u).sum()),
                  sum_q_minus_u=f"{float((q - u).sum()):.4f}",
                  record_sum_q_minus_u=rec["sum_q_minus_u"],
                  max_lp=256, lole_hr_yr=f"{res.lole_hr_yr:.3f}")
    for name in ("cholesky", "trsm_fwd"):
        results.setdefault(name, {})["launches_ce300"] = counts[name]

# The enumeration phase's record and bounds (results/enum_hybrid.json).
ENUM_ORDER5_STATES = 13077135
ENUM_MASS_TOL = 1e-9
ENUM_EDNS_RTOL = 1e-3
ENUM_PFAIL_RTOL = 5e-3
ENUM_STUDY_MASS_TOL = 1e-6
# cvseq: the per-year variance ratio of plain over control variate, over
# CVSEQ_SEEDS arms of 512 years each (seed 7, the record's, first). The
# plain arm's per-year variance is set by a few rare years (the copper
# deficit's variance over 512-year blocks of one stream ranges 299 to
# 220,362 MWh^2, median 7,841), so one arm's ratio is not a measurement:
# over the seeds 7-14 it ranged 2.9-40.3 (NVIDIA H100, PERF.md §6),
# 18.7 over their 4,096 years.
CVSEQ_MIN_RATIO = 10.0
CVSEQ_SEEDS = tuple(range(7, 15))
# The NSQ control variate's exact copper means at RTS-24's peak (the
# reference's copt.copper_cv_means) and their tolerance.
CV24_MU = (14.693678, 0.0845781)
CV24_MU_RTOL = 1e-6
HL1_ANALYTICAL_RTOL = 1e-4
HL1_BIG_SAMPLES = 2_000_000
HL1_BIG_BATCH = 100_000


def _nsq_run(tag, case, cfg, **kw):
    """run_nsq_study on the card with the launch counts reset; returns
    (result, wall s, launch counts)."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hl2_nsq.run_nsq_study(case, cfg, device="cuda", log_every=0, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _counts()


def _record_launches(results, tag, counts):
    for name in RTS24_KERNELS:
        results.setdefault(name, {})[f"launches_{tag}"] = counts[name]


def _sync_checked(step, gen):
    """One warm call of ``step(gen(0))``, then one under
    set_sync_debug_mode("error"); returns the second call's output and its
    wall ms."""
    import torch
    step(gen(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(gen(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _enum_lp_lanes(sys_, n_lanes: int, order: int = 5, chunk: int = 65536):
    """Structured LP inputs (colscale, br_up, c, b, l, u) of ``n_lanes``
    real order-``order`` LP lanes of RTS-24 at its peak: the enumeration's
    chunks of that order from its last colex rank down, and of each the
    states the certificate leaves uncertified or with a deficit, the
    lanes the screened evaluator sends to the LP in "lp" nodal mode."""
    from math import comb
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        enumeration)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    free = enumeration.free_components(
        sys_.unavail.cpu().numpy().astype(np.float64),
        sys_.always_up_nsq.cpu().numpy().astype(bool))
    free_d = torch.as_tensor(free.astype(np.int64), device="cuda")
    downs, got, end = [], 0, comb(len(free), order)
    while got < n_lanes:
        start = max(end - chunk, 0)
        combos = enumeration.unrank_combinations(
            np.arange(start, end, dtype=np.int64), order, len(free))
        down = torch.zeros((end - start, sys_.n_comp), dtype=torch.bool,
                           device="cuda")
        down.scatter_(1, free_d[torch.as_tensor(combos.astype(np.int64),
                                                device="cuda")], True)
        cert = dcopf.certify_states(
            sys_, down, sys_.load_pd[None, :].expand(down.shape[0], -1))
        idx = torch.nonzero((~cert.certified) | (cert.deficit > 0)).flatten()
        downs.append(down[idx])
        got += idx.numel()
        end = start
    up = 1.0 - torch.cat(downs)[:n_lanes].float()
    gen_up, br_up = up[:, :sys_.n_gen], up[:, sys_.n_gen:].contiguous()
    c, b, l, u, colscale = dcopf.build_state_lp_vectors(
        sys_, gen_up, br_up, sys_.load_pd[None, :].expand(n_lanes, -1),
        CompatFlags(), IPMConfig().theta_max)
    return colscale, br_up, c, b, l, u


def phase_enum24(results):
    """The exact order-5 enumeration of RTS-24, then the order-4 hybrid
    study, against results/enum_hybrid.json; K1, K2a and K2b on the
    order-5 pass's LP buffer of real order-5 lanes."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, ipm_fused)
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        enumeration)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig, MCSConfig)
    ref = json.loads((ROOT / "results" / "enum_hybrid.json").read_text())
    rec5, rec4 = ref["exact_order5"], ref["study_ab"]["enum4"]
    sys_ = build_system(cases.rts24(), device="cuda")
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _guard_counter() as guard:
        ex = enumeration.enumerate_exact(sys_, CompatFlags(), IPMConfig(),
                                         "lp", 5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    bad = []
    if ex.n_states != ENUM_ORDER5_STATES:
        bad.append(f"states {ex.n_states}")
    if not abs(ex.mass - rec5["mass"]) <= ENUM_MASS_TOL:
        bad.append(f"mass {ex.mass!r}")
    if not abs(ex.edns_mw / rec5["edns_exact_mw"] - 1) <= ENUM_EDNS_RTOL:
        bad.append(f"EDNS {ex.edns_mw}")
    if not abs(ex.pfail / rec5["pfail_exact"] - 1) <= ENUM_PFAIL_RTOL:
        bad.append(f"pfail {ex.pfail}")
    _line("enum24", order=5, states=ex.n_states,
          record_states=rec5["n_states"], mass=repr(ex.mass),
          record_mass=rec5["mass"], edns_exact_mw=f"{ex.edns_mw:.5f}",
          record_edns_exact_mw=rec5["edns_exact_mw"],
          pfail_exact=f"{ex.pfail:.7f}", record_pfail=rec5["pfail_exact"],
          infeasible=ex.infeasible, wall_s=f"{wall:.2f}",
          states_per_s=f"{ex.n_states / wall:.0f}",
          record_tpu_prepass_wall_s=ref["prepass_k5"]["wall_s"],
          card=repr(CARD["smi"]), lp_lanes_past_guard=_guard_text(guard),
          launches=json.dumps(counts).replace(" ", ""))
    _check_launched("enum24", counts, RTS24_KERNELS)
    _record_launches(results, "enum24_order5", counts)
    if bad:
        raise RuntimeError(f"enum24: order 5 off its record: {bad}")
    # K1, K2a and K2b at the pass's grown LP buffer (the chunk size), on
    # real order-5 LP lanes.
    args = _enum_lp_lanes(sys_, 65536)
    st = ipm_fused.build_structure(sys_)
    k1 = _k1_shape(sys_, st, 65536, IPMConfig(), args=args, tag="enum24",
                   guarded=True, deep=True)
    M = _polish_factor_inputs(st, args)
    solve_args = (bc.cholesky_plain(M), torch.randn(
        M.shape[:2], generator=torch.Generator(device="cuda").manual_seed(
            14), device="cuda"))
    rows = {"chol_enum": _k2_row("enum24", "chol_enum", "cholesky", (M,),
                                 (M,), tol="float64_check_below"),
            "solve_enum": _k2_row("enum24", "solve_enum", "cho_solve",
                                  solve_args, solve_args)}
    # The deep lanes' polish matrices are ill-conditioned: K2a is held to
    # the float64 factor there (_k2_vs_float64), K2b to its plain version.
    f64 = _k2_vs_float64("enum24", M)
    rows["chol_enum"].update(
        f64, tolerance=f"max({K2_L_BOUND}, 2 plain_vs_float64) a lane, "
        "against float64")
    rows["solve_enum"]["tolerance"] = K2_X_BOUND
    _check_k2_rows("enum24", {"solve_enum": rows["solve_enum"]})
    if not rows["chol_enum"]["finite"] or f64["lanes_past_float64_bound"]:
        raise RuntimeError("enum24: K2a farther from the float64 factor "
                           "than twice the plain version's error")
    # Folded into the kernels' top-level errors as the seq shapes are,
    # with their own tolerances beside them.
    entry = results.setdefault("fused_ipm_iterations", {})
    tol = (f"{K1_DEEP_BOUND}; objectives past it within "
           f"{LP_QUALITY_GUARD} of the float64 optimum")
    entry["enum_shape"] = dict(k1, tolerance=tol)
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                               k1["objective_err_pu"], k1["best_score_err"])
    entry.setdefault("shape_tolerances", {})["enum_shape"] = tol
    for kind, name in (("cholesky", "chol_enum"), ("cho_solve",
                                                   "solve_enum")):
        entry = results.setdefault(kind, {})
        entry.setdefault("path_shapes", {})[name] = rows[name]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                                   rows[name]["abs_err"])
        entry["max_rel_err"] = max(entry.get("max_rel_err", 0.0),
                                   rows[name]["rel_err"])
        entry.setdefault("shape_tolerances", {})[name] = \
            rows[name]["tolerance"]
    cfg = MCSConfig(batch_size=8192, max_samples=16384, beta_limit=0.0,
                    seed=3)
    res, wall, counts = _nsq_run("enum24", cases.rts24(), cfg, enum_order=4)
    _z_line("enum24", res.edns_mw, res.beta * res.edns_mw, rec4["edns"],
            rec4["beta"] * rec4["edns"], order=4, states=res.enum_states,
            record_states=rec4["enum_states"],
            mass=f"{res.enum_mass:.7f}", record_mass=rec4["enum_mass"],
            exact_part_mw=f"{res.enum_edns_exact_mw:.5f}",
            record_exact_part_mw=rec4["enum_edns_exact"],
            beta=f"{res.beta:.6f}", record_beta=rec4["beta"],
            samples=res.samples, overflow=res.overflow_states,
            wall_s=f"{wall:.2f}",
            launches=json.dumps(counts).replace(" ", ""))
    _check_launched("enum24 study", counts, RTS24_KERNELS)
    _record_launches(results, "enum24_study", counts)
    if (res.enum_states != rec4["enum_states"]
            or not abs(res.enum_mass - rec4["enum_mass"])
            <= ENUM_STUDY_MASS_TOL
            or not abs(res.enum_edns_exact_mw / rec4["enum_edns_exact"] - 1)
            <= ENUM_EDNS_RTOL or res.overflow_states):
        raise RuntimeError("enum24: the order-4 study is off its record")


def phase_cv24(results):
    """RTS-24 NSQ at 106,496 samples, plain and with the control variate,
    against results/nsq_results.json; the control-variate step under the
    sync check."""
    import math
    import numpy as np
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        copt, dcopf)
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig, MCSConfig)
    ref = json.loads((ROOT / "results" / "nsq_results.json").read_text())
    cfg = MCSConfig(max_samples=106496, beta_limit=0.0)
    plain, wall_p, _ = _nsq_run("cv24", cases.rts24(), cfg)
    cv, wall, counts = _nsq_run("cv24", cases.rts24(), cfg,
                                control_variate=True)
    # The exact copper means, from the study's own inputs (the units'
    # float32 capacities, the float32 total peak load).
    case = cases.rts24()
    total = np.float32(np.sum(np.asarray(case.bus_pd, np.float64)))
    mu_e, mu_l, _, _ = copt.copper_cv_means(
        np.asarray(case.gen_pmax, np.float32).astype(np.float64),
        twostate.unavailability(case)[:case.n_gen],
        np.asarray([total], np.float64),
        thresh_mw=CompatFlags().nsq_fail_flag_threshold_mw)
    _z_line("cv24", cv.edns_mw, cv.beta * cv.edns_mw, ref["edns_mw"],
            ref["beta"] * ref["edns_mw"], beta_cv=f"{cv.beta:.6f}",
            beta_plain=f"{plain.beta:.6f}",
            beta_ratio=f"{plain.beta / cv.beta:.2f}",
            plain_edns_mw=f"{plain.edns_mw:.5f}", mu_edns_mw=f"{mu_e:.7f}",
            mu_plc=f"{mu_l:.8f}", plc_cv=f"{cv.plc:.6f}",
            samples=cv.samples, overflow=cv.overflow_states,
            wall_s=f"{wall:.2f}", plain_wall_s=f"{wall_p:.2f}",
            launches=json.dumps(counts).replace(" ", ""))
    _check_launched("cv24", counts, RTS24_KERNELS)
    _record_launches(results, "cv24", counts)
    bad = [k for k, v, want in (("mu_EDNS", mu_e, CV24_MU[0]),
                                ("mu_PLC", mu_l, CV24_MU[1]))
           if not math.isclose(v, want, rel_tol=CV24_MU_RTOL)]
    if bad or not cv.beta < 0.5 * plain.beta or cv.overflow_states:
        raise RuntimeError(f"cv24: means off {bad}, or beta_cv {cv.beta} "
                           f"not below half of {plain.beta}")
    sys_ = build_system(case, device="cuda")
    step = hl2_nsq.make_nsq_batch_step(
        sys_, cfg.batch_size, CompatFlags(), IPMConfig(),
        shed_hint=dcopf.calibrate_shed_hint(sys_),
        cv_arrays=(np.asarray(case.gen_pmax, np.float32), float(total),
                   mu_e, mu_l))
    out, wall_ms = _sync_checked(
        step, lambda i: hl2_nsq.batch_generator(0, i, "cuda"))
    _line("cv24", step_batch=cfg.batch_size, step_wall_ms=f"{wall_ms:.2f}",
          sync_check="error", residual_sum_mw=f"{float(out[0].sum_dns):.4f}")


def _seq_se(values) -> float:
    import math
    import numpy as np
    return float(np.std(values, ddof=1) / math.sqrt(len(values)))


def phase_cvseq(results):
    """The RTS-24 SEQ study at load_scale 0.8, 512 years an arm at seed 7,
    stationary plain and with the control variate, against
    results/cv_rare_event.json; the per-year variance ratio over the
    years of seeds CVSEQ_SEEDS (the same paths in both arms)."""
    import math
    import numpy as np
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_seq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        MCSConfig)
    ref = json.loads((ROOT / "results" / "cv_rare_event.json").read_text())
    years = {"plain": [], "cv": []}
    bad = []
    t_all = time.perf_counter()
    for seed in CVSEQ_SEEDS:
        cfg = MCSConfig(seed=seed, max_years=ref["years_per_arm"],
                        cov_threshold=0.0)
        for arm, kw in (("plain", dict(sampling="stationary")),
                        ("cv", dict(control_variate=True))):
            _reset_counts()
            t0 = time.perf_counter()
            res = hl2_seq.run_seq_study(cases.rts24(), cfg, device="cuda",
                                        log_every=0,
                                        load_scale=ref["load_scale"], **kw)
            wall = time.perf_counter() - t0
            counts = _counts()
            years[arm].append(np.asarray(res.annual_ens))
            if res.overflow_hours:
                bad.append(f"{arm} seed {seed} overflow")
            if seed != ref["seed"]:
                continue
            rec = ref[arm]
            var = float(np.var(res.annual_ens, ddof=1))
            z = abs(res.eens_mwh_yr - rec["eens_mwh_yr"]) / math.hypot(
                _seq_se(res.annual_ens), rec["cov"] * rec["eens_mwh_yr"])
            _line("cvseq", arm=arm, seed=seed, years=res.years,
                  eens_mwh_yr=f"{res.eens_mwh_yr:.4f}",
                  eens_se=f"{_seq_se(res.annual_ens):.4f}",
                  record_eens_mwh_yr=rec["eens_mwh_yr"],
                  record_se=f"{rec['cov'] * rec['eens_mwh_yr']:.4f}",
                  eens_z=f"{z:.2f}<={RARE_MAX_Z:g}",
                  per_year_var=f"{var:.1f}",
                  record_per_year_var=rec["per_year_var"],
                  lole_hr_yr=f"{res.lole_hr_yr:.4f}",
                  overflow_hours=res.overflow_hours, wall_s=f"{wall:.2f}",
                  record_tpu_wall_s=rec["wall_s"], card=repr(CARD["smi"]),
                  launches=json.dumps(counts).replace(" ", ""))
            _check_launched(f"cvseq {arm}", counts, RTS24_KERNELS)
            _record_launches(results, f"cvseq_{arm}", counts)
            if not z <= RARE_MAX_Z:
                bad.append(f"{arm} z {z:.2f}")
    var = {arm: [float(np.var(v, ddof=1)) for v in vs]
           for arm, vs in years.items()}
    per_seed = [p / c for p, c in zip(var["plain"], var["cv"])]
    pooled = {arm: np.concatenate(vs) for arm, vs in years.items()}
    ratio = float(np.var(pooled["plain"], ddof=1)
                  / np.var(pooled["cv"], ddof=1))
    _line("cvseq", seeds=f"{CVSEQ_SEEDS[0]}-{CVSEQ_SEEDS[-1]}",
          years_per_arm=pooled["cv"].size,
          plain_eens_mwh_yr=f"{pooled['plain'].mean():.4f}",
          cv_eens_mwh_yr=f"{pooled['cv'].mean():.4f}",
          variance_ratio=f"{ratio:.2f}>={CVSEQ_MIN_RATIO:g}",
          record_seed_ratio=f"{per_seed[0]:.2f}",
          per_seed_ratios=json.dumps([round(r, 2) for r in per_seed]
                                     ).replace(" ", ""),
          record_variance_ratio=ref["variance_reduction"],
          wall_s=f"{time.perf_counter() - t_all:.2f}")
    if bad or not ratio >= CVSEQ_MIN_RATIO:
        raise RuntimeError(f"cvseq: {bad}, or the variance ratio "
                           f"{ratio:.2f} below {CVSEQ_MIN_RATIO}")


def phase_seqib(results):
    """The RTS-24 SEQ study with island_blackout to CoV 0.05 at seed 0
    against results/seq_compat_parity.json["island_blackout"]; one
    blackout SEQ step under the sync check."""
    import math
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig, MCSConfig)
    ref = json.loads((ROOT / "results" / "seq_compat_parity.json")
                     .read_text())
    rec = ref["island_blackout"]
    compat = CompatFlags(island_blackout=True)
    cfg = MCSConfig(seed=ref["seed"], cov_threshold=ref["cov"])
    _reset_counts()
    t0 = time.perf_counter()
    res = hl2_seq.run_seq_study(cases.rts24(), cfg, compat=compat,
                                device="cuda", log_every=0)
    wall = time.perf_counter() - t0
    counts = _counts()
    z = {"eens": abs(res.eens_mwh_yr - rec["eens_mwh_yr"]) / math.hypot(
        _seq_se(res.annual_ens), rec["cov"] * rec["eens_mwh_yr"])}
    # The record keeps no per-year DLC or NLC: their standard error is
    # taken equal to the port's.
    for key, field, per_year in (("lole", "lole_hr_yr", res.annual_dlc),
                                 ("lolf", "lolf_occ_yr", res.annual_nlc)):
        z[key] = abs(getattr(res, field) - rec[field]) / (
            math.sqrt(2.0) * _seq_se(per_year))
    _line("seqib", years=res.years, record_years=rec["years"],
          cov=f"{res.cov:.5f}",
          cov_before_last_batch=f"{res.cov_history[-2]:.5f}",
          eens_mwh_yr=f"{res.eens_mwh_yr:.3f}",
          record_eens_mwh_yr=f"{rec['eens_mwh_yr']:.3f}",
          eens_z=f"{z['eens']:.2f}<={RARE_MAX_Z:g}",
          lole_hr_yr=f"{res.lole_hr_yr:.4f}",
          record_lole_hr_yr=f"{rec['lole_hr_yr']:.4f}",
          lole_z=f"{z['lole']:.2f}", lolf_occ_yr=f"{res.lolf_occ_yr:.4f}",
          record_lolf_occ_yr=f"{rec['lolf_occ_yr']:.4f}",
          lolf_z=f"{z['lolf']:.2f}", overflow_hours=res.overflow_hours,
          wall_s=f"{wall:.2f}", record_tpu_wall_s=rec["wall_s"],
          card=repr(CARD["smi"]),
          launches=json.dumps(counts).replace(" ", ""))
    _check_launched("seqib", counts, RTS24_KERNELS)
    _record_launches(results, "seqib", counts)
    # The CoV reached the limit: the batch in flight when it did is still
    # folded, so the limit holds at the last batch or the one before.
    reached = min(res.cov_history[-2:]) <= cfg.cov_threshold
    if not z["eens"] <= RARE_MAX_Z or not reached:
        raise RuntimeError(f"seqib: EENS z {z['eens']:.2f}, or the CoV "
                           f"{res.cov_history[-2:]} never reached "
                           f"{cfg.cov_threshold}")
    hours = compat.hours_per_year_seq
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    step = hl2_seq.make_seq_batch_step(
        build_system(cases.rts24(), compat, device="cuda"), 16, compat,
        IPMConfig(), hours, k, 256, load_profile.load_factors(hours))
    out, wall_ms = _sync_checked(
        step, lambda i: hl2_nsq.batch_generator(0, i, "cuda"))
    _line("seqib", step_years=16, step_wall_ms=f"{wall_ms:.2f}",
          sync_check="error", step_overflow=int(out[8]))


def phase_hl1(results):
    """HL1 on RTS-24 (hl1_rts24.run) at the record's sizes against
    results/study_sweep.json["hl1_rts24"], a 2,000,000-sample NSQ Monte
    Carlo against the analytical value, and the float32 COPT on the card
    against the float64 host table. The standard errors come from the
    Monte Carlo methods' batch means."""
    import math
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import copt
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl1_comparison, hl1_rts24)
    rec = json.loads((ROOT / "results" / "study_sweep.json")
                     .read_text())["hl1_rts24"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = hl1_rts24.run(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nsq_se = got["Non-Sequential MC"]["se"]
    seq_se = got["Sequential MC"]["se"]
    gens, load = hl1_rts24.rts24_fleet(), hl1_rts24.rts24_load()
    t1 = time.perf_counter()
    big = hl1_comparison.run_non_sequential_mc(
        gens, load, HL1_BIG_SAMPLES, seed=5, batch=HL1_BIG_BATCH,
        device="cuda")
    big_wall = time.perf_counter() - t1
    big_se = big.standard_errors()
    big_m = (big.lole_hours_yr, big.eue_mwh_yr)
    ana = got["Analytical"]
    bad = [k for k in ("lole", "eue")
           if not math.isclose(ana[k], rec["Analytical"][k],
                               rel_tol=HL1_ANALYTICAL_RTOL)]
    zs = {}
    for tag, method, se in (("nsq", "Non-Sequential MC", nsq_se),
                            ("seq", "Sequential MC", seq_se)):
        for i, k in enumerate(("lole", "eue")):
            zs[f"{tag}_{k}"] = abs(got[method][k] - rec[method][k]) / (
                math.sqrt(2.0) * se[i])
    z_big = [abs(big_m[i] - ana[k]) / big_se[i]
             for i, k in enumerate(("lole", "eue"))]
    caps = np.asarray([g.capacity for g in gens], np.float32)
    fors = np.asarray([g.for_rate for g in gens], np.float32)
    table = copt.build_copt(torch.as_tensor(caps), torch.as_tensor(fors),
                            1.0, copt.grid_points_for(float(caps.sum()), 1.0),
                            device="cuda")
    host = copt.build_copt_np(caps.astype(np.float64),
                              fors.astype(np.float64), 1.0)
    copt_diff = float(np.abs(table.cpu().numpy() - host).max())
    _line("hl1", analytical_lole=f"{ana['lole']:.6f}",
          record_lole=rec["Analytical"]["lole"],
          analytical_eue=f"{ana['eue']:.3f}",
          record_eue=rec["Analytical"]["eue"],
          nsq_lole=f"{got['Non-Sequential MC']['lole']:.4f}",
          nsq_eue=f"{got['Non-Sequential MC']['eue']:.2f}",
          nsq_se=f"{nsq_se[0]:.4f}/{nsq_se[1]:.2f}",
          seq_lole=f"{got['Sequential MC']['lole']:.4f}",
          seq_eue=f"{got['Sequential MC']['eue']:.2f}",
          seq_se=f"{seq_se[0]:.4f}/{seq_se[1]:.2f}",
          z=json.dumps({k: round(v, 2) for k, v in zs.items()}
                       ).replace(" ", ""),
          wall_s=f"{wall:.2f}", record_tpu_wall_s=rec["wall_s"],
          card=repr(CARD["smi"]))
    _line("hl1", big_samples=HL1_BIG_SAMPLES,
          big_lole=f"{big.lole_hours_yr:.5f}",
          big_lole_se=f"{big_se[0]:.5f}", big_eue=f"{big.eue_mwh_yr:.3f}",
          big_eue_se=f"{big_se[1]:.3f}",
          big_z=f"{z_big[0]:.2f}/{z_big[1]:.2f}<={RARE_MAX_Z:g}",
          big_wall_s=f"{big_wall:.2f}",
          samples_per_s=f"{HL1_BIG_SAMPLES / big_wall:.0f}",
          copt_f32_vs_f64_max_abs=f"{copt_diff:.3e}")
    if bad or not all(z <= RARE_MAX_Z for z in (*zs.values(), *z_big)):
        raise RuntimeError(f"hl1: analytical off {bad}, or a Monte Carlo "
                           f"estimate past {RARE_MAX_Z} standard errors")


# The planning, maintenance and multi-area phases. Their records
# are results/study_sweep.json's, which keep no standard errors: each
# record's is taken equal to the port's own, so a z is the distance over
# sqrt(2) port standard errors (as seqib does).
PLAN_ANALYTICAL_RTOL = 1e-3
PLAN_ELU_YEARS = 2000          # the tail study's years, for the loop line
MULTI_NOISE_MW = 1e-3


def _per_year_se(values) -> float:
    import math
    import numpy as np
    v = np.asarray(values, np.float64)
    return float(v.std(ddof=1) / math.sqrt(v.shape[0]))


def _z_record(got, record, se) -> float:
    import math
    return abs(got - record) / (math.sqrt(2.0) * se) if se > 0 else (
        0.0 if got == record else float("inf"))


def phase_plan():
    """HL1 planning on the card: the analytical pipeline and both ELU
    comparisons against results/study_sweep.json, the ELU hour loop's
    times and launches (and once under the sync check), and the four
    educational studies."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        elu, planning)
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import markov
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, markov_education, planning_elu)
    sweep = json.loads((ROOT / "results" / "study_sweep.json").read_text())
    bad = []
    for key, hydro, years, seed in (("elu_600h", 600.0, 1000, 3),
                                    ("tail_risk_50h", 50.0, 2000, 4)):
        rec = sweep[key]
        load = planning_elu.demo_planning_load()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ana = planning_elu.run_planning_analytical(
            planning_elu.demo_planning_fleet(hydro), load, device="cuda")
        t_ana = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = planning_elu.run_elu_comparison(
            planning_elu.demo_planning_fleet(hydro), load, mc_years=years,
            seed=seed, device="cuda")
        t_cmp = time.perf_counter() - t0
        se = _per_year_se(res.mc_yearly_distribution)
        z = _z_record(res.mc_lole, rec["mc_lole"], se)
        rel = abs(ana.lole_hr_yr - rec["analytical_lole"]) / rec[
            "analytical_lole"]
        _line("plan", study=key, years=years, seed=seed,
              analytical_lole=f"{ana.lole_hr_yr:.6f}",
              record_analytical=f"{rec['analytical_lole']:.6f}",
              analytical_rel=f"{rel:.2e}<={PLAN_ANALYTICAL_RTOL:g}",
              effective_q_elu=f"{ana.effective_q[4]:.6f}",
              maint_start=json.dumps(ana.maint_start.tolist()).replace(
                  " ", ""),
              mc_lole=f"{res.mc_lole:.4f}", mc_se=f"{se:.4f}",
              record_mc_lole=f"{rec['mc_lole']:.4f}",
              mc_z=f"{z:.2f}<={RARE_MAX_Z:g}", var95=f"{res.var95:g}",
              record_var95=rec["var95"], cvar95=f"{res.cvar95:.4f}",
              record_cvar95=f"{rec['cvar95']:.4f}",
              diff_percent=f"{res.diff_percent:.2f}", success=res.success,
              analytical_s=f"{t_ana:.3f}", comparison_s=f"{t_cmp:.3f}",
              record_tpu_wall_s=f"{rec['wall_s']:.2f}",
              card=repr(CARD["smi"]))
        if not (rel <= PLAN_ANALYTICAL_RTOL and z <= RARE_MAX_Z):
            bad.append(key)

    # The ELU hour loop at the tail study's 2,000 years: the draw, then
    # the loop's wall, device time and launches, then once under the
    # sync check.
    fleet = planning_elu.demo_planning_fleet(50.0)
    load = planning_elu.demo_planning_load()
    planning.schedule_maintenance(fleet, planning_elu.weekly_peaks_of(load))
    gen = hl2_nsq.batch_generator(4, 0, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, z = elu.elu_draws(gen, PLAN_ELU_YEARS, len(load), fleet.n, "cuda")
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) * 1e3
    args = [torch.as_tensor(np.asarray(a), device="cuda") for a in (
        fleet.capacity, fleet.for_rate, fleet.maint_start, fleet.maint_weeks,
        fleet.energy_limit, load)]
    lfu = float(load.max()) * 0.05
    torch.cuda.reset_peak_memory_stats()
    loop = lambda h: elu.elu_mc_from_draws(u[:, :h], z[:, :h], *args[:5],
                                           args[5][:h], lfu)
    H = len(load)
    loop(H)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lole_y, _ = loop(H)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    # Device time and launches on a tenth of the year: the profiler's own
    # cost (key_averages over ~245,000 events) would take a minute on the
    # whole year's loop.
    hs = H // 10
    s_wall, s_dev, s_kernels, _ = _measure(lambda: loop(hs), reps=1)
    _line("plan", elu_loop_years=PLAN_ELU_YEARS, hours=H,
          draw_ms=f"{draw_ms:.2f}", loop_wall_ms=f"{wall:.2f}",
          sync_check="error", slice_hours=hs,
          slice_wall_ms=f"{s_wall:.2f}", slice_device_ms=f"{s_dev:.2f}",
          slice_device_busy_share=f"{s_dev / s_wall:.3f}",
          slice_kernel_launches=f"{s_kernels:.0f}",
          launches_per_hour=f"{s_kernels / hs:.2f}",
          mc_lole=f"{float(lole_y.mean()):.4f}",
          peak_mem_bytes=torch.cuda.max_memory_allocated())

    # The educational studies on the card.
    t0 = time.perf_counter()
    times, _, _ = markov_education.exponential_proof()
    single = markov_education.single_component_study(device="cuda")
    cap, total = markov_education.multi_unit_capacity_series(device="cuda")
    est = markov_education.parameter_estimation_study()
    mttf = np.array([1000.0, 1200.0, 800.0, 1500.0, 2000.0])
    mttr = np.array([50.0, 60.0, 40.0, 20.0, 100.0])
    p01, p10 = twostate.transition_probs(mttf, mttr)
    chains = markov.sample_markov_chain_batch(
        hl2_nsq.batch_generator(42, 1, "cuda"), p01, p10, 4000, 4096)
    down_share = chains[:, :, 1000:].float().mean((0, 2)).cpu().numpy()
    u_ss = twostate.steady_state_unavailability(mttf, mttr)
    markov_rel = float(np.abs(down_share / u_ss - 1.0).max())
    edu_s = time.perf_counter() - t0
    checks = {
        "exponential_mean": abs(np.mean(times) / 1000.0 - 1.0) <= 0.1,
        "single_steady_state": abs(single.prob_down_analytical[-1]
                                   / single.steady_state - 1.0) <= 0.05,
        "single_path": set(np.unique(single.mc_realization)) <= {0, 1},
        "capacity_range": 0 <= cap.min() and cap.max() <= total == 600.0,
        "running_lambda": abs(est.running_lambda[-1] / est.true_lambda
                              - 1.0) <= 0.1,
        "markov_stationary": markov_rel <= 0.1}
    checks = {k: bool(v) for k, v in checks.items()}
    _line("plan", educational_s=f"{edu_s:.3f}",
          exponential_mean_h=f"{np.mean(times):.2f}",
          single_down_hours=int(single.mc_realization.sum()),
          capacity_min_mw=f"{cap.min():.0f}", capacity_mean_mw=
          f"{cap.mean():.2f}", running_lambda=f"{est.running_lambda[-1]:.6f}",
          true_lambda=est.true_lambda,
          markov_down_share=json.dumps(np.round(down_share, 5).tolist()
                                       ).replace(" ", ""),
          markov_rel_err=f"{markov_rel:.4f}<=0.1",
          checks=json.dumps(checks).replace(" ", ""))
    bad += [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"plan: {bad} off their records or checks")


@contextlib.contextmanager
def _capturing_k1(store: list, warm: bool = False):
    """While active, the inputs of every K1 call on the LP path
    (``lp_kernels(...).iterate``) from the box midpoint, or with
    ``warm`` every call with a start point (the warm rescue's; the start
    appended as a seventh input), are appended to ``store``."""
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_batched as lpb)
    kernels = lpb._DIRECT_KERNELS["cuda"]

    def iterate(st, *args, x_init=None):
        if (x_init is not None) == warm:
            extra = (x_init,) if warm else ()
            store.append(tuple(a.clone() for a in (*args[:6], *extra)))
        return kernels.iterate(st, *args, x_init=x_init)

    lpb._DIRECT_KERNELS["cuda"] = kernels._replace(iterate=iterate)
    try:
        yield
    finally:
        lpb._DIRECT_KERNELS["cuda"] = kernels


def phase_seqmaint(sys_, results):
    """The RTS-24 SEQ study with scheduled maintenance at the record's
    configuration against results/study_sweep.json
    ["seq_with_maintenance"]; K1 on the step's own 8,192-lane LP buffer
    and K2a / K2b at its polish shape against their plain versions."""
    import io
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, ipm_fused)
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig, MCSConfig)
    rec = json.loads((ROOT / "results" / "study_sweep.json").read_text()
                     )["seq_with_maintenance"]
    years_per_step, max_lp = 8, 1024
    cfg = MCSConfig(max_years=512, cov_threshold=0.0, seed=11)
    _reset_counts()
    log = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log), _guard_counter() as guard:
        res = hl2_seq.run_seq_study(
            cases.rts24(), cfg, device="cuda", log_every=0,
            years_per_device=years_per_step, max_lp=max_lp,
            scheduled_maintenance=True)
    wall = time.perf_counter() - t0
    counts = _counts()
    text = log.getvalue()
    z = {"eens": _z_record(res.eens_mwh_yr, rec["eens"],
                           _per_year_se(res.annual_ens)),
         "lole": _z_record(res.lole_hr_yr, rec["lole"],
                           _per_year_se(res.annual_dlc)),
         "lolf": _z_record(res.lolf_occ_yr, rec["lolf"],
                           _per_year_se(res.annual_nlc))}
    _line("seqmaint", years=res.years, record_years=rec["years"],
          eens_mwh_yr=f"{res.eens_mwh_yr:.3f}",
          record_eens=f"{rec['eens']:.3f}",
          eens_se=f"{_per_year_se(res.annual_ens):.3f}",
          lole_hr_yr=f"{res.lole_hr_yr:.4f}",
          record_lole=f"{rec['lole']:.4f}",
          lolf_occ_yr=f"{res.lolf_occ_yr:.4f}",
          record_lolf=f"{rec['lolf']:.4f}",
          z=json.dumps({k: round(v, 2) for k, v in z.items()}
                       ).replace(" ", "") + f"<={RARE_MAX_Z:g}",
          overflow_hours=res.overflow_hours,
          redos=text.count("redoing batch"),
          promotions=text.count("promoting max_lp"),
          infeasible_hours=res.infeasible_hours, wall_s=f"{wall:.2f}",
          record_tpu_wall_s=f"{rec['wall_s']:.2f}", card=repr(CARD["smi"]),
          lp_lanes_past_guard=_guard_text(guard),
          launches=json.dumps(counts).replace(" ", ""))
    _check_launched("seqmaint", counts, RTS24_KERNELS)
    _record_launches(results, "seqmaint", counts)
    if res.overflow_hours or not all(v <= RARE_MAX_Z for v in z.values()):
        raise RuntimeError(f"seqmaint: z {z} past {RARE_MAX_Z}, or "
                           f"{res.overflow_hours} overflow hours left")

    # K1 and K2 on the step's own LP buffer (8 years x 1,024 lanes).
    case = cases.rts24()
    hours = CompatFlags().hours_per_year_seq
    mt = twostate.mean_times(case)
    step = hl2_seq.make_seq_batch_step(
        sys_, years_per_step, CompatFlags(), IPMConfig(), hours,
        chronological.default_num_draws(mt[:, 0], mt[:, 1], hours), max_lp,
        load_profile.load_factors(hours),
        maint_down=hl2_seq.maintenance_down(case, hours))
    store: list = []
    with _capturing_k1(store):
        step(hl2_nsq.batch_generator(cfg.seed, 0, "cuda"))
    lanes = store[0]
    n = lanes[2].shape[0]
    st = ipm_fused.build_structure(sys_)
    ipm = IPMConfig()
    k1 = _k1_shape(sys_, st, n, ipm, args=lanes, tag="seqmaint",
                   guarded=True)
    k1["device_ms"] = _graph_ms(
        lambda *a: ipm_fused.fused_ipm_iterations(st, *a, ipm), [lanes],
        calls=4, replays=3)
    k1["bound_share"] = k1["bound_ms"] / k1["device_ms"]
    _line("seqmaint", k1_lanes=n, device_ms=f"{k1['device_ms']:.4f}",
          bound_share_of_device=f"{k1['bound_share']:.4f}", library_ms=None)
    M = _polish_factor_inputs(st, lanes)
    r = torch.randn(M.shape[:2], generator=torch.Generator(
        device="cuda").manual_seed(15), device="cuda")
    rows = {"chol_seqmaint": _k2_row("seqmaint", "chol_seqmaint",
                                     "cholesky", (M,), (M,))}
    solve = (bc.cholesky_plain(M), r)
    rows["solve_seqmaint"] = _k2_row("seqmaint", "solve_seqmaint",
                                     "cho_solve", solve, solve)
    _check_k2_rows("seqmaint", rows)
    entry = results.setdefault("fused_ipm_iterations", {})
    entry["seqmaint_shape"] = k1
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                               k1["objective_err_pu"], k1["best_score_err"])
    for kind, name in (("cholesky", "chol_seqmaint"),
                       ("cho_solve", "solve_seqmaint")):
        entry = results.setdefault(kind, {})
        entry.setdefault("path_shapes", {})[name] = rows[name]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                                   rows[name]["abs_err"])
        entry["max_rel_err"] = max(entry.get("max_rel_err", 0.0),
                                   rows[name]["rel_err"])


def phase_multi(results):
    """The multi-area HL1.5 engine on the card: run_demo against
    results/study_sweep.json["multiarea"] from the per-batch partials,
    interconnection against isolation on the demo, RTS-96 and a 4-area
    ring, and the interconnected step's times and K2 launches."""
    import numpy as np
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import multiarea
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, multiarea_demo)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        IPMConfig)
    rec = json.loads((ROOT / "results" / "study_sweep.json").read_text()
                     )["multiarea"]
    parts: list = []
    batches = multiarea.multiarea_batches

    def keep(*a, **kw):
        parts.append(batches(*a, **kw))
        return parts[-1]

    _reset_counts()
    multiarea.multiarea_batches = keep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = multiarea_demo.run_demo(n_years=200, seed=5, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        multiarea.multiarea_batches = batches
    counts = _counts()
    bad = []
    for policy, (loss, eue, ypb) in zip(multiarea_demo.POLICIES, parts):
        zs = {}
        for key, part in (("lole", loss), ("eue", eue)):
            per_batch = part / ypb                      # [n_batches, A]
            for a in range(per_batch.shape[1]):
                zs[f"{key}{a}"] = _z_record(
                    res[policy][key][a], rec[policy][key][a],
                    _per_year_se(per_batch[:, a]))
        _line("multi", policy=policy, batches=loss.shape[0],
              years=loss.shape[0] * ypb,
              lole=json.dumps(np.round(res[policy]["lole"], 3).tolist()
                              ).replace(" ", ""),
              record_lole=json.dumps(rec[policy]["lole"]).replace(" ", ""),
              eue=json.dumps(np.round(res[policy]["eue"], 1).tolist()
                             ).replace(" ", ""),
              record_eue=json.dumps(np.round(rec[policy]["eue"], 1).tolist()
                                    ).replace(" ", ""),
              z=json.dumps({k: round(v, 2) for k, v in zs.items()}
                           ).replace(" ", "") + f"<={RARE_MAX_Z:g}")
        bad += [f"{policy} {k}" for k, v in zs.items() if not v <= RARE_MAX_Z]
    helps = {"demo": res}
    for tag, run in (("rts96", lambda: multiarea_demo.run_rts96_hl15(
                          n_years=50, device="cuda")),
                     ("ring4", lambda: multiarea_demo.run_nring_demo(
                          4, n_years=50, device="cuda"))):
        t1 = time.perf_counter()
        helps[tag] = run()
        _line("multi", system=tag, years=50,
              **{f"{p}_{k}": json.dumps(np.round(helps[tag][p][k], 2)
                                        .tolist()).replace(" ", "")
                 for p in multiarea_demo.POLICIES for k in ("lole", "eue")},
              wall_s=f"{time.perf_counter() - t1:.2f}")
    for tag, out in helps.items():
        iso = np.asarray(out[multiarea.ISOLATED]["eue"])
        inter = np.asarray(out[multiarea.INTERCONNECTED]["eue"])
        if not (inter <= iso + 1e-6).all():
            bad.append(f"{tag}: interconnection worsens an area")
    _line("multi", demo_wall_s=f"{wall:.2f}",
          record_tpu_wall_s=f"{rec['wall_s']:.2f}", card=repr(CARD["smi"]),
          launches=json.dumps({k: counts[k] for k in ("cholesky",
                                                      "cho_solve")}
                              ).replace(" ", ""))
    _check_launched("multi", counts, ("cholesky", "cho_solve"))
    for name in ("cholesky", "cho_solve"):
        results.setdefault(name, {})["launches_multi"] = counts[name]

    # The interconnected step alone: wall and device ms, launches, K2
    # launches a step, under the sync check; the loss hours whose
    # curtailment is float32 noise of the closed-form repair.
    for m, sys_ma in _multiarea_systems().items():
        step = multiarea.make_multiarea_batch_step(
            sys_ma, 8, multiarea.INTERCONNECTED, IPMConfig(iterations=20),
            device="cuda")
        seeds = iter(range(10**6))
        gen = lambda: hl2_nsq.batch_generator(5, next(seeds), "cuda")
        out, sync_ms = _sync_checked(step, lambda i: gen())
        before = dict(bc.launches)
        step(gen())
        k2 = {k: bc.launches[k] - before[k] for k in before}
        wall_ms, dev, n_kernels, kernels = _measure(lambda: step(gen()),
                                                    reps=4)
        margins = _multiarea_margins(sys_ma, gen())
        curt = multiarea.solve_curtailment(margins, sys_ma.tie_from,
                                           sys_ma.tie_to, sys_ma.tie_cap)
        noise = ((curt > 0) & (curt <= MULTI_NOISE_MW)).sum(0)
        _line("multi", step_areas=m, lanes=margins.shape[0],
              wall_ms=f"{wall_ms:.2f}", sync_checked_ms=f"{sync_ms:.2f}",
              device_ms=f"{dev:.3f}", device_busy_share=f"{dev / wall_ms:.3f}",
              kernel_launches=f"{n_kernels:.0f}",
              k2_launches=json.dumps(k2).replace(" ", ""),
              loss_hours=json.dumps((curt > 0).sum(0).tolist()
                                    ).replace(" ", ""),
              noise_loss_hours=json.dumps(noise.tolist()).replace(" ", ""),
              noise_mw=MULTI_NOISE_MW, finite=bool(torch.isfinite(
                  out[1]).all()))
        for e in sorted(kernels, key=_dev_us, reverse=True)[:6]:
            print(f"  step kernel {_dev_us(e) / 1e3 / 4:8.3f} ms/step "
                  f"{e.count / 4:6.0f}x  {e.key[:90]}")
    if bad:
        raise RuntimeError(f"multi: {bad}")


# The multilevel-splitting SEQ study (split) and the command line (cli).
SPLIT_YEARS = 512
SPLIT_SEED, SPLIT_CONTROL_SEED = 16, 17
SPLIT_YEARS_PER_STEP, SPLIT_MAX_LP = 16, 256
SPLIT_K1_YEARS = 64       # the K = 1 reduce-to-plain check, full years
SPLIT_EENS_RTOL = 1e-6


def _split_run(cfg, split, **kw):
    """run_seq_split_study on RTS-24 on the card with the launch counts
    reset; returns (result, wall s, launch counts, its printed log)."""
    import io
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_seq_split)
    _reset_counts()
    log = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        res = hl2_seq_split.run_seq_split_study(
            cases.rts24(), cfg, split, device="cuda", log_every=1,
            years_per_device=SPLIT_YEARS_PER_STEP, max_lp=SPLIT_MAX_LP,
            **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _counts(), log.getvalue()


def _split_z(a, b, se_b=None) -> dict:
    """EENS, LOLE and LOLF z of result ``a`` against ``b`` over their
    combined per-year standard errors (``se_b``: b's, where b keeps no
    per-year values)."""
    import math
    se_b = se_b or {"eens": _per_year_se(b.annual_ens),
                    "lole": _per_year_se(b.annual_dlc),
                    "lolf": _per_year_se(b.annual_nlc)}
    out = {}
    for key, field, years in (("eens", "eens_mwh_yr", a.annual_ens),
                              ("lole", "lole_hr_yr", a.annual_dlc),
                              ("lolf", "lolf_occ_yr", a.annual_nlc)):
        out[key] = abs(getattr(a, field) - getattr(b, field)) / math.hypot(
            _per_year_se(years), se_b[key])
    return out


def phase_split(sys_, results):
    """The multilevel-splitting SEQ study on RTS-24 at the CLI's defaults
    (auto level: entry 0.10, 256-year pilot; K 4, max_split 8, 16 years a
    step, max_lp 256, 8,736-hour years) for 512 years, against the same
    study never splitting (level -1e9, another seed) and against
    results/seq_results.json; K = 1 at -100 MW and 1.2x load equal to the
    never-split run on one seed; the step's times under the sync check;
    K1 and K2 on the step's clone-tail buffer against their plain
    versions."""
    import dataclasses
    import math
    import types
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        batched_chol as bc, ipm_fused)
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq_split)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig, MCSConfig)
    SplitConfig = hl2_seq_split.SplitConfig
    ref = json.loads((ROOT / "results" / "seq_results.json").read_text())
    cfg = MCSConfig(max_years=SPLIT_YEARS, cov_threshold=0.0,
                    seed=SPLIT_SEED)
    with _guard_counter() as guard:
        res, wall, counts, log = _split_run(cfg, SplitConfig())
    _line("split", study="split", lp_lanes_past_guard=_guard_text(guard))
    level = float(log.split("auto-calibrated splitting level: ")[1]
                  .split(" MW")[0])
    ctl, ctl_wall, _, ctl_log = _split_run(
        dataclasses.replace(cfg, seed=SPLIT_CONTROL_SEED),
        SplitConfig(level_mw=-1e9))
    # The record keeps per-year ENS; no per-year DLC or NLC, so their
    # standard errors are taken equal to the split study's own.
    rec = types.SimpleNamespace(**ref)
    z_ctl = _split_z(res, ctl)
    z_rec = _split_z(res, rec, {"eens": _per_year_se(ref["annual_ens"]),
                                "lole": _per_year_se(res.annual_dlc),
                                "lolf": _per_year_se(res.annual_nlc)})
    fmt = lambda z: json.dumps({k: round(v, 2) for k, v in z.items()}  # noqa: E731
                               ).replace(" ", "") + f"<={RARE_MAX_Z:g}"
    _line("split", years=res.years, level_mw=f"{level:.1f}",
          split_entered=res.split_entered,
          split_overflow=res.split_overflow,
          eens_mwh_yr=f"{res.eens_mwh_yr:.3f}",
          eens_se=f"{_per_year_se(res.annual_ens):.3f}",
          lole_hr_yr=f"{res.lole_hr_yr:.4f}",
          lolf_occ_yr=f"{res.lolf_occ_yr:.4f}",
          control_eens=f"{ctl.eens_mwh_yr:.3f}",
          control_eens_se=f"{_per_year_se(ctl.annual_ens):.3f}",
          control_lole=f"{ctl.lole_hr_yr:.4f}",
          control_lolf=f"{ctl.lolf_occ_yr:.4f}",
          record_eens=f"{ref['eens_mwh_yr']:.3f}",
          record_lole=f"{ref['lole_hr_yr']:.4f}",
          record_lolf=f"{ref['lolf_occ_yr']:.4f}",
          z_control=fmt(z_ctl), z_record=fmt(z_rec),
          overflow_hours=res.overflow_hours,
          redos=log.count("redoing batch"),
          control_redos=ctl_log.count("redoing batch"),
          wall_s=f"{wall:.2f}", control_wall_s=f"{ctl_wall:.2f}",
          card=repr(CARD["smi"]),
          launches=json.dumps(counts).replace(" ", ""))
    _check_launched("split", counts, RTS24_KERNELS)
    _record_launches(results, "split", counts)
    bad = [f"control {k}" for k, v in z_ctl.items() if not v <= RARE_MAX_Z]
    bad += [f"record {k}" for k, v in z_rec.items() if not v <= RARE_MAX_Z]
    if bad or res.split_entered == 0 or res.overflow_hours \
            or not math.isfinite(res.eens_mwh_yr):
        raise RuntimeError(f"split: z past {RARE_MAX_Z}: {bad}; or no "
                           f"parent entered, or {res.overflow_hours} "
                           "overflow hours")

    # K = 1 at a level entered mid-year equals the never-split run.
    k1_cfg = MCSConfig(max_years=SPLIT_K1_YEARS, cov_threshold=0.0,
                       seed=SPLIT_SEED)
    never, _, _, _ = _split_run(k1_cfg, SplitConfig(level_mw=-1e9),
                                load_scale=1.2)
    k1, k1_wall, _, _ = _split_run(
        k1_cfg, SplitConfig(level_mw=-100.0, k_clones=1), load_scale=1.2)
    rel = abs(k1.eens_mwh_yr - never.eens_mwh_yr) / never.eens_mwh_yr
    _line("split", k1_years=k1.years, k1_entered=k1.split_entered,
          eens_mwh_yr=f"{k1.eens_mwh_yr:.6f}",
          never_eens=f"{never.eens_mwh_yr:.6f}",
          eens_rel=f"{rel:.2e}<={SPLIT_EENS_RTOL:g}",
          lole_equal=k1.lole_hr_yr == never.lole_hr_yr,
          lolf_equal=k1.lolf_occ_yr == never.lolf_occ_yr,
          wall_s=f"{k1_wall:.2f}")
    if not (rel <= SPLIT_EENS_RTOL and k1.split_entered > 0
            and k1.lole_hr_yr == never.lole_hr_yr
            and k1.lolf_occ_yr == never.lolf_occ_yr):
        raise RuntimeError("split: K = 1 does not reduce to the never-split "
                           "estimate")

    # The step at the study's settings, under the sync check.
    hours = CompatFlags().hours_per_year_seq
    mt = twostate.mean_times(cases.rts24())
    step = hl2_seq_split.make_split_batch_step(
        sys_, SPLIT_YEARS_PER_STEP, CompatFlags(), IPMConfig(), hours,
        chronological.default_num_draws(mt[:, 0], mt[:, 1], hours),
        SPLIT_MAX_LP, load_profile.load_factors(hours),
        SplitConfig(level_mw=level))
    seeds = iter(range(10**6))
    gen = lambda: hl2_nsq.batch_generator(SPLIT_SEED, next(seeds), "cuda")  # noqa: E731
    lanes: list = []
    with _capturing_k1(lanes):
        step(gen())
    k1_lanes = [a[2].shape[0] for a in lanes]
    reps = 4
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(reps):
            out = step(gen())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) * 1e3 / reps
    step_counts = {k: v / reps for k, v in _counts().items() if v}
    _, dev, n_kernels, _ = _measure(lambda: step(gen()), reps=2)
    v = out.cpu().numpy()
    _line("split", step_years=SPLIT_YEARS_PER_STEP, wall_ms=f"{step_wall:.3f}",
          device_ms=f"{dev:.3f}", device_busy_share=f"{dev / step_wall:.3f}",
          kernel_launches=f"{n_kernels:.0f}",
          our_launches=json.dumps(step_counts).replace(" ", ""),
          k1_lanes=json.dumps(k1_lanes).replace(" ", ""),
          entered=int(v[3]), split_overflow=int(v[2]), n_over=int(v[1]),
          level_mw=f"{level:.1f}", card=repr(CARD["smi"]))
    if not (torch.isfinite(out).all() and int(v[1]) == 0):
        raise RuntimeError("split: the step gave non-finite values or "
                           "overflowed its LP buffer")

    # K1 and K2 on the step's clone-tail LP buffer (8 parents x 3 tails x
    # 256 lanes), a shape no other path gives them; the parents' 4,096
    # lanes are the seq phase's shape.
    clone = lanes[1]
    n = clone[2].shape[0]
    st = ipm_fused.build_structure(sys_)
    ipm = IPMConfig()
    k1 = _k1_shape(sys_, st, n, ipm, args=clone, tag="split", guarded=True)
    k1["device_ms"] = _graph_ms(
        lambda *a: ipm_fused.fused_ipm_iterations(st, *a, ipm), [clone],
        calls=4, replays=3)
    k1["bound_share"] = k1["bound_ms"] / k1["device_ms"]
    _line("split", k1_lanes=n, device_ms=f"{k1['device_ms']:.4f}",
          bound_share_of_device=f"{k1['bound_share']:.4f}", library_ms=None)
    M = _polish_factor_inputs(st, clone)
    r = torch.randn(M.shape[:2], generator=torch.Generator(
        device="cuda").manual_seed(16), device="cuda")
    rows = {"chol_split": _k2_row("split", "chol_split", "cholesky", (M,),
                                  (M,))}
    solve = (bc.cholesky_plain(M), r)
    rows["solve_split"] = _k2_row("split", "solve_split", "cho_solve",
                                  solve, solve)
    _check_k2_rows("split", rows)
    entry = results.setdefault("fused_ipm_iterations", {})
    entry["split_shape"] = k1
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                               k1["objective_err_pu"], k1["best_score_err"])
    for kind, name in (("cholesky", "chol_split"),
                       ("cho_solve", "solve_split")):
        entry = results.setdefault(kind, {})
        entry.setdefault("path_shapes", {})[name] = rows[name]
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                                   rows[name]["abs_err"])
        entry["max_rel_err"] = max(entry.get("max_rel_err", 0.0),
                                   rows[name]["rel_err"])


def _cli_main(argv):
    """The CLI's main(argv) in this process: (stdout, stderr, exit code,
    wall s, peak CUDA bytes)."""
    import io
    import torch
    from powersystemsreliabilityassessment_tpu_torch.__main__ import main
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    torch.cuda.synchronize()
    return (out.getvalue(), err.getvalue(), code, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def phase_cli(results):
    """The command line on the card: rts24 / rts96 written with
    save_matpower_case and loaded back field for field; main([...]) in
    this process for nsq (builtin and .m case: the same JSON), seq
    --split-level auto, scaleup on rts96, multiarea on the .m case and
    bench (exit 2); python -m for the multi-area demo; the figure line
    on stderr exactly when matplotlib is absent."""
    import dataclasses
    import importlib.util
    import tempfile
    import numpy as np
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.matpower_io import (
        load_matpower_case, save_matpower_case)
    tmp = Path(tempfile.mkdtemp(prefix="psra_cli_"))
    for name in ("rts24", "rts96"):
        want = getattr(cases, name)()
        path = tmp / f"{name}.m"
        save_matpower_case(want, str(path))
        got = load_matpower_case(str(path))
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            same = (np.allclose(a, b, rtol=1e-9, atol=0)
                    if isinstance(b, np.ndarray) else a == b)
            if not same:
                raise RuntimeError(f"cli: {name}.m loads {f.name} unlike "
                                   "the constructor")
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    runs = {
        "nsq": ["nsq", "--samples", "65536", "--batch", "8192", "--seed",
                "5", "--out", str(tmp / "nsq")],
        "nsq_m": ["nsq", "--samples", "65536", "--batch", "8192", "--seed",
                  "5", "--case", str(tmp / "rts24.m"), "--out",
                  str(tmp / "nsq_m")],
        "seq_split": ["seq", "--split-level", "auto", "--years", "32",
                      "--out", str(tmp / "seq")],
        "scaleup": ["scaleup", "--case", "rts96", "--samples", "16384"],
        "multiarea_case": ["multiarea", "--system", "case", "--case",
                           str(tmp / "rts96.m"), "--years", "10"],
        "bench": ["bench"],
    }
    got, bad = {}, []
    for tag, argv in runs.items():
        _reset_counts()
        out, err, code, wall, peak = _cli_main(argv)
        counts = _counts()
        last = out.strip().splitlines()[-1] if out.strip() else ""
        got[tag] = last
        fig_line = "figures not written" in err
        _line("cli", command=repr(" ".join(argv[:2])), exit=code,
              wall_s=f"{wall:.2f}", peak_cuda_bytes=peak,
              figure_line=fig_line,
              our_launches=json.dumps({k: v for k, v in counts.items()
                                       if v}).replace(" ", ""),
              last_line=repr(last[:160]))
        if tag == "bench":
            if code != 2 or "Queue 1 item 1" not in err:
                bad.append("bench did not exit 2 with its message")
            continue
        if code not in (0, None) or peak <= 0:
            bad.append(f"{tag}: exit {code}, peak CUDA bytes {peak}")
        if tag in ("nsq", "nsq_m", "seq_split"):
            fig = (tmp / "seq" / "convergence_curve.png" if tag == "seq_split"
                   else tmp / tag / "convergence.png")
            if fig_line == have_mpl or fig.exists() != have_mpl:
                bad.append(f"{tag}: figure line {fig_line}, figure "
                           f"{fig.exists()}, matplotlib {have_mpl}")
            missing = [k for k in RTS24_KERNELS if counts[k] <= 0]
            if missing:
                bad.append(f"{tag}: kernels never launched {missing}")
            results.setdefault("fused_ipm_iterations", {})[
                f"launches_cli_{tag}"] = counts["fused_ipm_iterations"]
        try:
            json.loads(last)
        except ValueError:
            bad.append(f"{tag}: last line is not JSON")
    if got["nsq"] != got["nsq_m"]:
        bad.append("nsq on rts24.m printed another JSON than on rts24")
    exports = sorted(p.name for p in (tmp / "seq").iterdir())
    _line("cli", nsq_json_equal=got["nsq"] == got["nsq_m"],
          seq_exports=json.dumps(exports).replace(" ", ""),
          matplotlib=have_mpl)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", PKG, "multiarea", "--system", "demo",
         "--years", "10"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    _line("cli", command=repr("python -m ... multiarea --system demo"),
          exit=proc.returncode, wall_s=f"{time.perf_counter() - t0:.2f}",
          table="MULTI-AREA COMPARISON" in proc.stdout)
    if proc.returncode != 0 or "MULTI-AREA COMPARISON" not in proc.stdout:
        bad.append(f"python -m multiarea: exit {proc.returncode}: "
                   f"{proc.stderr[-400:]}")
    if bad:
        raise RuntimeError(f"cli: {bad}")


MESH_RANKS = 2                 # ranks that share the card over gloo
MESH_LAUNCH_TIMEOUT_S = 300


def _torchrun_start(tag, argv, tmp, nproc=MESH_RANKS, backend="gloo"):
    """Start ``python -m torch.distributed.run --standalone
    --nproc_per_node nproc -m PKG argv`` from the root, each rank's
    output teed with its rank's prefix (``backend`` as PSRA_MESH_BACKEND,
    None: the CLI's own choice). Returns (tag, process, start time) for
    :func:`_torchrun_finish`."""
    import os
    env = dict(os.environ)
    env.pop("PSRA_MESH_BACKEND", None)
    if backend:
        env["PSRA_MESH_BACKEND"] = backend
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "--log-dir",
           str(tmp / f"logs_{tag}"), "--tee", "3", "-m", PKG, *argv]
    return tag, subprocess.Popen(
        cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter()


def _torchrun_finish(started):
    """Wait for a :func:`_torchrun_start` launch; past
    MESH_LAUNCH_TIMEOUT_S torchrun is stopped (it stops its workers),
    then killed. Returns (rank 0's JSON lines, rank 0's output, wall s);
    a failed launch, or a JSON line from another rank, raises."""
    import re
    tag, proc, t0 = started
    try:
        out, err = proc.communicate(timeout=MESH_LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        finally:
            proc.kill()
            proc.communicate()
        raise RuntimeError(f"mesh {tag}: torchrun past "
                           f"{MESH_LAUNCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"mesh {tag}: exit {proc.returncode}:\n"
                           f"{out[-2000:]}\n{err[-3000:]}")
    rank0 = [ln.split(":", 1)[1] for ln in out.splitlines()
             if ln.startswith("[default0]:")]
    if re.search(r"^\[default[1-9]\d*\]:\{", out, re.M):
        raise RuntimeError(f"mesh {tag}: a rank other than 0 printed JSON")
    return ([json.loads(ln) for ln in rank0 if ln.startswith("{")],
            "\n".join(rank0), wall)


def _torchrun(tag, argv, tmp, nproc=MESH_RANKS, backend="gloo"):
    """One launch, alone on the card: :func:`_torchrun_start`, then
    :func:`_torchrun_finish`."""
    return _torchrun_finish(_torchrun_start(tag, argv, tmp, nproc, backend))


def phase_mesh(sys_, results):
    """The scenario mesh (parallel/mesh.py) on the card. 1: one NCCL rank
    in this process (a world of one: the real all_reduce in the real
    step): the bench-shaped step on the mesh bit-equal to the one-device
    step under the sync check, the all_reduce's device time, both steps'
    device time and launches; the 106,496-sample RTS-24 study on the mesh
    bit-equal to the one-device study. 2: two ranks sharing the card
    over gloo, through the CLI under torchrun: that study (z <= 4 against
    results/nsq_results.json), the seq phase's study (EENS z <= 4 against
    results/seq_results.json), one multi-area block and one case300s NSQ
    batch. 3: NCCL across cards on min(count, 4) ranks where the machine
    has two or more."""
    import math
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.parallel import (
        accumulators, mesh as meshlib)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig, MCSConfig)
    tmp = Path(tempfile.mkdtemp(prefix="psra_mesh_"))
    count = torch.cuda.device_count()
    _line("mesh", device_count=count)

    # 1. One NCCL rank in this process.
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                            world_size=1, timeout=meshlib.TIMEOUT)
    try:
        mesh = meshlib.scenario_mesh("cuda:0")
        batch, gen = 262144, hl2_nsq.batch_generator
        kw = dict(max_lp=256, nodal_mode="proportional",
                  shed_hint=dcopf.calibrate_shed_hint(sys_))
        one = hl2_nsq.make_nsq_batch_step(sys_, batch, CompatFlags(),
                                          IPMConfig(), **kw)
        on_mesh = hl2_nsq.make_nsq_batch_step(sys_, batch, CompatFlags(),
                                              IPMConfig(), mesh=mesh, **kw)
        pack = lambda out: accumulators.pack_moments(  # noqa: E731
            out[0], out[1].float(), out[2].float())
        flat = torch.zeros(7 + sys_.n_bus + sys_.n_comp, device="cuda")
        meshlib.psum(mesh, flat)          # the communicator, before timing
        one(gen(0, 10**6, "cuda"))
        on_mesh(gen(0, 10**6, "cuda"))
        torch.cuda.synchronize()
        n_steps = 8
        _reset_counts()
        got = []
        for it in range(n_steps):
            torch.cuda.set_sync_debug_mode("error")
            try:
                got.append(pack(on_mesh(gen(0, it, "cuda"))))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = _counts()
        _check_launched("mesh", counts, RTS24_KERNELS)
        same = sum(torch.equal(g, pack(one(gen(0, it, "cuda"))))
                   for it, g in enumerate(got))
        # 200 all_reduce calls back to back: host ms a call, and ms a call
        # between CUDA events on the compute stream (it waits on NCCL's).
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            meshlib.psum(mesh, flat)
        torch.cuda.synchronize()
        ar_host = (time.perf_counter() - t0) * 1e3 / 200
        ar_ms = _time_ms(lambda: meshlib.psum(mesh, flat), reps=200)
        wall1, dev1, n1, _ = _measure(lambda: one(gen(0, 3, "cuda")), 8)
        wallm, devm, nm, kern = _measure(
            lambda: on_mesh(gen(0, 3, "cuda")), 8)
        nccl = [e for e in kern if "nccl" in e.key.lower()]
        _line("mesh", part="nccl_one_rank_step", batch=batch,
              bit_equal_steps=f"{same}/{n_steps}", sync_checked=True,
              all_reduce_floats=flat.numel(),
              all_reduce_host_ms=f"{ar_host:.4f}",
              all_reduce_event_ms=f"{ar_ms:.4f}",
              nccl_kernels_per_step=f"{sum(e.count for e in nccl) / 8:.0f}",
              nccl_kernel_ms_per_step=(
                  f"{sum(_dev_us(e) for e in nccl) / 1e3 / 8:.4f}"),
              step_wall_ms=f"{wall1:.3f},{wallm:.3f}",
              step_device_ms=f"{dev1:.3f},{devm:.3f}",
              step_launches=f"{n1:.0f},{nm:.0f}",
              order="one_device,mesh",
              launches=json.dumps(counts).replace(" ", ""))
        if same != n_steps:
            raise RuntimeError(f"mesh: {n_steps - same} mesh steps differ "
                               "from the one-device step")
        cfg = MCSConfig(max_samples=106496)
        t0 = time.perf_counter()
        alone = hl2_nsq.run_nsq_study(cases.rts24(), cfg, device="cuda",
                                      log_every=0)
        t1 = time.perf_counter()
        meshed = hl2_nsq.run_nsq_study(cases.rts24(), cfg, log_every=0,
                                       mesh=mesh)
        t2 = time.perf_counter()
        _line("mesh", part="nccl_one_rank_study", samples=meshed.samples,
              edns_mw=repr(meshed.edns_mw), edns_one_device=repr(
                  alone.edns_mw), wall_s=f"{t1 - t0:.2f},{t2 - t1:.2f}")
        if (meshed.edns_history != alone.edns_history
                or meshed.beta != alone.beta):
            raise RuntimeError("mesh: the one-rank study differs from the "
                               "one-device study")
    finally:
        dist.destroy_process_group()

    # 2. Two ranks sharing the card over gloo, through the CLI.
    nsq_ref = json.loads((ROOT / "results" / "nsq_results.json").read_text())
    seq_ref = json.loads((ROOT / "results" / "seq_results.json").read_text())
    dev = ["--device", "cuda:0"]
    jsons, _, wall = _torchrun("nsq", ["nsq", "--samples", "106496", "--out",
                                       str(tmp / "nsq"), *dev], tmp)
    res = jsons[-1]
    rec = json.loads((tmp / "nsq" / "nsq_results.json").read_text())
    z_e, z_p = _nsq_z(nsq_ref, res["edns"], res["beta"], res["plc"],
                      rec["samples"])
    _line("mesh", part="gloo_two_ranks_nsq", json_lines=len(jsons),
          samples=rec["samples"], edns_mw=f"{res['edns']:.4f}",
          plc=f"{res['plc']:.5f}", beta=f"{res['beta']:.5f}",
          edns_z=f"{z_e:.2f}<=4", plc_z=f"{z_p:.2f}<=4",
          overflow=rec["overflow_states"], wall_s=f"{wall:.2f}")
    if not (len(jsons) == 1 and rec["samples"] == 106496 and z_e <= 4
            and z_p <= 4):
        raise RuntimeError("mesh: the two-rank NSQ study is off its record")
    jsons, _, wall = _torchrun("seq", ["seq", "--seed", "1",
                                       "--years-per-device", "8", "--out",
                                       str(tmp / "seq"), *dev], tmp)
    res = jsons[-1]
    rec = json.loads((tmp / "seq" / "seq_results.json").read_text())
    se = lambda v: float(np.std(v, ddof=1) / math.sqrt(len(v)))  # noqa: E731
    z = abs(rec["eens_mwh_yr"] - seq_ref["eens_mwh_yr"]) / math.hypot(
        se(seq_ref["annual_ens"]), se(rec["annual_ens"]))
    _line("mesh", part="gloo_two_ranks_seq", json_lines=len(jsons),
          years=rec["years"], converged=rec["converged"],
          eens_mwh_yr=f"{rec['eens_mwh_yr']:.4f}",
          lole_hr_yr=f"{res['lole']:.4f}", lolf_occ_yr=f"{res['lolf']:.4f}",
          eens_z=f"{z:.2f}<=4", overflow_hours=rec["overflow_hours"],
          wall_s=f"{wall:.2f}")
    if not (len(jsons) == 1 and rec["years"] % 16 == 0 and z <= 4):
        raise RuntimeError("mesh: the two-rank SEQ study is off its record")
    # The multi-area block and the case300s batch side by side: four
    # ranks on the card at once, so their walls overlap.
    started = [_torchrun_start("multiarea", ["multiarea", "--system", "demo",
                                             "--years", "16", *dev], tmp),
               _torchrun_start("case300s", [
                   "nsq", "--case", "case300s", "--samples", "4096",
                   "--batch", "4096", "--out", str(tmp / "n300"), *dev],
                   tmp)]
    (_, out, wall_ma), (jsons, _, wall) = map(_torchrun_finish, started)
    _line("mesh", part="gloo_two_ranks_multiarea", years=16,
          table="MULTI-AREA COMPARISON" in out, wall_s=f"{wall_ma:.2f}",
          beside="case300s")
    if "MULTI-AREA COMPARISON" not in out:
        raise RuntimeError("mesh: no multi-area table from rank 0")
    res = jsons[-1]
    _line("mesh", part="gloo_two_ranks_case300s", states_per_rank=2048,
          edns_mw=f"{res['edns']:.4f}", wall_s=f"{wall:.2f}",
          beside="multiarea")
    if not math.isfinite(res["edns"]):
        raise RuntimeError("mesh: case300s NSQ on two ranks not finite")

    # 3. NCCL between cards.
    if count < 2:
        _line("mesh", part="nccl_across_cards", run=False,
              reason=f"{count} card on this machine: NCCL between cards "
              "was not run")
        return
    ranks = min(count, 4)
    jsons, _, wall = _torchrun("nccl", ["nsq", "--samples", "106496",
                                        "--out", str(tmp / "nccl")], tmp,
                               nproc=ranks, backend=None)
    res = jsons[-1]
    rec = json.loads((tmp / "nccl" / "nsq_results.json").read_text())
    z_e, z_p = _nsq_z(nsq_ref, res["edns"], res["beta"], res["plc"],
                      rec["samples"])
    _line("mesh", part="nccl_across_cards", ranks=ranks,
          edns_mw=f"{res['edns']:.4f}", edns_z=f"{z_e:.2f}<=4",
          plc_z=f"{z_p:.2f}<=4", wall_s=f"{wall:.2f}")
    if not (z_e <= 4 and z_p <= 4):
        raise RuntimeError("mesh: the NCCL study is off its record")


def phase_studyfused(results):
    counts = phase_study("studyfused", fused=True, kernels=FUSED_KERNELS)
    results.setdefault("sample_certify_quick", {})["launches"] = \
        counts["sample_certify_quick"]


def _measure(fn, reps=16):
    """(host wall ms, device kernel ms, kernel launches, kernel events)
    per call. Only kernel events are summed: a CPU op's self device time
    repeats the kernels it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
               and _dev_us(e) > 0]
    dev = sum(_dev_us(e) for e in kernels) / 1e3 / reps
    return wall, dev, sum(e.count for e in kernels) / reps, kernels


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _profile_lines(tag, layers, reps=16, top=12):
    step_kernels, step_dev = None, None
    for name, fn in layers.items():
        wall, dev, n, kernels = _measure(fn, reps)
        step_kernels = step_kernels or kernels
        step_dev = step_dev or dev
        _line(tag, layer=name, wall_ms=f"{wall:.3f}",
              device_ms=f"{dev:.3f}", device_busy_share=f"{dev / wall:.3f}",
              kernel_launches=f"{n:.0f}")
    for e in sorted(step_kernels, key=_dev_us, reverse=True)[:top]:
        print(f"  step kernel {_dev_us(e) / 1e3 / reps:8.3f} ms/step "
              f"{e.count / reps:6.0f}x  {e.key[:90]}")
    # K1's and K4's shares of the step's device time (K1: its template
    # instances).
    for layer, kernel in (("step_k1", "fused_ipm_kernel"),
                          ("step_k4", "quick_kernel")):
        evs = [e for e in step_kernels if kernel in e.key]
        if evs:
            k_ms = sum(_dev_us(e) for e in evs) / 1e3 / reps
            _line(tag, layer=layer, device_ms=f"{k_ms:.3f}",
                  launches=f"{sum(e.count for e in evs) / reps:.3f}",
                  share_of_step_device=f"{k_ms / step_dev:.3f}")
    # K2's share of the step: K2a (the first port's cholesky_kernel or
    # the lane kernel's instances) and K2b, per step.
    k2 = {kind: [e for e in step_kernels if any(n in e.key for n in names)]
          for kind, names in (("chol", ("cholesky_kernel",
                                        "cholesky_lanes_kernel")),
                              ("solve", ("cho_solve_kernel",)))}
    if any(k2.values()):
        k2_ms = {kind: sum(_dev_us(e) for e in evs) / 1e3 / reps
                 for kind, evs in k2.items()}
        _line(tag, layer="step_k2", **{
            f"{kind}_{key}": f"{val:.4f}" for kind, evs in k2.items()
            for key, val in (("device_ms", k2_ms[kind]),
                             ("launches", sum(e.count for e in evs) / reps))},
            share_of_step_device=f"{sum(k2_ms.values()) / step_dev:.4f}")
    # K3's share of the step: K = 1 (trsm_vec_kernel) and K > 1
    # (trsm_cols_kernel), summed over their template instances.
    k3 = {kind: [e for e in step_kernels if f"trsm_{kind}_kernel" in e.key]
          for kind in ("vec", "cols")}
    if any(k3.values()):
        _line(tag, layer="step_k3", **{
            f"{kind}_{key}": f"{val:.3f}" for kind, evs in k3.items()
            for key, val in (
                ("device_ms", sum(_dev_us(e) for e in evs) / 1e3 / reps),
                ("launches", sum(e.count for e in evs) / reps))})


def _rescue_ab(tag, layers, reps=16):
    """Each of ``layers`` (name -> callable) with the warm rescue off
    (``lp_ipm_structured.RESCUE_LANES`` 0: the LP tier as it was before
    the rescue) and on, in the order off, on, on, off in this process:
    host wall ms, device ms and launches per call of each run, and the
    rescue's own launches per call (on less off)."""
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        lp_ipm_structured as ls)
    saved = ls.RESCUE_LANES
    try:
        for name, fn in layers.items():
            runs = []
            for k in (0, saved, saved, 0):
                ls.RESCUE_LANES = k
                runs.append(_measure(fn, reps)[:3])
            join = lambda i: ",".join(f"{r[i]:.3f}" for r in runs)  # noqa: E731
            gain = lambda i: (runs[1][i] + runs[2][i]  # noqa: E731
                              - runs[0][i] - runs[3][i]) / 2
            _line(tag, layer=f"{name}_rescue_ab", order="off,on,on,off",
                  wall_ms=join(0), device_ms=join(1), kernel_launches=join(2),
                  rescue_wall_ms=f"{gain(0):.3f}",
                  rescue_device_ms=f"{gain(1):.3f}",
                  rescue_launches=f"{gain(2):.1f}")
    finally:
        ls.RESCUE_LANES = saved


def phase_profile(sys_):
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.ops import (
        fused_sampler_cert)
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
    down = sample_states(gen(), sys_.unavail, sys_.always_up_nsq, batch)
    pre = dcopf.certify_states(sys_, down, load, shed_hint=hint_b,
                               repair_buffer=rbuf)
    idx = dcopf._topk_lanes(~pre.certified, max_lp)
    _profile_lines("profile", {
        "step": lambda: step(gen()),
        "sampling": lambda: sample_states(
            gen(), sys_.unavail, sys_.always_up_nsq, batch),
        "tier1": lambda: dcopf.certify_states(
            sys_, down, load, shed_hint=hint_b, repair_buffer=rbuf),
        "lp_tier": lambda: dcopf.evaluate_states(sys_, down[idx], load[idx]),
    })
    _rescue_ab("profile", {
        "step": lambda: step(gen()),
        "lp_tier": lambda: dcopf.evaluate_states(sys_, down[idx], load[idx]),
    })
    # The fused step (fused_tier1) and its two tier-1 layers.
    fused = hl2_nsq.make_nsq_batch_step(
        sys_, batch, CompatFlags(), IPMConfig(), max_lp=max_lp,
        nodal_mode="proportional", shed_hint=hint, fused_tier1=True)
    hint_t = hint_b[0]
    # Packed once, as the fused step does.
    ops = fused_sampler_cert.kernel_operands(sys_, hint_t)
    dq, okq, deq, shq = fused_sampler_cert.sample_certify_quick(
        gen(), sys_, batch, shed_hint=hint_t, operands=ops)
    fbuf = dcopf.default_finish_buffer(batch, hinted=True)
    _profile_lines("profile_fused", {
        "step_fused": lambda: fused(gen()),
        "sample_certify_quick": lambda: fused_sampler_cert.
        sample_certify_quick(gen(), sys_, batch, shed_hint=hint_t,
                             operands=ops),
        "certify_finish": lambda: dcopf.certify_finish(
            sys_, dq, load, deq, shq, okq, fbuf),
    })


def phase_profile_seq(sys_):
    """The SEQ step (16 years x 8,736 hours, max_lp 256 a year) by
    layer: the year-block draw, the certificate on the flat block, the
    LP tier on its 4,096-lane buffer, and the whole evaluation."""
    from powersystemsreliabilityassessment_tpu_torch.core import (
        cases, load_profile)
    from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
    from powersystemsreliabilityassessment_tpu_torch.models import twostate
    from powersystemsreliabilityassessment_tpu_torch.sampling import (
        chronological)
    from powersystemsreliabilityassessment_tpu_torch.studies import (
        hl2_nsq, hl2_seq)
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    hours, years, max_lp = 8736, 16, 256
    mt = twostate.mean_times(cases.rts24())
    k = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    factors = load_profile.load_factors(hours)
    load = hl2_seq.year_block_load(sys_, factors, years)
    step = hl2_seq.make_seq_batch_step(sys_, years, CompatFlags(),
                                       IPMConfig(), hours, k, max_lp,
                                       factors)
    seeds = iter(range(10**7))
    gen = lambda: hl2_nsq.batch_generator(4, next(seeds), "cuda")
    down = hl2_seq.sample_years(gen(), sys_, years, hours, k)
    flat = down.transpose(1, 2).reshape(years * hours, -1)
    rbuf = years * hours // 16
    cert = dcopf.certify_states(sys_, flat, load, repair_buffer=rbuf)
    idx = dcopf._topk_lanes(~(cert.certified & (cert.deficit <= 0)),
                            years * max_lp)
    _reset_counts()
    _profile_lines("profile_seq", {
        "step": lambda: step(gen()),
        "sampling": lambda: hl2_seq.sample_years(gen(), sys_, years, hours,
                                                 k),
        "evaluation": lambda: hl2_seq.evaluate_years(
            sys_, CompatFlags(), IPMConfig(), load, down, years * max_lp),
        "tier1": lambda: dcopf.certify_states(sys_, flat, load,
                                              repair_buffer=rbuf),
        "lp_tier": lambda: dcopf.evaluate_states(sys_, flat[idx],
                                                 load[idx]),
    })
    _rescue_ab("profile_seq", {
        "step": lambda: step(gen()),
        "lp_tier": lambda: dcopf.evaluate_states(sys_, flat[idx],
                                                 load[idx]),
    })


def phase_profile96(sys96):
    """The RTS-96 study step (batch 8192, "lp" nodal mode, the default
    max_lp 2048) by layer, with the LP tier split into its parts, each
    timed alone at the step's shapes: the normal-matrix product (16 per
    LP solve), the blocked factor (16 + 2 polish) and the blocked solve
    (32 + 3 polish), and the polish."""
    import torch
    from powersystemsreliabilityassessment_tpu_torch.engines import (
        dcopf, lp_ipm_batched as lpb)
    from powersystemsreliabilityassessment_tpu_torch.ops import blocked_chol
    from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
        sample_states)
    from powersystemsreliabilityassessment_tpu_torch.studies import hl2_nsq
    from powersystemsreliabilityassessment_tpu_torch.utils.config import (
        CompatFlags, IPMConfig)
    st = _rts96_step(sys96, seed=2)
    batch, max_lp, wk, rbuf = st["batch"], st["max_lp"], st["wk"], st["rbuf"]
    down, load, hint_b, idx = st["down"], st["load"], st["hint_b"], st["idx"]
    c, A, b, l, u = st["lp"]
    step = hl2_nsq.make_nsq_batch_step(
        sys96, batch, CompatFlags(), IPMConfig(), max_lp=max_lp,
        nodal_mode="lp", woodbury_k=wk, shed_hint=st["hint"])
    seeds = iter(range(1, 10**7))
    gen = lambda: hl2_nsq.batch_generator(2, next(seeds), "cuda")
    ops = lpb.dense_linops(A)
    mats: list = []
    polish_args: list = []
    orig_polish = lpb.polish_box_lp

    def polish(*a, **k):
        polish_args.append((a, k))
        return orig_polish(*a, **k)

    lpb.polish_box_lp = polish
    try:
        with _capturing_blocked_factor(mats):
            lpb.solve_box_lp_batched(c, A, b, l, u, IPMConfig())
    finally:
        lpb.polish_box_lp = orig_polish
    d = torch.clamp(4.0 / (u - l), 1e-6, 1e10)   # the box midpoint's
    M8 = mats[8]
    F8 = blocked_chol.blocked_cholesky(M8)
    r = M8.sum(2)
    _reset_counts()
    _profile_lines("profile96", {
        "step": lambda: step(gen()),
        "sampling": lambda: sample_states(
            gen(), sys96.unavail, sys96.always_up_nsq, batch),
        "tier1": lambda: dcopf.certify_states(
            sys96, down, load, shed_hint=hint_b, repair_buffer=rbuf,
            woodbury_k=wk),
        "lp_tier": lambda: dcopf.evaluate_states(
            sys96, down[idx], load[idx], woodbury_k=wk),
        "lp_normal_x1": lambda: ops.normal(d),
        "lp_blocked_factor_x1": lambda: blocked_chol.blocked_cholesky(M8),
        "lp_blocked_solve_x1": lambda: blocked_chol.blocked_cho_solve(F8, r),
        "lp_polish": lambda: orig_polish(*polish_args[0][0],
                                         **polish_args[0][1]),
    }, reps=4)
    _line("profile96", lp_lanes=idx.shape[0], need_lp=int(st["need"].sum()),
          factorizations_per_lp_solve=len(mats),
          rescues_while_profiling=json.dumps(
              {k: int(v) for k, v in blocked_chol.rescues.items()})
          .replace(" ", ""))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of "
                    + ",".join(ALL_PHASES + EXTRA_PHASES))
    phases = ap.parse_args().phases.split(",")
    unknown = set(phases) - set(ALL_PHASES + EXTRA_PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    CARD["smi"] = phase_device()
    sys.path.insert(0, str(ROOT))
    import torch
    from powersystemsreliabilityassessment_tpu_torch.core import cases
    from powersystemsreliabilityassessment_tpu_torch.core.system import (
        build_system)
    results: dict = {}
    phase_build()
    sys_ = build_system(cases.rts24(), device="cuda")
    sys96 = build_system(cases.rts96(), device="cuda")
    if "k2" in phases:
        phase_k2(sys_, sys96, results)
    if "k1" in phases:
        phase_k1(sys_, results)
    if "faulta" in phases:
        phase_faulta(sys_, results)
    if "bench" in phases:
        phase_bench(sys_, results)
    if "study" in phases:
        phase_study()
    if "k3" in phases:
        phase_k3(sys96, results)
    if "study96" in phases:
        phase_study96(sys96, results)
    if "k6" in phases:
        phase_k6(sys_, results)
    if "k4" in phases:
        phase_k4(sys_, results)
    if "k5" in phases:
        phase_k5(sys_, sys96, results)
    if "studyfused" in phases:
        phase_studyfused(results)
    if "seq" in phases:
        phase_seq(sys_, results)
    if "lp300" in phases:
        phase_lp300(results)
    if "pf300" in phases:
        phase_pf300()
    if "study300" in phases:
        phase_study300(results)
    if "anti" in phases:
        phase_anti(results)
    if "is24" in phases:
        phase_is24(sys_, results)
    if "mix300" in phases:
        phase_mix300(results)
    if "ce300" in phases:
        phase_ce300(results)
    if "enum24" in phases:
        phase_enum24(results)
    if "cv24" in phases:
        phase_cv24(results)
    if "cvseq" in phases:
        phase_cvseq(results)
    if "seqib" in phases:
        phase_seqib(results)
    if "hl1" in phases:
        phase_hl1(results)
    if "plan" in phases:
        phase_plan()
    if "seqmaint" in phases:
        phase_seqmaint(sys_, results)
    if "multi" in phases:
        phase_multi(results)
    if "split" in phases:
        phase_split(sys_, results)
    if "cli" in phases:
        phase_cli(results)
    if "seq300" in phases:
        phase_seq300(results)
    if "seq96" in phases:
        phase_seq96(results)
    if "mesh" in phases:
        phase_mesh(sys_, results)
    if "seq300full" in phases:
        phase_seq300full(results)
    if "profile" in phases:
        phase_profile(sys_)
        phase_profile96(sys96)
    if "profileseq" in phases:
        phase_profile_seq(sys_)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
