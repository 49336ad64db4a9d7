"""HL2 non-sequential Monte Carlo study (the ``nsqMain.m`` path).

Port of ``powersystemsreliabilityassessment_tpu/studies/hl2_nsq.py``.
Per batch, on each device of the scenario mesh: sample Bernoulli
component states at fixed peak load (plain, antithetic,
importance-sampled with its scopes or a cross-entropy proposal, or a
defensive mixture over component groups), evaluate them with the
two-tier DC-OPF evaluator (``engines/dcopf.py``), and reduce the index
partial sums. The host folds the partial sums into float64 running
statistics and applies the beta stopping rule (beta < ``beta_limit`` or
``max_samples``, nsqMain.m:60-61). The weighted samplers' moments are
importance-sampling estimates (``accumulators.batch_moments(weight=)``).
Two options carry exact means on the host: the copper-sheet control
variate (``control_variate``: the moments track DNS minus the state's
copper deficit, whose exact mean comes from a float64 COPT) and the
enumeration hybrid (``enum_order``: every state with at most that many
outages is evaluated once, exactly, by ``sampling/enumeration.py``, and
the Monte Carlo counts only the deeper tail).

Threefry keys become one ``torch.Generator`` per batch and rank, seeded
from (study seed, batch index, rank): a batch is reproducible from its
index, which the grow-and-redo protocol relies on. ``MCSConfig.
fused_tier1`` samples and first-pass-certifies each batch in the K4
kernel (``ops/fused_sampler_cert.py``). A ``runtime.checkpoint.
Checkpointer`` saves the host state every few batches, and a study given
one resumes from it.

On a scenario mesh of N ranks (``parallel/mesh.py``; one process per
device under torchrun) each rank draws ``batch_size // N`` states a
batch from its own generator, and the step sums the packed partials
over the ranks in one ``all_reduce`` before the host reads them, as the
reference ``psum``s inside ``shard_map``. Every host decision (grow-and-
redo, the beta stop, ``max_samples``) reads only summed numbers, so
every rank takes the same branch and issues the same collectives; every
rank runs the pre-passes and takes rank 0's results
(``parallel.mesh.from_rank0``), and rank 0 alone writes the checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core.cases import CaseData
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    System, build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import copt, dcopf
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.ops import fused_sampler_cert
from powersystemsreliabilityassessment_tpu_torch.parallel import (
    accumulators, mesh as meshlib)
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.runtime.host_loop import (
    double_buffered_loop)
from powersystemsreliabilityassessment_tpu_torch.sampling import enumeration
from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
    sample_states, sample_states_importance, sample_states_mixture)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)
from powersystemsreliabilityassessment_tpu_torch.utils.profiling import (
    span, traced)


# The LP buffer's cap where tier 1.5 is on (m > 336): the reference's
# memory envelope of a large-m IPM buffer on a 15.75 GB chip (reference
# ``studies/hl2_nsq.py::default_max_lp``), kept so that the study can be
# compared with its artifact; not sized again for the H100's 80 GB yet
# (ROADMAP.md Queue 1 item 1, the constants).
PF_TIER_LP_CAP = 2048
# The proportional-mode buffer with tier 1.5 on: its misses are ~0.1% of
# lanes (results/r4_miss.json), and <= 128 lanes cost the large-m LP
# about the same.
PF_TIER_PROPORTIONAL_LP = 128


def default_max_lp(batch_per_device: int, nodal_mode: str = "lp",
                   is_boost: float = 0.0, is_boost_scope: str = "all",
                   pf_tier: bool = False) -> int:
    """Default LP-lane buffer per batch; mirrors reference
    ``studies/hl2_nsq.py::default_max_lp``: "lp" mode sends every
    positive-deficit state to the LP (~10% of RTS-24 peak states), so
    25%; "proportional" mode only certificate failures (~0.04%), so
    1.56%. Importance sampling that boosts branches (scope "all" or
    "branches") multiplies the certificate's misses, and any boost in
    "lp" mode the deficit states: 50%. ``pf_tier`` (tier 1.5 on, m > 336)
    caps it at ``PF_TIER_LP_CAP``, and unboosted in "proportional" mode
    at ``PF_TIER_PROPORTIONAL_LP``. Overflow self-corrects through
    grow-and-redo. These are TPU-era settings not yet measured again on
    the H100."""
    if is_boost > 1.0 and (is_boost_scope in ("all", "branches")
                           or nodal_mode == "lp"):
        frac = 2
    elif nodal_mode == "proportional":
        frac = 64
    else:
        frac = 4
    lanes = max(batch_per_device // frac, 16)
    if pf_tier:
        lanes = min(lanes, PF_TIER_LP_CAP)
        if nodal_mode == "proportional" and is_boost <= 1.0:
            lanes = min(lanes, PF_TIER_PROPORTIONAL_LP)
    return lanes


def default_woodbury_k(sys: System, is_boost: float = 0.0,
                       is_boost_scope: str = "all",
                       q_vec: np.ndarray | None = None) -> int:
    """Certificate rank: 2 unless >= 3 simultaneous branch outages have
    probability >= 1e-4 under the sampling measure (Poisson bound), then
    4. The measure includes the boost where its scope covers branches;
    ``q_vec`` gives the cross-entropy proposal's rates directly. Mirrors
    reference ``studies/hl2_nsq.py::default_woodbury_k``. Plain MC
    resolves RTS-24 to 2, RTS-96 and case300s to 4."""
    if q_vec is not None:
        q = np.asarray(q_vec, np.float64)[sys.n_gen:]
    else:
        q = sys.unavail.detach().cpu().numpy().astype(np.float64)[sys.n_gen:]
        if is_boost > 1.0 and is_boost_scope in ("all", "branches"):
            q = np.minimum(is_boost * q, 0.5)
    lam = float(q.sum())
    p_ge3 = 1.0 - np.exp(-lam) * (1.0 + lam + lam * lam / 2.0)
    return 2 if p_ge3 < 1e-4 else 4


def gen_area_masks(case: CaseData) -> np.ndarray | None:
    """[K, n_comp] bool: one row per area's generators, the groups of
    :func:`sampling.state.sample_states_mixture`; None without
    ``case.bus_area`` or with one area. Mirrors reference
    ``studies/hl2_nsq.py::gen_area_masks``."""
    if case.bus_area is None:
        return None
    areas = np.unique(case.bus_area)
    if areas.size < 2:
        return None
    gen_area = np.asarray(case.bus_area)[np.asarray(case.gen_bus)]
    masks = np.zeros((areas.size, case.n_comp), bool)
    for i, a in enumerate(areas):
        masks[i, :case.n_gen] = gen_area == a
    return masks[masks.any(axis=1)]


def _generator(entropy: tuple, device) -> torch.Generator:
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words.view(np.uint64)[0]))
    return gen


# The word that keeps a rank's batch generators apart from every other
# generator of the port: pilot_generator already derives from (seed,
# round, chunk), so a rank's (seed, batch, rank) would replay CE pilot
# and splitting-level streams inside the same study.
RANK_TAG = 0x52414E4B


def batch_generator(seed: int, batch_idx: int, device: torch.device | str,
                    rank: int = 0) -> torch.Generator:
    """The generator of batch ``batch_idx`` of a study seeded ``seed`` on
    mesh rank ``rank`` (Philox on CUDA); takes the place of the
    reference's ``fold_in(fold_in(root, i), device)``
    (``studies/hl2_nsq.py::run_nsq_study``, ``device_step``).
    Deterministic in (seed, batch_idx, rank), so a redo of a batch draws
    the same states. Rank 0 derives from (seed, batch_idx) alone, so a
    one-rank study draws what a study without a mesh draws; rank r > 0
    from (seed, batch_idx, :data:`RANK_TAG`, r)."""
    if rank == 0:
        return _generator((seed, batch_idx), device)
    return _generator((seed, batch_idx, RANK_TAG, rank), device)


def pilot_generator(seed: int, round_idx: int, chunk_idx: int,
                    device: torch.device | str) -> torch.Generator:
    """The generator of chunk ``chunk_idx`` of round ``round_idx`` of a
    cross-entropy pilot seeded ``seed``, derived as
    :func:`batch_generator` derives a batch's; takes the place of the
    reference's ``fold_in(fold_in(key(seed), r), j)``
    (``studies/hl2_nsq.py::calibrate_ce_proposal``)."""
    return _generator((seed, round_idx, chunk_idx), device)


def calibrate_ce_proposal(sys: System, compat: CompatFlags, ipm: IPMConfig,
                          batch: int = 32768, rounds: int = 2,
                          boost0: float = 4.0, smoothing: float = 0.7,
                          seed: int = 1717,
                          shed_hint: np.ndarray | None = None,
                          log_every: int = 1):
    """Cross-entropy calibration of a per-component importance proposal
    from pilot batches; mirrors reference
    ``studies/hl2_nsq.py::calibrate_ce_proposal``.

    The CE-optimal product-form proposal for E[f] (f = DNS) has marginals
    q_k* = E_p[f 1(k down)] / E_p[f], estimated self-normalized under the
    current proposal. Round 0 starts from a uniform branch boost
    ``boost0``; each round replaces q by ``smoothing`` q_CE + (1 -
    ``smoothing``) q, clamped to [U, 0.5], 0 on pinned components. The
    pilot runs in chunks of min(batch, 8192) samples with an LP buffer of
    min(chunk, 1024) lanes and tier 1.5 where the system takes it, one
    generator per (seed, round, chunk) (:func:`pilot_generator`); each
    chunk's sums are read on the host once. An overflow only blunts the
    learned tilt: the study's weights are exact for any q.

    Returns (q float32 [n_comp], diagnostics), or (None, diagnostics)
    when a round sees fewer than 8 deficit events.
    """
    ng = sys.n_gen
    U = sys.unavail.detach().cpu().numpy().astype(np.float64)
    always = sys.always_up_nsq.detach().cpu().numpy()
    q = U.copy()
    q[ng:] = np.minimum(boost0 * np.maximum(U[ng:], 1e-9), 0.5)
    q = np.where(always, 0.0, q)

    chunk = min(batch, 8192)
    n_chunks = (batch + chunk - 1) // chunk
    load = sys.load_pd[None, :].expand(chunk, sys.n_load)
    hint = (None if shed_hint is None else torch.as_tensor(
        shed_hint, dtype=sys.load_pd.dtype, device=sys.device))
    max_lp = min(chunk, 1024)
    wk = default_woodbury_k(sys, q_vec=q)
    pf_buffer = dcopf.default_pf_buffer(sys, chunk)

    def pilot(gen, qv):
        down, w = sample_states_importance(gen, sys.unavail,
                                           sys.always_up_nsq, chunk, 0.0,
                                           q_override=qv)
        res, n_over = dcopf.evaluate_states_screened(
            sys, down, load, max_lp, compat, ipm, "proportional",
            repair_buffer=None, woodbury_k=wk, shed_hint=hint,
            pf_buffer=pf_buffer)
        f = res.dns_mw
        wf = w * f
        sums = torch.stack([wf.sum(), (wf * wf).sum(),
                            (f > 0).sum().to(f.dtype), n_over.to(f.dtype)])
        return torch.cat([wf @ down.to(f.dtype), sums])

    # The pilot draws n_chunks * chunk samples (>= batch when batch is
    # not a chunk multiple); the rel-var diagnostic uses that count.
    n_total = n_chunks * chunk
    diag = {"rounds": [], "batch": batch, "n_pilot": n_total,
            "boost0": boost0, "chunk": chunk}
    for r in range(rounds):
        qv = torch.as_tensor(q, dtype=sys.unavail.dtype, device=sys.device)
        acc = np.zeros(sys.n_comp + 4)
        for j in range(n_chunks):
            acc += pilot(pilot_generator(seed, r, j, sys.device),
                         qv).cpu().numpy().astype(np.float64)
        swfx = acc[:sys.n_comp]
        swf, swf2, n_events, n_over = acc[sys.n_comp:]
        rvar = float(n_total * swf2 / max(swf * swf, 1e-30) - 1.0)
        diag["rounds"].append({
            "round": r, "events": int(n_events), "overflow": int(n_over),
            "rel_var_wf": round(rvar, 3),
            "sum_q_branches": round(float(q[ng:].sum()), 4)})
        if log_every:
            print(f"CE round {r}: {int(n_events)} deficit events, "
                  f"rel-var(wf) {rvar:.1f}, sum q_br {q[ng:].sum():.3f}, "
                  f"overflow {int(n_over)}")
        if swf <= 0.0 or n_events < 8:
            return None, diag
        q_ce = np.clip(swfx / swf, 0.0, 1.0)
        q = smoothing * q_ce + (1.0 - smoothing) * q
        q = np.clip(q, U, 0.5)
        q = np.where(always, 0.0, q)
    return q.astype(np.float32), diag


def sparsify_ce_proposal(q: np.ndarray, sys: System, top_k: int = 8,
                         q_cap: float = 0.05,
                         branches_only: bool = True) -> np.ndarray:
    """Keep a CE-learned tilt on its ``top_k`` components by q / U
    (branches only by default), at max(U, min(q, ``q_cap``)); U
    everywhere else, 0 on pinned components. Every likelihood weight is
    then bounded by ~exp(top_k q_cap). Float64 numpy; mirrors reference
    ``studies/hl2_nsq.py::sparsify_ce_proposal``, except that a
    component whose ratio is 0 is never kept (the reference keeps some
    when fewer than ``top_k`` ratios are positive)."""
    ng = sys.n_gen
    U = sys.unavail.detach().cpu().numpy().astype(np.float64)
    always = sys.always_up_nsq.detach().cpu().numpy()
    ratio = np.asarray(q, np.float64) / np.maximum(U, 1e-9)
    if branches_only:
        ratio[:ng] = 0.0
    ratio[always] = 0.0
    keep = np.argsort(ratio)[::-1][:top_k]
    # Only components with a positive ratio: the reference pads the keep
    # set with zero-ratio ones, which tilts generators under
    # branches_only (ROADMAP.md Queue 3, faults in the reference).
    keep = keep[ratio[keep] > 0.0]
    out = U.copy()
    # max(U, min(q, cap)): a capped up-tilt, never below the true rate.
    out[keep] = np.maximum(U[keep],
                           np.minimum(np.asarray(q, np.float64)[keep],
                                      q_cap))
    out[always] = 0.0
    return out.astype(np.float32)


def make_nsq_batch_step(sys: System, batch_per_device: int,
                        compat: CompatFlags, ipm: IPMConfig,
                        max_lp: int | None = None, nodal_mode: str = "lp",
                        woodbury_k: int | None = None,
                        shed_hint: np.ndarray | None = None,
                        fused_tier1: bool = False, antithetic: bool = False,
                        is_boost: float = 0.0, is_boost_scope: str = "all",
                        is_q: np.ndarray | None = None,
                        mix: tuple | None = None,
                        cv_arrays: tuple | None = None,
                        enum_order: int = 0, mesh=None):
    """One-batch step ``generator -> (BatchMoments, n_overflow,
    n_infeasible)``, all device tensors; mirrors reference
    ``studies/hl2_nsq.py::make_nsq_batch_step``. On a ``mesh`` with a
    group (``parallel/mesh.py``) the step packs its partials, sums them
    over the ranks in one ``all_reduce`` and returns views of the sum
    (the counts then float32); without one (None: ``sys``'s device alone)
    it returns its own partials. At m <= 336
    the step only enqueues device work: nothing in it waits for the
    device (``torch.cuda.set_sync_debug_mode("error")`` passes over it).
    At m > 336 tier 1.5 is on (``dcopf.default_pf_buffer``) and the LP
    buffer's large-m solve reads on the host (each Schur inverse's probe
    and the rescue ladder's gates): ~40 syncs a step on case300s.

    The sampler, in the reference's order of precedence: ``fused_tier1``
    (the K4 kernel draws and first-pass-certifies the batch, then
    ``dcopf.certify_finish`` completes the certificate; plain MC only,
    and unlike the reference no fallback to the default path: a CPU
    system runs the kernel's plain version); ``is_q`` (the cross-entropy
    proposal's rates [n_comp]); ``mix = (group_masks [K, n_comp], boost,
    alpha0)`` (the defensive mixture); ``is_boost > 0`` (importance
    sampling on ``is_boost_scope``'s components: "all", "gens" or
    "branches"); else plain MC, ``antithetic`` pairing if asked. The
    weighted samplers' weights enter the moments. Combinations the
    reference asserts against raise ValueError.

    ``max_lp`` None takes ``batch // 8`` under ``is_q``, ``min(max(batch
    // 16, 128), 2048)`` under ``mix``, else :func:`default_max_lp`.
    ``woodbury_k`` None takes :func:`default_woodbury_k` under the
    sampling measure.

    ``cv_arrays = (gen_cap_mw [ng], total_load_mw, mu_e, mu_l)`` turns on
    the copper-sheet control variate: each state's copper deficit c =
    max(total load - up capacity, 0) MW and its flag c > the failure
    threshold go to ``batch_moments(cv=...)``, which keeps the residuals
    (the exact means live on the host, :func:`run_nsq_study`).
    ``enum_order > 0`` masks every state with at most that many
    components down out of the moments (``n`` still counts it): the
    enumeration pre-pass carries those states exactly. The two exclude
    each other, as in the reference."""
    if antithetic and (is_boost > 0 or is_q is not None):
        raise ValueError("antithetic and importance sampling are mutually "
                         "exclusive")
    if is_q is not None and (is_boost > 0 or fused_tier1):
        raise ValueError("is_q (the CE proposal) replaces is_boost; "
                         "fused_tier1 is plain MC only")
    if mix is not None and (is_boost > 0 or is_q is not None or antithetic
                            or fused_tier1):
        raise ValueError("mix (defensive mixture sampling) excludes every "
                         "other sampler option")
    if fused_tier1 and (antithetic or is_boost > 0 or enum_order > 0
                        or compat.island_blackout):
        raise ValueError("fused_tier1 supports plain MC only (no pairing, "
                         "weights, enumeration tail mask or blackout)")
    if enum_order > 0 and (cv_arrays is not None or mix is not None):
        raise ValueError("enum_order excludes the control variate (both "
                         "carry exact-mean offsets) and the mixture")
    if is_boost_scope not in ("all", "gens", "branches"):
        raise ValueError(f"unknown is_boost_scope {is_boost_scope!r}; "
                         "expected 'all', 'gens' or 'branches'")
    pf_buffer = dcopf.default_pf_buffer(sys, batch_per_device)
    if max_lp is None:
        if is_q is not None:
            max_lp = max(batch_per_device // 8, 16)
        elif mix is not None:
            max_lp = min(max(batch_per_device // 16, 128), 2048)
        else:
            max_lp = default_max_lp(batch_per_device, nodal_mode, is_boost,
                                    is_boost_scope,
                                    pf_tier=pf_buffer is not None)
    if woodbury_k is None:
        woodbury_k = default_woodbury_k(sys, is_boost, is_boost_scope,
                                        q_vec=is_q)
    if not 2 <= woodbury_k <= 4:
        # The unrolled Cramer solves are characterized for k <= 4 only.
        raise ValueError(f"woodbury_k must be in [2, 4], got {woodbury_k}")
    hinted = shed_hint is not None
    repair_buffer = dcopf.default_repair_buffer(
        batch_per_device,
        max(is_boost, 2.0 if (is_q is not None or mix is not None) else 1.0),
        hinted=hinted)
    load = sys.load_pd[None, :].expand(batch_per_device, sys.n_load)
    # The sampler's operands go to the device once here: a host-to-device
    # copy inside the step would synchronize the stream every batch.
    if hinted:
        shed_hint = torch.as_tensor(shed_hint, dtype=sys.load_pd.dtype,
                                    device=sys.device)
    boost_mask = None
    if is_boost > 0 and is_boost_scope != "all":
        gens = torch.arange(sys.n_comp, device=sys.device) < sys.n_gen
        boost_mask = gens if is_boost_scope == "gens" else ~gens
    if is_q is not None:
        q_dev = torch.as_tensor(np.asarray(is_q), dtype=sys.unavail.dtype,
                                device=sys.device)
    if mix is not None:
        mix_masks = torch.as_tensor(np.asarray(mix[0], bool),
                                    device=sys.device)
        mix_boost, mix_alpha0 = float(mix[1]), float(mix[2])
    if cv_arrays is not None:
        gen_cap_mw = torch.as_tensor(np.asarray(cv_arrays[0], np.float32),
                                     device=sys.device)
        total_load_mw = float(np.float32(cv_arrays[1]))
    if fused_tier1:
        fused_sampler_cert.check_supported(sys)
        finish_buffer = dcopf.default_finish_buffer(batch_per_device,
                                                    hinted=hinted)
        # The kernel's packed operands depend only on (sys, hint): packed
        # once here, so the step adds one seed draw and one launch.
        quick_ops = fused_sampler_cert.kernel_operands(
            sys, fused_sampler_cert.hint_row(sys, shed_hint))

    def step(generator: torch.Generator):
        pre, weight = None, None
        unavail, up = sys.unavail, sys.always_up_nsq
        with span("sampling.states"):
            if fused_tier1:
                down, ok1, deficit, shed = \
                    fused_sampler_cert.sample_certify_quick(
                        generator, sys, batch_per_device,
                        shed_hint=shed_hint, operands=quick_ops)
            elif is_q is not None:
                down, weight = sample_states_importance(
                    generator, unavail, up, batch_per_device, 0.0,
                    q_override=q_dev)
            elif mix is not None:
                down, weight = sample_states_mixture(
                    generator, unavail, up, batch_per_device, mix_masks,
                    mix_boost, mix_alpha0)
            elif is_boost > 0:
                down, weight = sample_states_importance(
                    generator, unavail, up, batch_per_device, is_boost,
                    boost_mask=boost_mask)
            elif antithetic:
                down = sample_states(generator, unavail, up,
                                     batch_per_device, antithetic=True)
            else:
                down = sample_states(generator, unavail, up,
                                     batch_per_device)
        if fused_tier1:
            pre = dcopf.certify_finish(sys, down, load, deficit, shed, ok1,
                                       finish_buffer, woodbury_k=woodbury_k)
        res, n_over = dcopf.evaluate_states_screened(
            sys, down, load, max_lp, compat, ipm, nodal_mode,
            repair_buffer=repair_buffer, woodbury_k=woodbury_k,
            shed_hint=shed_hint, pre=pre, pf_buffer=pf_buffer)
        dns, nodal, failure = res.dns_mw, res.nodal_mw, res.failure
        if enum_order > 0:
            tail = down.sum(1) > enum_order
            dns, nodal = dns * tail, nodal * tail[:, None]
            failure = failure & tail
        cv = None
        if cv_arrays is not None:
            # Integer-valued float32 unit capacities: the capacity sum is
            # exact, and the host's exact means saw the same f32 load.
            gen_up = 1.0 - down[:, :sys.n_gen].to(dns.dtype)
            c_mw = torch.clamp_min(total_load_mw - gen_up @ gen_cap_mw, 0.0)
            cv = (c_mw, c_mw > compat.nsq_fail_flag_threshold_mw)
        with span("loop.reduce"):
            m = accumulators.batch_moments(dns, nodal, failure, down, weight,
                                           cv)
        if mesh is None or mesh.group is None:
            return m, n_over, res.infeasible.sum()
        # One collective a step, of the packed partials and both counts.
        with span("loop.reduce"):
            packed = accumulators.pack_moments(
                m, n_over.to(dns.dtype), res.infeasible.sum().to(dns.dtype))
        flat = meshlib.psum(mesh, packed)
        m, (n_over, n_infeas) = accumulators.unpack_moments(
            flat, sys.n_bus, 2)
        return m, n_over, n_infeas

    return step


@traced("loop.reduce")
def fetch_async(flat: torch.Tensor):
    """Start copying a step's packed outputs ``flat`` to the host. Returns
    (host tensor, CUDA event or None); the event completes when this
    batch's own work and copy are done, so waiting on it never waits for
    a batch dispatched later."""
    if not flat.is_cuda:
        return flat, None
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def fetched_numpy(fetched) -> np.ndarray:
    """Wait for one :func:`fetch_async` copy; its values as float64."""
    host, event = fetched
    if event is not None:
        with span("loop.wait"):
            event.synchronize()
    return host.numpy().astype(np.float64)


def _fetch_async(out):
    m, n_over, n_infeas = out
    dt = m.sum_dns.dtype
    with span("loop.reduce"):
        flat = accumulators.pack_moments(m, n_over.to(dt), n_infeas.to(dt))
    return fetch_async(flat)


def _unpack(fetched, nb: int):
    moments, (n_over, n_infeas) = accumulators.unpack_moments(
        fetched_numpy(fetched), nb, 2)
    return moments, int(n_over), int(n_infeas)


@dataclasses.dataclass
class NSQResult:
    """Mirrors reference ``studies/hl2_nsq.py::NSQResult``."""
    edns_mw: float
    lole_hr_yr: float
    plc: float
    beta: float
    samples: int
    converged: bool
    nodal_eens_mwh_yr: np.ndarray
    comp_importance: np.ndarray
    beta_history: list
    edns_history: list
    lole_history: list
    plc_history: list
    overflow_states: int
    infeasible_states: int = 0
    # The enumeration hybrid (enum_order > 0): states enumerated, their
    # exact probability mass and the exact EDNS part (the Monte Carlo's
    # is edns_mw - enum_edns_exact_mw).
    enum_order: int = 0
    enum_states: int = 0
    enum_mass: float = 0.0
    enum_edns_exact_mw: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["nodal_eens_mwh_yr"] = self.nodal_eens_mwh_yr.tolist()
        d["comp_importance"] = self.comp_importance.tolist()
        return d


def run_nsq_study(case: CaseData, cfg: MCSConfig = MCSConfig(),
                  compat: CompatFlags = CompatFlags(),
                  ipm: IPMConfig = IPMConfig(),
                  device: torch.device | str = "cuda",
                  log_every: int = 10,
                  max_lp: int | None = None,
                  checkpointer: Checkpointer | None = None,
                  checkpoint_every: int = 50,
                  control_variate: bool = False,
                  enum_order: int = 0, mesh=None) -> NSQResult:
    """HL2 NSQ study on ``device`` (the card unless the caller passes
    ``device="cpu"``), or on every rank of ``mesh``
    (``parallel.mesh.scenario_mesh``, which then gives the device);
    mirrors reference ``studies/hl2_nsq.py::run_nsq_study``.

    On a mesh of N ranks each rank evaluates ``cfg.batch_size // N``
    states a batch (a batch is that times N) from
    ``batch_generator(seed, batch, rank)``, and every rank returns the
    same result. Every rank takes rank 0's shed-hint calibration, CE
    pilot, enumeration pre-pass and control-variate means
    (``parallel.mesh.from_rank0``); rank 0 alone writes the checkpoint
    and prints.

    The sampler comes from ``cfg``: ``antithetic``, ``is_boost`` on
    ``is_boost_scope``, ``fused_tier1``, or ``is_ce``: before the loop a
    cross-entropy pilot (:func:`calibrate_ce_proposal`, seed ``cfg.seed +
    90210``) learns the proposal, sparsified by
    :func:`sparsify_ce_proposal` when ``cfg.ce_top_k`` is set; a pilot
    that sees fewer than 8 events leaves the configured sampler.

    ``max_lp``: initial LP-lane buffer per batch (None = the default for
    the sampler, ``cfg.nodal_mode`` and the system; under CE, 1.5 x the
    pilot's last deficit fraction of the batch + 64, rounded up to 128);
    on overflow it doubles and the batch is redone with the same
    generator, so the estimate does not depend on it. It grows up to the
    batch, or up to ``PF_TIER_LP_CAP`` where tier 1.5 is on (m > 336);
    past that, the lanes that did not fit keep their certificate bounds
    and are counted in ``overflow_states``.

    ``checkpointer``: every ``checkpoint_every`` folded batches the
    stats, histories, next batch index, overflow and infeasible counts,
    the grown ``max_lp`` and the CE proposal are saved; a study whose
    checkpointer holds a state starts from it, with the saved proposal
    in place of a new pilot. A batch's draws depend only on (seed, batch
    index), so the resumed study equals an uninterrupted one.

    ``control_variate``: each state's copper-sheet deficit is subtracted
    and its exact expectation at the peak load, from a float64 COPT
    (``copt.copper_cv_means``), added back: EDNS_cv = mu_C + mean(DNS -
    C), and PLC likewise with the copper flag. NSQ states are i.i.d.
    Bernoulli(U), the COPT's own law, and E_q[w C] = mu_C under every
    sampler, so the estimate stays unbiased while beta collapses.

    ``enum_order = k > 0``: the enumeration hybrid. Before the loop,
    every state with <= k outages is evaluated once
    (``enumeration.enumerate_exact``; skipped on resume, where the
    checkpoint's offsets carry it); its float64 parts become the
    ``RunningStats`` offsets, and the Monte Carlo estimates only the
    #down > k tail. Excludes ``control_variate``, ``fused_tier1`` and the
    mixture (ValueError).
    """
    if enum_order > 0 and (control_variate or cfg.fused_tier1):
        raise ValueError("enum_order excludes control_variate (both carry "
                         "exact-mean offsets) and fused_tier1")
    mesh = mesh or meshlib.one_device(device)
    if mesh.rank != 0:
        log_every = 0
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    sys = build_system(case, compat, mesh.device)
    bpd = max(cfg.batch_size // mesh.size, 1)
    global_batch = bpd * mesh.size
    pf_tier = dcopf.default_pf_buffer(sys, bpd) is not None
    if max_lp is None and not cfg.is_ce:
        max_lp = default_max_lp(bpd, cfg.nodal_mode, cfg.is_boost,
                                cfg.is_boost_scope, pf_tier=pf_tier)
    lp_cap = min(bpd, PF_TIER_LP_CAP) if pf_tier else bpd
    cv_arrays = None
    stats = accumulators.RunningStats()
    if control_variate:
        gen_cap_mw = np.asarray(case.gen_pmax, np.float32)
        total_load_mw = np.float32(np.sum(np.asarray(case.bus_pd,
                                                     np.float64)))

        def cv_means():
            mu_e, mu_l, _, _ = copt.copper_cv_means(
                gen_cap_mw.astype(np.float64),
                twostate.unavailability(case)[:case.n_gen],
                np.asarray([total_load_mw], np.float64),
                thresh_mw=compat.nsq_fail_flag_threshold_mw)
            return np.asarray([mu_e, mu_l], np.float64)

        mu_e, mu_l = meshlib.from_rank0(mesh, cv_means, 2)
        cv_arrays = (gen_cap_mw, total_load_mw, mu_e, mu_l)
        stats.mu_dns, stats.mu_flag = float(mu_e), float(mu_l)
        if log_every:
            print(f"control variate: mu_EDNS {mu_e:.4f} MW, "
                  f"mu_PLC {mu_l:.6f} (exact f64 COPT)")
    histories = {"beta": [], "edns": [], "lole": [], "plc": []}
    batch_idx, overflow, infeasible, enum_info = 0, 0, 0, None
    restored = checkpointer.restore() if checkpointer is not None else None
    if restored is not None:
        stats = accumulators.RunningStats.from_state(restored["stats"])
        histories = restored["histories"]
        batch_idx = int(restored["batch_idx"])
        overflow = int(restored.get("overflow", 0))
        infeasible = int(restored.get("infeasible", 0))
        max_lp = int(restored.get("max_lp", max_lp))
        enum_info = restored.get("enum")
    elif enum_order > 0:
        def enum_pass():
            exact = enumeration.enumerate_exact(sys, compat, ipm,
                                                cfg.nodal_mode, enum_order,
                                                log_every=log_every)
            if log_every:
                print(f"enumeration order {enum_order}: {exact.n_states:,} "
                      f"states, mass {exact.mass:.6f} (tail "
                      f"{exact.tail_mass:.2e}), exact EDNS part "
                      f"{exact.edns_mw:.4f} MW, exact PLC part "
                      f"{exact.pfail:.6f}")
            return np.concatenate([
                [exact.edns_mw, exact.pfail, exact.n_states, exact.mass],
                exact.nodal_mw, exact.comp_fail])

        v = meshlib.from_rank0(mesh, enum_pass, 4 + sys.n_bus + sys.n_comp)
        stats.mu_dns, stats.mu_flag = float(v[0]), float(v[1])
        stats.mu_flag_raw = float(v[1])
        stats.mu_nodal = v[4:4 + sys.n_bus]
        stats.mu_comp_fail = v[4 + sys.n_bus:]
        enum_info = {"order": enum_order, "n_states": int(v[2]),
                     "mass": float(v[3]), "edns_exact": float(v[0])}
    # Static shed-direction calibration: the first certificate pass then
    # closes ~99.96% of lanes. Correctness never depends on the hint.
    shed_hint = meshlib.from_rank0(
        mesh, lambda: dcopf.calibrate_shed_hint(sys), sys.n_load)
    if shed_hint is not None:
        shed_hint = np.asarray(shed_hint, np.float32)
    if log_every and shed_hint is None:
        print("shed-hint calibration: too few repairable lanes; keeping "
              "the load-proportional candidate")
    is_q = None
    if cfg.is_ce and restored is not None and "is_q" in restored:
        # The pilot's proposal as the interrupted study ran it.
        if restored["is_q"] is not None:
            is_q = np.asarray(restored["is_q"], np.float32)
    elif cfg.is_ce:
        def ce_pass():
            q, diag = calibrate_ce_proposal(
                sys, compat, ipm, batch=cfg.ce_batch, rounds=cfg.ce_rounds,
                boost0=cfg.ce_boost0, smoothing=cfg.ce_smoothing,
                seed=cfg.seed + 90210, shed_hint=shed_hint,
                log_every=log_every)
            if q is None:
                return None
            if cfg.ce_top_k is not None:
                q = sparsify_ce_proposal(q, sys, top_k=cfg.ce_top_k,
                                         q_cap=cfg.ce_q_cap)
            return np.concatenate([[diag["rounds"][-1]["events"]], q])

        v = meshlib.from_rank0(mesh, ce_pass, 1 + sys.n_comp)
        is_q = None if v is None else np.asarray(v[1:], np.float32)
        if log_every and is_q is None:
            print("CE calibration saw too few deficit events; keeping the "
                  "configured sampler")
        if max_lp is None and is_q is not None:
            frac = float(v[0]) / cfg.ce_batch
            need = int(1.5 * frac * bpd) + 64
            max_lp = min(bpd, ((need + 127) // 128) * 128)
            if log_every:
                print(f"CE max_lp: {max_lp} (pilot deficit frac "
                      f"{frac:.3f})")
    if max_lp is None:
        max_lp = default_max_lp(bpd, cfg.nodal_mode, cfg.is_boost,
                                cfg.is_boost_scope, pf_tier=pf_tier)
    step_kwargs = dict(
        nodal_mode=cfg.nodal_mode, woodbury_k=cfg.woodbury_k,
        shed_hint=shed_hint, fused_tier1=cfg.fused_tier1,
        antithetic=cfg.antithetic,
        is_boost=0.0 if is_q is not None else cfg.is_boost,
        is_boost_scope=cfg.is_boost_scope, is_q=is_q, cv_arrays=cv_arrays,
        enum_order=enum_order, mesh=mesh)
    step = make_nsq_batch_step(sys, bpd, compat, ipm, max_lp=max_lp,
                               **step_kwargs)

    hours = compat.hours_per_year_annualize

    def consume(fetched, next_idx) -> bool:
        """Fold a finished batch into stats; True if a redo is needed."""
        nonlocal max_lp, step, overflow, infeasible
        moments, n_over, n_infeas = _unpack(fetched, sys.n_bus)
        if n_over > 0:
            grown = 2 * max_lp
            if grown <= lp_cap:
                max_lp = grown
                say(f"LP buffer overflow ({n_over}); growing max_lp to "
                    f"{max_lp} and redoing batch")
                step = make_nsq_batch_step(sys, bpd, compat, ipm,
                                           max_lp=max_lp, **step_kwargs)
                return True
            overflow += n_over   # buffer already at its cap
        infeasible += n_infeas
        stats.update(moments)
        histories["beta"].append(stats.beta)
        histories["edns"].append(stats.edns)
        histories["lole"].append(stats.lole(hours))
        histories["plc"].append(stats.plc)
        n_batches = len(histories["beta"])
        if log_every and n_batches % log_every == 0:
            print(f"samples {int(stats.n):7d}: beta={stats.beta:.6f} "
                  f"EDNS={stats.edns:.4f} MW LOLE={stats.lole(hours):.2f} "
                  f"hr/yr")
        if (checkpointer is not None and mesh.rank == 0
                and n_batches % checkpoint_every == 0):
            checkpointer.save({"stats": stats.state(),
                               "histories": histories,
                               "batch_idx": next_idx, "overflow": overflow,
                               "infeasible": infeasible, "max_lp": max_lp,
                               "enum": enum_info,
                               **({"is_q": is_q} if cfg.is_ce else {})})
        return False

    double_buffered_loop(
        dispatch=lambda i: _fetch_async(
            step(batch_generator(cfg.seed, i, sys.device, mesh.rank))),
        consume=consume,
        should_continue=lambda i: (i * global_batch < cfg.max_samples
                                   and stats.beta > cfg.beta_limit),
        start_idx=batch_idx)

    return NSQResult(
        edns_mw=stats.edns, lole_hr_yr=stats.lole(hours), plc=stats.plc,
        beta=stats.beta, samples=int(stats.n),
        converged=stats.beta <= cfg.beta_limit,
        nodal_eens_mwh_yr=stats.nodal_eens(hours),
        comp_importance=stats.component_importance(),
        beta_history=histories["beta"], edns_history=histories["edns"],
        lole_history=histories["lole"], plc_history=histories["plc"],
        overflow_states=overflow, infeasible_states=infeasible,
        enum_order=enum_order,
        enum_states=(enum_info or {}).get("n_states", 0),
        enum_mass=(enum_info or {}).get("mass", 0.0),
        enum_edns_exact_mw=(enum_info or {}).get("edns_exact", 0.0))
