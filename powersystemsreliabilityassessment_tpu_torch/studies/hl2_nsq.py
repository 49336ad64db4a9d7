"""HL2 non-sequential Monte Carlo study (the ``nsqMain.m`` path).

Port of ``powersystemsreliabilityassessment_tpu/studies/hl2_nsq.py``,
plain Monte Carlo on one device. Per batch, on the device: sample
Bernoulli component states at fixed peak load, evaluate them with the
two-tier DC-OPF evaluator (``engines/dcopf.py``), and reduce the index
partial sums. The host folds the partial sums into float64 running
statistics and applies the beta stopping rule (beta < ``beta_limit`` or
``max_samples``, nsqMain.m:60-61).

Threefry keys become one ``torch.Generator`` per batch, seeded from
(study seed, batch index): a batch is reproducible from its index, which
the grow-and-redo protocol relies on. ``MCSConfig.fused_tier1`` samples
and first-pass-certifies each batch in the K4 kernel
(``ops/fused_sampler_cert.py``). A ``runtime.checkpoint.Checkpointer``
saves the host state every few batches, and a study given one resumes
from it. Not ported yet (ROADMAP.md Queue 1): the mesh and ``psum``,
antithetic / importance / CE / mixture sampling, the control variate,
enumeration.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core.cases import CaseData
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    System, build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import dcopf
from powersystemsreliabilityassessment_tpu_torch.ops import fused_sampler_cert
from powersystemsreliabilityassessment_tpu_torch.parallel import accumulators
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.runtime.host_loop import (
    double_buffered_loop)
from powersystemsreliabilityassessment_tpu_torch.sampling.state import (
    sample_states)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)


# The LP buffer's cap where tier 1.5 is on (m > 336): the reference's
# memory envelope of a large-m IPM buffer on a 15.75 GB chip (reference
# ``studies/hl2_nsq.py::default_max_lp``), kept so that the study can be
# compared with its artifact; not sized again for the H100's 80 GB yet
# (ROADMAP.md Queue 1 item 7).
PF_TIER_LP_CAP = 2048
# The proportional-mode buffer with tier 1.5 on: its misses are ~0.1% of
# lanes (results/r4_miss.json), and <= 128 lanes cost the large-m LP
# about the same.
PF_TIER_PROPORTIONAL_LP = 128


def default_max_lp(batch_per_device: int, nodal_mode: str = "lp",
                   pf_tier: bool = False) -> int:
    """Default LP-lane buffer per batch; mirrors reference
    ``studies/hl2_nsq.py::default_max_lp`` (plain MC): "lp" mode sends
    every positive-deficit state to the LP (~10% of RTS-24 peak states),
    so 25%; "proportional" mode only certificate failures (~0.04%), so
    1.56%. ``pf_tier`` (tier 1.5 on, m > 336) caps it at
    ``PF_TIER_LP_CAP``, and in "proportional" mode at
    ``PF_TIER_PROPORTIONAL_LP``. Overflow self-corrects through
    grow-and-redo. These are TPU-era settings not yet measured again on
    the H100."""
    frac = 64 if nodal_mode == "proportional" else 4
    lanes = max(batch_per_device // frac, 16)
    if pf_tier:
        lanes = min(lanes, PF_TIER_LP_CAP)
        if nodal_mode == "proportional":
            lanes = min(lanes, PF_TIER_PROPORTIONAL_LP)
    return lanes


def default_woodbury_k(sys: System) -> int:
    """Certificate rank: 2 unless >= 3 simultaneous branch outages have
    probability >= 1e-4 under the sampling measure (Poisson bound), then
    4. Mirrors reference ``studies/hl2_nsq.py::default_woodbury_k``
    (plain MC). RTS-24 resolves to 2, RTS-96 and case300s to 4."""
    q = sys.unavail.detach().cpu().numpy().astype(np.float64)[sys.n_gen:]
    lam = float(q.sum())
    p_ge3 = 1.0 - np.exp(-lam) * (1.0 + lam + lam * lam / 2.0)
    return 2 if p_ge3 < 1e-4 else 4


def batch_generator(seed: int, batch_idx: int,
                    device: torch.device | str) -> torch.Generator:
    """The generator of batch ``batch_idx`` of a study seeded ``seed``
    (Philox on CUDA); takes the place of the reference's
    ``jax.random.fold_in(root, i)`` (``studies/hl2_nsq.py::run_nsq_study``).
    Deterministic in (seed, batch_idx), so a redo of a batch draws the
    same states."""
    words = np.random.SeedSequence((seed, batch_idx)).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(words.view(np.uint64)[0]))
    return gen


def make_nsq_batch_step(sys: System, batch_per_device: int,
                        compat: CompatFlags, ipm: IPMConfig,
                        max_lp: int | None = None, nodal_mode: str = "lp",
                        woodbury_k: int | None = None,
                        shed_hint: np.ndarray | None = None,
                        fused_tier1: bool = False):
    """One-batch step ``generator -> (BatchMoments, n_overflow,
    n_infeasible)``, all device tensors; mirrors reference
    ``studies/hl2_nsq.py::make_nsq_batch_step`` (plain MC, one device).
    At m <= 336 the step only enqueues device work: nothing in it waits
    for the device (``torch.cuda.set_sync_debug_mode("error")`` passes
    over it). At m > 336 tier 1.5 is on (``dcopf.default_pf_buffer``)
    and the LP buffer's large-m solve reads on the host (each Schur
    inverse's probe and the rescue ladder's gates): ~40 syncs a step on
    case300s.

    ``fused_tier1``: the K4 kernel draws and first-pass-certifies the
    batch (``fused_sampler_cert.sample_certify_quick``), then
    ``dcopf.certify_finish`` completes the certificate on a compacted
    buffer and hands it to the screened evaluator (``pre``). Unlike the
    reference, there is no fallback to the default path: a CPU system
    runs the kernel's plain version."""
    pf_buffer = dcopf.default_pf_buffer(sys, batch_per_device)
    if max_lp is None:
        max_lp = default_max_lp(batch_per_device, nodal_mode,
                                pf_tier=pf_buffer is not None)
    if woodbury_k is None:
        woodbury_k = default_woodbury_k(sys)
    if not 2 <= woodbury_k <= 4:
        # The unrolled Cramer solves are characterized for k <= 4 only.
        raise ValueError(f"woodbury_k must be in [2, 4], got {woodbury_k}")
    repair_buffer = dcopf.default_repair_buffer(
        batch_per_device, hinted=shed_hint is not None)
    load = sys.load_pd[None, :].expand(batch_per_device, sys.n_load)
    hinted = shed_hint is not None
    if hinted:
        # Copied to the device once here: a host-to-device copy inside
        # the step would synchronize the stream every batch.
        shed_hint = torch.as_tensor(shed_hint, dtype=sys.load_pd.dtype,
                                    device=sys.device)
    if fused_tier1:
        # Plain MC is the only sampler here; island_blackout raises in the
        # screened evaluator.
        fused_sampler_cert.check_supported(sys)
        finish_buffer = dcopf.default_finish_buffer(batch_per_device,
                                                    hinted=hinted)
        # The kernel's packed operands depend only on (sys, hint): packed
        # once here, so the step adds one seed draw and one launch.
        quick_ops = fused_sampler_cert.kernel_operands(
            sys, fused_sampler_cert.hint_row(sys, shed_hint))

    def step(generator: torch.Generator):
        pre = None
        if fused_tier1:
            down, ok1, deficit, shed = \
                fused_sampler_cert.sample_certify_quick(
                    generator, sys, batch_per_device, shed_hint=shed_hint,
                    operands=quick_ops)
            pre = dcopf.certify_finish(sys, down, load, deficit, shed, ok1,
                                       finish_buffer, woodbury_k=woodbury_k)
        else:
            down = sample_states(generator, sys.unavail, sys.always_up_nsq,
                                 batch_per_device)
        res, n_over = dcopf.evaluate_states_screened(
            sys, down, load, max_lp, compat, ipm, nodal_mode,
            repair_buffer=repair_buffer, woodbury_k=woodbury_k,
            shed_hint=shed_hint, pre=pre, pf_buffer=pf_buffer)
        m = accumulators.batch_moments(res.dns_mw, res.nodal_mw,
                                       res.failure, down)
        return m, n_over, res.infeasible.sum()

    return step


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
        event.synchronize()
    return host.numpy().astype(np.float64)


def _fetch_async(out):
    m, n_over, n_infeas = out
    return fetch_async(torch.cat([
        torch.stack([m.n, m.sum_dns, m.sum_dns_sq, m.sum_flag,
                     m.sum_flag_raw, n_over.to(m.sum_dns.dtype),
                     n_infeas.to(m.sum_dns.dtype)]),
        m.sum_nodal, m.sum_comp_fail]))


def _unpack(fetched, nb: int):
    v = fetched_numpy(fetched)
    moments = accumulators.BatchMoments(
        n=v[0], sum_dns=v[1], sum_dns_sq=v[2], sum_flag=v[3],
        sum_nodal=v[7:7 + nb], sum_comp_fail=v[7 + nb:], sum_flag_raw=v[4])
    return moments, int(v[5]), int(v[6])


@dataclasses.dataclass
class NSQResult:
    """Mirrors reference ``studies/hl2_nsq.py::NSQResult`` (without the
    enumeration fields)."""
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
                  checkpoint_every: int = 50) -> NSQResult:
    """HL2 NSQ study on one device (the card unless the caller passes
    ``device="cpu"``); mirrors reference
    ``studies/hl2_nsq.py::run_nsq_study`` (plain MC).

    ``max_lp``: initial LP-lane buffer per batch (None = the default for
    ``cfg.nodal_mode`` and the system); on overflow it doubles and the
    batch is redone with the same generator, so the estimate does not
    depend on it. It grows up to the batch, or up to ``PF_TIER_LP_CAP``
    where tier 1.5 is on (m > 336); past that, the lanes that did not
    fit keep their certificate bounds and are counted in
    ``overflow_states``.

    ``checkpointer``: every ``checkpoint_every`` folded batches the
    stats, histories, next batch index, overflow and infeasible counts
    and the grown ``max_lp`` are saved; a study whose checkpointer holds
    a state starts from it. A batch's draws depend only on (seed, batch
    index), so the resumed study equals an uninterrupted one.
    """
    sys = build_system(case, compat, device)
    bpd = max(cfg.batch_size, 1)
    pf_tier = dcopf.default_pf_buffer(sys, bpd) is not None
    if max_lp is None:
        max_lp = default_max_lp(bpd, cfg.nodal_mode, pf_tier=pf_tier)
    lp_cap = min(bpd, PF_TIER_LP_CAP) if pf_tier else bpd
    stats = accumulators.RunningStats()
    histories = {"beta": [], "edns": [], "lole": [], "plc": []}
    batch_idx, overflow, infeasible = 0, 0, 0
    restored = checkpointer.restore() if checkpointer is not None else None
    if restored is not None:
        stats = accumulators.RunningStats.from_state(restored["stats"])
        histories = restored["histories"]
        batch_idx = int(restored["batch_idx"])
        overflow = int(restored.get("overflow", 0))
        infeasible = int(restored.get("infeasible", 0))
        max_lp = int(restored.get("max_lp", max_lp))
    # Static shed-direction calibration: the first certificate pass then
    # closes ~99.96% of lanes. Correctness never depends on the hint.
    shed_hint = dcopf.calibrate_shed_hint(sys)
    if log_every and shed_hint is None:
        print("shed-hint calibration: too few repairable lanes; keeping "
              "the load-proportional candidate")
    step_kwargs = dict(nodal_mode=cfg.nodal_mode, woodbury_k=cfg.woodbury_k,
                       shed_hint=shed_hint, fused_tier1=cfg.fused_tier1)
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
                print(f"LP buffer overflow ({n_over}); growing max_lp to "
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
        if checkpointer is not None and n_batches % checkpoint_every == 0:
            checkpointer.save({"stats": stats.state(),
                               "histories": histories,
                               "batch_idx": next_idx, "overflow": overflow,
                               "infeasible": infeasible, "max_lp": max_lp})
        return False

    double_buffered_loop(
        dispatch=lambda i: _fetch_async(
            step(batch_generator(cfg.seed, i, sys.device))),
        consume=consume,
        should_continue=lambda i: (i * bpd < cfg.max_samples
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
        overflow_states=overflow, infeasible_states=infeasible)
