"""Multilevel-splitting (RESTART) variance reduction for the sequential
HL2 study, the chronological counterpart of NSQ importance sampling.

Port of ``powersystemsreliabilityassessment_tpu/studies/hl2_seq_split.py``
on one device. Splitting biases nothing: it spends extra samples on the
conditional tail of years that approach failure, with the copper margin
as the importance function. Per parent year, one splitting level:

    M_t   = available capacity(t) - system load(t)   (copper margin)
    T     = first hour with M_t < level_mw           (H if never)
    F     = F_pre(T)  +  (1/K) sum_k F_tail_k(T)

F_pre sums the index over hours < T; clone 0's tail is the parent's own
continuation, and clones 1..K-1 restart the component process at hour T
from the parent's binary state, exactly, by the memorylessness of the
exponential dwells (``chronological.timeline_from_state_uniforms``; this
is why the study samples with ``quantize=False``). Each parent's estimate
is unbiased by the tower property, so splitting changes only the
variance. Parents that never reach the level keep their plain estimate,
and so do the parents past the per-batch clone budget (in lane order,
independent of the tails).

One batch step is three parts, so each can be run and tested alone:

* :func:`split_sample`: the parents' continuous-dwell years, the copper
  margin, the first entry hour T, the top-S parent selection, and the
  clone tails' uniforms (each antithetic pair drawn once, evaluated plain
  and reflected);
* :func:`split_evaluate`: the parents' full years, then the S (K - 1)
  clone tails, through the screened evaluator (K1, K2 on RTS-24);
* :func:`split_combine`: the pre / tail decomposition of ENS, DLC, NLC
  (with the boundary rise at T), nodal EENS and component importance.

Every uniform of a batch comes from its generator
(``hl2_nsq.batch_generator``: deterministic in (seed, batch index)),
parents first, so a same-draws redo is exact and a resumed study equals
an uninterrupted one. The step reads nothing on the host; the study reads
one packed vector a batch.

STATUS (the reference's round-3 measurement): splitting has not shown a
winning niche. On RTS-24 the copper control variate beats it ~20x
(results/cv_rare_event.json); on RTS-96 with tie ratings halved it ties
plain Monte Carlo (results/split_niche.json): the copper margin cannot see
network-driven deficits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core import load_profile
from powersystemsreliabilityassessment_tpu_torch.core.cases import CaseData
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    System, build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    copper_sheet, dcopf)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.parallel.accumulators import (
    AnnualStats)
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.runtime.host_loop import (
    double_buffered_loop)
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    batch_generator, fetch_async, fetched_numpy, pilot_generator)
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_seq import (
    SEQResult, year_block_load)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)

# The pilot's generators are pilot_generator(seed, _PILOT_SALT, chunk):
# apart from the batches' (seed, index) and the CE pilot's rounds.
_PILOT_SALT = 0x5117
_PILOT_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    """Mirrors reference ``studies/hl2_seq_split.py::SplitConfig``."""
    # Margin level (MW) that triggers splitting; None = auto-calibrate
    # from a sampler-only pilot so that ~entry_target of years enter.
    level_mw: float | None = None
    k_clones: int = 4         # tail samples per split parent (incl. parent)
    max_split: int = 8        # clone budget: parents split per batch
    entry_target: float = 0.10   # auto-calibration yearly entry fraction
    pilot_years: int = 256    # pilot size for auto-calibration
    # Fresh clones in antithetic (u, 1 - u) dwell pairs: tail ENS is
    # monotone in the dwell uniforms, so pair members are negatively
    # correlated; each member stays exactly distributed.
    antithetic_clones: bool = True


def _pad_shift_table(v: np.ndarray) -> np.ndarray:
    """Zero-pad a length-H table to 2H, so that the H entries from any
    split hour t <= H are in bounds (``table[t + arange(H)]``). Mirrors
    reference ``_pad_shift_table``, whose padding too short once aliased
    every late split hour onto an early one (clones then saw January's
    loads, the reference's round-2 bias); its rounding of the length to a
    multiple of 128 is a TPU compile workaround the port drops."""
    n = v.shape[0]
    out = np.zeros(2 * n, v.dtype)
    out[:n] = v
    return out


def _min_margins(sys: System, down: torch.Tensor,
                 fac: torch.Tensor) -> torch.Tensor:
    """Copper margin (p.u.) ``[Y, H]`` of DOWN timelines ``[Y, n_comp,
    H]``: up generator capacity minus the system load."""
    gen_up = 1.0 - down[:, :sys.n_gen, :].to(fac.dtype)
    cap = torch.einsum("ygh,g->yh", gen_up, sys.gen_pmax)
    return cap - fac[None, :] * sys.load_pd.sum()


def calibrate_level(sys: System, factors, hours: int, n_draws: int,
                    entry_target: float = 0.10, pilot_years: int = 256,
                    seed: int = 0) -> float:
    """Sampler-only pilot: the copper-margin level (MW) whose yearly entry
    fraction is ``entry_target``, the empirical quantile of the yearly
    minimum margin. Mirrors reference ``calibrate_level``: chunks of 128
    years (at least one), each from
    ``pilot_generator(seed, 0x5117, chunk)``; no LP work, one host read."""
    fac = torch.as_tensor(np.asarray(factors, np.float32),
                          device=sys.device)
    mins = []
    for b in range(max(pilot_years // _PILOT_CHUNK, 1)):
        down = chronological.sample_timeline_batch(
            pilot_generator(seed, _PILOT_SALT, b, sys.device), sys.mttf,
            sys.mttr, hours, n_draws, _PILOT_CHUNK, quantize=False)
        mins.append(_min_margins(sys, down, fac).amin(1))
    mm = torch.cat(mins).cpu().numpy()
    return float(np.percentile(mm, 100.0 * entry_target)
                 * float(sys.base_mva))


class SplitDraw(NamedTuple):
    """One batch's draws (:func:`split_sample`), all on the device."""
    down: torch.Tensor        # [Y, n_comp, H] bool, the parents' years
    T: torch.Tensor           # [Y] int64, first hour below the level (H)
    entered: torch.Tensor     # [Y] bool
    pidx: torch.Tensor        # [S] int64, parents given the clone budget
    psel: torch.Tensor        # [S] bool, ... that entered the level
    clone_down: torch.Tensor  # [S, K - 1, n_comp, H] bool, relative hours


def split_sample(generator: torch.Generator, sys: System, years: int,
                 hours: int, n_draws: int, fac: torch.Tensor,
                 level_pu: float, k_clones: int, max_split: int,
                 antithetic_clones: bool = True) -> SplitDraw:
    """Draw a batch: the parents' continuous-dwell years, their first
    entry hour T below ``level_pu`` (``fac`` [H] the load factors on the
    device), the first ``S = min(max_split, years)`` entering parents in
    lane order (then the others, unselected), and their K - 1 clone tails
    from the state at T. The sampling half of reference
    ``make_split_batch_step``'s ``device_step``.

    The parents' uniforms come first, so the parents do not depend on K
    or the budget. With ``antithetic_clones`` and K > 2 each of the
    (K - 1) // 2 pairs draws its uniforms once and is evaluated plain and
    reflected (reference ``:207-215``), plus one plain tail if K - 1 is
    odd."""
    Y, S, K = years, min(max_split, years), k_clones
    nc = sys.n_comp
    dev = sys.device
    down = chronological.sample_timeline_batch(
        generator, sys.mttf, sys.mttr, hours, n_draws, Y, quantize=False)
    danger = _min_margins(sys, down, fac) < level_pu          # [Y, H]
    entered = danger.any(1)
    # First True hour: argmax of an integer tensor returns the first of
    # equal maxima; no hour below the level gives T = H.
    T = torch.where(entered, danger.to(torch.int32).argmax(1), hours)
    ar = torch.arange(Y, device=dev)
    score = entered.to(torch.int64) * (2 * Y) - ar
    pidx = torch.topk(score, S).indices
    psel = entered[pidx] & (torch.arange(S, device=dev) < entered.sum())
    if K == 1:
        return SplitDraw(down, T, entered, pidx, psel,
                         torch.zeros((S, 0, nc, hours), dtype=torch.bool,
                                     device=dev))
    Tsel = T[pidx]
    at = torch.clamp_max(Tsel, hours - 1)
    state0 = down[pidx].gather(
        2, at[:, None, None].expand(S, nc, 1))[:, :, 0]           # [S, nc]
    if antithetic_clones and K > 2:
        n_pairs = (K - 1) // 2
        n_draw = n_pairs + (K - 1) - 2 * n_pairs
    else:
        n_pairs, n_draw = 0, K - 1
    ua, ub = chronological.timeline_uniforms(generator, nc, n_draws,
                                             (S, n_draw), device=dev)
    s0 = state0[:, None, :].expand(S, n_draw, nc)
    tails = chronological.timeline_from_state_uniforms(
        ua, ub, s0, sys.mttf, sys.mttr, hours)
    if n_pairs:
        anti = chronological.timeline_from_state_uniforms(
            ua[:, :n_pairs], ub[:, :n_pairs], s0[:, :n_pairs], sys.mttf,
            sys.mttr, hours, antithetic=True)
        tails = torch.cat([tails, anti], dim=1)
    return SplitDraw(down, T, entered, pidx, psel, tails)


def _screened(sys: System, compat: CompatFlags, ipm: IPMConfig,
              down_h: torch.Tensor, load: torch.Tensor, max_lp: int,
              nodal_mode: str):
    """``[N, H, n_comp]`` hour-states and ``[N H, n_load]`` p.u. loads
    through the screened evaluator as one flat batch: per-hour DNS
    ``[N, H]``, nodal shed ``[N, H, nb]`` and the overflow count. The
    repair buffer is the SEQ study's (``hl2_seq.evaluate_years``)."""
    N, H, _ = down_h.shape
    res, n_over = dcopf.evaluate_states_screened(
        sys, down_h.reshape(N * H, -1), load, max_lp, compat, ipm,
        nodal_mode, repair_buffer=max(4096, (N * H) // 16))
    return res.dns_mw.reshape(N, H), res.nodal_mw.reshape(N, H, -1), n_over


def split_evaluate(sys: System, compat: CompatFlags, ipm: IPMConfig,
                   draw: SplitDraw, parent_load: torch.Tensor,
                   fac_pad: torch.Tensor, hours: int, max_lp: int,
                   nodal_mode: str = "lp"):
    """The evaluation half of reference ``device_step``: the parents' full
    years (``parent_load`` from ``hl2_seq.year_block_load``, an LP buffer
    of ``max_lp`` lanes a year), then the clone tails with the load
    factors ``fac_pad[T + rel]`` of their own hours (``fac_pad`` from
    :func:`_pad_shift_table`), zero past the year's end (a certified
    zero-shed lane). Returns ``(dns_p [Y, H], nodal_p [Y, H, nb], dns_c
    [S, K - 1, H], nodal_c [S, K - 1, H, nb], valid_rel [S, H], n_over)``.
    """
    Y = draw.down.shape[0]
    S, Km1 = draw.clone_down.shape[:2]
    down_h = draw.down.transpose(1, 2)
    dns_p, nodal_p, n_over = _screened(sys, compat, ipm, down_h,
                                       parent_load, max_lp * Y, nodal_mode)
    rel = torch.arange(hours, device=sys.device)
    Tsel = draw.T[draw.pidx]
    valid_rel = rel[None, :] < (hours - Tsel)[:, None]             # [S, H]
    nb = nodal_p.shape[-1]
    if Km1 == 0:
        z = dns_p.new_zeros
        return (dns_p, nodal_p, z((S, 0, hours)), z((S, 0, hours, nb)),
                valid_rel, n_over)
    fshift = torch.where(valid_rel, fac_pad[Tsel[:, None] + rel[None, :]],
                         0.0)
    load = fshift[:, None, :, None] * sys.load_pd
    load = load.expand(S, Km1, hours, sys.n_load).reshape(-1, sys.n_load)
    cd = draw.clone_down.transpose(2, 3).reshape(S * Km1, hours, -1)
    dns_c, nodal_c, n_over_c = _screened(sys, compat, ipm, cd, load,
                                         max_lp * S * Km1, nodal_mode)
    return (dns_p, nodal_p, dns_c.reshape(S, Km1, hours),
            nodal_c.reshape(S, Km1, hours, nb), valid_rel,
            n_over + n_over_c)


def _tail_stats(dns, nodal, down, vmask, last_pre, thresh, hours,
                start_idx=None):
    """Per-tail (ENS, DLC, NLC with the boundary rise, nodal, component
    sums) over the hours ``vmask``. ``start_idx`` is the position of the
    tail's first hour in the flag array: None for fresh clones (relative
    hours, position 0 is the split hour), ``Tsel`` for the parent's own
    tail (absolute hours). ``count_curtailment_events`` counts a rise at
    that position equal to the flag there; it is replaced by the true
    rise against the last pre-split hour. An anchor at position 0 for the
    parent's tail would count twice an event that straddles T (reference
    ``:276-304``)."""
    flag = (dns > thresh) & vmask
    ens = torch.where(vmask, dns, 0.0).sum(-1)
    flag_f = flag.to(dns.dtype)
    dlc = flag_f.sum(-1)
    rises = copper_sheet.count_curtailment_events(flag)
    if start_idx is None:
        start = flag[..., 0]
        lp = last_pre[:, None]
    else:
        start = flag.gather(1, torch.clamp_max(start_idx, hours - 1)[:, None]
                            )[:, 0]
        lp = last_pre
    nlc = (rises.to(dns.dtype) - start.to(dns.dtype)
           + (start & ~lp).to(dns.dtype))
    nod = torch.where(flag[..., None], nodal, 0.0).sum(-2)
    comp = torch.einsum("...h,...hc->...c", flag_f, down.to(dns.dtype))
    return ens, dlc, nlc, nod, comp


def split_combine(draw: SplitDraw, dns_p: torch.Tensor,
                  nodal_p: torch.Tensor, dns_c: torch.Tensor,
                  nodal_c: torch.Tensor, valid_rel: torch.Tensor,
                  k_clones: int, thresh: float, hours: int):
    """Per-parent-year index estimates (reference ``:240-339``): the plain
    yearly values, and for each selected entering parent (``psel``)
    F_pre(T) + (F_tail_parent + sum of the clone tails) / K. Returns
    device tensors ``(ens [Y] MWh, plc [Y], nlc [Y], dlc [Y], edns [Y]
    MW, nodal [Y, nb] MWh, comp [Y, n_comp] h)``."""
    K = k_clones
    pidx, psel = draw.pidx, draw.psel
    down_h = draw.down.transpose(1, 2)                      # [Y, H, nc]
    dt = dns_p.dtype
    t_abs = torch.arange(hours, device=dns_p.device)
    pre_mask = t_abs[None, :] < draw.T[:, None]            # [Y, H]
    flag_p = dns_p > thresh
    flag_pf = flag_p.to(dt)
    ens = dns_p.sum(1)
    dlc = flag_pf.sum(1)
    nlc = copper_sheet.count_curtailment_events(flag_p).to(dt)
    nodal = torch.where(flag_p[:, :, None], nodal_p, 0.0).sum(1)
    comp = torch.einsum("yh,yhc->yc", flag_pf, down_h.to(dt))

    # The selected parents' pre-split parts.
    pre = pre_mask[pidx]
    dns_s, flag_s, nodal_s, down_s = (dns_p[pidx], flag_p[pidx],
                                      nodal_p[pidx], down_h[pidx])
    flag_pre = flag_s & pre
    ens_pre = torch.where(pre, dns_s, 0.0).sum(1)
    dlc_pre = flag_pre.to(dt).sum(1)
    nlc_pre = copper_sheet.count_curtailment_events(flag_pre).to(dt)
    nodal_pre = torch.where(flag_pre[:, :, None], nodal_s, 0.0).sum(1)
    comp_pre = torch.einsum("sh,shc->sc", flag_pre.to(dt),
                            (down_s & pre[:, :, None]).to(dt))
    Tsel = draw.T[pidx]
    last_pre = (Tsel > 0) & flag_s.gather(
        1, torch.clamp_min(Tsel - 1, 0)[:, None])[:, 0]

    # The parent's own tail (absolute hours >= T), then the fresh clones
    # (relative hours, valid to the year's end).
    tail = ~pre
    pt = _tail_stats(dns_s, nodal_s, down_s & tail[:, :, None], tail,
                     last_pre, thresh, hours, start_idx=Tsel)
    cd = draw.clone_down.transpose(2, 3)                # [S, K-1, H, nc]
    ct = _tail_stats(dns_c, nodal_c, cd & valid_rel[:, None, :, None],
                     valid_rel[:, None, :], last_pre, thresh, hours)
    split = [p0 + (p + c.sum(1)) / K for p0, p, c in zip(
        (ens_pre, dlc_pre, nlc_pre, nodal_pre, comp_pre), pt, ct)]

    out = []
    for plain, new in zip((ens, dlc, nlc, nodal, comp), split):
        sel = psel if new.dim() == 1 else psel[:, None]
        plain = plain.clone()
        plain[pidx] = torch.where(sel, new, plain[pidx])
        out.append(plain)
    ens, dlc, nlc, nodal, comp = out
    return ens, dlc / hours, nlc, dlc, ens / hours, nodal, comp


def make_split_batch_step(sys: System, years_per_device: int,
                          compat: CompatFlags, ipm: IPMConfig, hours: int,
                          n_draws: int, max_lp: int, factors,
                          split: SplitConfig, nodal_mode: str = "lp"):
    """One-batch step ``generator -> packed float32 vector`` (see
    :func:`_unpack`): :func:`split_sample`, :func:`split_evaluate`,
    :func:`split_combine`, then the batch sums; mirrors reference
    ``make_split_batch_step`` on one device. ``max_lp`` is LP lanes a
    year (parent or clone tail); ``split.level_mw`` must be set. The step
    only enqueues device work."""
    fac_h = np.asarray(factors, np.float32)
    fac = torch.as_tensor(fac_h, device=sys.device)
    fac_pad = torch.as_tensor(_pad_shift_table(fac_h), device=sys.device)
    parent_load = year_block_load(sys, fac, years_per_device)
    level_pu = split.level_mw / sys.base_mva
    thresh = compat.seq_curtail_threshold_mw

    def step(generator: torch.Generator) -> torch.Tensor:
        draw = split_sample(generator, sys, years_per_device, hours,
                            n_draws, fac, level_pu, split.k_clones,
                            split.max_split, split.antithetic_clones)
        (dns_p, nodal_p, dns_c, nodal_c, valid_rel,
         n_over) = split_evaluate(sys, compat, ipm, draw, parent_load,
                                  fac_pad, hours, max_lp, nodal_mode)
        ens, plc, nlc, dlc, edns, nodal, comp = split_combine(
            draw, dns_p, nodal_p, dns_c, nodal_c, valid_rel,
            split.k_clones, thresh, hours)
        n_entered = draw.entered.sum()
        n_split_over = torch.clamp_min(n_entered - draw.pidx.shape[0], 0)
        return torch.cat([
            torch.stack([dlc.sum(), n_over.to(ens.dtype),
                         n_split_over.to(ens.dtype),
                         n_entered.to(ens.dtype)]),
            ens, plc, nlc, dlc, edns, nodal.sum(0), comp.sum(0)])

    return step


def _unpack(v: np.ndarray, years: int, nb: int):
    """A step's packed vector (float64 on the host) -> (per-year (ens,
    plc, nlc, dlc, edns), nodal sum, component sum, loss hours, n_over,
    split overflow, entered)."""
    per_year = v[4:4 + 5 * years].reshape(5, years)
    rest = v[4 + 5 * years:]
    return (tuple(per_year), rest[:nb], rest[nb:], v[0], int(v[1]),
            int(v[2]), int(v[3]))


def run_seq_split_study(case: CaseData, cfg: MCSConfig = MCSConfig(),
                        split: SplitConfig = SplitConfig(),
                        compat: CompatFlags = CompatFlags(),
                        ipm: IPMConfig = IPMConfig(),
                        device: torch.device | str = "cuda",
                        years_per_device: int = 16,
                        max_lp: int = 256,
                        hours: int | None = None,
                        load_scale: float = 1.0,
                        checkpointer: Checkpointer | None = None,
                        checkpoint_every: int = 10,
                        log_every: int = 5) -> SEQResult:
    """SEQ study with multilevel splitting on one device (the card unless
    the caller passes ``device="cpu"``); returns an ``SEQResult`` with
    ``split_entered`` (parents that reached the level) and
    ``split_overflow`` (entering parents past the clone budget, which kept
    their plain estimate). Mirrors reference
    ``studies/hl2_seq_split.py::run_seq_split_study`` without the mesh.

    ``split.level_mw=None`` calibrates the level first
    (:func:`calibrate_level` at ``cfg.seed``). ``load_scale`` multiplies
    the load profile. An LP-buffer overflow doubles ``max_lp`` (up to
    ``hours``) and redoes the batch on its own draws (reference
    ``:420-431``); past that the overflow is counted in
    ``overflow_hours``. ``checkpointer``: every ``checkpoint_every``
    folded batches the stats, histories, next batch index, counters and
    ``max_lp`` are saved, and a study whose checkpointer holds a state
    resumes from it, equal to an uninterrupted one.
    """
    sys = build_system(case, compat, device)
    hours = hours or compat.hours_per_year_seq
    factors = load_profile.load_factors(hours, compat.weekday_mode)
    factors = factors * load_scale
    mt = twostate.mean_times(case)
    n_draws = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)

    if split.level_mw is None:
        level = calibrate_level(sys, factors, hours, n_draws,
                                split.entry_target, split.pilot_years,
                                cfg.seed)
        if log_every:
            print(f"auto-calibrated splitting level: {level:.1f} MW "
                  f"(target entry {split.entry_target:.0%}, "
                  f"{split.pilot_years}-year pilot)")
        split = dataclasses.replace(split, level_mw=level)

    Y = years_per_device
    stats = AnnualStats()
    cov_history, eens_history = [], []
    batch_idx, overflow, split_overflow, entered_total = 0, 0, 0, 0
    restored = checkpointer.restore() if checkpointer is not None else None
    if restored is not None:
        stats = AnnualStats.from_state(restored["stats"])
        cov_history = restored["cov_history"]
        eens_history = restored["eens_history"]
        batch_idx = int(restored["batch_idx"])
        overflow = int(restored.get("overflow", 0))
        split_overflow = int(restored.get("split_overflow", 0))
        entered_total = int(restored.get("entered_total", 0))
        max_lp = int(restored.get("max_lp", max_lp))

    make = lambda lp: make_split_batch_step(  # noqa: E731
        sys, Y, compat, ipm, hours, n_draws, lp, factors, split,
        nodal_mode=cfg.nodal_mode)
    step = make(max_lp)

    def dispatch(i: int):
        return fetch_async(step(batch_generator(cfg.seed, i, sys.device)))

    def consume(fetched, next_idx) -> bool:
        nonlocal max_lp, step, overflow, split_overflow, entered_total
        (per_year, nodal, comp, loss_h, n_over, n_sover,
         n_entered) = _unpack(fetched_numpy(fetched), Y, sys.n_bus)
        if n_over > 0 and max_lp < hours:
            max_lp = min(2 * max_lp, hours)
            print(f"LP buffer overflow ({n_over} h); growing max_lp to "
                  f"{max_lp} and redoing batch")
            step = make(max_lp)
            return True
        stats.update_years(*per_year, nodal, comp, loss_h)
        overflow += n_over
        split_overflow += n_sover
        entered_total += n_entered
        eens_history.append(stats.eens)
        cov_history.append(stats.cov)
        n_batches = len(eens_history)
        if log_every and n_batches % log_every == 0:
            print(f"year {stats.years:5d} | EENS {stats.eens:9.3f} "
                  f"| CoV {stats.cov:.4f} | split-over {split_overflow}")
        if checkpointer is not None and n_batches % checkpoint_every == 0:
            checkpointer.save({
                "stats": stats.state(), "cov_history": cov_history,
                "eens_history": eens_history, "batch_idx": next_idx,
                "overflow": overflow, "split_overflow": split_overflow,
                "entered_total": entered_total, "max_lp": max_lp})
        return False

    double_buffered_loop(
        dispatch=dispatch, consume=consume,
        should_continue=lambda i: (i * Y < cfg.max_years
                                   and stats.cov > cfg.cov_threshold),
        start_idx=batch_idx)

    mean = lambda v: float(np.mean(v)) if v else 0.0  # noqa: E731
    return SEQResult(
        eens_mwh_yr=stats.eens, lole_hr_yr=mean(stats.dlc),
        lolf_occ_yr=mean(stats.nlc), plc=mean(stats.plc),
        edns_mw=mean(stats.dns), cov=stats.cov, years=stats.years,
        converged=stats.cov <= cfg.cov_threshold,
        nodal_eens_mwh_yr=stats.nodal_eens(),
        comp_importance=stats.component_importance(),
        eens_history=eens_history, cov_history=cov_history,
        overflow_hours=overflow, annual_ens=list(stats.ens),
        split_entered=entered_total, split_overflow=split_overflow,
        annual_dlc=list(stats.dlc), annual_nlc=list(stats.nlc))
