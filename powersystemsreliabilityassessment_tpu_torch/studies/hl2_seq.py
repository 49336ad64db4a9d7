"""HL2 sequential (chronological) Monte Carlo study (the ``seqMain.m`` path).

Port of ``powersystemsreliabilityassessment_tpu/studies/hl2_seq.py`` on one
device. Per batch of ``years_per_device`` simulated years, on the device:

1. draw the block's per-component chronological timelines
   (``sampling/chronological.py``) from the batch's generator
   (``studies.hl2_nsq.batch_generator``: deterministic in the seed and
   the batch index);
2. scale the RTS-79 hourly load profile (``core/load_profile.py``) and
   evaluate every hour-state of the block as one flat batch through the
   screened evaluator: the certificate proves most hours shed-free, and
   the LP (K1, then the polish's K2a / K2b on RTS-24) takes the rest in
   a buffer of ``max_lp`` lanes a year;
3. reduce to the annual indices ENS / PLC / NLC (event counting,
   calnlc.m) / DLC / EDNS (seqMain.m:160-176) and the nodal and
   weak-point sums.

The host folds each batch into float64 ``AnnualStats`` and stops when
the CoV std / (mean sqrt(N)) falls below ``cov_threshold`` or at
``max_years`` (seqMain.m:178-198). A batch whose LP buffer overflows is
redone at twice the size (the same draws, so the estimate does not
depend on the buffer); three redone batches in a row promote the size.
``control_variate`` adjusts each year by its copper-sheet deficit and
that deficit's exact stationary mean (a float64 COPT).
``scheduled_maintenance`` takes each generator out for its levelized
maintenance weeks (``engines/planning.py``). Not ported yet (ROADMAP.md
Queue 1): the mesh (item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.core import load_profile
from powersystemsreliabilityassessment_tpu_torch.core.cases import CaseData
from powersystemsreliabilityassessment_tpu_torch.core.system import (
    System, build_system)
from powersystemsreliabilityassessment_tpu_torch.engines import (
    copper_sheet, copt, dcopf, planning)
from powersystemsreliabilityassessment_tpu_torch.models import twostate
from powersystemsreliabilityassessment_tpu_torch.parallel.accumulators import (
    AnnualStats)
from powersystemsreliabilityassessment_tpu_torch.runtime.checkpoint import (
    Checkpointer)
from powersystemsreliabilityassessment_tpu_torch.runtime.host_loop import (
    double_buffered_loop)
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    batch_generator, fetch_async, fetched_numpy)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    CompatFlags, IPMConfig, MCSConfig)


def sample_years(generator: torch.Generator, sys: System, years: int,
                 hours: int, n_draws: int,
                 stationary: bool = False) -> torch.Tensor:
    """bool ``[years, n_comp, hours]`` (True = DOWN): a year block's
    timelines, every uniform drawn before any is used, so the draws do
    not depend on the LP buffer. Reference ``sampling="reference"``
    starts all-up with quantized dwells; ``stationary`` starts from the
    stationary law with continuous dwells. The SEQ sampler pins no
    component (the sync condenser pin is NSQ only)."""
    if stationary:
        return chronological.sample_timeline_stationary(
            generator, sys.mttf, sys.mttr, hours, n_draws, batch=(years,))
    return chronological.sample_timeline_batch(
        generator, sys.mttf, sys.mttr, hours, n_draws, years)


def year_block_load(sys: System, factors, years: int) -> torch.Tensor:
    """``[years * H, n_load]`` p.u.: ``factors[:, None] * load_pd`` for
    each hour, the same for every year of the block. Made once per step
    (not per batch)."""
    fac = torch.as_tensor(factors, dtype=torch.float32, device=sys.device)
    load_h = fac[:, None] * sys.load_pd[None, :]
    return load_h.expand(years, *load_h.shape).reshape(-1, sys.n_load)


def evaluate_years(sys: System, compat: CompatFlags, ipm: IPMConfig,
                   load: torch.Tensor, down: torch.Tensor, max_lp: int,
                   nodal_mode: str = "lp", cv_arrays: tuple | None = None,
                   maint_down: torch.Tensor | None = None):
    """Annual indices of a given year block ``down`` ``[Y, n_comp, H]``
    evaluated as ONE flat batch of ``Y * H`` hour-states (``load`` from
    :func:`year_block_load`, ``max_lp`` the whole block's LP buffer).
    The evaluation part of reference ``studies/hl2_seq.py::_years_eval``.
    ``maint_down`` ``[H, n_comp]`` (bool, on the device) is ORed into
    every year's states: a component on scheduled maintenance is DOWN,
    in the evaluation and in the weak-point counts.

    Returns device tensors ``(ens [Y] MWh, plc [Y], nlc [Y], dlc [Y],
    edns [Y] MW, nodal [Y, nb] MWh, comp_fail [Y, n_comp] h, loss_hours
    [Y], n_over, n_infeasible)``. With ``cv_arrays = (loads_mw [H],
    gen_cap_mw [ng])`` (device tensors: the float32-rounded hourly system
    load and the unit capacities) two more follow, the copper-sheet
    control variates ``c_ens [Y]`` (MWh of max(load - up capacity, 0))
    and ``c_dlc [Y]`` (hours that deficit exceeds the curtailment
    threshold).
    """
    Y, _, H = down.shape
    down_h = down.transpose(1, 2)                           # [Y, H, n_comp]
    if maint_down is not None:
        down_h = down_h | maint_down[None]
    # Chronological outages cluster (one long line repair can make ~800
    # consecutive needy hours), so the repair buffer is Y H / 16, far
    # above the bursts the reference observed; overflow only sends the
    # excess lanes to the LP buffer.
    res, n_over = dcopf.evaluate_states_screened(
        sys, down_h.reshape(Y * H, -1), load, max_lp, compat, ipm,
        nodal_mode, repair_buffer=max(4096, (Y * H) // 16))
    dns = res.dns_mw.reshape(Y, H)
    flag = dns > compat.seq_curtail_threshold_mw
    flag_f = flag.to(dns.dtype)
    ens = dns.sum(1)
    dlc = flag_f.sum(1)
    nlc = copper_sheet.count_curtailment_events(flag).to(dns.dtype)
    nodal = torch.where(flag[:, :, None], res.nodal_mw.reshape(Y, H, -1),
                        0.0).sum(1)
    # 0/1 sums below 2^24: exact in float32 (TF32 is off package-wide).
    comp_fail = torch.einsum("yh,yhc->yc", flag_f, down_h.to(dns.dtype))
    # PLC as the reference's mean computes it (XLA: the sum times 1 / H).
    outs = (ens, dlc * (1.0 / H), nlc, dlc, ens / H, nodal, comp_fail, dlc,
            n_over, res.infeasible.sum())
    if cv_arrays is not None:
        # Integer-valued float32 capacities: the capacity sums are exact
        # (TF32 is off), so the host's exact means see the same deficits.
        loads_mw, gen_cap_mw = cv_arrays
        gen_up = 1.0 - down[:, :sys.n_gen, :].to(dns.dtype)
        cap_mw = torch.einsum("ygh,g->yh", gen_up, gen_cap_mw)
        deficit = torch.clamp_min(loads_mw[None, :] - cap_mw, 0.0)
        outs = outs + (deficit.sum(1), (
            deficit > compat.seq_curtail_threshold_mw).to(dns.dtype).sum(1))
    return outs


def _years_eval(sys: System, compat: CompatFlags, ipm: IPMConfig,
                load: torch.Tensor, hours: int, n_draws: int, max_lp: int,
                nodal_mode: str, generator: torch.Generator, years: int,
                stationary: bool = False, cv_arrays: tuple | None = None,
                maint_down: torch.Tensor | None = None):
    """Draw a block of ``years`` years and evaluate it; mirrors reference
    ``studies/hl2_seq.py::_years_eval``: :func:`sample_years`, then
    :func:`evaluate_years`."""
    down = sample_years(generator, sys, years, hours, n_draws, stationary)
    return evaluate_years(sys, compat, ipm, load, down, max_lp, nodal_mode,
                          cv_arrays, maint_down)


def make_seq_batch_step(sys: System, years_per_device: int,
                        compat: CompatFlags, ipm: IPMConfig, hours: int,
                        n_draws: int, max_lp: int, factors,
                        nodal_mode: str = "lp", stationary: bool = False,
                        cv_arrays: tuple | None = None,
                        maint_down: np.ndarray | None = None):
    """One-batch step ``generator -> (ens [Y], plc [Y], nlc [Y], dlc [Y],
    edns [Y], nodal_sum [nb], comp_fail_sum [n_comp], loss_hours,
    n_over, n_infeasible)``, all device tensors, followed by ``(c_ens [Y],
    c_dlc [Y])`` when ``cv_arrays = (loads_mw [H], gen_cap_mw [ng])``
    (host arrays, copied to the device here) is given; mirrors reference
    ``studies/hl2_seq.py::make_seq_batch_step`` on one device.
    ``max_lp`` is per year; ``maint_down`` (host bool ``[H, n_comp]``,
    copied to the device here) is the maintenance schedule of
    :func:`maintenance_down`. The step only enqueues device work:
    nothing in it waits for the device."""
    load = year_block_load(sys, factors, years_per_device)
    if maint_down is not None:
        maint_down = torch.as_tensor(np.asarray(maint_down, bool),
                                     device=sys.device)
    if cv_arrays is not None:
        cv_arrays = tuple(torch.as_tensor(np.asarray(a, np.float32),
                                          device=sys.device)
                          for a in cv_arrays)

    def step(generator: torch.Generator):
        out = _years_eval(sys, compat, ipm, load, hours, n_draws,
                          max_lp * years_per_device, nodal_mode, generator,
                          years_per_device, stationary, cv_arrays,
                          maint_down)
        (ens, plc, nlc, dlc, edns, nodal, comp_fail, loss_h, n_over,
         n_infeas) = out[:10]
        return (ens, plc, nlc, dlc, edns, nodal.sum(0), comp_fail.sum(0),
                loss_h.sum(), n_over, n_infeas) + out[10:]

    return step


def _pack(out) -> torch.Tensor:
    """One step's outputs as one float32 vector: loss hours, n_over,
    n_infeasible, the per-year vectors (five, or seven with the control
    variates), nodal and component sums."""
    (ens, plc, nlc, dlc, edns, nodal, comp_fail, loss_h, n_over,
     n_infeas) = out[:10]
    dt = ens.dtype
    return torch.cat([torch.stack([loss_h, n_over.to(dt), n_infeas.to(dt)]),
                      ens, plc, nlc, dlc, edns, *out[10:], nodal, comp_fail])


def _unpack(v: np.ndarray, years: int, nb: int, n_per_year: int = 5):
    """Inverse of :func:`_pack` on the host's float64 copy: (per-year
    vectors (ens, plc, nlc, dlc, edns[, c_ens, c_dlc]), nodal, comp_fail,
    loss_hours, n_over, n_infeasible)."""
    per_year = v[3:3 + n_per_year * years].reshape(n_per_year, years)
    rest = v[3 + n_per_year * years:]
    return (tuple(per_year), rest[:nb], rest[nb:], v[0], int(v[1]),
            int(v[2]))


@dataclasses.dataclass
class SEQResult:
    """Mirrors reference ``studies/hl2_seq.py::SEQResult``."""
    eens_mwh_yr: float
    lole_hr_yr: float       # mean DLC (seqMain.m:212)
    lolf_occ_yr: float      # mean NLC (seqMain.m:213)
    plc: float
    edns_mw: float
    cov: float
    years: int
    converged: bool
    nodal_eens_mwh_yr: np.ndarray
    comp_importance: np.ndarray
    eens_history: list
    cov_history: list
    overflow_hours: int
    annual_ens: list = dataclasses.field(default_factory=list)
    # Hours with no feasible dispatch (enforce_pmin only); the reference's
    # MATLAB records zero for these (seqMain.m:117-126).
    infeasible_hours: int = 0
    # Multilevel-splitting diagnostics, filled by
    # studies/hl2_seq_split.py (0 in the plain study): parent years that
    # reached the level, and those past the clone budget.
    split_entered: int = 0
    split_overflow: int = 0
    # Per-year DLC (h) and NLC, for the standard errors of LOLE and LOLF
    # (not in the reference's result, nor in its exported schema).
    annual_dlc: list = dataclasses.field(default_factory=list)
    annual_nlc: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        del d["annual_dlc"], d["annual_nlc"]
        d["nodal_eens_mwh_yr"] = self.nodal_eens_mwh_yr.tolist()
        d["comp_importance"] = self.comp_importance.tolist()
        return d


def maintenance_down(case: CaseData, hours: int,
                     weekday_mode: str = "reference") -> np.ndarray:
    """bool ``[hours, n_comp]``: the generators on scheduled maintenance
    each hour (branches never). A levelized schedule of ``gen_maint_weeks``
    (case24_failrate.m:48-56) against the 52 weekly peaks of the full
    year's profile, also when ``hours`` is shorter; week 52 runs on past
    hour 8,736. The maintenance part of reference
    ``studies/hl2_seq.py::run_seq_study``."""
    fleet = planning.PlanningFleet(
        names=[f"G{i + 1}" for i in range(case.n_gen)],
        capacity=case.gen_pmax.astype(float),
        for_rate=np.zeros(case.n_gen),
        maint_weeks=np.round(case.gen_maint_weeks).astype(int),
        energy_limit=np.full(case.n_gen, np.inf))
    planning.schedule_maintenance(fleet, load_profile.weekly_peaks(
        load_profile.load_factors(52 * 168, weekday_mode)))
    week_of_hour = np.minimum(np.arange(hours) // 168, 51)
    maint_down = np.zeros((hours, case.n_comp), bool)
    maint_down[:, :case.n_gen] = planning.maintenance_mask(fleet)[
        week_of_hour]
    return maint_down


def seq_lp_cap(m: int, hours: int, years_per_device: int) -> int:
    """Per-year LP-buffer ceiling of the chronological study; mirrors
    reference ``studies/hl2_seq.py::seq_lp_cap``. Systems with m <= 336
    may grow to the whole year; larger ones keep the reference's TPU
    memory envelope (4096 / Y^2 a year), not yet sized for the H100
    (ROADMAP.md Queue 1 item 7). Hours past the cap keep their certified
    deficit bounds and are counted in ``overflow_hours``."""
    if m <= 336:
        return hours
    return min(hours, max(128, 4096 // (years_per_device *
                                        years_per_device)))


def run_seq_study(case: CaseData, cfg: MCSConfig = MCSConfig(),
                  compat: CompatFlags = CompatFlags(),
                  ipm: IPMConfig = IPMConfig(),
                  device: torch.device | str = "cuda",
                  years_per_device: int = 16,
                  max_lp: int = 256,
                  hours: int | None = None,
                  scheduled_maintenance: bool = False,
                  checkpointer: Checkpointer | None = None,
                  checkpoint_every: int = 20,
                  log_every: int = 5,
                  sampling: str = "reference",
                  control_variate: bool = False,
                  load_scale: float = 1.0) -> SEQResult:
    """HL2 SEQ study on one device (the card unless the caller passes
    ``device="cpu"``); mirrors reference
    ``studies/hl2_seq.py::run_seq_study`` without the mesh.

    ``years_per_device`` years a batch; ``max_lp`` LP lanes a year (the
    step's buffer is ``max_lp * years_per_device``); ``hours`` a year
    (None: ``compat.hours_per_year_seq``). ``sampling="stationary"``
    starts each year from the stationary component law with continuous
    dwells. ``checkpointer``: every ``checkpoint_every`` folded batches
    the stats, histories, next batch index, overflow and infeasible
    counts and the promoted ``max_lp`` are saved, and a study whose
    checkpointer holds a state resumes from it (exactly: the draws depend
    only on (seed, batch index)). ``load_scale`` multiplies the load
    profile.

    ``scheduled_maintenance=True`` takes each generator out for the
    levelized window of its ``gen_maint_weeks`` (:func:`maintenance_down`),
    the same weeks every year.

    ``control_variate=True`` (stationary sampling; ``"reference"`` is
    switched to it, as in the reference) subtracts each year's copper-
    sheet deficit C (``c_ens``, ``c_dlc`` of :func:`evaluate_years`) and
    adds back its exact stationary mean from a float64 COPT
    (``copt.copper_cv_means`` on the same float32-rounded hourly loads):
    ENS_cv = ENS - C + mu_C, DLC likewise, on the host in float64. NLC,
    nodal and weak-point sums stay plain. With ``scheduled_maintenance``
    it raises ValueError (maintenance breaks stationarity).
    """
    if control_variate and sampling == "reference":
        sampling = "stationary"
    if sampling not in ("reference", "stationary"):
        raise ValueError(f"unknown sampling mode {sampling!r}")
    if control_variate and scheduled_maintenance:
        raise ValueError("control_variate requires a stationary fleet; "
                         "scheduled maintenance breaks stationarity")
    stationary = sampling == "stationary"

    sys = build_system(case, compat, device)
    if log_every:
        dcopf.print_baseline(sys)
    hours = hours or compat.hours_per_year_seq
    factors = load_profile.load_factors(hours, compat.weekday_mode)
    if load_scale != 1.0:
        factors = factors * load_scale
    cv_arrays, mu_eens, mu_lole = None, 0.0, 0.0
    if control_variate:
        gen_cap_mw = np.asarray(case.gen_pmax, np.float32)
        total_load_mw = float(np.sum(np.asarray(case.bus_pd, np.float64)))
        # Rounded to float32 before the exact means: host and device then
        # see the same load values.
        loads_mw = (np.asarray(factors, np.float64)
                    * total_load_mw).astype(np.float32)
        mu_eens, mu_lole, _, _ = copt.copper_cv_means(
            gen_cap_mw.astype(np.float64),
            twostate.unavailability(case)[:case.n_gen],
            loads_mw.astype(np.float64),
            thresh_mw=compat.seq_curtail_threshold_mw)
        cv_arrays = (loads_mw, gen_cap_mw)
        if log_every:
            print(f"control variate: mu_EENS {mu_eens:.3f} MWh/yr, "
                  f"mu_LOLE {mu_lole:.4f} h/yr (exact f64 COPT)")
    maint_down = (maintenance_down(case, hours, compat.weekday_mode)
                  if scheduled_maintenance else None)
    # Copied to the device once; every step's load is made from it.
    factors = torch.as_tensor(factors, dtype=torch.float32,
                              device=sys.device)
    mt = twostate.mean_times(case)
    n_draws = chronological.default_num_draws(mt[:, 0], mt[:, 1], hours)
    Y = years_per_device
    lp_cap = seq_lp_cap(sys.n_bus + sys.n_branch, hours, Y)
    if max_lp > lp_cap:
        print(f"max_lp {max_lp}/yr exceeds the large-m cap; clamping to "
              f"{lp_cap}/yr (years_per_device={Y})")
        max_lp = lp_cap

    stats = AnnualStats()
    cov_history, eens_history = [], []
    batch_idx, overflow, infeasible = 0, 0, 0
    restored = checkpointer.restore() if checkpointer is not None else None
    if restored is not None:
        stats = AnnualStats.from_state(restored["stats"])
        cov_history = restored["cov_history"]
        eens_history = restored["eens_history"]
        batch_idx = int(restored["batch_idx"])
        overflow = int(restored.get("overflow", 0))
        infeasible = int(restored.get("infeasible", 0))
        max_lp = min(int(restored.get("max_lp", max_lp)), lp_cap)

    steps: dict[int, Any] = {}       # buffer size a year -> step

    def step_for(lp: int):
        if lp not in steps:
            steps[lp] = make_seq_batch_step(
                sys, Y, compat, ipm, hours, n_draws, lp, factors,
                nodal_mode=cfg.nodal_mode, stationary=stationary,
                cv_arrays=cv_arrays, maint_down=maint_down)
        return steps[lp]

    # Transient grow-and-redo: chronological outages cluster, so a batch
    # that overflows is redone through a transient bigger step while the
    # base keeps its size (a permanently grown buffer would tax every
    # later batch); three redone batches in a row mean the base itself is
    # too small, and promote the size. Every batch carries the size it
    # was dispatched with, so a batch in flight during a promotion is
    # judged by its own buffer.
    redo_lp: dict[int, int] = {}     # batch index -> transient size
    consec_over = 0
    cap_warned = False

    def dispatch(i: int):
        lp = redo_lp.get(i, max_lp)
        out = step_for(lp)(batch_generator(cfg.seed, i, sys.device))
        return i, lp, fetch_async(_pack(out))

    def consume(dispatched, next_idx) -> bool:
        nonlocal overflow, infeasible, cap_warned, consec_over, max_lp
        idx, lp_used, fetched = dispatched
        per_year, nodal, comp_fail, loss_h, n_over, n_infeas = _unpack(
            fetched_numpy(fetched), Y, sys.n_bus,
            5 if cv_arrays is None else 7)
        if n_over > 0 and lp_used < lp_cap:
            redo_lp[idx] = min(2 * lp_used, lp_cap)
            print(f"LP buffer overflow ({n_over} h); redoing batch {idx} "
                  f"with a transient {redo_lp[idx]}/yr buffer")
            return True
        if n_over > 0:
            # At the cap: the hours that did not fit keep their certified
            # deficit bounds and are counted.
            redo_lp.pop(idx, None)
            consec_over = 0
            if not cap_warned:
                cap_warned = True
                print(f"LP buffer at its cap ({lp_used}/yr x {Y}); "
                      f"{n_over} overflow hours keep certified deficit "
                      "bounds (counted in overflow_hours)")
        elif idx in redo_lp:
            consec_over += 1
            size = redo_lp.pop(idx)
            if consec_over >= 3 and size > max_lp:
                max_lp = size
                print(f"3 consecutive overflow redos; promoting max_lp "
                      f"{max_lp}/yr to the base step")
        else:
            consec_over = 0
        if cv_arrays is not None:
            # Y_i = ENS_i - C_i + mu_C in float64: E[C_i] = mu_C exactly
            # under stationary sampling, so the mean is unchanged and the
            # copper deficit's variance leaves.
            ens, _, nlc, dlc, _, c_ens, c_dlc = per_year
            ens = ens - c_ens + mu_eens
            dlc = dlc - c_dlc + mu_lole
            per_year = (ens, dlc / hours, nlc, dlc, ens / hours)
        stats.update_years(*per_year, nodal, comp_fail, loss_h)
        overflow += n_over
        infeasible += n_infeas
        eens_history.append(stats.eens)
        cov_history.append(stats.cov)
        n_batches = len(eens_history)
        if log_every and n_batches % log_every == 0:
            print(f"year {stats.years:5d} | EENS {stats.eens:9.2f} MWh/yr "
                  f"| CoV {stats.cov:.4f}")
        if checkpointer is not None and n_batches % checkpoint_every == 0:
            checkpointer.save({
                "stats": stats.state(), "cov_history": cov_history,
                "eens_history": eens_history, "batch_idx": next_idx,
                "overflow": overflow, "infeasible": infeasible,
                "max_lp": max_lp})
        return False

    double_buffered_loop(
        dispatch=dispatch, consume=consume,
        should_continue=lambda i: (i * Y < cfg.max_years
                                   and stats.cov > cfg.cov_threshold),
        start_idx=batch_idx)

    mean = lambda v: float(np.mean(v)) if v else 0.0
    return SEQResult(
        eens_mwh_yr=stats.eens, lole_hr_yr=mean(stats.dlc),
        lolf_occ_yr=mean(stats.nlc), plc=mean(stats.plc),
        edns_mw=mean(stats.dns), cov=stats.cov, years=stats.years,
        converged=stats.cov <= cfg.cov_threshold,
        nodal_eens_mwh_yr=stats.nodal_eens(),
        comp_importance=stats.component_importance(),
        eens_history=eens_history, cov_history=cov_history,
        overflow_hours=overflow, annual_ens=list(stats.ens),
        infeasible_hours=infeasible, annual_dlc=list(stats.dlc),
        annual_nlc=list(stats.nlc))
