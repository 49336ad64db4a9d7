"""Multi-area adequacy with tie-line constraints (HL1.5).

Port of ``powersystemsreliabilityassessment_tpu/engines/multiarea.py``,
which replaces ``AdequacyAssessmentII.jl`` (module AdequacyAssessmentFast):
areas with their own fleets and load curves, joined by capacity-limited
tie lines; each hour the minimum total curtailment moves surplus to
deficit areas. The reference's Ford-Fulkerson max-flow (:73-179) is a
tiny LP here, solved by the batched interior point:

    variables  x = [flow+ (T), flow- (T), curtail (A), spill (A)]
    minimize   sum(curtail) + 1e-3 sum(flow)
    s.t. per area: margin + inflow - outflow + curtail - spill = 0
         0 <= flow+- <= tie_cap, 0 <= curtail <= max(-margin, 0),
         0 <= spill

with a fast path for hours with no deficit (:78-80) and the closed-form
ISOLATED policy (:84-92). ``solve_curtailment`` goes through
``lp_ipm_batched.solve_box_lp_batched``, so on the card the normal
matrices (m = the number of areas) take the K2a / K2b kernels
(``ops/batched_chol.py``), on the CPU their plain versions. The
reference pads the batch to 128 lanes on the TPU; the CUDA kernels take
any batch, so the port does not.

The study runs on one device (the card unless the caller passes
``device="cpu"``) or on every rank of a scenario mesh
(``parallel/mesh.py``): each batch of years draws its timelines from its
own generator (``hl2_nsq.batch_generator(seed, batch, rank)``), and the
per-batch partial sums stay on the device, summed over the ranks in one
``all_reduce``, until one read at the end.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from powersystemsreliabilityassessment_tpu_torch.engines import (
    lp_ipm_batched)
from powersystemsreliabilityassessment_tpu_torch.parallel import (
    mesh as meshlib)
from powersystemsreliabilityassessment_tpu_torch.sampling import chronological
from powersystemsreliabilityassessment_tpu_torch.studies.hl2_nsq import (
    batch_generator)
from powersystemsreliabilityassessment_tpu_torch.utils.config import (
    IPMConfig)

ISOLATED = "isolated"
INTERCONNECTED = "interconnected"
# The cost of a MW on a tie: among the minimum-total-curtailment optima
# it picks the minimal-flow one (reference _build_interconnect_lp).
FLOW_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class MultiAreaSystem:
    """Host-side description (numpy); mirrors reference
    ``engines/multiarea.py::MultiAreaSystem``."""
    area_names: list
    gen_capacity: list          # per area: np [Gi]
    gen_mttf: list
    gen_mttr: list
    hourly_load: np.ndarray     # [A, H]
    tie_from: np.ndarray        # [T] 0-based area index
    tie_to: np.ndarray          # [T]
    tie_cap: np.ndarray         # [T]

    @property
    def n_areas(self) -> int:
        return len(self.area_names)


def areas_from_case(case, area_of_bus: np.ndarray,
                    hourly_factors: np.ndarray,
                    area_names: list | None = None) -> MultiAreaSystem:
    """The HL1.5 multi-area view of a network case; mirrors reference
    ``engines/multiarea.py::areas_from_case``. Each area aggregates its
    generating units (zero-capacity units, the synchronous condensers,
    are dropped), each inter-area branch becomes a tie line rated at its
    continuous rating (parallel ties stay separate), and each area's load
    is its summed bus peak load times ``hourly_factors`` [H].
    ``area_of_bus``: [nb] 0-based area a bus."""
    area_of_bus = np.asarray(area_of_bus, np.int64)
    n_areas = int(area_of_bus.max()) + 1
    if area_names is None:
        area_names = [chr(ord("A") + a) if n_areas <= 26 else f"Area{a}"
                      for a in range(n_areas)]
    gen_area = area_of_bus[np.asarray(case.gen_bus)]
    real = np.asarray(case.gen_pmax) > 0
    pick = lambda v: [np.asarray(v)[real & (gen_area == a)]
                      for a in range(n_areas)]
    af = area_of_bus[np.asarray(case.br_from)]
    at = area_of_bus[np.asarray(case.br_to)]
    inter = af != at
    factors = np.asarray(hourly_factors, np.float64)
    area_peak = np.zeros(n_areas)
    np.add.at(area_peak, area_of_bus, np.asarray(case.bus_pd))
    return MultiAreaSystem(
        area_names=area_names,
        gen_capacity=pick(case.gen_pmax),
        gen_mttf=pick(case.gen_mttf),
        gen_mttr=pick(case.gen_mttr),
        hourly_load=area_peak[:, None] * factors[None, :],
        tie_from=af[inter].astype(np.int32),
        tie_to=at[inter].astype(np.int32),
        tie_cap=np.asarray(case.br_rate)[inter].astype(np.float64),
    )


def curtail_isolated(margins: torch.Tensor) -> torch.Tensor:
    """[..., A] -> [..., A]: curtailment = -min(margin, 0). Mirrors
    reference ``engines/multiarea.py::curtail_isolated``."""
    return torch.clamp_min(-margins, 0.0)


def _build_interconnect_lp(margins, tie_from, tie_to, tie_cap, big):
    """The interconnected-curtailment LPs ``(c, A, b, l, u)`` of a batch
    of margins [B, A]; mirrors reference
    ``engines/multiarea.py::_build_interconnect_lp`` (there vmapped over
    lanes). Each area's curtailment is capped at its ISOLATED deficit
    (the reference's max-flow moves surplus only, so interconnection
    never worsens an area); a surplus area gets a zero curtail column and
    a unit dummy box. The FLOW_EPS tie cost picks the minimal-flow
    optimum, which fixes the per-area split; it keeps the minimum total
    while augmenting paths cross fewer than 1 / FLOW_EPS ties."""
    B, n_a = margins.shape
    T = tie_cap.shape[0]
    dt, dev = margins.dtype, margins.device
    # incidence of directed flows: +1 into 'to', -1 out of 'from' (as
    # compares, which read no index back to the host)
    area = torch.arange(n_a, device=dev)[:, None]
    inc = ((tie_to[None, :] == area).to(dt)
           - (tie_from[None, :] == area).to(dt))               # [A, T]
    deficit = margins < 0
    eye = torch.eye(n_a, dtype=dt, device=dev)
    Amat = torch.cat([inc.expand(B, n_a, T), (-inc).expand(B, n_a, T),
                      eye * deficit.to(dt)[:, None, :],
                      (-eye).expand(B, n_a, n_a)], dim=2).contiguous()
    b = -margins
    n = 2 * T + 2 * n_a
    c = torch.cat([torch.full((2 * T,), FLOW_EPS, dtype=dt, device=dev),
                   torch.ones(n_a, dtype=dt, device=dev),
                   torch.zeros(n_a, dtype=dt, device=dev)]).expand(B, n)
    l = torch.zeros((B, n), dtype=dt, device=dev)
    u = torch.cat([tie_cap.expand(B, T), tie_cap.expand(B, T),
                   torch.where(deficit, -margins, 1.0),
                   big.expand(B, n_a)], dim=1)
    return c.contiguous(), Amat, b, l, u


def solve_curtailment(margins: torch.Tensor, tie_from, tie_to, tie_cap,
                      policy: str = INTERCONNECTED,
                      ipm: IPMConfig = IPMConfig(iterations=20)
                      ) -> torch.Tensor:
    """Minimum curtailment [B, A] of per-area margins [B, A] (float32, on
    any device; the tie arrays are moved to it). Mirrors reference
    ``engines/multiarea.py::solve_curtailment`` without its 128-lane
    padding. With the LP's near-optimal tie flows fixed, the per-area
    curtailment is the closed-form deficit of the netted margins (the
    float32 interior point's gap removed); a lane with no deficit
    anywhere is exactly zero."""
    if policy == ISOLATED:
        return curtail_isolated(margins)
    dev, dt = margins.device, margins.dtype
    tie_from = torch.as_tensor(tie_from, dtype=torch.int64, device=dev)
    tie_to = torch.as_tensor(tie_to, dtype=torch.int64, device=dev)
    tie_cap = torch.as_tensor(tie_cap, dtype=dt, device=dev)
    T = tie_cap.shape[0]
    big = torch.clamp_min(margins.abs().amax(), 1.0) * 2.0
    c, Am, b, l, u = _build_interconnect_lp(margins, tie_from, tie_to,
                                            tie_cap, big)
    sol = lp_ipm_batched.solve_box_lp_batched(c, Am, b, l, u, ipm)
    flows = (Am[:, :, :2 * T] @ sol.x[:, :2 * T, None])[:, :, 0]
    out = torch.clamp_min(-(margins + flows), 0.0)
    any_deficit = (margins < 0).any(1, keepdim=True)
    return torch.where(any_deficit, out, 0.0)


def _padded_fleet(sys: MultiAreaSystem):
    """The ragged per-area fleets as [A, Gmax] arrays (capacity-0 padding
    with a huge MTTF adds no capacity and no failures); mirrors reference
    ``engines/multiarea.py::_padded_fleet``."""
    A = sys.n_areas
    gmax = max(int(len(c)) for c in sys.gen_capacity)
    caps = np.zeros((A, gmax), np.float32)
    mttf = np.full((A, gmax), 1e9, np.float64)
    mttr = np.full((A, gmax), 1.0, np.float64)
    for a in range(A):
        g = len(sys.gen_capacity[a])
        caps[a, :g] = sys.gen_capacity[a]
        mttf[a, :g] = sys.gen_mttf[a]
        mttr[a, :g] = sys.gen_mttr[a]
    return caps, mttf, mttr


def block_margins(down: torch.Tensor, caps: torch.Tensor,
                  load: torch.Tensor) -> torch.Tensor:
    """Per-area margins [Y H, A] (MW, float32) of a block of years
    ``down`` ``[Y, A Gmax, H]`` (True = DOWN): each area's available
    capacity a hour (``caps`` [A, Gmax]) less its ``load`` [A, H].
    Integer-MW capacities sum exactly in float32."""
    Y, _, H = down.shape
    A, gmax = caps.shape
    avail = 1.0 - down.to(torch.float32)
    cap_series = (avail.reshape(Y, A, gmax, H)
                  * caps[None, :, :, None]).sum(2)          # [Y, A, H]
    return (cap_series.transpose(1, 2) - load.T[None]).reshape(-1, A)


def evaluate_block(down: torch.Tensor, caps: torch.Tensor,
                   load: torch.Tensor, tie_from, tie_to, tie_cap,
                   policy: str, ipm: IPMConfig):
    """Per-area ``(loss hours [A], curtailment sum [A] MWh)`` of a block
    of years ``down`` ``[Y, A Gmax, H]``: :func:`block_margins`,
    curtailment, then the sums; the evaluation of reference
    ``make_multiarea_batch_step``'s device step."""
    curt = solve_curtailment(block_margins(down, caps, load), tie_from,
                             tie_to, tie_cap, policy, ipm)
    return (curt > 0).sum(0), curt.sum(0)


class DeviceAreas(NamedTuple):
    """A :class:`MultiAreaSystem` on a device, as the step reads it:
    the padded fleet (capacities [A, Gmax], MTTF / MTTR [A Gmax]), the
    loads [A, H], the ties and the draws a component a year."""
    caps: torch.Tensor
    mttf: torch.Tensor
    mttr: torch.Tensor
    load: torch.Tensor
    tie_from: torch.Tensor
    tie_to: torch.Tensor
    tie_cap: torch.Tensor
    n_draws: int


def device_areas(sys: MultiAreaSystem,
                 device: torch.device | str) -> DeviceAreas:
    """``sys`` copied to ``device`` once (float32; int64 tie ends)."""
    caps, mttf, mttr = _padded_fleet(sys)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                    device=device)
    return DeviceAreas(
        f32(caps), f32(mttf.reshape(-1)), f32(mttr.reshape(-1)),
        f32(sys.hourly_load), i64(sys.tie_from), i64(sys.tie_to),
        f32(sys.tie_cap), chronological.default_num_draws(
            mttf.reshape(-1), mttr.reshape(-1), sys.hourly_load.shape[1]))


def draw_block(areas: DeviceAreas, years: int,
               generator: torch.Generator) -> torch.Tensor:
    """bool ``[years, A Gmax, H]`` (True = DOWN): a block's chronological
    timelines with continuous dwells (the reference's
    ``sample_timeline(quantize=False)``), from ``generator``."""
    return chronological.sample_timeline_batch(
        generator, areas.mttf, areas.mttr, areas.load.shape[1],
        areas.n_draws, years, quantize=False)


def make_multiarea_batch_step(sys: MultiAreaSystem, years_per_device: int,
                              policy: str, ipm: IPMConfig,
                              device: torch.device | str = "cuda",
                              mesh=None):
    """One-batch step ``generator -> (loss hours [A], curtailment sum [A]
    MWh)``, device tensors, over ``years_per_device`` years on
    ``device`` (``mesh``'s device where one is given); mirrors reference
    ``engines/multiarea.py::make_multiarea_batch_step``:
    :func:`draw_block`, then :func:`evaluate_block`. The step only
    enqueues device work; the rank's sums are summed over the mesh by
    :func:`multiarea_batches`, once for all batches."""
    areas = device_areas(sys, device if mesh is None else mesh.device)

    def step(generator: torch.Generator):
        return evaluate_block(draw_block(areas, years_per_device, generator),
                              areas.caps, areas.load, areas.tie_from,
                              areas.tie_to, areas.tie_cap, policy, ipm)

    return step


def multiarea_batches(sys: MultiAreaSystem, policy: str, n_years: int,
                      seed: int = 0,
                      ipm: IPMConfig = IPMConfig(iterations=20),
                      years_per_device: int = 8,
                      device: torch.device | str = "cuda", mesh=None):
    """``(loss hours [n_batches, A], curtailment sums [n_batches, A],
    years a batch)``, float64 numpy: each batch's per-area sums over
    every rank of ``mesh`` (None: ``device`` alone), summed on the device
    in one ``all_reduce`` and read once after the last batch. Rank r's
    part of batch b draws from ``batch_generator(seed, b, rank=r)``;
    ``years_per_device`` is capped at ``ceil(n_years / N)`` on N ranks,
    as the reference caps it (``:280-283``)."""
    mesh = mesh or meshlib.one_device(device)
    ypd = max(1, min(years_per_device, -(-n_years // mesh.size)))
    ypb = ypd * mesh.size
    n_batches = max(1, -(-n_years // ypb))
    step = make_multiarea_batch_step(sys, ypd, policy, ipm, mesh=mesh)
    parts = [step(batch_generator(seed, b, mesh.device, mesh.rank))
             for b in range(n_batches)]
    # Loss hours are counts below 2^24: exact in float32.
    sums = torch.stack([torch.stack([loss.to(eue.dtype), eue])
                        for loss, eue in parts])          # [n_batches, 2, A]
    sums = meshlib.psum(mesh, sums).cpu().numpy().astype(np.float64)
    return sums[:, 0], sums[:, 1], ypb


def run_multiarea_sequential(sys: MultiAreaSystem, policy: str,
                             n_years: int, seed: int = 0,
                             ipm: IPMConfig = IPMConfig(iterations=20),
                             years_per_device: int = 8,
                             device: torch.device | str = "cuda",
                             mesh=None):
    """Sequential multi-area simulation (AdequacyAssessmentII.jl:185-250):
    ``(LOLE [A] h/yr, EUE [A] MWh/yr)`` over whole batches of
    ``years_per_device`` years a rank (at least ``n_years`` in all), on
    ``device`` or on every rank of ``mesh``. Mirrors reference
    ``engines/multiarea.py::run_multiarea_sequential``; device memory is
    O(years_per_device H A) whatever ``n_years``."""
    loss, eue, ypb = multiarea_batches(sys, policy, n_years, seed, ipm,
                                       years_per_device, device, mesh)
    total_years = loss.shape[0] * ypb
    return loss.sum(0) / total_years, eue.sum(0) / total_years
