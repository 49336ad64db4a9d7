"""Loss of load of every state of a batch, in the reference's arithmetic.

A state whose units can carry the load, and whose branches are all in
service, sheds nothing if one dispatch fits every rating: each unit in
service at the same share of its capacity, the flows from the intact
network's PTDF. That proves a loss of 0 without an LP. Every other state
goes to the LP of :mod:`psra_bench.reference.lp`. The study's noise floor
then sets a loss below it to 0.
"""
from __future__ import annotations

import numpy as np
import torch

from psra_bench.reference.case import RefCase, intact_ptdf
from psra_bench.reference.lp import Precision, min_shed


def loss_of_load(case: RefCase, down: torch.Tensor, load_mw: torch.Tensor,
                 prec: Precision, lanes_per_solve: int = 4096):
    """(dns [B] MW, shed [B, nd] MW, lp_lanes, merit): the least load shed
    of each state (``down`` bool [B, n_comp], ``load_mw`` [B, nd] or
    [nd]), how many states the LP solved and its worst lane's merit."""
    dev, dt = down.device, prec.dtype
    B, ng = down.shape[0], case.n_gen
    load = torch.as_tensor(load_mw, device=dev).to(dt).expand(B, case.n_load)
    up_gen = (~down[:, :ng]).to(dt)
    pmax = torch.as_tensor(case.gen_pmax, dtype=dt, device=dev)
    cap = prec.mm(up_gen, pmax)
    total = load.sum(1)
    easy = (cap >= total) & ~down[:, ng:].any(1)
    # The proportional dispatch and its flows, MW.
    share = torch.where(cap > 0, total / torch.clamp_min(cap, 1e-30), 0.0)
    pg = up_gen * pmax * share[:, None]
    inj = torch.zeros((B, case.n_bus), dtype=dt, device=dev)
    inj.index_add_(1, torch.as_tensor(case.gen_bus, device=dev), pg)
    inj.index_add_(1, torch.as_tensor(case.load_bus, device=dev), -load)
    ptdf = torch.as_tensor(intact_ptdf(case), dtype=dt, device=dev)
    rate = torch.as_tensor(case.br_rate, dtype=dt, device=dev)
    flows = prec.mm(inj, ptdf.T)
    zero = easy & (flows.abs() <= rate).all(1)
    shed = torch.zeros((B, case.n_load), dtype=dt, device=dev)
    need = (~zero).nonzero().flatten()
    merit = 0.0
    if need.numel():
        lp_shed, merit = min_shed(case, down[need], load[need], prec,
                                  lanes_per_solve)
        shed[need] = lp_shed.to(dt)
    dns = shed.sum(1)
    floor = float(case.study["dns_noise_floor_mw"])
    dns = torch.where(dns < floor, torch.zeros_like(dns), dns)
    return dns, shed, int(need.numel()), merit


def hourly_loads(case: RefCase, factors: np.ndarray) -> np.ndarray:
    """[H, nd] MW: each load at each hour's share of its peak."""
    return np.asarray(factors, np.float64)[:, None] * case.bus_pd[
        case.load_bus][None, :]
