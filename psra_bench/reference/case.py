"""A configuration's network and reliability data as float64 arrays.

Plain NumPy, from the configuration file alone: the bus, unit and branch
tables, the two-state unavailabilities and mean times, the intact
network's PTDF, and the hourly load model of RTS-79 (IEEE Trans. PAS-98(6),
1979, Tables 1-3). Nothing here imports the program under test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

HOURS_PER_YEAR_RATES = 8760.0   # outage rates per year -> hours


@dataclasses.dataclass(frozen=True)
class RefCase:
    """One configuration, float64 host arrays, 0-based indices."""
    name: str
    base_mva: float
    bus_pd: np.ndarray        # [nb] MW
    load_bus: np.ndarray      # [nd] bus of each load (buses with pd != 0)
    gen_bus: np.ndarray       # [ng]
    gen_pmax: np.ndarray      # [ng] MW
    br_from: np.ndarray       # [nl]
    br_to: np.ndarray         # [nl]
    br_x: np.ndarray          # [nl] p.u.
    br_rate: np.ndarray       # [nl] MW
    unavail: np.ndarray       # [n_comp] generators, then branches
    mttf: np.ndarray          # [n_comp] hours
    mttr: np.ndarray          # [n_comp] hours
    pinned_nsq: np.ndarray    # [n_comp] bool: never down in NSQ sampling
    study: dict               # thresholds and precision of the study
    profile: dict             # RTS-79 hourly load model

    @property
    def n_bus(self) -> int:
        return self.bus_pd.shape[0]

    @property
    def n_gen(self) -> int:
        return self.gen_bus.shape[0]

    @property
    def n_branch(self) -> int:
        return self.br_from.shape[0]

    @property
    def n_load(self) -> int:
        return self.load_bus.shape[0]

    @property
    def n_comp(self) -> int:
        return self.n_gen + self.n_branch


def from_config(cfg: dict) -> RefCase:
    """The :class:`RefCase` of a parsed configuration file."""
    c = cfg["case"]
    f = lambda k: np.asarray(c[k], np.float64)  # noqa: E731
    i = lambda k: np.asarray(c[k], np.int64)    # noqa: E731
    bus_pd = f("bus_pd")
    gen_mttf, gen_mttr = f("gen_mttf"), f("gen_mttr")
    lam, dur = f("br_lambda"), f("br_dur")
    # Branch outages: rate lambda a year, repair mu = 8760 / duration.
    br_unavail = lam / (lam + HOURS_PER_YEAR_RATES / dur)
    pmax = f("gen_pmax")
    pinned = np.zeros(pmax.shape[0] + lam.shape[0], bool)
    if cfg["study"]["sync_cond_always_up_nsq"]:
        pinned[:pmax.shape[0]] = pmax <= 0.0
    return RefCase(
        name=cfg["name"], base_mva=float(c["base_mva"]), bus_pd=bus_pd,
        load_bus=np.flatnonzero(bus_pd != 0.0), gen_bus=i("gen_bus"),
        gen_pmax=pmax, br_from=i("br_from"), br_to=i("br_to"),
        br_x=f("br_x"), br_rate=f("br_rate"),
        unavail=np.concatenate([gen_mttr / (gen_mttf + gen_mttr),
                                br_unavail]),
        mttf=np.concatenate([gen_mttf, HOURS_PER_YEAR_RATES / lam]),
        mttr=np.concatenate([gen_mttr, dur]),
        pinned_nsq=pinned, study=dict(cfg["study"]),
        profile=dict(cfg["load_profile"]))


def incidence(case: RefCase) -> np.ndarray:
    """[nl, nb]: +1 at the from bus, -1 at the to bus."""
    inc = np.zeros((case.n_branch, case.n_bus))
    inc[np.arange(case.n_branch), case.br_from] = 1.0
    inc[np.arange(case.n_branch), case.br_to] = -1.0
    return inc


def intact_ptdf(case: RefCase) -> np.ndarray:
    """[nl, nb] flows (p.u.) per unit injection at each bus, withdrawn at
    bus 0, of the network with every branch in service."""
    inc = incidence(case)
    bsus = 1.0 / case.br_x
    b_bus = inc.T @ (bsus[:, None] * inc)
    ptdf = np.zeros((case.n_branch, case.n_bus))
    ptdf[:, 1:] = (bsus[:, None] * inc[:, 1:]) @ np.linalg.inv(b_bus[1:, 1:])
    return ptdf


def load_factors(case: RefCase, hours: int) -> np.ndarray:
    """[hours] share of the annual peak at each hour of the year: weekly
    peak x daily peak x hourly share (winter weeks 1-8 and 44-52, summer
    18-30, spring and autumn between; weekday or weekend column). The
    day of the week follows the study's rule: ``ceil(mod(h / 24, 7))``
    of the 1-based hour h ("reference") or ``((h - 1) // 24) mod 7 + 1``
    ("calendar")."""
    p = case.profile
    weekly = np.asarray(p["weekly"], np.float64)
    daily = np.asarray(p["daily"], np.float64)
    hourly = np.asarray(p["hourly"], np.float64)
    h = np.arange(1, hours + 1)
    week = np.clip((h + 167) // 168, 1, 52)
    if case.study["weekday_mode"] == "reference":
        day = np.ceil(np.mod(h / 24.0, 7.0)).astype(np.int64)
        day[day == 0] = 7
    else:
        day = ((h - 1) // 24) % 7 + 1
    hour = h % 24
    hour[hour == 0] = 24
    season = np.where((week <= 8) | (week >= 44), 0,
                      np.where((week >= 18) & (week <= 30), 2, 4))
    col = season + (day > 5)
    return weekly[week - 1] * daily[day - 1] * hourly[hour - 1, col]
