"""Built-in test systems as plain numpy data (host side).

Port of ``powersystemsreliabilityassessment_tpu/core/cases.py``:
``CaseData`` and ``rts24`` (IEEE RTS-24, 24 buses, 33 units including the
synchronous condenser, 38 branches, 2850 MW peak), unchanged — the data is
numpy and framework-free. The other reference cases (``replicate_case``,
``rts96``, ``case300s``) come with the mid/large-m slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CaseData:
    """Raw case description (host-side, numpy); mirrors reference
    ``core/cases.py::CaseData``.

    Component ordering convention (identical to the reference): the
    ``n_gen + n_branch`` component vector is generators first (in the order
    below) then branches. For RTS-24 this gives 71 components with the
    synchronous condenser at component index 14 (0-based; index 15 in the
    reference's 1-based MATLAB).
    """

    name: str
    base_mva: float
    # Buses -----------------------------------------------------------------
    bus_pd: np.ndarray          # [nb] peak active load, MW
    bus_qd: np.ndarray          # [nb] peak reactive load, MVAr
    # Generators ------------------------------------------------------------
    gen_bus: np.ndarray         # [ng] 0-based bus index
    gen_pmax: np.ndarray        # [ng] MW
    gen_pmin: np.ndarray        # [ng] MW
    gen_mttf: np.ndarray        # [ng] hours
    gen_mttr: np.ndarray        # [ng] hours
    gen_maint_weeks: np.ndarray  # [ng] scheduled maintenance weeks/yr
    # Branches ----------------------------------------------------------------
    br_from: np.ndarray         # [nl] 0-based bus index
    br_to: np.ndarray           # [nl] 0-based bus index
    br_x: np.ndarray            # [nl] reactance, p.u.
    br_rate: np.ndarray         # [nl] continuous rating, MW (MVA)
    br_lambda: np.ndarray       # [nl] permanent outage rate, occ/yr
    br_dur: np.ndarray          # [nl] outage duration, hours
    # Optional per-bus area assignment (0-based contiguous), from the
    # MATPOWER BUS_AREA column or a tiled construction; None when the
    # case carries no area structure. Consumed by
    # engines/multiarea.areas_from_case for the HL1.5 view.
    bus_area: np.ndarray | None = None

    @property
    def n_bus(self) -> int:
        return int(self.bus_pd.shape[0])

    @property
    def n_gen(self) -> int:
        return int(self.gen_bus.shape[0])

    @property
    def n_branch(self) -> int:
        return int(self.br_from.shape[0])

    @property
    def n_comp(self) -> int:
        return self.n_gen + self.n_branch

    @property
    def total_load(self) -> float:
        return float(self.bus_pd.sum())

    @property
    def sync_cond_mask(self) -> np.ndarray:
        """Boolean mask of zero-capacity units (synchronous condensers)."""
        return self.gen_pmax <= 0.0


def _f(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _i(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


def rts24() -> CaseData:
    """IEEE RTS-24 single-area system with reference reliability data.

    Mirrors reference ``core/cases.py::rts24``."""
    # Bus peak loads (RTS-79 Table 4 / case24_loadprofile.m:842-860). Buses
    # without entries carry zero load.
    nb = 24
    bus_pd = np.zeros(nb)
    bus_qd = np.zeros(nb)
    load_rows = [
        # bus (1-based), Pd, Qd
        (1, 108, 22), (2, 97, 20), (3, 180, 37), (4, 74, 15), (5, 71, 14),
        (6, 136, 28), (7, 125, 25), (8, 171, 35), (9, 175, 36), (10, 195, 40),
        (13, 265, 54), (14, 194, 39), (15, 317, 64), (16, 100, 20),
        (18, 333, 68), (19, 181, 37), (20, 128, 26),
    ]
    for b, p, q in load_rows:
        bus_pd[b - 1] = p
        bus_qd[b - 1] = q

    # Generating units, in the same order as the reference component vector
    # (MATPOWER case24_ieee_rts order; reliability rows from
    # case24_failrate.m:23-78).   (bus, Pmax, Pmin, MTTF, MTTR, maint_weeks)
    gen_rows = [
        (1, 20, 4.0, 450, 50, 2),       # U20
        (1, 20, 4.0, 450, 50, 2),
        (1, 76, 15.2, 1960, 40, 3),     # U76
        (1, 76, 15.2, 1960, 40, 3),
        (2, 20, 4.0, 450, 50, 2),
        (2, 20, 4.0, 450, 50, 2),
        (2, 76, 15.2, 1960, 40, 3),
        (2, 76, 15.2, 1960, 40, 3),
        (7, 100, 25.0, 1200, 50, 3),    # U100
        (7, 100, 25.0, 1200, 50, 3),
        (7, 100, 25.0, 1200, 50, 3),
        (13, 197, 69.0, 950, 50, 4),    # U197
        (13, 197, 69.0, 950, 50, 4),
        (13, 197, 69.0, 950, 50, 4),
        (14, 0, 0.0, 10000, 0.1, 0.1),  # synchronous condenser (component 15)
        (15, 12, 2.4, 2940, 60, 2),     # U12
        (15, 12, 2.4, 2940, 60, 2),
        (15, 12, 2.4, 2940, 60, 2),
        (15, 12, 2.4, 2940, 60, 2),
        (15, 12, 2.4, 2940, 60, 2),
        (15, 155, 54.25, 960, 40, 4),   # U155
        (16, 155, 54.25, 960, 40, 4),
        (18, 400, 100.0, 1100, 150, 6),  # U400
        (21, 400, 100.0, 1100, 150, 6),
        (22, 50, 10.0, 1980, 20, 2),    # U50 hydro
        (22, 50, 10.0, 1980, 20, 2),
        (22, 50, 10.0, 1980, 20, 2),
        (22, 50, 10.0, 1980, 20, 2),
        (22, 50, 10.0, 1980, 20, 2),
        (22, 50, 10.0, 1980, 20, 2),
        (23, 155, 54.25, 960, 40, 4),
        (23, 155, 54.25, 960, 40, 4),
        (23, 350, 140.0, 1150, 100, 5),  # U350
    ]
    gen_bus = _i([r[0] - 1 for r in gen_rows])
    gen_pmax = _f([r[1] for r in gen_rows])
    gen_pmin = _f([r[2] for r in gen_rows])
    gen_mttf = _f([r[3] for r in gen_rows])
    gen_mttr = _f([r[4] for r in gen_rows])
    gen_weeks = _f([r[5] for r in gen_rows])

    # Branches (RTS-79 Table 12 / MATPOWER case24_ieee_rts):
    # (from, to, x, rateA).  Reliability columns (lambda occ/yr, duration h)
    # appended from case24_failrate.m:62-78 in the same order.
    br_rows = [
        (1, 2, 0.0139, 175), (1, 3, 0.2112, 175), (1, 5, 0.0845, 175),
        (2, 4, 0.1267, 175), (2, 6, 0.1920, 175), (3, 9, 0.1190, 175),
        (3, 24, 0.0839, 400), (4, 9, 0.1037, 175), (5, 10, 0.0883, 175),
        (6, 10, 0.0605, 175), (7, 8, 0.0614, 175), (8, 9, 0.1651, 175),
        (8, 10, 0.1651, 175), (9, 11, 0.0839, 400), (9, 12, 0.0839, 400),
        (10, 11, 0.0839, 400), (10, 12, 0.0839, 400), (11, 13, 0.0476, 500),
        (11, 14, 0.0418, 500), (12, 13, 0.0476, 500), (12, 23, 0.0966, 500),
        (13, 23, 0.0865, 500), (14, 16, 0.0389, 500), (15, 16, 0.0173, 500),
        (15, 21, 0.0490, 500), (15, 21, 0.0490, 500), (15, 24, 0.0519, 500),
        (16, 17, 0.0259, 500), (16, 19, 0.0231, 500), (17, 18, 0.0144, 500),
        (17, 22, 0.1053, 500), (18, 21, 0.0259, 500), (18, 21, 0.0259, 500),
        (19, 20, 0.0396, 500), (19, 20, 0.0396, 500), (20, 23, 0.0216, 500),
        (20, 23, 0.0216, 500), (21, 22, 0.0678, 500),
    ]
    br_lambda = _f([
        0.24, 0.51, 0.33, 0.39, 0.48, 0.38, 0.02, 0.36, 0.34, 0.33, 0.30,
        0.44, 0.44, 0.02, 0.02, 0.02, 0.02, 0.40, 0.39, 0.40, 0.52, 0.49,
        0.38, 0.33, 0.41, 0.41, 0.41, 0.35, 0.34, 0.32, 0.54, 0.35, 0.35,
        0.38, 0.38, 0.34, 0.34, 0.45,
    ])
    br_dur = _f([
        16, 10, 10, 10, 10, 768, 10, 10, 35, 10, 10, 10,
        10, 768, 768, 768, 768, 11, 11, 11, 11, 11, 11, 11,
        11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11,
    ])

    return CaseData(
        name="rts24",
        base_mva=100.0,
        bus_pd=bus_pd,
        bus_qd=bus_qd,
        gen_bus=gen_bus,
        gen_pmax=gen_pmax,
        gen_pmin=gen_pmin,
        gen_mttf=gen_mttf,
        gen_mttr=gen_mttr,
        gen_maint_weeks=gen_weeks,
        br_from=_i([r[0] - 1 for r in br_rows]),
        br_to=_i([r[1] - 1 for r in br_rows]),
        br_x=_f([r[2] for r in br_rows]),
        br_rate=_f([r[3] for r in br_rows]),
        br_lambda=br_lambda,
        br_dur=br_dur,
    )
