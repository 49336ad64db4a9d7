"""IEEE RTS-79 hierarchical chronological load model (host-side numpy).

Port of ``powersystemsreliabilityassessment_tpu/core/load_profile.py``:
``Load(t) = Peak * Weekly(w) * Daily(d) * Hourly(h | season, daytype)``,
the tables of ``Montecarlo_seq/case24_loadprofile.m:18-95`` and the
factor hierarchy of ``anloducurve.m:24-88``, including its day-of-week
formula ``ceil(mod(hour/24, 7))`` (the default, ``weekday_mode=
"reference"``); ``"calendar"`` is the conventional one. The profile is
static data: computed once on the host and copied to the device once.
"""
from __future__ import annotations

import numpy as np

PEAK_MW = 2850.0
PEAK_MVAR = 580.0

# Weekly peak factors, weeks 1..52 (case24_loadprofile.m:788-802).
WEEKLY = np.array([
    0.862, 0.900, 0.878, 0.834, 0.880, 0.841, 0.832, 0.806,
    0.740, 0.737, 0.715, 0.727, 0.704, 0.750, 0.721, 0.800,
    0.754, 0.837, 0.870, 0.880, 0.856, 0.811, 0.900, 0.887,
    0.896, 0.861, 0.755, 0.816, 0.801, 0.880, 0.722, 0.776,
    0.800, 0.729, 0.726, 0.705, 0.780, 0.695, 0.724, 0.723,
    0.743, 0.744, 0.800, 0.881, 0.885, 0.909, 0.940, 0.890,
    0.942, 0.970, 1.000, 0.952,
])

# Daily peak factors Mon..Sun (case24_loadprofile.m:806).
DAILY = np.array([0.93, 1.00, 0.98, 0.96, 0.94, 0.77, 0.75])

# Hourly factors [24, 6]; columns: winter wkdy, winter wknd, summer wkdy,
# summer wknd, spring/fall wkdy, spring/fall wknd
# (case24_loadprofile.m:813-838).
HOURLY = np.array([
    [0.67, 0.78, 0.64, 0.74, 0.63, 0.75],
    [0.63, 0.72, 0.60, 0.70, 0.62, 0.73],
    [0.60, 0.68, 0.58, 0.66, 0.60, 0.69],
    [0.59, 0.66, 0.56, 0.65, 0.58, 0.66],
    [0.59, 0.64, 0.56, 0.64, 0.59, 0.65],
    [0.60, 0.65, 0.58, 0.62, 0.65, 0.65],
    [0.74, 0.66, 0.64, 0.62, 0.72, 0.68],
    [0.86, 0.70, 0.76, 0.66, 0.85, 0.74],
    [0.95, 0.80, 0.87, 0.81, 0.95, 0.83],
    [0.96, 0.88, 0.95, 0.86, 0.99, 0.89],
    [0.96, 0.90, 0.99, 0.91, 1.00, 0.92],
    [0.95, 0.91, 1.00, 0.93, 0.99, 0.94],
    [0.95, 0.90, 0.99, 0.93, 0.93, 0.91],
    [0.95, 0.88, 1.00, 0.92, 0.92, 0.90],
    [0.93, 0.87, 1.00, 0.91, 0.90, 0.90],
    [0.94, 0.87, 0.97, 0.91, 0.88, 0.86],
    [0.99, 0.91, 0.96, 0.92, 0.90, 0.85],
    [1.00, 1.00, 0.96, 0.94, 0.92, 0.88],
    [1.00, 0.99, 0.93, 0.95, 0.96, 0.92],
    [0.96, 0.97, 0.92, 0.95, 0.98, 1.00],
    [0.91, 0.94, 0.92, 1.00, 0.96, 0.97],
    [0.83, 0.92, 0.93, 0.93, 0.90, 0.95],
    [0.73, 0.87, 0.87, 0.88, 0.80, 0.90],
    [0.63, 0.81, 0.72, 0.80, 0.70, 0.85],
])

HOURS_PER_WEEK = 168
HOURS_PER_YEAR_RTS = 8736  # 52 weeks * 168 h (seqMain.m:38)


def load_factors(total_hours: int = HOURS_PER_YEAR_RTS,
                 weekday_mode: str = "reference") -> np.ndarray:
    """Per-hour scaling factor vector (fraction of system peak), [H]
    float64. Mirrors reference ``core/load_profile.py::load_factors``.

    ``weekday_mode="reference"`` replicates ``anloducurve.m:39``'s
    ``ceil(mod(hour/24, 7))`` day-of-week formula; ``"calendar"`` uses the
    conventional ``((hour-1) // 24) mod 7``.
    """
    h = np.arange(1, total_hours + 1)  # 1-based hour index, like the reference

    week = np.clip(np.ceil(h / HOURS_PER_WEEK).astype(int), 1, 52)

    if weekday_mode == "reference":
        day = np.ceil(np.mod(h / 24.0, 7.0)).astype(int)
        day[day == 0] = 7
    elif weekday_mode == "calendar":
        day = ((h - 1) // 24) % 7 + 1
    else:
        raise ValueError(f"unknown weekday_mode: {weekday_mode}")

    hour_of_day = np.mod(h, 24)
    hour_of_day[hour_of_day == 0] = 24

    winter = (week <= 8) | (week >= 44)
    summer = (week >= 18) & (week <= 30)
    season_base = np.where(winter, 0, np.where(summer, 2, 4))
    col = season_base + (day > 5).astype(int)

    return (WEEKLY[week - 1] * DAILY[day - 1]
            * HOURLY[hour_of_day - 1, col])


def hourly_bus_loads(bus_pd: np.ndarray, total_hours: int = HOURS_PER_YEAR_RTS,
                     **kw) -> tuple[np.ndarray, np.ndarray]:
    """``(bus_loads [nb, H], factors [H])`` in MW. Mirrors reference
    ``core/load_profile.py::hourly_bus_loads``."""
    f = load_factors(total_hours, **kw)
    return bus_pd[:, None] * f[None, :], f


def weekly_peaks(factors: np.ndarray, peak_mw: float = PEAK_MW) -> np.ndarray:
    """Peak MW of each 168-hour week of a factor vector. Mirrors
    reference ``core/load_profile.py::weekly_peaks``."""
    n_weeks = len(factors) // HOURS_PER_WEEK
    trimmed = factors[: n_weeks * HOURS_PER_WEEK]
    return trimmed.reshape(n_weeks, HOURS_PER_WEEK).max(axis=1) * peak_mw
