"""GPS time <-> calendar conversions and week-second arithmetic.

Host-side epoch math (SURVEY.md #4). Semantics match the reference:
  * date2gps leap-day arithmetic     (plutogpssim.c:250-272)
  * gps2date via Julian day          (plutogpssim.c:274-290)
  * subGpsTime / incGpsTime          (plutogpssim.c:838-866), including the
    deliberate rounding of seconds to 1 ms in incGpsTime (c:853) which the
    whole 0.1 s epoch grid depends on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..constants import SECONDS_IN_DAY, SECONDS_IN_HOUR, SECONDS_IN_MINUTE, SECONDS_IN_WEEK

__all__ = ["inc_gps_time_grid", "GpsTime", "DateTime", "date2gps", "gps2date", "sub_gps_time", "inc_gps_time"]


@dataclass(frozen=True)
class GpsTime:
    week: int   # GPS week number since Jan 1980
    sec: float  # seconds into the week


@dataclass
class DateTime:
    y: int
    m: int
    d: int
    hh: int
    mm: int
    sec: float


_DOY = (0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334)


def date2gps(t: DateTime) -> GpsTime:
    ye = t.y - 1980
    # leap days since Jan 5/6 1980
    lpdays = ye // 4 + 1
    if ye % 4 == 0 and t.m <= 2:
        lpdays -= 1
    de = ye * 365 + _DOY[t.m - 1] + t.d + lpdays - 6
    week = de // 7
    sec = float(de % 7) * SECONDS_IN_DAY + t.hh * SECONDS_IN_HOUR \
        + t.mm * SECONDS_IN_MINUTE + t.sec
    return GpsTime(week, sec)


def gps2date(g: GpsTime) -> DateTime:
    c = int(7 * g.week + math.floor(g.sec / 86400.0) + 2444245.0) + 1537
    d = int((c - 122.1) / 365.25)
    e = 365 * d + d // 4
    f = int((c - e) / 30.6001)

    day = c - e - int(30.6001 * f)
    month = f - 1 - 12 * (f // 14)
    year = d - 4715 - ((7 + month) // 10)

    hh = int(g.sec / 3600.0) % 24
    mm = int(g.sec / 60.0) % 60
    sec = g.sec - 60.0 * math.floor(g.sec / 60.0)
    return DateTime(year, month, day, hh, mm, sec)


def sub_gps_time(g1: GpsTime, g0: GpsTime) -> float:
    return (g1.sec - g0.sec) + (g1.week - g0.week) * SECONDS_IN_WEEK


def inc_gps_time(g0: GpsTime, dt: float) -> GpsTime:
    week = g0.week
    sec = g0.sec + dt
    # Reference rounds to 1 ms to avoid drift on the 0.1 s grid (c:853).
    # C round() is round-half-away-from-zero.
    sec = _c_round(sec * 1000.0) / 1000.0
    while sec >= SECONDS_IN_WEEK:
        sec -= SECONDS_IN_WEEK
        week += 1
    while sec < 0.0:
        sec += SECONDS_IN_WEEK
        week -= 1
    return GpsTime(week, sec)


def _c_round(x: float) -> float:
    """C round(): half away from zero (Python round() is banker's)."""
    return math.floor(x + 0.5) if x >= 0.0 else math.ceil(x - 0.5)


def inc_gps_time_grid(g0: GpsTime, dts: "np.ndarray"):
    """Vectorized inc_gps_time over an array of offsets (all >= 0).

    Elementwise IEEE-identical to [inc_gps_time(g0, dt) for dt in dts]
    (same operation tree: add, *1000, half-away round, /1000, week wrap);
    used by the scheduler's epoch grid, where the per-epoch Python-loop
    cost matters at Monte-Carlo batch sizes.  Returns (secs f64, weeks
    int64)."""
    import numpy as np
    sec = g0.sec + np.asarray(dts, dtype=np.float64)
    sec = np.floor(sec * 1000.0 + 0.5) / 1000.0
    wrap = np.floor_divide(sec, SECONDS_IN_WEEK).astype(np.int64)
    return sec - wrap * SECONDS_IN_WEEK, g0.week + wrap
