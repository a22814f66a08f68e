"""Scenario time setup: start time selection, TOC/TOE overwrite, set choice.

Host logic matching the reference's main() scenario section
(plutogpssim.c:2497-2597):

  * default start = first valid SV's time-of-clock in set 0;
  * -t start must lie within [gmin, gmax] of the file;
  * -T overwrite mode aligns the start down to a 7200 s boundary and
    shifts every toc/toe (and the UTC reference week/time) by the delta;
  * the active ephemeris set is the first whose |t - toc| < 1 hour.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import EPHEM_ARRAY_SIZE, MAX_SAT, SECONDS_IN_HOUR
from ..ingest.rinex import RinexResult
from ..models.gpstime import (
    GpsTime,
    gps2date,
    inc_gps_time,
    sub_gps_time,
)

__all__ = ["ScenarioError", "setup_scenario", "select_ephemeris_set",
           "advance_ephemeris_set"]


class ScenarioError(Exception):
    pass


def _first_valid_toc(rin: RinexResult, iset: int) -> GpsTime | None:
    eph = rin.eph[iset]
    for sv in range(MAX_SAT):
        if eph.vflg[sv]:
            return GpsTime(int(eph.toc_week[sv]), float(eph.toc_sec[sv]))
    return None


def setup_scenario(rin: RinexResult, g0: GpsTime | None,
                   timeoverwrite: bool = False) -> GpsTime:
    """Validate / derive the scenario start time; may shift rin's
    ephemerides in time-overwrite mode.  Returns the start GpsTime."""
    gmin = _first_valid_toc(rin, 0)
    if gmin is None:
        raise ScenarioError("no valid ephemerides in set 0")
    gmax = _first_valid_toc(rin, rin.n_sets - 1) or gmin

    if g0 is not None:
        if timeoverwrite:
            # Align down to 2 h (7200 s) boundary and shift everything
            gtmp = GpsTime(g0.week, float(int(g0.sec) // 7200) * 7200.0)
            dsec = sub_gps_time(gtmp, gmin)

            rin.ionoutc.wnt = np.array(gtmp.week, np.int32)
            rin.ionoutc.tot = np.array(int(gtmp.sec), np.int32)

            for iset in range(rin.n_sets):
                eph = rin.eph[iset]
                for sv in range(MAX_SAT):
                    if eph.vflg[sv]:
                        toc = inc_gps_time(
                            GpsTime(int(eph.toc_week[sv]),
                                    float(eph.toc_sec[sv])), dsec)
                        eph.toc_week[sv] = toc.week
                        eph.toc_sec[sv] = toc.sec
                        rin.t[iset][sv] = gps2date(toc)
                        toe = inc_gps_time(
                            GpsTime(int(eph.toe_week[sv]),
                                    float(eph.toe_sec[sv])), dsec)
                        eph.toe_week[sv] = toe.week
                        eph.toe_sec[sv] = toe.sec
        else:
            if sub_gps_time(g0, gmin) < 0.0 or sub_gps_time(gmax, g0) < 0.0:
                raise ScenarioError(
                    f"start time outside ephemeris span "
                    f"({gmin.week}:{gmin.sec:.0f} .. {gmax.week}:{gmax.sec:.0f})")
        return g0

    return gmin


def select_ephemeris_set(rin: RinexResult, g0: GpsTime) -> int:
    """First set where ANY valid SV has |g0 - toc| < 1 h (c:2576-2597;
    the reference's inner loop scans all 32 SVs, breaking only on a
    match)."""
    for iset in range(rin.n_sets):
        eph = rin.eph[iset]
        for sv in range(MAX_SAT):
            if eph.vflg[sv]:
                dt = sub_gps_time(g0, GpsTime(int(eph.toc_week[sv]),
                                              float(eph.toc_sec[sv])))
                if -SECONDS_IN_HOUR <= dt < SECONDS_IN_HOUR:
                    return iset
    raise ScenarioError("no current set of ephemerides found")


def advance_ephemeris_set(rin: RinexResult, ieph: int, grx: GpsTime) -> int:
    """30 s-cadence rollover check (c:2774-2790): if the next set's first
    valid SV has toc within 1 h of now, advance.  Returns new ieph."""
    if ieph + 1 >= EPHEM_ARRAY_SIZE:
        return ieph
    nxt = rin.eph[ieph + 1]
    for sv in range(MAX_SAT):
        if nxt.vflg[sv]:
            dt = sub_gps_time(GpsTime(int(nxt.toc_week[sv]),
                                      float(nxt.toc_sec[sv])), grx)
            if dt < SECONDS_IN_HOUR:
                return ieph + 1
            break  # reference breaks after the first valid SV
    return ieph
