"""RINEX v2/v3 GPS broadcast-navigation parsers.

Host-side ingest with column-exact parity with the reference parsers
(readRinex2 plutogpssim.c:874-1233, readRinex3 c:1241-1610):

  * transparently reads gzip or plain text (the reference uses gzopen,
    which does the same);
  * FORTRAN 'D' exponents fixed up before float conversion
    (replaceExpDesignator c:821-836);
  * C atof/atoi semantics (parse leading prefix, 0 on failure);
  * records grouped into a new ephemeris set when the time-of-clock gap
    exceeds one hour (c:1048-1054), max 13 sets x 32 SVs;
  * v2 epoch-seconds quirk preserved: the reference copies 4 chars but
    NUL-terminates at index 2, so only 2 digits are ever parsed (c:1036-1038);
  * svhlth MSB fix-up (c:1200-1201) and derived working variables
    A, n, sq1e2, omgkdot (c:1221-1224).

Outputs the SoA Ephemerides list + IonoUtc consumed by the JAX layers.
"""

from __future__ import annotations

import gzip
import math
import re

import numpy as np

from ..constants import (
    EPHEM_ARRAY_SIZE,
    GM_EARTH,
    MAX_SAT,
    OMEGA_EARTH,
    SECONDS_IN_HOUR,
)
from ..models.gpstime import DateTime, GpsTime, date2gps, sub_gps_time
from ..types import Ephemerides, IonoUtc, empty_ephemerides

__all__ = ["read_rinex2", "read_rinex3", "RinexResult", "RinexError"]


class RinexError(Exception):
    pass


_FLOAT_RE = re.compile(r"^\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")
_INT_RE = re.compile(r"^\s*[+-]?\d+")


def _atof(s: str) -> float:
    """C atof(): parse a leading float prefix, 0.0 if none."""
    m = _FLOAT_RE.match(s)
    return float(m.group(0)) if m else 0.0


def _atoi(s: str) -> int:
    m = _INT_RE.match(s)
    return int(m.group(0)) if m else 0


def _fortran_float(s: str) -> float:
    """replaceExpDesignator + atof (c:821-836)."""
    return _atof(s.replace("D", "E").replace("d", "E"))


def _open_lines(fname: str) -> list[str]:
    try:
        with gzip.open(fname, "rt", errors="replace") as fp:
            return fp.read().splitlines()
    except (gzip.BadGzipFile, OSError):
        with open(fname, "rt", errors="replace") as fp:
            return fp.read().splitlines()


class RinexResult:
    def __init__(self, eph: list[Ephemerides], ionoutc: IonoUtc,
                 n_sets: int, rinex_date: str):
        self.eph = eph            # list[EPHEM_ARRAY_SIZE] of Ephemerides SoA
        self.ionoutc = ionoutc
        self.n_sets = n_sets
        self.rinex_date = rinex_date
        # per-set per-sv calendar datetime (host bookkeeping, eph_t.t)
        self.t: list[list[DateTime | None]] = [
            [None] * MAX_SAT for _ in range(EPHEM_ARRAY_SIZE)]


def _finalize_sv(eph: Ephemerides, sv: int) -> None:
    """Derived working variables (c:1221-1224)."""
    A = eph.sqrta[sv] * eph.sqrta[sv]
    eph.A[sv] = A
    eph.n[sv] = math.sqrt(GM_EARTH / (A * A * A)) + eph.deltan[sv]
    eph.sq1e2[sv] = math.sqrt(1.0 - eph.ecc[sv] * eph.ecc[sv])
    eph.omgkdot[sv] = eph.omgdot[sv] - OMEGA_EARTH
    eph.vflg[sv] = True
    if 0 < eph.svhlth[sv] < 32:
        eph.svhlth[sv] += 32  # set MSB (c:1200-1201)


def _parse_header_v2(lines: list[str], ionoutc: IonoUtc) -> tuple[int, str]:
    flags = 0
    rinex_date = ""
    idx = 0
    saw_version = saw_end = False
    for idx, line in enumerate(lines):
        tag = line[60:]
        if tag.startswith("COMMENT"):
            continue
        if tag.startswith("END OF HEADER"):
            saw_end = True
            break
        if tag.startswith("RINEX VERSION / TYPE"):
            saw_version = True
            ver = _fortran_float(line[0:9])
            if ver > 3.0:
                raise RinexError("not a RINEX v2 file")
            if len(line) <= 20 or line[20] != "N":
                raise RinexError("not a navigation file")
        elif tag.startswith("PGM / RUN BY / DATE"):
            rinex_date = line[40:60]
        elif tag.startswith("ION ALPHA"):
            ionoutc.alpha0 = np.array(_fortran_float(line[2:14]))
            ionoutc.alpha1 = np.array(_fortran_float(line[14:26]))
            ionoutc.alpha2 = np.array(_fortran_float(line[26:38]))
            ionoutc.alpha3 = np.array(_fortran_float(line[38:50]))
            flags |= 0x1
        elif tag.startswith("ION BETA"):
            ionoutc.beta0 = np.array(_fortran_float(line[2:14]))
            ionoutc.beta1 = np.array(_fortran_float(line[14:26]))
            ionoutc.beta2 = np.array(_fortran_float(line[26:38]))
            ionoutc.beta3 = np.array(_fortran_float(line[38:50]))
            flags |= 0x2
        elif tag.startswith("DELTA-UTC"):
            ionoutc.A0 = np.array(_fortran_float(line[3:22]))
            ionoutc.A1 = np.array(_fortran_float(line[22:41]))
            ionoutc.tot = np.array(_atoi(line[41:50]), np.int32)
            ionoutc.wnt = np.array(_atoi(line[50:59]), np.int32)
            if int(ionoutc.tot) % 4096 == 0:
                flags |= 0x4
        elif tag.startswith("LEAP SECONDS"):
            ionoutc.dtls = np.array(_atoi(line[0:6]), np.int32)
            flags |= 0x8
    if not (saw_version and saw_end):
        raise RinexError("not a RINEX v2 file (missing version line or "
                         "END OF HEADER)")
    return flags, rinex_date, idx + 1


def _parse_header_v3(lines: list[str], ionoutc: IonoUtc) -> tuple[int, str]:
    flags = 0
    rinex_date = ""
    idx = 0
    saw_version = saw_end = False
    for idx, line in enumerate(lines):
        tag = line[60:]
        if tag.startswith("COMMENT"):
            continue
        if tag.startswith("END OF HEADER"):
            saw_end = True
            break
        if tag.startswith("RINEX VERSION / TYPE"):
            saw_version = True
            ver = _fortran_float(line[0:9])
            if ver < 3.0:
                raise RinexError("not a RINEX v3 file")
            # reference checks str[20]!='N' && str[40]!='G' (c:1284)
            if (len(line) <= 20 or line[20] != "N") and \
               (len(line) <= 40 or line[40] != "G"):
                raise RinexError("not a navigation file")
        elif tag.startswith("PGM / RUN BY / DATE"):
            rinex_date = line[40:60]
        elif tag.startswith("IONOSPHERIC CORR"):
            if line.startswith("GPSA"):
                ionoutc.alpha0 = np.array(_fortran_float(line[5:17]))
                ionoutc.alpha1 = np.array(_fortran_float(line[17:29]))
                ionoutc.alpha2 = np.array(_fortran_float(line[29:41]))
                ionoutc.alpha3 = np.array(_fortran_float(line[41:53]))
                flags |= 0x1
            elif line.startswith("GPSB"):
                ionoutc.beta0 = np.array(_fortran_float(line[5:17]))
                ionoutc.beta1 = np.array(_fortran_float(line[17:29]))
                ionoutc.beta2 = np.array(_fortran_float(line[29:41]))
                ionoutc.beta3 = np.array(_fortran_float(line[41:53]))
                flags |= 0x2
        elif tag.startswith("TIME SYSTEM CORR") and line.startswith("GPUT"):
            ionoutc.A0 = np.array(_fortran_float(line[5:22]))
            ionoutc.A1 = np.array(_fortran_float(line[22:38]))
            ionoutc.tot = np.array(_atoi(line[38:45]), np.int32)
            ionoutc.wnt = np.array(_atoi(line[45:51]), np.int32)
            if int(ionoutc.tot) % 4096 == 0:
                flags |= 0x4
        elif tag.startswith("LEAP SECONDS"):
            ionoutc.dtls = np.array(_atoi(line[0:6]), np.int32)
            flags |= 0x8
    if not (saw_version and saw_end):
        raise RinexError("not a RINEX v3 file (missing version line or "
                         "END OF HEADER)")
    return flags, rinex_date, idx + 1


# (field name, line offset within record, column start) per RINEX version.
# Record layout: line 0 = epoch/clock, lines 1..6 = BROADCAST ORBIT 1-6,
# line 7 = BROADCAST ORBIT 7 (consumed, unused).
def _orbit_fields(col0: int) -> list[tuple[str, int, int]]:
    c1, c2, c3 = col0, col0 + 19, col0 + 38
    return [
        ("iode", 1, c1), ("crs", 1, c2), ("deltan", 1, c3), ("m0", 1, c3 + 19),
        ("cuc", 2, c1), ("ecc", 2, c2), ("cus", 2, c3), ("sqrta", 2, c3 + 19),
        ("toe_sec", 3, c1), ("cic", 3, c2), ("omg0", 3, c3), ("cis", 3, c3 + 19),
        ("inc0", 4, c1), ("crc", 4, c2), ("aop", 4, c3), ("omgdot", 4, c3 + 19),
        ("idot", 5, c1), ("codeL2", 5, c2), ("toe_week", 5, c3),
        ("svhlth", 6, c2), ("tgd", 6, c3), ("iodc", 6, c3 + 19),
    ]


_INT_FIELDS = {"iode", "codeL2", "toe_week", "svhlth", "iodc"}


def _read_rinex(fname: str, version: int) -> RinexResult:
    lines = _open_lines(fname)
    ionoutc = IonoUtc()
    eph = empty_ephemerides(EPHEM_ARRAY_SIZE)
    result = RinexResult(eph, ionoutc, 0, "")

    if version == 2:
        flags, rinex_date, body_start = _parse_header_v2(lines, ionoutc)
        fields = _orbit_fields(3)
    else:
        flags, rinex_date, body_start = _parse_header_v3(lines, ionoutc)
        fields = _orbit_fields(4)

    ionoutc.vflg = np.array(flags == 0xF)
    result.rinex_date = rinex_date

    g0: GpsTime | None = None
    ieph = 0
    li = body_start
    while li < len(lines):
        line = lines[li]
        if version == 3:
            if not line.startswith("G"):
                li += 1
                continue
            sv = _atoi(line[1:3]) - 1
            t = DateTime(
                y=_atoi(line[4:8]), m=_atoi(line[9:11]), d=_atoi(line[12:14]),
                hh=_atoi(line[15:17]), mm=_atoi(line[18:20]),
                sec=float(_atoi(line[21:23])))
            clk_cols = (23, 42, 61)
        else:
            sv = _atoi(line[0:2]) - 1
            t = DateTime(
                y=_atoi(line[3:5]) + 2000, m=_atoi(line[6:8]), d=_atoi(line[9:11]),
                hh=_atoi(line[12:14]), mm=_atoi(line[15:17]),
                # reference quirk: only 2 chars of the seconds field (c:1036-1038)
                sec=_atof(line[18:20]))
            clk_cols = (22, 41, 60)

        if li + 7 >= len(lines):
            break  # incomplete trailing record, like the reference's EOF breaks
        record = lines[li:li + 8]
        li += 8

        if not 0 <= sv < MAX_SAT:
            continue

        g = date2gps(t)
        if g0 is None:
            g0 = g
        if sub_gps_time(g, g0) > SECONDS_IN_HOUR:
            g0 = g
            ieph += 1
            if ieph >= EPHEM_ARRAY_SIZE:
                break

        e = eph[ieph]
        result.t[ieph][sv] = t
        e.toc_week[sv] = g.week
        e.toc_sec[sv] = g.sec
        e.af0[sv] = _fortran_float(record[0][clk_cols[0]:clk_cols[0] + 19])
        e.af1[sv] = _fortran_float(record[0][clk_cols[1]:clk_cols[1] + 19])
        e.af2[sv] = _fortran_float(record[0][clk_cols[2]:clk_cols[2] + 19])

        for name, lineno, col in fields:
            val = _fortran_float(record[lineno][col:col + 19])
            getattr(e, name)[sv] = int(val) if name in _INT_FIELDS else val
        _finalize_sv(e, sv)

    # ieph may equal EPHEM_ARRAY_SIZE when the file holds more groups
    # than the 13-set capacity (the loop breaks mid-record); clamp so
    # n_sets always indexes the eph list validly, like the reference's
    # fixed eph[13][32] array
    n_sets = min(ieph, EPHEM_ARRAY_SIZE - 1) + 1 if g0 is not None else 0
    result.n_sets = n_sets
    return result


def read_rinex2(fname: str) -> RinexResult:
    return _read_rinex(fname, 2)


def read_rinex3(fname: str) -> RinexResult:
    return _read_rinex(fname, 3)
