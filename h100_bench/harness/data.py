"""The cells' input files, made from the run's seed.

A frozen copy of the repository's synthetic fixture writers (an
almanac-like constellation written as a column-exact RINEX v2
navigation file, and a 10 Hz circular ECEF trajectory), changed only so
that the draws come from a numpy Generator and the file holds a whole
broadcast day: ``sets`` ephemeris sets ``set_gap_hours`` apart.  Kept
here so that the benchmark's data cannot change when the test fixtures
do.  Both the program and the reference parse the files written here.
"""

from __future__ import annotations

import math

import numpy as np

# the day the files describe: 2023/01/10 00:00:00 GPS time
DAY = dict(y=2023, m=1, d=10, hh=0, mm=0, sec=0.0)
GM_EARTH = 3.986005e14
WGS84_A = 6378137.0
WGS84_E = 0.0818191908426


def _fort(x: float, width: int = 19, prec: int = 12) -> str:
    """FORTRAN-style %19.12E with a 'D' exponent, as brdc files have."""
    s = f"{x: .{prec}E}"
    mant, exp = s.split("E")
    return f"{mant}D{int(exp):+03d}".rjust(width)


def date2gps(y, m, d, hh, mm, sec):
    """(GPS week, seconds of week) of a calendar date."""
    doy = (0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334)
    ye = y - 1980
    lpdays = ye // 4 + 1
    if ye % 4 == 0 and m <= 2:
        lpdays -= 1
    de = ye * 365 + doy[m - 1] + d + lpdays - 6
    return de // 7, float(de % 7) * 86400.0 + hh * 3600.0 + mm * 60.0 + sec


def constellation(n_sat: int, rng: np.random.Generator) -> list[dict]:
    """Almanac-like orbital elements for n_sat GPS satellites."""
    sats = []
    for i in range(n_sat):
        plane, slot = i % 6, i // 6
        sats.append(dict(
            prn=i + 1,
            af0=rng.uniform(-5e-4, 5e-4),
            af1=rng.uniform(-5e-12, 5e-12),
            af2=0.0,
            iode=10 + i,
            crs=rng.uniform(-100, 100),
            deltan=rng.uniform(3e-9, 6e-9),
            m0=(2 * math.pi * slot / 4.0 + 0.15 * plane) % (2 * math.pi)
            - math.pi,
            cuc=rng.uniform(-5e-6, 5e-6),
            ecc=rng.uniform(0.001, 0.02),
            cus=rng.uniform(-5e-6, 5e-6),
            sqrta=5153.7 + rng.uniform(-1.0, 1.0),
            cic=rng.uniform(-2e-7, 2e-7),
            omg0=(2 * math.pi * plane / 6.0) - math.pi,
            cis=rng.uniform(-2e-7, 2e-7),
            inc0=0.958 + rng.uniform(-0.02, 0.02),
            crc=rng.uniform(150, 300),
            aop=rng.uniform(-math.pi, math.pi),
            omgdot=rng.uniform(-8.3e-9, -7.7e-9),
            idot=rng.uniform(-1e-10, 1e-10),
            codeL2=1,
            svhlth=0,
            tgd=rng.uniform(-1e-8, 1e-8),
            iodc=10 + i,
        ))
    return sats


def propagate_set(s: dict, dt: float) -> dict:
    """Advance orbital elements by dt seconds, so that consecutive sets
    describe one continuous orbit, as real broadcast uploads do."""
    if dt == 0.0:
        return dict(s)
    a = s["sqrta"] ** 2
    n = math.sqrt(GM_EARTH / a**3) + s["deltan"]

    def wrap(x):
        return (x + math.pi) % (2.0 * math.pi) - math.pi

    out = dict(s)
    out["m0"] = wrap(s["m0"] + n * dt)
    out["omg0"] = wrap(s["omg0"] + s["omgdot"] * dt)
    out["inc0"] = s["inc0"] + s["idot"] * dt
    out["af0"] = s["af0"] + s["af1"] * dt + s["af2"] * dt * dt
    out["iode"] = s["iode"] + 1
    out["iodc"] = s["iodc"] + 1
    return out


def write_rinex2(path: str, rng: np.random.Generator, n_sets: int,
                 n_sat: int, set_gap_hours: float) -> None:
    """A RINEX 2.10 GPS navigation file of n_sets sets of n_sat
    satellites, set_gap_hours apart from DAY's midnight."""
    sats = constellation(n_sat, rng)
    week, tow0 = date2gps(**DAY)
    lines = []

    def hdr(content: str, tag: str) -> None:
        lines.append(f"{content:<60}{tag}")

    hdr(f"{2.10:9.2f}{'':11}{'N: GPS NAV DATA':<20}", "RINEX VERSION / TYPE")
    hdr(f"{'h100_bench':<20}{'bench':<20}{'20230110 000000 UTC':<20}",
        "PGM / RUN BY / DATE")
    hdr("  " + "".join(f"{v:12.4E}" for v in (
        1.1176e-08, 1.4901e-08, -5.9605e-08, -1.1921e-07)).replace("E", "D"),
        "ION ALPHA")
    hdr("  " + "".join(f"{v:12.4E}" for v in (
        9.0112e+04, 1.6384e+04, -1.9661e+05, -6.5536e+04)).replace("E", "D"),
        "ION BETA")
    hdr("   " + _fort(2.793967723846e-09) + _fort(8.881784197001e-16)
        + f"{331776:9d}{week:9d}", "DELTA-UTC: A0,A1,T,W")
    hdr(f"{18:6d}", "LEAP SECONDS")
    hdr("", "END OF HEADER")

    yy = DAY["y"] % 100
    for iset in range(n_sets):
        hh = DAY["hh"] + int(iset * set_gap_hours)
        for s0 in sats:
            s = propagate_set(s0, iset * set_gap_hours * 3600.0)
            toc_sec = tow0 + iset * set_gap_hours * 3600.0
            lines.append(
                f"{s['prn']:2d} {yy:02d} {DAY['m']:2d} {DAY['d']:2d} "
                f"{hh:2d} {DAY['mm']:2d} {DAY['sec']:4.1f}"
                + _fort(s["af0"]) + _fort(s["af1"]) + _fort(s["af2"]))
            orb = [
                (float(s["iode"]), s["crs"], s["deltan"], s["m0"]),
                (s["cuc"], s["ecc"], s["cus"], s["sqrta"]),
                (toc_sec, s["cic"], s["omg0"], s["cis"]),
                (s["inc0"], s["crc"], s["aop"], s["omgdot"]),
                (s["idot"], float(s["codeL2"]), float(week), 0.0),
                (2.0, float(s["svhlth"]), s["tgd"], float(s["iodc"])),
                (toc_sec, 4.0, 0.0, 0.0),
            ]
            for row in orb:
                lines.append("   " + "".join(_fort(v) for v in row))
    with open(path, "wt") as fp:
        fp.write("\n".join(lines) + "\n")


def llh_to_ecef(lat_deg: float, lon_deg: float, h: float) -> np.ndarray:
    """WGS-84 geodetic -> ECEF metres."""
    lat, lon = math.radians(lat_deg), math.radians(lon_deg)
    nrad = WGS84_A / math.sqrt(1 - (WGS84_E * math.sin(lat)) ** 2)
    return np.array([(nrad + h) * math.cos(lat) * math.cos(lon),
                     (nrad + h) * math.cos(lat) * math.sin(lon),
                     ((1 - WGS84_E ** 2) * nrad + h) * math.sin(lat)])


def write_circle_motion(path: str, n: int, center_llh, radius_m: float,
                        period_s: float) -> None:
    """n rows of a 10 Hz circular trajectory around center_llh, as the
    t,x,y,z ECEF CSV that the -u option reads."""
    lat = math.radians(center_llh[0])
    lon = math.radians(center_llh[1])
    cx, cy, cz = llh_to_ecef(*center_llh)
    east = (-math.sin(lon), math.cos(lon), 0.0)
    north = (-math.sin(lat) * math.cos(lon), -math.sin(lat) * math.sin(lon),
             math.cos(lat))
    with open(path, "wt") as fp:
        for i in range(n):
            t = i * 0.1
            ang = 2 * math.pi * t / period_s
            de = radius_m * math.cos(ang)
            dn = radius_m * math.sin(ang)
            x = cx + de * east[0] + dn * north[0]
            y = cy + de * east[1] + dn * north[1]
            z = cz + de * east[2] + dn * north[2]
            fp.write(f"{t:.1f},{x:.3f},{y:.3f},{z:.3f}\n")
