"""Optional FTP fetch of near-real-time RINEX navigation files.

A copy of the JAX package's ``ingest/fetch.py:1-52``.

Equivalent of the reference's libcurl fetch (plutogpssim.c:2428-2474):
pulls the previous hour's hourly brdc file from the BKG IGS server for a
catalog station, RINEX v2 (station ffmj) or v3 (station func) by default.
Uses stdlib ftplib/urllib — no native dependency.  Network access is
optional; everything else in the framework works from local files.
"""

from __future__ import annotations

import time
import urllib.request

from .stations import STATIONS_V2, STATIONS_V3

__all__ = ["compose_rinex_url", "fetch_rinex"]

RINEX_FTP_URL = "ftp://igs.bkg.bund.de/IGS/"
RINEX2_SUBFOLDER = "nrt"
RINEX3_SUBFOLDER = "nrt_v3"


def compose_rinex_url(use_rinex3: bool = False, now: float | None = None,
                      base_url: str | None = None) -> str:
    """Compose the hourly NRT URL exactly like the reference (c:2444-2445).

    Uses the previous UTC hour because the current hour is still being
    accumulated (c:2434-2437).  base_url overrides the IGS server root
    (tests point it at a local fake FTP server)."""
    tm = time.gmtime(time.time() if now is None else now)
    hour = tm.tm_hour - 1
    if hour < 0:
        hour = 23
    station = STATIONS_V3[0].id_v2 if use_rinex3 else STATIONS_V2[14].id_v2
    sub = RINEX3_SUBFOLDER if use_rinex3 else RINEX2_SUBFOLDER
    doy = tm.tm_yday
    yy = tm.tm_year % 100
    root = RINEX_FTP_URL if base_url is None else base_url
    return (f"{root}{sub}/{doy:03d}/{hour:02d}/"
            f"{station}{doy:03d}{chr(ord('a') + hour)}.{yy:02d}n.gz")


def fetch_rinex(dest_path: str, use_rinex3: bool = False,
                timeout: float = 30.0, base_url: str | None = None) -> str:
    """Download the current NRT RINEX file to dest_path; returns the URL."""
    url = compose_rinex_url(use_rinex3, base_url=base_url)
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        data = resp.read()
    with open(dest_path, "wb") as fp:
        fp.write(data)
    return url
