"""GPS LNAV navigation-message codec: subframe packing + (32,26) parity.

Bit-exact host-side equivalent of the reference's L3 codec:
  * eph_to_subframes — ICD-GPS-200 field quantization and 5-subframe
    packing, incl. the hardcoded leap-second schedule and the deliberate
    wn=0 placeholder stamped at transmit time (plutogpssim.c:552-723).
  * compute_checksum — Hamming (32,26) parity with D30 inversion and the
    non-information-bearing-bit solve for words 2 and 10 (c:729-814).
  * generate_nav_msg — 30 s frame scheduler producing dwrd[60] with the
    previous subframe-5 in slot 0 (c:1820-1894).

These run at channel allocation + every 30 s per channel — O(60 words),
so plain Python ints are the right tool; the device only ever consumes
the resulting uint32 dwrd tables.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..constants import (
    N_DWRD,
    N_DWRD_SBF,
    N_SBF,
    PI,
    POW2_M5,
    POW2_M19,
    POW2_M24,
    POW2_M27,
    POW2_M29,
    POW2_M30,
    POW2_M31,
    POW2_M33,
    POW2_M43,
    POW2_M50,
    POW2_M55,
)
from ..types import IonoUtc
from .gpstime import GpsTime

__all__ = ["eph_to_subframes", "compute_checksum", "generate_nav_msg"]

_PARITY_MASKS = (
    0x3B1F3480, 0x1D8F9A40, 0x2EC7CD00,
    0x1763E680, 0x2BB1F340, 0x0B7A89C0,
)


def _c_round(x: float) -> int:
    """C round(): half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0.0 else int(math.ceil(x - 0.5))


def _trunc(x: float) -> int:
    """C (long) cast: truncate toward zero."""
    return int(x)


def eph_to_subframes(eph, sv: int, ionoutc: IonoUtc) -> np.ndarray:
    """Pack one SV's ephemeris into sbf[5][10] raw 24-bit words
    (plutogpssim.c:552-723).

    `eph` is an SoA Ephemerides; `sv` selects the satellite (0-based).
    Parity bits are absent; wn is 0 here and injected at transmit time."""
    def f(name):
        return float(getattr(eph, name)[sv])

    def i(name):
        return int(getattr(eph, name)[sv])

    ura = 0
    data_id = 1
    sbf4_page25_sv_id = 63
    sbf5_page25_sv_id = 51
    sbf4_page18_sv_id = 56

    wn = 0  # transmission week stamped by generate_nav_msg (c:595-597)
    toe = _trunc(f("toe_sec") / 16.0)
    toc = _trunc(f("toc_sec") / 16.0)
    iode = i("iode")
    iodc = i("iodc")
    deltan = _trunc(f("deltan") / POW2_M43 / PI)
    cuc = _trunc(f("cuc") / POW2_M29)
    cus = _trunc(f("cus") / POW2_M29)
    cic = _trunc(f("cic") / POW2_M29)
    cis = _trunc(f("cis") / POW2_M29)
    crc = _trunc(f("crc") / POW2_M5)
    crs = _trunc(f("crs") / POW2_M5)
    ecc = _trunc(f("ecc") / POW2_M33)
    sqrta = _trunc(f("sqrta") / POW2_M19)
    m0 = _trunc(f("m0") / POW2_M31 / PI)
    omg0 = _trunc(f("omg0") / POW2_M31 / PI)
    inc0 = _trunc(f("inc0") / POW2_M31 / PI)
    aop = _trunc(f("aop") / POW2_M31 / PI)
    omgdot = _trunc(f("omgdot") / POW2_M43 / PI)
    idot = _trunc(f("idot") / POW2_M43 / PI)
    af0 = _trunc(f("af0") / POW2_M31)
    af1 = _trunc(f("af1") / POW2_M43)
    af2 = _trunc(f("af2") / POW2_M55)
    tgd = _trunc(f("tgd") / POW2_M31)
    svhlth = i("svhlth")
    code_l2 = i("codeL2")

    wna = int(eph.toe_week[sv]) % 256
    toa = _trunc(f("toe_sec") / 4096.0)

    alpha0 = _c_round(float(ionoutc.alpha0) / POW2_M30)
    alpha1 = _c_round(float(ionoutc.alpha1) / POW2_M27)
    alpha2 = _c_round(float(ionoutc.alpha2) / POW2_M24)
    alpha3 = _c_round(float(ionoutc.alpha3) / POW2_M24)
    beta0 = _c_round(float(ionoutc.beta0) / 2048.0)
    beta1 = _c_round(float(ionoutc.beta1) / 16384.0)
    beta2 = _c_round(float(ionoutc.beta2) / 65536.0)
    beta3 = _c_round(float(ionoutc.beta3) / 65536.0)
    a0_utc = _c_round(float(ionoutc.A0) / POW2_M30)
    a1_utc = _c_round(float(ionoutc.A1) / POW2_M50)
    dtls = int(ionoutc.dtls)
    tot = int(ionoutc.tot) // 4096
    wnt = int(ionoutc.wnt) % 256
    # Hardcoded scheduled-leap-second block, matching the reference
    # (c:641-645): 2016/12/31 -> WNlsf=1929, DN=7, dtlsf=18.
    wnlsf = 1929 % 256
    dn = 7
    dtlsf = 18

    tlm = 0x8B0000 << 6
    sbf = np.zeros((N_SBF, N_DWRD_SBF), dtype=np.uint32)

    def w(word: int) -> int:
        return word & 0xFFFFFFFF

    # Subframe 1 (clock)
    sbf[0][0] = w(tlm)
    sbf[0][1] = w(0x1 << 8)
    sbf[0][2] = w(((wn & 0x3FF) << 20) | ((code_l2 & 0x3) << 18)
                  | ((ura & 0xF) << 14) | ((svhlth & 0x3F) << 8)
                  | (((iodc >> 8) & 0x3) << 6))
    sbf[0][3] = 0
    sbf[0][4] = 0
    sbf[0][5] = 0
    sbf[0][6] = w((tgd & 0xFF) << 6)
    sbf[0][7] = w(((iodc & 0xFF) << 22) | ((toc & 0xFFFF) << 6))
    sbf[0][8] = w(((af2 & 0xFF) << 22) | ((af1 & 0xFFFF) << 6))
    sbf[0][9] = w((af0 & 0x3FFFFF) << 8)

    # Subframe 2 (ephemeris)
    sbf[1][0] = w(tlm)
    sbf[1][1] = w(0x2 << 8)
    sbf[1][2] = w(((iode & 0xFF) << 22) | ((crs & 0xFFFF) << 6))
    sbf[1][3] = w(((deltan & 0xFFFF) << 14) | (((m0 >> 24) & 0xFF) << 6))
    sbf[1][4] = w((m0 & 0xFFFFFF) << 6)
    sbf[1][5] = w(((cuc & 0xFFFF) << 14) | (((ecc >> 24) & 0xFF) << 6))
    sbf[1][6] = w((ecc & 0xFFFFFF) << 6)
    sbf[1][7] = w(((cus & 0xFFFF) << 14) | (((sqrta >> 24) & 0xFF) << 6))
    sbf[1][8] = w((sqrta & 0xFFFFFF) << 6)
    sbf[1][9] = w((toe & 0xFFFF) << 14)

    # Subframe 3 (ephemeris)
    sbf[2][0] = w(tlm)
    sbf[2][1] = w(0x3 << 8)
    sbf[2][2] = w(((cic & 0xFFFF) << 14) | (((omg0 >> 24) & 0xFF) << 6))
    sbf[2][3] = w((omg0 & 0xFFFFFF) << 6)
    sbf[2][4] = w(((cis & 0xFFFF) << 14) | (((inc0 >> 24) & 0xFF) << 6))
    sbf[2][5] = w((inc0 & 0xFFFFFF) << 6)
    sbf[2][6] = w(((crc & 0xFFFF) << 14) | (((aop >> 24) & 0xFF) << 6))
    sbf[2][7] = w((aop & 0xFFFFFF) << 6)
    sbf[2][8] = w((omgdot & 0xFFFFFF) << 6)
    sbf[2][9] = w(((iode & 0xFF) << 22) | ((idot & 0x3FFF) << 8))

    if bool(ionoutc.vflg):
        # Subframe 4, page 18 (iono/UTC)
        sbf[3][0] = w(tlm)
        sbf[3][1] = w(0x4 << 8)
        sbf[3][2] = w((data_id << 28) | (sbf4_page18_sv_id << 22)
                      | ((alpha0 & 0xFF) << 14) | ((alpha1 & 0xFF) << 6))
        sbf[3][3] = w(((alpha2 & 0xFF) << 22) | ((alpha3 & 0xFF) << 14)
                      | ((beta0 & 0xFF) << 6))
        sbf[3][4] = w(((beta1 & 0xFF) << 22) | ((beta2 & 0xFF) << 14)
                      | ((beta3 & 0xFF) << 6))
        sbf[3][5] = w((a1_utc & 0xFFFFFF) << 6)
        sbf[3][6] = w(((a0_utc >> 8) & 0xFFFFFF) << 6)
        sbf[3][7] = w(((a0_utc & 0xFF) << 22) | ((tot & 0xFF) << 14)
                      | ((wnt & 0xFF) << 6))
        sbf[3][8] = w(((dtls & 0xFF) << 22) | ((wnlsf & 0xFF) << 14)
                      | ((dn & 0xFF) << 6))
        sbf[3][9] = w((dtlsf & 0xFF) << 22)
    else:
        # Subframe 4, page 25
        sbf[3][0] = w(tlm)
        sbf[3][1] = w(0x4 << 8)
        sbf[3][2] = w((data_id << 28) | (sbf4_page25_sv_id << 22))

    # Subframe 5, page 25 (almanac stub)
    sbf[4][0] = w(tlm)
    sbf[4][1] = w(0x5 << 8)
    sbf[4][2] = w((data_id << 28) | (sbf5_page25_sv_id << 22)
                  | ((toa & 0xFF) << 14) | ((wna & 0xFF) << 6))

    return sbf


def compute_checksum(source: int, nib: bool) -> int:
    """GPS (32,26) word finalizer (plutogpssim.c:751-814).

    source bits 31..30 = D29*/D30* of previous word, 29..6 = data,
    5..0 = empty.  Returns the 30-bit transmitted word."""
    d = source & 0x3FFFFFC0
    d29 = (source >> 31) & 0x1
    d30 = (source >> 30) & 0x1

    if nib:
        # Solve data bits 23/24 so parity bits 29/30 come out zero
        if (d30 + (_PARITY_MASKS[4] & d).bit_count()) % 2:
            d ^= 0x1 << 6
        if (d29 + (_PARITY_MASKS[5] & d).bit_count()) % 2:
            d ^= 0x1 << 7

    word = d
    if d30:
        word ^= 0x3FFFFFC0

    word |= ((d29 + (_PARITY_MASKS[0] & d).bit_count()) % 2) << 5
    word |= ((d30 + (_PARITY_MASKS[1] & d).bit_count()) % 2) << 4
    word |= ((d29 + (_PARITY_MASKS[2] & d).bit_count()) % 2) << 3
    word |= ((d30 + (_PARITY_MASKS[3] & d).bit_count()) % 2) << 2
    word |= ((d30 + (_PARITY_MASKS[4] & d).bit_count()) % 2) << 1
    word |= (d29 + (_PARITY_MASKS[5] & d).bit_count()) % 2

    return word & 0x3FFFFFFF


def generate_nav_msg(g: GpsTime, sbf: np.ndarray, dwrd: np.ndarray,
                     init: bool) -> GpsTime:
    """Build/refresh the 60-word transmit buffer (plutogpssim.c:1820-1894).

    Mutates dwrd[60] in place; returns the new data-bit reference time g0
    (g aligned down-ish to the 30 s frame boundary, c:1828-1830)."""
    g0_sec = float(int(g.sec + 0.5) // 30) * 30.0
    g0 = GpsTime(g.week, g0_sec)

    wn = g0.week % 1024
    tow = int(g0_sec) // 6

    if init:
        prevwrd = 0
        for iwrd in range(N_DWRD_SBF):
            sbfwrd = int(sbf[4][iwrd])
            if iwrd == 1:
                sbfwrd |= (tow & 0x1FFFF) << 13
            sbfwrd |= (prevwrd << 30) & 0xC0000000
            nib = iwrd in (1, 9)
            dwrd[iwrd] = compute_checksum(sbfwrd, nib)
            prevwrd = int(dwrd[iwrd])
    else:
        for iwrd in range(N_DWRD_SBF):
            dwrd[iwrd] = dwrd[N_DWRD_SBF * N_SBF + iwrd]
            prevwrd = int(dwrd[iwrd])

    for isbf in range(N_SBF):
        tow += 1
        for iwrd in range(N_DWRD_SBF):
            sbfwrd = int(sbf[isbf][iwrd])
            if isbf == 0 and iwrd == 2:
                sbfwrd |= (wn & 0x3FF) << 20
            if iwrd == 1:
                sbfwrd |= (tow & 0x1FFFF) << 13
            sbfwrd |= (prevwrd << 30) & 0xC0000000
            nib = iwrd in (1, 9)
            dwrd[(isbf + 1) * N_DWRD_SBF + iwrd] = compute_checksum(sbfwrd, nib)
            prevwrd = int(dwrd[(isbf + 1) * N_DWRD_SBF + iwrd])

    return g0


