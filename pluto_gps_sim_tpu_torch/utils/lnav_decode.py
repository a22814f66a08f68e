"""GPS LNAV decoder: parity check, subframe field extraction, ephemeris
reconstruction.

A copy of the JAX package's ``utils/lnav_decode.py:1-250`` (plain host
Python).

Receiver-side inverse of `models/lnav.py` (which mirrors the reference
encoder, plutogpssim.c:552-814): given the 30-bit words a tracking loop
demodulated, verify the (32,26) Hamming parity, undo the D30 data
inversion, and unpack ICD-GPS-200 fields back to physical units.  Used
by `utils/receiver.py` to prove the synthesized stream carries a
navigation message a real receiver could use — the software stand-in
for the reference's only validation method (feeding RF to a GPS
receiver and checking it decodes / fixes).

Everything here is plain host Python on ints, like the encoder: the
data rate is 50 bit/s, so O(words) cost is irrelevant.

Decoding conventions (ICD-GPS-200C §20.3.3):
  * a transmitted word is 30 bits: 24 data bits (XORed with the previous
    word's D30*) + 6 parity bits computed over the UNinverted data;
  * two's-complement fields are explicitly sign-extended here; unsigned
    fields (ecc, sqrta, toe, toc, tow) are taken raw;
  * subframe 1 wn is the 10-bit transmission week (mod 1024): callers
    resolve the 1024-week ambiguity against a reference week.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import (
    GM_EARTH,
    OMEGA_EARTH,
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

__all__ = ["PREAMBLE", "parity_check", "decode_how", "decode_frame",
           "build_ephemerides", "build_ionoutc"]

PREAMBLE = 0x8B  # TLM word bits 1..8 (10001011)

# The six ICD parity equations as data-bit masks over source-word layout
# (bits 29..6 = d1..d24), identical data to models/lnav.py — these ARE
# the ICD-200 table 20-XIV equations, shared constants, not shared code.
_PARITY_MASKS = (
    0x3B1F3480, 0x1D8F9A40, 0x2EC7CD00,
    0x1763E680, 0x2BB1F340, 0x0B7A89C0,
)
# Which of D29*/D30* seeds each parity bit (ICD: D25..D30)
_PARITY_SEED_IS_D29 = (True, False, True, False, False, True)


def _s(value: int, bits: int) -> int:
    """Two's-complement sign extension of a `bits`-wide field."""
    return value - (1 << bits) if value & (1 << (bits - 1)) else value


def parity_check(word: int, prev_word: int) -> tuple[bool, int]:
    """Verify one received 30-bit word against its parity.

    `word`: the transmitted word (bits 29..6 data as broadcast — i.e.
    already XOR-inverted by the encoder if D30* was set); `prev_word`:
    the PREVIOUS transmitted 30-bit word, whose two trailing parity
    bits D29*/D30* (bits 1/0) seed this word's equations.  Returns
    (parity_ok, data24) where data24 is the de-inverted 24-bit payload.
    """
    d29s = (prev_word >> 1) & 1
    d30s = prev_word & 1
    data_inv = (word >> 6) & 0xFFFFFF
    data24 = data_inv ^ 0xFFFFFF if d30s else data_inv
    d = (data24 << 6) & 0x3FFFFFC0
    for k, (mask, seed29) in enumerate(zip(_PARITY_MASKS,
                                           _PARITY_SEED_IS_D29)):
        seed = d29s if seed29 else d30s
        expect = (seed + (mask & d).bit_count()) % 2
        if ((word >> (5 - k)) & 1) != expect:
            return False, data24
    return True, data24


def decode_how(data24: int) -> tuple[int, int]:
    """HOW payload -> (tow_count, subframe_id).

    tow_count is the 17-bit Z-count of the NEXT subframe boundary; the
    current subframe's first bit was transmitted at (tow_count-1)*6 s.
    """
    tow = (data24 >> 7) & 0x1FFFF
    sbf_id = (data24 >> 2) & 0x7
    return tow, sbf_id


def _decode_sf1(d: list[int]) -> dict:
    wn = (d[2] >> 14) & 0x3FF
    code_l2 = (d[2] >> 12) & 0x3
    ura = (d[2] >> 8) & 0xF
    svhlth = (d[2] >> 2) & 0x3F
    iodc = ((d[2] & 0x3) << 8) | ((d[7] >> 16) & 0xFF)
    tgd = _s(d[6] & 0xFF, 8) * POW2_M31
    toc = (d[7] & 0xFFFF) * 16.0
    af2 = _s((d[8] >> 16) & 0xFF, 8) * POW2_M55
    af1 = _s(d[8] & 0xFFFF, 16) * POW2_M43
    af0 = _s((d[9] >> 2) & 0x3FFFFF, 22) * POW2_M31
    return {"wn": wn, "codeL2": code_l2, "ura": ura, "svhlth": svhlth,
            "iodc": iodc, "tgd": tgd, "toc_sec": toc,
            "af2": af2, "af1": af1, "af0": af0}


def _decode_sf2(d: list[int]) -> dict:
    iode = (d[2] >> 16) & 0xFF
    crs = _s(d[2] & 0xFFFF, 16) * POW2_M5
    deltan = _s((d[3] >> 8) & 0xFFFF, 16) * POW2_M43 * PI
    m0 = _s(((d[3] & 0xFF) << 24) | d[4], 32) * POW2_M31 * PI
    cuc = _s((d[5] >> 8) & 0xFFFF, 16) * POW2_M29
    ecc = (((d[5] & 0xFF) << 24) | d[6]) * POW2_M33
    cus = _s((d[7] >> 8) & 0xFFFF, 16) * POW2_M29
    sqrta = (((d[7] & 0xFF) << 24) | d[8]) * POW2_M19
    toe = ((d[9] >> 8) & 0xFFFF) * 16.0
    return {"iode": iode, "crs": crs, "deltan": deltan, "m0": m0,
            "cuc": cuc, "ecc": ecc, "cus": cus, "sqrta": sqrta,
            "toe_sec": toe}


def _decode_sf3(d: list[int]) -> dict:
    cic = _s((d[2] >> 8) & 0xFFFF, 16) * POW2_M29
    omg0 = _s(((d[2] & 0xFF) << 24) | d[3], 32) * POW2_M31 * PI
    cis = _s((d[4] >> 8) & 0xFFFF, 16) * POW2_M29
    inc0 = _s(((d[4] & 0xFF) << 24) | d[5], 32) * POW2_M31 * PI
    crc = _s((d[6] >> 8) & 0xFFFF, 16) * POW2_M5
    aop = _s(((d[6] & 0xFF) << 24) | d[7], 32) * POW2_M31 * PI
    omgdot = _s(d[8], 24) * POW2_M43 * PI
    iode = (d[9] >> 16) & 0xFF
    idot = _s((d[9] >> 2) & 0x3FFF, 14) * POW2_M43 * PI
    return {"cic": cic, "omg0": omg0, "cis": cis, "inc0": inc0,
            "crc": crc, "aop": aop, "omgdot": omgdot,
            "iode_sf3": iode, "idot": idot}


def _decode_sf4(d: list[int]) -> dict:
    """Subframe 4: page 18 (iono/UTC) if that's what was broadcast."""
    sv_id = (d[2] >> 16) & 0x3F
    if sv_id != 56:          # not page 18 — e.g. the vflg=0 page-25 stub
        return {"sf4_page": sv_id}
    return {
        "sf4_page": sv_id,
        "alpha0": _s((d[2] >> 8) & 0xFF, 8) * POW2_M30,
        "alpha1": _s(d[2] & 0xFF, 8) * POW2_M27,
        "alpha2": _s((d[3] >> 16) & 0xFF, 8) * POW2_M24,
        "alpha3": _s((d[3] >> 8) & 0xFF, 8) * POW2_M24,
        "beta0": _s(d[3] & 0xFF, 8) * 2048.0,
        "beta1": _s((d[4] >> 16) & 0xFF, 8) * 16384.0,
        "beta2": _s((d[4] >> 8) & 0xFF, 8) * 65536.0,
        "beta3": _s(d[4] & 0xFF, 8) * 65536.0,
        "A1": _s(d[5] & 0xFFFFFF, 24) * POW2_M50,
        "A0": _s((d[6] << 8) | ((d[7] >> 16) & 0xFF), 32) * POW2_M30,
        "tot": ((d[7] >> 8) & 0xFF) * 4096,
        "wnt": d[7] & 0xFF,
        "dtls": _s((d[8] >> 16) & 0xFF, 8),
        "wnlsf": (d[8] >> 8) & 0xFF,
        "dn": d[8] & 0xFF,
        "dtlsf": _s((d[9] >> 16) & 0xFF, 8),
    }


_SF_DECODERS = {1: _decode_sf1, 2: _decode_sf2, 3: _decode_sf3,
                4: _decode_sf4}


def decode_frame(subframes: dict[int, list[int]]) -> dict:
    """Merge decoded fields from {subframe_id: [10 x data24]}.

    Needs at least {1,2,3}; subframe 4 adds iono/UTC when it carries
    page 18.  Raises on an IODE/IODC mismatch (a real receiver would
    refuse to combine subframes from different ephemeris uploads).
    """
    out: dict = {}
    for sid, words in subframes.items():
        dec = _SF_DECODERS.get(sid)
        if dec is not None:
            out.update(dec(words))
    if {"iodc", "iode", "iode_sf3"} <= out.keys():
        if out["iode"] != out["iode_sf3"] or \
                out["iode"] != (out["iodc"] & 0xFF):
            raise ValueError(
                f"IODE/IODC mismatch across subframes: "
                f"SF2 {out['iode']}, SF3 {out['iode_sf3']}, "
                f"IODC {out['iodc']}")
    return out


def build_ephemerides(decoded: dict, sv: int, ref_week: int,
                      eph_factory=None):
    """Decoded-field dict -> a 32-slot `Ephemerides` usable by satpos.

    `sv` is the 0-based PRN slot to populate; `ref_week` resolves the
    10-bit broadcast week (mod 1024) to a full GPS week.  All other
    slots stay vflg=False/zero.  Pass several (decoded, sv) pairs
    through repeatedly via `eph_factory=existing` to accumulate SVs.
    """
    from ..types import empty_ephemerides

    eph = empty_ephemerides(1)[0] if eph_factory is None else eph_factory

    # nearest full week congruent to the broadcast wn mod 1024
    k = round((ref_week - decoded["wn"]) / 1024.0)
    week = decoded["wn"] + 1024 * k

    eph.vflg[sv] = True
    eph.toc_week[sv] = week
    eph.toe_week[sv] = week
    for f in ("toc_sec", "toe_sec", "deltan", "cuc", "cus", "cic", "cis",
              "crc", "crs", "ecc", "sqrta", "m0", "omg0", "inc0", "aop",
              "omgdot", "idot", "af0", "af1", "af2", "tgd"):
        getattr(eph, f)[sv] = decoded[f]
    eph.iodc[sv] = decoded["iodc"]
    eph.iode[sv] = decoded["iode"]
    eph.svhlth[sv] = decoded["svhlth"]
    eph.codeL2[sv] = decoded["codeL2"]

    a = decoded["sqrta"] ** 2
    eph.A[sv] = a
    eph.n[sv] = math.sqrt(GM_EARTH / (a * a * a)) + decoded["deltan"]
    eph.sq1e2[sv] = math.sqrt(1.0 - decoded["ecc"] ** 2)
    eph.omgkdot[sv] = decoded["omgdot"] - OMEGA_EARTH
    return eph


def build_ionoutc(decoded: dict):
    """Decoded subframe-4 page-18 fields -> an `IonoUtc` for the
    Klobuchar model (`models.orbits.ionospheric_delay`)."""
    from ..types import IonoUtc

    if decoded.get("sf4_page") != 56:
        return IonoUtc()          # vflg stays False: model falls back
    kw = {f: np.array(decoded[f]) for f in
          ("alpha0", "alpha1", "alpha2", "alpha3",
           "beta0", "beta1", "beta2", "beta3", "A0", "A1")}
    kw.update({f: np.array(decoded[f], np.int32) for f in
               ("dtls", "tot", "wnt", "dtlsf", "dn", "wnlsf")})
    return IonoUtc(enable=np.array(True), vflg=np.array(True), **kw)
