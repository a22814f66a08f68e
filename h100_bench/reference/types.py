"""Core data types as plain dataclasses (structure-of-arrays).

The reference's per-satellite structs (ephem_t plutogpssim.h:97-130,
ionoutc_t h:132-140, range_t h:142-149, channel_t h:151-174) become SoA
dataclasses: every numeric field is an array with a leading [MAX_SAT] or
[MAX_CHAN] axis so satellite math vmaps/shards cleanly and channel slots
keep static shapes for jit (rise/set handled by masks, not reshapes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from .constants import MAX_CHAN, MAX_SAT

__all__ = ["Ephemerides", "IonoUtc", "EpochParams", "empty_ephemerides"]


@dataclass
class Ephemerides:
    """One set of broadcast ephemerides, SoA over [MAX_SAT] (ephem_t h:97)."""

    vflg: np.ndarray      # bool [32]
    toc_week: np.ndarray  # int32 [32]
    toc_sec: np.ndarray   # f64 [32]
    toe_week: np.ndarray
    toe_sec: np.ndarray
    iodc: np.ndarray      # int32
    iode: np.ndarray
    deltan: np.ndarray    # f64 radians/s
    cuc: np.ndarray
    cus: np.ndarray
    cic: np.ndarray
    cis: np.ndarray
    crc: np.ndarray
    crs: np.ndarray
    ecc: np.ndarray
    sqrta: np.ndarray
    m0: np.ndarray
    omg0: np.ndarray
    inc0: np.ndarray
    aop: np.ndarray
    omgdot: np.ndarray
    idot: np.ndarray
    af0: np.ndarray
    af1: np.ndarray
    af2: np.ndarray
    tgd: np.ndarray
    svhlth: np.ndarray    # int32
    codeL2: np.ndarray    # int32
    # Derived working variables (plutogpssim.c:1221-1224)
    A: np.ndarray
    n: np.ndarray
    sq1e2: np.ndarray
    omgkdot: np.ndarray


@dataclass
class IonoUtc:
    """Klobuchar + UTC parameters (ionoutc_t h:132-140)."""

    enable: np.ndarray = field(default_factory=lambda: np.array(True))
    vflg: np.ndarray = field(default_factory=lambda: np.array(False))
    alpha0: np.ndarray = field(default_factory=lambda: np.array(0.0))
    alpha1: np.ndarray = field(default_factory=lambda: np.array(0.0))
    alpha2: np.ndarray = field(default_factory=lambda: np.array(0.0))
    alpha3: np.ndarray = field(default_factory=lambda: np.array(0.0))
    beta0: np.ndarray = field(default_factory=lambda: np.array(0.0))
    beta1: np.ndarray = field(default_factory=lambda: np.array(0.0))
    beta2: np.ndarray = field(default_factory=lambda: np.array(0.0))
    beta3: np.ndarray = field(default_factory=lambda: np.array(0.0))
    A0: np.ndarray = field(default_factory=lambda: np.array(0.0))
    A1: np.ndarray = field(default_factory=lambda: np.array(0.0))
    dtls: np.ndarray = field(default_factory=lambda: np.array(0, np.int32))
    tot: np.ndarray = field(default_factory=lambda: np.array(0, np.int32))
    wnt: np.ndarray = field(default_factory=lambda: np.array(0, np.int32))
    dtlsf: np.ndarray = field(default_factory=lambda: np.array(0, np.int32))
    dn: np.ndarray = field(default_factory=lambda: np.array(0, np.int32))
    wnlsf: np.ndarray = field(default_factory=lambda: np.array(0, np.int32))


@dataclass
class EpochParams:
    """Per-(block, channel) sample-synthesis parameters.

    Produced by the 10 Hz epoch solve, consumed by the sample kernel.
    All arrays have shape [n_blocks, MAX_CHAN] unless noted.  Equivalent to
    the reference's channel_t scalars refreshed at c:2656-2687."""

    active: np.ndarray       # bool — channel allocated for this block
    f_carr: np.ndarray       # f64 carrier Doppler [Hz]
    f_code: np.ndarray       # f64 code frequency [Hz]
    code_phase: np.ndarray   # f64 chips in [0, 1023)
    icode: np.ndarray        # int32 code period within bit [0,20)
    ibit: np.ndarray         # int32 bit within word [0,30)
    iword: np.ndarray        # int32 word index into dwrd[60]
    carr_phase: np.ndarray   # f64 carrier phase at block start, cycles [0,1)
    gain: np.ndarray         # f64 path_loss * antenna gain


def empty_ephemerides(n_sets: int = 1) -> list[Ephemerides]:
    """Allocate n_sets invalid ephemeris sets (all vflg=False)."""
    out = []
    for _ in range(n_sets):
        kw = {}
        for f in dataclasses.fields(Ephemerides):
            if f.name == "vflg":
                kw[f.name] = np.zeros(MAX_SAT, dtype=bool)
            elif f.name in ("toc_week", "toe_week", "iodc", "iode", "svhlth", "codeL2"):
                kw[f.name] = np.zeros(MAX_SAT, dtype=np.int32)
            else:
                kw[f.name] = np.zeros(MAX_SAT, dtype=np.float64)
        out.append(Ephemerides(**kw))
    return out
