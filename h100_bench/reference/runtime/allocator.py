"""Channel allocation: satellite rise/set management.

Host-side equivalent of allocateChannel (plutogpssim.c:1918-1989), driving
fixed-width [MAX_CHAN] state arrays with masks so device shapes stay
static.  Semantics preserved:

  * scan SVs in ascending order; visible (el > 0 deg, the reference
    hardcodes the mask, c:1930) and unallocated -> claim the first free
    channel slot; invisible and allocated -> free the slot (a slot freed
    by a lower SV can be reclaimed by a higher SV in the same pass);
  * new channels get C/A code, subframes, nav message (init=1), an
    initial pseudorange anchor, and the reference's two-range carrier
    phase init: frac((2*r_earthcenter - r_receiver)/lambda) (c:1956-1968).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import MAX_CHAN, MAX_SAT, N_DWRD, LAMBDA_L1
from ..models import lnav, orbits
from ..models.gpstime import GpsTime
from ..types import Ephemerides, IonoUtc

__all__ = ["ChannelState", "allocate_channels"]


@dataclass
class ChannelState:
    """SoA channel slots (channel_t h:151-174 minus per-sample NCO state,
    which is closed-form in this framework)."""

    prn: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_CHAN, dtype=np.int32))
    sbf: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_CHAN, 5, 10), dtype=np.uint32))
    dwrd: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_CHAN, N_DWRD), dtype=np.uint32))
    g0_week: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_CHAN, dtype=np.int64))
    g0_sec: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_CHAN, dtype=np.float64))
    carr_phase: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_CHAN, dtype=np.float64))
    rho0_range: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_CHAN, dtype=np.float64))
    # carrier-phase anchor pair: carr_phase is the phase AT the anchor
    # epoch and rho_anchor the pseudorange there; both re-based at every
    # 30 s boundary (scheduler._boundary_update).  Between anchors the
    # per-block phase is CLOSED FORM: the reference's per-sample
    # accumulation (c:2741-2746) telescopes to
    #   phase(t) = frac(carr_phase - (rho(t) - rho_anchor)/lambda)
    # because f_carr is defined from consecutive pseudoranges (c:1760,
    # 1763).  GPS pseudoranges stay within a 1.4x ratio, so the
    # subtraction is Sterbenz-exact; re-basing every 30 s keeps the
    # division+frac rounding ~3e-11 cycles, 10x below the kernel's u32
    # phase quantum.  This removes the last per-block chain from the
    # control plane (fast_forward becomes O(boundaries), not O(blocks)).
    rho_anchor: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_CHAN, dtype=np.float64))
    azel: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_CHAN, 2), dtype=np.float64))
    iono_delay: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_CHAN, dtype=np.float64))
    d0: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_CHAN, dtype=np.float64))
    allocated_sat: np.ndarray = field(
        default_factory=lambda: -np.ones(MAX_SAT, dtype=np.int32))

    @property
    def active(self) -> np.ndarray:
        return self.prn > 0

    @property
    def sv_idx(self) -> np.ndarray:
        """0-based satellite index per channel (0 for inactive slots)."""
        return np.maximum(self.prn - 1, 0).astype(np.int32)


def allocate_channels(state: ChannelState, eph: Ephemerides,
                      ionoutc: IonoUtc, grx: GpsTime,
                      xyz: np.ndarray) -> int:
    """One allocation pass at time grx; mutates state; returns #visible."""
    vis, azel = orbits.check_visibility(eph, grx.sec, xyz)
    vis = np.asarray(vis)
    azel = np.asarray(azel)
    rho = rho_ref = None
    nsat = 0
    for sv in range(MAX_SAT):
        if vis[sv]:
            nsat += 1
            if state.allocated_sat[sv] == -1:
                free = np.flatnonzero(state.prn == 0)
                if free.size:
                    if rho is None:
                        rho = {k: np.asarray(v) for k, v in
                               orbits.compute_range(eph, ionoutc, grx.sec,
                                                    xyz).items()}
                        rho_ref = {k: np.asarray(v) for k, v in
                                   orbits.compute_range(eph, ionoutc,
                                                        grx.sec,
                                                        np.zeros(3)).items()}
                    i = int(free[0])
                    _init_channel(state, i, sv, eph, ionoutc, grx,
                                  azel[sv], rho, rho_ref)
                    state.allocated_sat[sv] = i
        elif state.allocated_sat[sv] >= 0:
            state.prn[state.allocated_sat[sv]] = 0
            state.allocated_sat[sv] = -1
    return nsat


def _init_channel(state: ChannelState, i: int, sv: int, eph: Ephemerides,
                  ionoutc: IonoUtc, grx: GpsTime, azel_sv: np.ndarray,
                  rho: dict, rho_ref: dict) -> None:
    state.prn[i] = sv + 1
    state.azel[i] = azel_sv
    state.sbf[i] = lnav.eph_to_subframes(eph, sv, ionoutc)
    g0 = lnav.generate_nav_msg(grx, state.sbf[i], state.dwrd[i], init=True)
    state.g0_week[i] = g0.week
    state.g0_sec[i] = g0.sec

    r_xyz = float(rho["range"][sv])
    state.rho0_range[i] = r_xyz
    state.rho_anchor[i] = r_xyz
    state.iono_delay[i] = float(rho["iono_delay"][sv])
    state.d0[i] = float(rho["d"][sv])

    r_ref = float(rho_ref["range"][sv])
    phase_ini = (2.0 * r_ref - r_xyz) / LAMBDA_L1
    state.carr_phase[i] = phase_ini - np.floor(phase_ini)
