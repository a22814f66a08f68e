"""The reference's control plane: one superframe after another.

A frozen, trimmed copy of the program's scheduler in its plain form:
every superframe is planned by its own epoch solve (no grouped solves,
no batched boundary passes), the nav message is refreshed by the
scalar word-by-word generator, and the allocation pass solves its own
visibility.  The boundary protocol is the upstream loop's, in its order
(plutogpssim.c:2762-2798):

    1. generate_nav_msg(init=0) for active channels
    2. ephemeris-set rollover (rebuild subframes only)
    3. channel re-allocation

``advance`` moves the state over a superframe that is not compared: it
solves only the superframe's last epoch, which is all the state that
crosses a boundary needs (the carrier phase is closed form between
30 s anchors).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import LAMBDA_L1, MAX_CHAN
from ..models import lnav
from ..models.cacode import CA_TABLE
from ..models.gpstime import GpsTime, inc_gps_time, inc_gps_time_grid
from ..ops.epoch import solve_ranges_lean, solve_superframe
from . import scenario as scenario_mod
from .allocator import ChannelState, allocate_channels

__all__ = ["SuperframePlan", "Scheduler"]

_BLOCK_DT = 0.1


@dataclass
class SuperframePlan:
    """Synthesis plan for one superframe of M blocks."""

    n_blocks: int
    block_samples: int
    delt: float
    ca2: np.ndarray          # [C, 1023] int8, chips as +-1
    bits: np.ndarray         # [C, 1800] int8, nav bits as +-1
    active: np.ndarray       # [M, C] bool
    f_carr: np.ndarray       # [M, C] f64
    f_code: np.ndarray       # [M, C] f64
    code_phase: np.ndarray   # [M, C] f64 chips
    icode: np.ndarray        # [M, C] int32
    ibit: np.ndarray         # [M, C] int32
    iword: np.ndarray        # [M, C] int32
    carr_phase: np.ndarray   # [M, C] f64 cycles, block-start
    gain: np.ndarray         # [M, C] f64


class Scheduler:
    """Plans superframes and owns all mutable scenario state."""

    def __init__(self, rin, start: GpsTime, ieph: int, xyz: np.ndarray,
                 fs: float, static_mode: bool = True):
        self.rin = rin
        self.ionoutc = rin.ionoutc
        self.ieph = ieph
        self.xyz = np.atleast_2d(np.asarray(xyz, dtype=np.float64))
        self.numd = self.xyz.shape[0]
        self.static_mode = static_mode
        self.delt = 1.0 / float(fs)
        self.block_samples = int(round(fs / 10))
        self.phase_ratio = (self.block_samples * self.delt) / _BLOCK_DT
        self.g_start = start
        self.jblk = 0
        self.state = ChannelState()
        allocate_channels(self.state, rin.eph[ieph], self.ionoutc, start,
                          self.xyz[0])

    def _epoch_time(self, k: int) -> GpsTime:
        return inc_gps_time(self.g_start, _BLOCK_DT * k)

    def _motion_index(self, k: int) -> int:
        """The upstream loop's off-by-one: block k >= 1 uses motion row
        (k-1) mod numd (c:2802-2805)."""
        if self.static_mode or k <= 0:
            return 0
        return (k - 1) % self.numd

    def _grid(self, ks: np.ndarray):
        g_secs, g_weeks = inc_gps_time_grid(self.g_start, _BLOCK_DT * ks)
        rx = self.xyz[[self._motion_index(int(k)) for k in ks]]
        return g_secs, g_weeks, rx

    def blocks_to_boundary(self) -> int:
        """Blocks from the current anchor to the next 30 s boundary."""
        rem = (-int(round(self._epoch_time(self.jblk).sec * 10.0))) % 300
        return rem if rem > 0 else 300

    def plan(self, max_blocks: int) -> SuperframePlan:
        """Plan the next superframe (up to max_blocks blocks) and advance
        the state past it."""
        M = min(self.blocks_to_boundary(), max_blocks)
        st = self.state
        t0 = self._epoch_time(self.jblk)
        g_secs, g_weeks, rx = self._grid(self.jblk + np.arange(M + 1))
        active = st.active.copy()
        g0_sec = np.where(active, st.g0_sec, t0.sec)
        g0_week = np.where(active, st.g0_week, t0.week)
        params, carry = solve_superframe(
            self.rin.eph[self.ieph], self.ionoutc, g_secs, g_weeks, rx,
            st.sv_idx, active, g0_sec, g0_week, st.rho0_range,
            dt=_BLOCK_DT)
        # closed-form carrier phase against the 30 s anchor pair
        dr = params["rng0"] - st.rho_anchor[None, :]
        c0 = st.carr_phase[None, :] - dr * self.phase_ratio / LAMBDA_L1
        c0 -= np.floor(c0)
        act = params["active"] & active[None, :]
        c0 = np.where(act, c0, 0.0)
        st.rho0_range = np.where(active, carry["rho0_range"], st.rho0_range)
        st.azel = np.where(active[:, None], carry["azel_last"], st.azel)
        plan = SuperframePlan(
            n_blocks=M, block_samples=self.block_samples, delt=self.delt,
            ca2=(CA_TABLE[st.sv_idx] * 2 - 1).astype(np.int8),
            bits=self._bits_table(), active=act,
            f_carr=params["f_carr"], f_code=params["f_code"],
            code_phase=params["code_phase"], icode=params["icode"],
            ibit=params["ibit"], iword=params["iword"], carr_phase=c0,
            gain=params["gain"])
        self._step(M)
        return plan

    def advance(self, max_blocks: int) -> int:
        """Move the state over the next superframe (up to max_blocks
        blocks) without planning it; returns its block count."""
        M = min(self.blocks_to_boundary(), max_blocks)
        st = self.state
        act = st.active
        g_secs, _, rx = self._grid(np.array([self.jblk + M]))
        rho = solve_ranges_lean(self.rin.eph[self.ieph], self.ionoutc,
                                g_secs, rx)
        rng = np.asarray(rho["range"])[0, st.sv_idx]
        azel = np.asarray(rho["azel"])[0, st.sv_idx]
        st.rho0_range = np.where(act, rng, st.rho0_range)
        st.azel = np.where(act[:, None], azel, st.azel)
        self._step(M)
        return M

    def _step(self, M: int) -> None:
        self.jblk += M
        t_end = self._epoch_time(self.jblk)
        if int(round(t_end.sec * 10.0)) % 300 == 0:
            self._boundary_update(t_end)

    def _bits_table(self) -> np.ndarray:
        """dwrd[60] words -> per-channel +-1 bit table [C, 1800]."""
        words = self.state.dwrd.astype(np.uint32)
        shifts = (29 - np.arange(30, dtype=np.uint32))[None, None, :]
        bits = ((words[:, :, None] >> shifts) & 1).astype(np.int8)
        return (bits.reshape(MAX_CHAN, -1) * 2 - 1).astype(np.int8)

    def _boundary_update(self, grx: GpsTime) -> None:
        st = self.state
        # re-base the carrier anchor pair to this boundary
        act = st.prn > 0
        cb = st.carr_phase - \
            (st.rho0_range - st.rho_anchor) * self.phase_ratio / LAMBDA_L1
        cb -= np.floor(cb)
        st.carr_phase = np.where(act, cb, st.carr_phase)
        st.rho_anchor = np.where(act, st.rho0_range, st.rho_anchor)
        # 1. nav message refresh for active channels
        for c in range(MAX_CHAN):
            if st.prn[c] > 0:
                g0 = lnav.generate_nav_msg(grx, st.sbf[c], st.dwrd[c],
                                           init=False)
                st.g0_week[c] = g0.week
                st.g0_sec[c] = g0.sec
        # 2. ephemeris-set rollover: rebuild subframes only
        new_ieph = scenario_mod.advance_ephemeris_set(self.rin, self.ieph,
                                                      grx)
        if new_ieph != self.ieph:
            self.ieph = new_ieph
            eph = self.rin.eph[self.ieph]
            for c in range(MAX_CHAN):
                if st.prn[c] > 0:
                    st.sbf[c] = lnav.eph_to_subframes(eph, int(st.prn[c]) - 1,
                                                      self.ionoutc)
        # 3. channel re-allocation (rise/set)
        allocate_channels(st, self.rin.eph[self.ieph], self.ionoutc, grx,
                          self.xyz[self._motion_index(self.jblk)])
