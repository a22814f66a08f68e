"""Superframe scheduler: host control plane for the TPU synthesis stream.

The reference interleaves everything in one sequential loop (epoch solve,
sample loop, 30 s nav/allocation updates, c:2655-2806).  The TPU design
splits control from compute: this scheduler plans *superframes* (runs of
0.1 s blocks between consecutive 30 s boundaries), does all host-side
control at the boundaries in exactly the reference's order —

    1. generate_nav_msg(init=0) for active channels   (c:2769-2772)
    2. ephemeris-set rollover (rebuild subframes only) (c:2774-2790)
    3. channel re-allocation                           (c:2792-2797)

— and emits a SuperframePlan whose arrays fully determine the device
synthesis (closed-form phase ramps).  Nothing is chained across blocks
anymore: the reference's per-sample carrier NCO (c:2741-2746)
telescopes over its per-epoch f_carr definition (c:1760,1763) to
phase(t) = frac(cb - (rng(t) - rho_anchor)/lambda) against a per-30 s
boundary anchor pair (see ChannelState.rho_anchor), so every per-block
quantity is a pure function of absolute time — which is what makes
skip()/fast_forward O(boundaries) and host partitioning cheap.

Motion indexing preserves the reference's off-by-one: the epoch at
scenario block k (k >= 1) uses motion sample (k-1) mod numd (iumd is
incremented at the *end* of each loop iteration, c:2802-2805), and the
initial allocation uses sample 0.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..constants import LAMBDA_L1, MAX_CHAN, N_DWRD
from ..ingest.rinex import RinexResult
from ..models import lnav, orbits
from ..models.cacode import CA_TABLE
from ..models.gpstime import GpsTime, inc_gps_time, inc_gps_time_grid
from ..ops.epoch import solve_ranges_lean, solve_superframe
from ..types import IonoUtc
from . import scenario as scenario_mod
from . import trace
from .allocator import ChannelState, allocate_channels

__all__ = ["SuperframePlan", "Scheduler", "copy_snapshot"]

_BLOCK_DT = 0.1


def _gather_eph(eph, sv_idx: np.ndarray):
    """Ephemeris dataclass gathered to the channel slots' satellites."""
    return type(eph)(**{f.name: np.asarray(getattr(eph, f.name))[sv_idx]
                        for f in dataclasses.fields(eph)})


def copy_snapshot(snap: dict) -> dict:
    """A copy of a Scheduler.snapshot() capsule that shares no array."""
    return {"jblk": snap["jblk"], "ieph": snap["ieph"],
            "channel_state": {k: np.copy(v) for k, v in
                              snap["channel_state"].items()}}


@dataclass
class SuperframePlan:
    """Device-ready synthesis plan for one superframe of M blocks."""

    n_blocks: int
    block_samples: int
    delt: float
    # per-channel constants for this superframe
    prn: np.ndarray          # [C] int32, 0 = inactive
    ca2: np.ndarray          # [C, 1023] int8, chips as +-1
    bits: np.ndarray         # [C, 1800] int8, nav bits as +-1
    # per-(block, channel) parameters
    active: np.ndarray       # [M, C] bool
    f_carr: np.ndarray       # [M, C] f64
    f_code: np.ndarray       # [M, C] f64
    code_phase: np.ndarray   # [M, C] f64 chips
    icode: np.ndarray        # [M, C] int32
    ibit: np.ndarray         # [M, C] int32
    iword: np.ndarray        # [M, C] int32
    carr_phase: np.ndarray   # [M, C] f64 cycles, block-start
    gain: np.ndarray         # [M, C] f64
    azel: np.ndarray         # [M, C, 2] f64 (diagnostics)
    t0_sec: float = 0.0      # superframe start, GPS seconds of week


class Scheduler:
    """Plans superframes and owns all mutable scenario state."""

    def __init__(self, rin: RinexResult, start: GpsTime, ieph: int,
                 xyz: np.ndarray, fs: float,
                 block_samples: int | None = None,
                 static_mode: bool = True,
                 nav_cache=None, alloc_precomp: dict | None = None):
        self.rin = rin
        self.ionoutc: IonoUtc = rin.ionoutc
        self.ieph = ieph
        self.xyz = np.atleast_2d(np.asarray(xyz, dtype=np.float64))
        self.numd = self.xyz.shape[0]
        self.static_mode = static_mode
        self.fs = float(fs)
        self.delt = 1.0 / float(fs)
        self.block_samples = int(block_samples or round(fs / 10))
        # per-block carrier advance is f_carr * (block_samples*delt): in
        # ref-compat mode (block_samples=300000 at fs != 3 MHz, the
        # reference's compile-time NUM_SAMPLES quirk, c:44/2800) a block
        # spans less signal time than the 0.1 s epoch grid, so the
        # telescoped closed-form phase scales the range delta by
        #   ratio = (block_samples*delt) / dt_epoch
        # (= 1.0 up to fp rounding in the corrected default sizing)
        self.phase_ratio = (self.block_samples * self.delt) / _BLOCK_DT
        self.nav_cache = nav_cache  # models.lnav.NavCache, shared in MC

        self.g_start = start
        self.jblk = 0  # global block counter: current anchor = start + 0.1*jblk
        self.state = ChannelState()
        self._nav_refresher = lnav.NavRefresher()

        # initial allocation at t_0 with motion sample 0 (c:2629-2632)
        allocate_channels(self.state, rin.eph[ieph], self.ionoutc, start,
                          self.xyz[0], precomp=alloc_precomp,
                          nav_cache=nav_cache)

    # -- helpers -----------------------------------------------------------

    def _epoch_time(self, k: int) -> GpsTime:
        return inc_gps_time(self.g_start, _BLOCK_DT * k)

    def _motion_index(self, k: int) -> int:
        if self.static_mode or k <= 0:
            return 0
        return (k - 1) % self.numd

    def _grid_arrays(self, ks: np.ndarray):
        """(g_secs, g_weeks, rx) for an explicit block-index grid."""
        g_secs, g_weeks = inc_gps_time_grid(self.g_start, _BLOCK_DT * ks)
        if self.static_mode:
            rx = np.broadcast_to(self.xyz[0], (len(ks), 3))
        else:
            rx = self.xyz[np.where(ks <= 0, 0, (ks - 1) % self.numd)]
        return g_secs, g_weeks, rx

    def epoch_grid(self, M: int):
        """The (M+1)-epoch grid for the next M blocks: (g_secs, g_weeks,
        rx) — the exact arrays plan() solves over.  Exposed so batched
        control planes (parallel/montecarlo.py) can precompute the range
        solve on the identical grid."""
        return self._grid_arrays(self.jblk + np.arange(M + 1))

    def next_plan_span(self, max_blocks: int):
        """(M, t_end, boundary) for the NEXT plan(max_blocks) call:
        how many blocks it will cover, the time it ends at, and whether
        that end is a 30 s boundary (where nav refresh / rollover /
        re-allocation run, c:2762-2798)."""
        M = min(self._blocks_to_boundary(), max_blocks)
        t_end = self._epoch_time(self.jblk + M)
        boundary = int(round(t_end.sec * 10.0)) % 300 == 0
        return M, t_end, boundary

    def _blocks_to_boundary(self) -> int:
        """Blocks from the current anchor to the next 30 s boundary."""
        t0 = self._epoch_time(self.jblk)
        igrx = int(round(t0.sec * 10.0))
        rem = (-igrx) % 300
        return rem if rem > 0 else 300

    def simulate_spans(self, max_blocks: int = 300,
                       n_superframes: int | None = None,
                       total_blocks: int | None = None) -> list:
        """Deterministic pre-simulation of the spans a plan()/skip()
        loop would take from the current state — all host arithmetic,
        no state change.  One record per span:

            (jblk0, M, eph_pre, t_end, boundary, eph_post)

        eph advances only at 30 s boundaries via the deterministic
        advance_ephemeris_set, mirroring _boundary_update: eph_pre is
        the set in effect DURING the span (anchor/plan solves use it —
        c:2774-2790 semantics), eph_post the set after the span-end
        rollover check (what the boundary allocation pass sees).  This
        is the ONE copy of the span/boundary/rollover protocol; it must
        stay in lockstep with plan()'s own _blocks_to_boundary or
        batched callers (plan_group, skip, the Monte-Carlo control
        plane) lose clock sync with the plans they feed."""
        spans = []
        jblk, ieph = self.jblk, self.ieph
        left = total_blocks
        while n_superframes is None or len(spans) < n_superframes:
            cap = max_blocks if left is None else min(max_blocks, left)
            if cap <= 0:
                break
            t0 = self._epoch_time(jblk)
            rem = (-int(round(t0.sec * 10.0))) % 300
            M = min(rem if rem > 0 else 300, cap)
            t_end = self._epoch_time(jblk + M)
            bnd = int(round(t_end.sec * 10.0)) % 300 == 0
            post = scenario_mod.advance_ephemeris_set(
                self.rin, ieph, t_end) if bnd else ieph
            spans.append((jblk, M, ieph, t_end, bnd, post))
            jblk += M
            if left is not None:
                left -= M
            ieph = post
        return spans

    # -- state -------------------------------------------------------------

    def snapshot(self) -> dict:
        """A copy of everything plan(), plan_group() and skip() change:
        the block counter, the ephemeris set and every channel-state
        field (the nav memos, _nav_refresher and a shared NavCache, need
        none)."""
        return copy_snapshot({"jblk": self.jblk, "ieph": self.ieph,
                              "channel_state": vars(self.state)})

    def restore(self, snap: dict) -> None:
        """Put the state of a snapshot() back."""
        self.jblk = snap["jblk"]
        self.ieph = snap["ieph"]
        for k, v in snap["channel_state"].items():
            setattr(self.state, k, np.copy(v))

    # -- planning ----------------------------------------------------------

    def plan(self, max_blocks: int, rho=None, rho_in_slots: bool = False,
             alloc_precomp: dict | None = None) -> SuperframePlan | None:
        """Plan the next superframe (up to max_blocks blocks), advance all
        host state, and run boundary updates when a 30 s boundary is hit.

        rho / alloc_precomp: precomputed device solves for batched
        control planes (parallel/montecarlo.py) — rho is this receiver's
        solve_ranges output over the plan's epoch grid; alloc_precomp
        feeds the boundary allocation pass (see allocate_channels)."""
        if max_blocks <= 0:
            return None
        M = min(self._blocks_to_boundary(), max_blocks)

        st = self.state
        t0 = self._epoch_time(self.jblk)
        g_secs, g_weeks, rx = self.epoch_grid(M)

        active = st.active.copy()
        # inactive slots get a nearby dummy g0 so masked lanes stay finite
        g0_sec = np.where(active, st.g0_sec, t0.sec)
        g0_week = np.where(active, st.g0_week, t0.week)

        eph = self.rin.eph[self.ieph]
        params, carry = solve_superframe(
            eph, self.ionoutc, g_secs, g_weeks, rx, st.sv_idx, active,
            g0_sec, g0_week, st.rho0_range, dt=_BLOCK_DT, rho=rho,
            rho_in_slots=rho_in_slots)

        # closed-form carrier phase: the reference's per-sample NCO
        # accumulation (c:2741-2746) telescopes over its per-epoch
        # f_carr = -(rho1-rho0)/dt/lambda (c:1760,1763) to
        #   phase(t_k) = frac(cb - (rng(t_k) - rho_anchor)/lambda),
        # with (cb, rho_anchor) the channel's 30 s-boundary anchor pair
        # (see ChannelState.rho_anchor).  Pseudoranges stay within a
        # 1.4x ratio so the subtraction is Sterbenz-exact; one frac per
        # block replaces the sequential per-block chain this scheduler
        # used to carry — every block's phase is now a pure function of
        # absolute time, which is what makes fast_forward O(boundaries).
        dr = params["rng0"] - st.rho_anchor[None, :]
        c0 = st.carr_phase[None, :] - dr * self.phase_ratio / LAMBDA_L1
        c0 -= np.floor(c0)
        c0 = np.where(params["active"] & active[None, :], c0, 0.0)
        st.rho0_range = np.where(active, carry["rho0_range"], st.rho0_range)
        st.azel = np.where(active[:, None], carry["azel_last"], st.azel)

        plan = SuperframePlan(
            n_blocks=M, block_samples=self.block_samples, delt=self.delt,
            prn=st.prn.copy(),
            ca2=(CA_TABLE[st.sv_idx] * 2 - 1).astype(np.int8),
            bits=self._bits_table(),
            active=params["active"] & active[None, :],
            f_carr=params["f_carr"], f_code=params["f_code"],
            code_phase=params["code_phase"], icode=params["icode"],
            ibit=params["ibit"], iword=params["iword"],
            carr_phase=c0, gain=params["gain"], azel=params["azel"],
            t0_sec=float(t0.sec),
        )

        # advance to t_M and run boundary updates if it is a 30 s boundary
        self.jblk += M
        t_end = self._epoch_time(self.jblk)
        if int(round(t_end.sec * 10.0)) % 300 == 0:
            self._boundary_update(t_end, alloc_precomp)
        return plan

    def plan_group(self, n_superframes: int, max_blocks: int = 300,
                   total_blocks: int | None = None) -> list[SuperframePlan]:
        """Plan up to n_superframes consecutive superframes with ONE
        range solve per run of superframes sharing an ephemeris set
        (instead of one jitted solve dispatch per superframe — the
        dominant host control-plane cost).  Returns exactly the plans a
        plan() loop would produce, bit for bit: the solve is the same
        vmapped elementwise computation over a longer epoch grid, and
        each span is then fed to plan(rho=slice) so every boundary
        update (nav refresh, rollover, re-allocation) runs identically
        (asserted by test_scheduler_stream.py::test_plan_group_*).

        total_blocks caps the summed block count (None = uncapped).
        """
        if n_superframes <= 0:
            return []
        # one shared span pre-simulation (simulate_spans); bounds[k] =
        # (jblk_end, post-rollover eph set) for each span ending on a
        # 30 s boundary — the inputs of the batched boundary-visibility
        # precomp below
        recs = self.simulate_spans(max_blocks, n_superframes=n_superframes,
                                   total_blocks=total_blocks)
        spans = [(jb, M, pre_eph) for jb, M, pre_eph, _, _, _ in recs]
        bounds = {k: (jb + M, post)
                  for k, (jb, M, _, _, bnd, post) in enumerate(recs)
                  if bnd}

        # boundary allocation inputs for the whole group in ONE batched
        # visibility solve (per-boundary [32] solves were numpy-overhead
        # bound on the 1-core pipelined host path)
        pre = self._boundary_precomp(bounds)

        plans: list[SuperframePlan] = []
        i = 0
        while i < len(spans):
            j = i                  # contiguous run on one ephemeris set
            while j + 1 < len(spans) and spans[j + 1][2] == spans[i][2]:
                j += 1
            # One batched range solve per run — over the 12 CHANNEL
            # SLOTS, not all 32 SVs: satpos is elementwise per
            # satellite, so solving the sv_idx-gathered ephemeris gives
            # bit-identical columns at ~2.7x less host compute (the
            # pipelined stream is host-bound).  A boundary update
            # inside the run can re-allocate slots; the guard re-solves
            # the remaining spans with the new sv_idx when that happens
            # (rise/set cadence is ~minutes, so typically 1 solve/run).
            # Grids are exact-length: the old padding to one canonical
            # shape existed for the jitted solve's XLA compile cache
            # (~1.4 s per fresh grid length) and died with the round-5
            # numpy port.
            k = i
            while k <= j:
                jblk0 = spans[k][0]
                total = spans[j][0] + spans[j][1] - jblk0
                ks = jblk0 + np.arange(total + 1)
                g_secs, g_weeks, rx = self._grid_arrays(ks)
                sv_idx = self.state.sv_idx.copy()
                eph_sub = _gather_eph(self.rin.eph[spans[i][2]], sv_idx)
                with trace.child("scheduler.solve"):
                    rho = solve_ranges_lean(eph_sub, self.ionoutc, g_secs,
                                            rx)
                while k <= j:
                    if not np.array_equal(self.state.sv_idx, sv_idx):
                        break      # slots changed mid-run: re-solve rest
                    jb, M, _ = spans[k]
                    off = jb - jblk0
                    rho_s = {kk: v[off:off + M + 1]
                             for kk, v in rho.items()}
                    plan = self.plan(M, rho=rho_s, rho_in_slots=True,
                                     alloc_precomp=pre.get(k))
                    assert plan is not None and plan.n_blocks == M, \
                        "plan_group span simulation diverged from plan()"
                    plans.append(plan)
                    k += 1
            i = j + 1
        return plans

    def _boundary_precomp(self, bounds: dict[int, tuple[int, int]]) -> dict:
        """Batched boundary-allocation visibility: {key: (jblk, ieph)}
        -> {key: {"vis": [32], "azel": [32, 2]}} with ONE
        check_visibility call per run of boundaries sharing an eph set
        (instead of one tiny [32] solve inside every _boundary_update —
        pure numpy per-op overhead on the host-bound critical path).
        ieph is the POST-rollover set, matching the set
        _boundary_update's allocation pass uses; values are
        bit-identical to the per-boundary scalar calls (satpos/geodesy
        are elementwise over the epoch axis).  The allocator's range
        solves stay lazy (allocate_channels only runs them when a rise
        event claims a slot)."""
        if not bounds:
            return {}
        keys = list(bounds)
        out: dict = {}
        i = 0
        while i < len(keys):
            j = i                  # contiguous run on one ephemeris set
            while j + 1 < len(keys) and \
                    bounds[keys[j + 1]][1] == bounds[keys[i]][1]:
                j += 1
            ks = np.array([bounds[k][0] for k in keys[i:j + 1]])
            g_secs, _, rx = self._grid_arrays(ks)
            vis, azel = orbits.check_visibility(
                self.rin.eph[bounds[keys[i]][1]], g_secs, rx)
            for r, k in enumerate(keys[i:j + 1]):
                out[k] = {"vis": vis[r], "azel": azel[r]}
            i = j + 1
        return out

    def skip(self, n_blocks: int) -> None:
        """Advance n_blocks without planning — O(boundaries) host work.

        Because every per-block quantity is closed-form in absolute time
        (see module docstring), skipping only has to maintain the
        boundary-anchored state: per-channel range/azel anchors at each
        stop epoch and the 30 s boundary updates (nav refresh, rollover,
        re-allocation).  The stop epochs and their eph sets are
        deterministic (independent of channel state), so like
        plan_group the range solves batch into ONE slot-gathered numpy
        solve per run of stops sharing an ephemeris set, and the
        boundary allocation visibilities into one batched solve per
        run.  Downstream plans are
        bit-identical to a plan() loop over the same span
        (test_host_partition_concatenates_identically) — this is the
        host-partition entry point that replaces the reference's
        strictly sequential loop (plutogpssim.c:2655-2806) at host
        scale."""
        # one shared span pre-simulation (simulate_spans); each stop's
        # anchor solve uses the PRE-rollover set (c:2774-2790
        # semantics), the boundary allocation pass the POST set
        recs = self.simulate_spans(total_blocks=int(n_blocks))
        stops = [(jb + M, pre_eph, bnd, post)
                 for jb, M, pre_eph, _, bnd, post in recs]
        bounds = {k: (jb + M, post)
                  for k, (jb, M, _, _, bnd, post) in enumerate(recs)
                  if bnd}

        # batched boundary-allocation visibility, as in plan_group
        pre = self._boundary_precomp(bounds)

        i = 0
        while i < len(stops):
            j = i                  # contiguous run on one ephemeris set
            while j + 1 < len(stops) and stops[j + 1][1] == stops[i][1]:
                j += 1
            # anchor solves gathered to the 12 channel slots, like
            # plan_group (bit-identical columns, ~2.7x less host
            # compute); a boundary re-allocation inside the run changes
            # sv_idx, so the guard re-solves the remaining stops with
            # the new slots.  Grids are exact-length (the old
            # power-of-two padding served the jitted solve's compile
            # cache, gone with the round-5 numpy port).
            k = i
            while k <= j:
                sv_idx = self.state.sv_idx.copy()
                eph_sub = _gather_eph(self.rin.eph[stops[i][1]], sv_idx)
                ks = np.array([s[0] for s in stops[k:j + 1]])
                g_secs, _, rx = self._grid_arrays(ks)
                rho = solve_ranges_lean(eph_sub, self.ionoutc, g_secs, rx)
                rng_all = np.asarray(rho["range"])
                azel_all = np.asarray(rho["azel"])
                r = 0
                while k <= j:
                    if not np.array_equal(self.state.sv_idx, sv_idx):
                        break      # slots changed mid-run: re-solve rest
                    jb, _, bnd, _ = stops[k]
                    self.jblk = jb
                    st = self.state
                    act = st.active
                    st.rho0_range = np.where(act, rng_all[r],
                                             st.rho0_range)
                    st.azel = np.where(act[:, None], azel_all[r], st.azel)
                    if bnd:
                        self._boundary_update(self._epoch_time(jb),
                                              pre.get(k))
                    k += 1
                    r += 1
            i = j + 1

    def _bits_table(self) -> np.ndarray:
        """dwrd[60] words -> per-channel +-1 bit table [C, 1800]."""
        st = self.state
        words = st.dwrd.astype(np.uint32)            # [C, 60]
        shifts = (29 - np.arange(30, dtype=np.uint32))[None, None, :]
        bits = ((words[:, :, None] >> shifts) & 1).astype(np.int8)
        return (bits.reshape(MAX_CHAN, N_DWRD * 30) * 2 - 1).astype(np.int8)

    def _boundary_update(self, grx: GpsTime,
                         alloc_precomp: dict | None = None) -> None:
        st = self.state
        cache = self.nav_cache
        # 0. re-base the carrier anchor pair to this boundary: the phase
        #    at grx is closed-form from the previous anchor, and
        #    st.rho0_range already holds rng(grx) (updated by plan()/
        #    skip() just before this call, with the PRE-rollover eph set
        #    — matching the next superframe's rng[0] override).  Must
        #    run before re-allocation, which overwrites freed slots.
        act = st.prn > 0
        cb = st.carr_phase - \
            (st.rho0_range - st.rho_anchor) * self.phase_ratio / LAMBDA_L1
        cb -= np.floor(cb)
        st.carr_phase = np.where(act, cb, st.carr_phase)
        st.rho_anchor = np.where(act, st.rho0_range, st.rho_anchor)
        # 1. nav message refresh (shift SF5, new frame) for active channels
        if cache is not None:
            for c in range(MAX_CHAN):
                if st.prn[c] > 0:
                    g0, dwrd = cache.nav_msg(grx, st.sbf[c], st.dwrd[c],
                                             init=False)
                    st.dwrd[c] = dwrd
                    st.g0_week[c] = g0.week
                    st.g0_sec[c] = g0.sec
        else:
            idx = np.nonzero(st.prn > 0)[0]
            if idx.size:
                dwrd = st.dwrd[idx]
                # frame-invariant words cached by (sbf, wn): only the 5
                # HOW words carry the frame TOW (lnav.NavRefresher)
                g0 = self._nav_refresher.refresh(grx, st.sbf[idx], dwrd)
                st.dwrd[idx] = dwrd
                st.g0_week[idx] = g0.week
                st.g0_sec[idx] = g0.sec
        # 2. ephemeris-set rollover: rebuild subframes only (takes effect
        #    at the *next* boundary's nav refresh, like the reference)
        new_ieph = scenario_mod.advance_ephemeris_set(self.rin, self.ieph, grx)
        if new_ieph != self.ieph:
            self.ieph = new_ieph
            eph = self.rin.eph[self.ieph]
            for c in range(MAX_CHAN):
                if st.prn[c] > 0:
                    st.sbf[c] = (cache.subframes(eph, int(st.prn[c]) - 1,
                                                 self.ionoutc)
                                 if cache is not None else
                                 lnav.eph_to_subframes(eph, int(st.prn[c]) - 1,
                                                       self.ionoutc))
        # 3. channel re-allocation (rise/set)
        allocate_channels(st, self.rin.eph[self.ieph], self.ionoutc, grx,
                          self.xyz[self._motion_index(self.jblk)],
                          precomp=alloc_precomp, nav_cache=cache)
