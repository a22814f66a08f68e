"""The benchmark's plain reference: what the words of a scenario are.

Plain numpy (the control plane, in f64) and plain torch (the
synthesis), parsing the same generated files as the program.  Nothing
here imports the program, the JAX package or JAX: the control plane is
a frozen, trimmed copy of the program's numpy modules, planned one
superframe at a time (``runtime.scheduler``), and the synthesis is the
f64 closed form (``synth``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ingest.motion import read_user_motion
from .ingest.rinex import read_rinex2
from .models.gpstime import inc_gps_time
from .runtime.scenario import select_ephemeris_set, setup_scenario
from .runtime.scheduler import Scheduler
from .synth import synth_blocks

__all__ = ["replay", "channel_counts"]


def _scheduler(nav_path: str, start_offset_s: float, xyz, fs: float,
               motion_path: str | None, ionosphere: bool = True
               ) -> Scheduler:
    rin = read_rinex2(nav_path)
    rin.ionoutc.enable = np.array(bool(ionosphere))    # -i turns it off
    g0 = setup_scenario(rin, inc_gps_time(setup_scenario(rin, None),
                                          float(start_offset_s)))
    ieph = select_ephemeris_set(rin, g0)
    if motion_path is not None:
        return Scheduler(rin, g0, ieph, read_user_motion(motion_path), fs,
                         static_mode=False)
    return Scheduler(rin, g0, ieph, xyz, fs)


def replay(nav_path: str, start_offset_s: float, xyz, fs: float,
           blocks, device, dtype=torch.float64,
           motion_path: str | None = None, ionosphere: bool = True) -> dict:
    """{block: int16 IQ [N, 2]} for the scenario's blocks `blocks`
    (0.1 s blocks counted from the start, which is start_offset_s after
    the file's first time of clock); the receiver is static at ECEF xyz,
    or follows the motion CSV; ionosphere=False is upstream's -i."""
    want = sorted({int(b) for b in blocks})
    sched = _scheduler(nav_path, start_offset_s, xyz, fs, motion_path,
                       ionosphere)
    out = {}
    i = 0
    while i < len(want):
        m = sched.blocks_to_boundary()
        lo = sched.jblk
        if want[i] >= lo + m:
            sched.advance(300)
            continue
        plan = sched.plan(300)
        rows = [b - lo for b in want[i:] if b < lo + plan.n_blocks]
        for b, iq in zip(rows, synth_blocks(plan, rows, device, dtype)):
            out[lo + b] = iq
        i += len(rows)
    return out


def channel_counts(nav_path: str, start_offset_s: float, xyzs, fs: float,
                   n_blocks: int, motion_path: str | None = None):
    """[R, n_blocks] active channels per block of the first n_blocks,
    for R static receivers at ECEF xyzs [R, 3] (or the one receiver of
    the motion CSV): the allocation's scan alone (c:1918-1989), which
    needs visibility and no nav or range solve.  A receiver claims a
    free slot for each newly visible satellite in ascending order and
    frees the slot of each satellite that set."""
    from .models.orbits import check_visibility
    from .runtime.scenario import advance_ephemeris_set
    sched = _scheduler(nav_path, start_offset_s, np.zeros(3), fs,
                       motion_path)
    rows = sched.xyz if motion_path is not None else \
        np.atleast_2d(np.asarray(xyzs, np.float64))
    nrx = 1 if motion_path is not None else rows.shape[0]
    alloc = np.zeros((nrx, 32), bool)
    n = np.zeros(nrx, np.int64)

    def scan(ieph, t, rx):
        vis, _ = check_visibility(sched.rin.eph[ieph], np.full(nrx, t.sec),
                                  rx)
        vis = np.asarray(vis)
        for sv in range(32):
            claim = vis[:, sv] & ~alloc[:, sv] & (n < 12)
            free = ~vis[:, sv] & alloc[:, sv]
            alloc[claim, sv] = True
            alloc[free, sv] = False
            n[:] += claim.astype(np.int64) - free.astype(np.int64)

    def rx_at(k):
        return rows[[sched._motion_index(k)]] if motion_path is not None \
            else rows

    scan(sched.ieph, sched.g_start, rx_at(0))
    ieph, jblk = sched.ieph, 0
    out = np.zeros((nrx, n_blocks), np.int64)
    while jblk < n_blocks:
        sched.jblk = jblk
        m = sched.blocks_to_boundary()
        out[:, jblk:jblk + m] = n[:, None]
        jblk += m
        t_end = sched._epoch_time(jblk)
        if int(round(t_end.sec * 10.0)) % 300 == 0:
            ieph = advance_ephemeris_set(sched.rin, ieph, t_end)
            scan(ieph, t_end, rx_at(jblk))
    return out
