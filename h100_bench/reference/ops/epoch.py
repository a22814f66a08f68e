"""Batched 10 Hz epoch solve: ephemeris -> per-block synthesis parameters.

Replaces the reference's scalar per-channel epoch refresh
(plutogpssim.c:2656-2687 + computeCodePhase c:1754-1787) with one
broadcast numpy computation per 30 s superframe:

    ranges  : compute_range broadcast over (epoch, satellite)
    params  : per block k, pairs (rho[k], rho[k+1]) -> f_carr, f_code,
              code phase/word/bit/code counters, gain

Pure numpy f64 on the host (round 5; was jitted CPU-JAX through round
4 — the jit dispatch + device->host conversions cost ~2x the actual
compute on the pipelined stream's host-bound critical path; see
models/orbits.py for the exactness rationale).  All outputs are
TPU-kernel-ready: int32 counters and f64 values later split into
int/f32 anchors.

Exactness notes vs the reference:
  * rhorate uses the (rho1-rho0)/dt pair, rho0 anchored one epoch back
    (c:1760); block k covers scenario time [t_k, t_{k+1}).
  * ms = ((t_prev - g0_databit) + 6.0 - rho0/c)*1e3, truncated to int ms,
    then split 600/20/1 ms into word/bit/code counters (c:1767-1778).
  * gain = (20200000/d) * ant_pat[(90 - el_deg)/5] (c:2678-2685).
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    CA_SEQ_LEN,
    CARR_TO_CODE,
    CODE_FREQ,
    LAMBDA_L1,
    PATH_LOSS_NUMERATOR,
    R2D,
    SECONDS_IN_WEEK,
    SPEED_OF_LIGHT,
)
from ..models import orbits
from ..models.tables import ant_pat_linear
from ..types import Ephemerides, IonoUtc

__all__ = ["solve_ranges", "solve_ranges_lean", "ranges_to_params",
           "solve_superframe"]

_ANT_PAT = np.asarray(ant_pat_linear())


def solve_ranges(eph: Ephemerides, ionoutc: IonoUtc,
                 g_secs, rx_pos):
    """compute_range over a [n_epochs] grid x [32] satellites.

    g_secs: [n_epochs] GPS seconds-of-week; rx_pos: [n_epochs, 3] ECEF.
    Returns dict of arrays [n_epochs, 32].  (compute_range broadcasts,
    so this and the batch form below are the same call; the named entry
    points keep the control-plane call sites self-describing.)"""
    return orbits.compute_range(eph, ionoutc, g_secs, rx_pos)


def solve_ranges_lean(eph: Ephemerides, ionoutc: IonoUtc,
                      g_secs, rx_pos):
    """solve_ranges returning only what the planning path consumes
    (range, d, azel) — skips the rate dot product ("iono_delay" is
    already folded into range; the reference also computes-but-drops
    the rate term, c:1731).  Values are bit-identical to
    solve_ranges'."""
    return orbits.compute_range(eph, ionoutc, g_secs, rx_pos, lean=True)


def ranges_to_params(rho_range: np.ndarray, rho_d: np.ndarray,
                     rho_el: np.ndarray,
                     g_secs: np.ndarray, g_weeks: np.ndarray,
                     g0_sec: np.ndarray, g0_week: np.ndarray, dt: float):
    """Per-block channel parameters from consecutive range pairs.

    Inputs are per-channel gathers over the epoch grid:
      rho_range [n_epochs, C] pseudoranges, rho_d / rho_el likewise,
      g_secs/g_weeks [n_epochs] epoch GPS time (seconds-of-week, week),
      g0_sec/g0_week [C] each channel's data-bit reference time.
    Block k (k in [0, n_epochs-1)) uses epochs k (anchor) and k+1.

    Pure numpy (f64): this used to be a cpu_jit, but the per-superframe
    jit dispatch + host<->jax conversions cost ~5 ms on one core — ~25x
    the actual [300, 12] elementwise compute — and sat on the pipelined
    stream's critical host path.  The expression tree is unchanged
    (plain IEEE-754 f64 elementwise ops, truncating int casts), and
    every synthesis path consumes the same plan arrays, so the
    bit-exactness chain (precise == tiled == pallas) is unaffected.

    Returns dict of [n_blocks, C]: f_carr, f_code, code_phase, iword,
    ibit, icode, gain."""
    rho0 = rho_range[:-1]      # anchor epoch ranges  [n_blocks, C]
    rho1 = rho_range[1:]
    rhorate = (rho1 - rho0) / dt
    f_carr = -rhorate / LAMBDA_L1
    f_code = CODE_FREQ + f_carr * CARR_TO_CODE

    # ms since data-bit reference (+1 subframe), minus range latency.
    # t_anchor MUST be the single-rounding subGpsTime(rho0.g, g0) tree
    # (fl(sec diff) + week diff * 604800, c:838-845/1767): computing it
    # as (t_k - t_0) + (t_0 - g0) instead costs ~ulp(3000 s) = 4.5e-13 s
    # = ~5e-7 chips of anchor offset, which lands a chip transition on
    # the wrong sample ~0.1 times per block — a full-amplitude sample
    # error that caps long-run SNR near 70 dB (round-2 root cause).
    t_anchor = (g_secs[:-1, None] - g0_sec[None, :]) + \
        (g_weeks[:-1, None] - g0_week[None, :]) * SECONDS_IN_WEEK
    ms = ((t_anchor + 6.0) - rho0 / SPEED_OF_LIGHT) * 1000.0
    ims = ms.astype(np.int32)           # C (int) truncation (ms >= 0 here)
    code_phase = (ms - ims) * CA_SEQ_LEN

    iword = ims // 600
    ims = ims - iword * 600
    ibit = ims // 20
    ims = ims - ibit * 20
    icode = ims

    # Gain from the *current* epoch's geometry (c:2678-2685 uses rho at
    # the epoch solve, i.e. the k+1 range of the block pair)
    d1 = rho_d[1:]
    el1 = rho_el[1:]
    path_loss = PATH_LOSS_NUMERATOR / d1
    ibs = ((90.0 - el1 * R2D) / 5.0).astype(np.int32)
    # the jitted version's gather clamped OOB indices (XLA semantics);
    # keep that for masked lanes whose dummy elevation may be < 0
    ant_gain = _ANT_PAT[np.clip(ibs, 0, len(_ANT_PAT) - 1)]
    gain = path_loss * ant_gain

    return {
        "f_carr": f_carr, "f_code": f_code, "code_phase": code_phase,
        "iword": iword, "ibit": ibit, "icode": icode, "gain": gain,
    }


def solve_superframe(eph: Ephemerides, ionoutc: IonoUtc,
                     g_secs: np.ndarray, g_weeks: np.ndarray,
                     rx_pos: np.ndarray,
                     sv_idx: np.ndarray, active: np.ndarray,
                     g0_sec: np.ndarray, g0_week: np.ndarray,
                     rho0_range: np.ndarray,
                     dt: float = 0.1, rho=None, rho_in_slots: bool = False):
    """Full epoch solve for one superframe.

    g_secs/g_weeks [n_epochs]: epoch grid t_0..t_M GPS time (t_0 = anchor
      carried from the previous superframe / allocation).
    rx_pos [n_epochs, 3], sv_idx [C] satellite index per channel (0-based,
      arbitrary for inactive channels), active [C] bool, g0_sec/g0_week
      [C] each channel's data-bit reference time (inactive slots must
      hold a sane nearby time so masked lanes stay finite),
      rho0_range [C] override pseudorange anchor at t_0 (carried across
      superframes / from allocation, possibly computed with the previous
      ephemeris set at rollovers — reference c:2774-2790 semantics).

    rho: optional precomputed solve_ranges output for this exact grid
      (batched Monte-Carlo planes compute it once for all receivers).
    rho_in_slots: the precomputed rho's satellite axis is already in
      CHANNEL-SLOT order (solved from an sv_idx-gathered ephemeris —
      the scheduler's plan_group fast path), so no per-channel gather
      is applied here; columns are bit-identical either way (the solve
      is vmapped elementwise per satellite).

    Returns (params dict [n_blocks, C], carry dict for the next superframe).
    """
    if rho is None:
        rho = solve_ranges_lean(eph, ionoutc, g_secs, rx_pos)
    cols = slice(None) if rho_in_slots else sv_idx
    rng = np.asarray(rho["range"])[:, cols]          # [n_epochs, C]
    d = np.asarray(rho["d"])[:, cols]
    azel = np.asarray(rho["azel"])[:, cols, :]
    el = azel[..., 1]

    # anchor override at t_0 (cross-superframe continuity)
    rng = rng.copy()
    rng[0] = np.where(active, rho0_range, rng[0])
    params = ranges_to_params(rng, d, el, np.asarray(g_secs, np.float64),
                              np.asarray(g_weeks, np.float64),
                              np.asarray(g0_sec, np.float64),
                              np.asarray(g0_week, np.float64), dt)
    params["active"] = np.broadcast_to(active, params["f_carr"].shape).copy()
    params["azel"] = azel[1:]  # per-block az/el (epoch k+1), for logging
    # anchor-epoch pseudoranges (override applied): the scheduler's
    # closed-form carrier phase c0[k] = frac(cb - (rng0[k] - ra)/lambda)
    # telescopes the f_carr chain exactly (scheduler.py plan())
    params["rng0"] = rng[:-1].copy()

    carry = {
        "rho0_range": rng[-1],     # anchor for the next superframe's t_0
        "azel_last": azel[-1],
    }
    return params, carry
