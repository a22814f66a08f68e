"""Composite GPS L1 C/A IQ synthesis: the Hopper kernel's wrapper, its
plain PyTorch twin, and the host packing that feeds them.

The counterpart of the JAX package's ``ops/synth_pallas.py``.  One CUDA
kernel (``csrc/synth_blocks.cu``, replacing the Pallas TPU kernel
``synth_pallas.py::_kernel``) evaluates, per (block, sample) and for all
12 channel slots, the closed-form NCOs and mixes them into packed int16
IQ (the math is in ``docs/KERNEL_MATH.md``):

  carrier   floor uint32 NCO + Q12-seeded step-quantization residual:
            phase = floor_u32(phase0) + step_u32*n
                  + ((sr12*n + cq12 + trunc(srem*n)) >> 12)
            LUT index = phase >> 23 replicates floor(carr_phase*512)
            (c:2697) as an exact floor of the f64 phase down to the f32
            trunc level (2^-12 u32 units)
  code      four-level integer NCO:
            chips*4096 = cp0_q12 + v_q12*n + ((res0_q24 + r24*n
                       + ((res0_q36 + r36*n + trunc(rrr*n)) >> 12)) >> 12)
            truncation at 2^-36 chips, the f64 closed form's own floor
  nav bits  a per-(block, channel) 32-bit mask indexed by
            q = (icode0 + code_periods)//20 (c:2732)
  C/A chips bit-packed: 1023 chips -> 32 uint32 words per channel row
  mixing    one lookup per channel and sample in a 512-entry biased pair
            table (cos+512) | (sin+512) << 16, which the TPU kernel
            rebuilt from a 128-entry quadrant table by exact identities
            (_check_quadrant_identities proves both bit-identical);
            gain scaling iv = trunc(f32(T)*f32(gain)); the spreading sign
            (chip XOR nav bit) complements around a 1024 bias per channel
            so I (low 16 bits) and Q (high 16) share one int32 accumulator.
            The TPU kernel evaluated the gain product per sample; the
            CUDA kernel and the twin read it, signed, from a per-row
            table (gain_sign_table_plain) indexed by itab | sign << 9,
            built with the same expression, so the sum is the same word
  patches   up to 7 gain-trunc patch words per block, each +-1 where the
            LUT value equals the patched magnitude (see _SLOT_I)
  output    un-bias with the in-kernel count of executed channels, pack
            (I & 0xffff) | (Q << 16) — memory-identical to the reference's
            interleaved little-endian int16 stream (c:2754) — or emit
            separate int32 I and Q (packed=False)

All per-(block, channel) parameters are packed into two [M, 256] planes
(int32 and float32, 2 KB per block): lanes 0..127 hold the per-channel
params, lanes 128..255 the gain-trunc patch slots.  The planes, the
bit-packed C/A tables and the block->superframe map are byte-identical
to the JAX package's, so either package's host output feeds the other's
kernel.

``synth_blocks`` launches the CUDA kernel for CUDA tensors and runs
``synth_blocks_plain`` — the same integer and f32 op sequence in torch,
emulating uint32 with int64 — only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..constants import CA_SEQ_LEN, MAX_CHAN
from ..models.tables import COS_TABLE_512, SIN_TABLE_512

__all__ = ["synth_blocks", "synth_blocks_plain", "gain_sign_table_plain",
           "build_block_params", "build_group_params", "pack_ca_tables",
           "unpack_iq", "BlockParams", "MAX_BLOCK_SAMPLES",
           "MAX_KERNEL_SAMPLES", "launch_count", "reset_launch_count"]

# Q24 code-NCO range bound: the per-sample integer residual ramp r24*n
# (r24 <= 4095) must stay inside int32, so blocks are capped at 524k
# samples — fs <= 5.24 MHz at 0.1 s blocks (the reference's RF path also
# caps at 5 MHz, c:2372-2375)
MAX_BLOCK_SAMPLES = 524_000

# parameter planes are [M, 2*_LANES]: lanes 0..127 hold the per-channel
# params (the column bases below), lanes 128..255 the packed patch slots
_LANES = 128
_C = MAX_CHAN

# packed-parameter column bases (x12 channels each); ints and floats in
# separate planes (the layout the JAX package's Pallas kernel reads)
_P_PHASE0, _P_STEP, _P_CP0Q, _P_VQ, _P_NBM, _P_IC0 = 0, 12, 24, 36, 48, 60
_P_RES0Q24, _P_R24 = 72, 84
_P_RES0Q36, _P_R36 = 96, 108
# carrier step residual: sr12 = floor(stepres*4096) carried as f32
# (exact, |sr12| <= 2048) and its [0,1) f32 remainder.  One f32 level
# (trunc(stepres*n), error up to +-1 u32 unit) was enough for SNR but
# made Doppler-resonant blocks — frac(f_carr/fs)*512 within ~1e-3 of an
# integer — collect ~2k adjacent-LUT picks per block; the Q12 level puts
# the ramp error at 2^-12 units.  CQ12 is the sub-unit Q12 digit of the
# FLOORed phase anchor, seeding the residual cascade: a round()ed anchor
# sat up to 0.5 u32 units off the f64 phase, flipping the 9-bit LUT
# index on boundary-straddling samples (~124 components per 990-block
# run); with floor + seed the integer phase is an exact floor of the
# f64 phase down to the f32 trunc level (~0.03 per 990 blocks).
_F_SR12, _F_SREM, _F_CQ12, _F_RRR, _F_GAIN = 0, 12, 24, 36, 48
# gain-trunc patch slots: the kernel's per-sample iv = trunc(f32(T)*f32(g))
# differs from the f64 tables' trunc(T*g) by exactly +-1 on LUT entries
# whose product lands within f32 rounding of an integer (~0.02 entries
# per block, measured).  build_block_params detects every such entry
# host-side (f32 prefilter + exact f64 check over the 223 distinct
# magnitudes), first NUDGES the f32 gain lane a few ulps to clear
# same-direction bursts outright (the nudge pass; this retired slot
# overflow as a correctness hole in round 5 — drops measure 0 on the
# bench deep scenario and the hour soak), and emits one patch word per
# surviving (entry, half); the kernel applies them in a patch pass that
# almost no block enters, so the fused path reproduces the f64 tables
# bit-for-bit at ~zero cost.
# Word encoding (f32-exact integer, 0 = empty slot):
#   bits [15:6] |T| magnitude, [5:2] channel, [1] half (0=I,1=Q),
#   [0] delta sign (0 -> +1, 1 -> -1)
_N_PATCH = 7

# Patch slot k's data lives in the plane's second half at lanes
# 128 + W*k (W = _SLOT_I_W ints, _SLOT_F_W floats): the owning
# channel's params at static offsets plus the patch word itself.  The
# CUDA kernel reads the slots there directly (the TPU kernel expanded
# them into sublane rows first, a Mosaic lowering constraint).
_SLOT_I = {_P_PHASE0: 0, _P_STEP: 1, _P_CP0Q: 2, _P_VQ: 3, _P_NBM: 4,
           _P_IC0: 5, _P_RES0Q24: 6, _P_R24: 7, _P_RES0Q36: 8, _P_R36: 9}
_SLOT_I_W = 10
_SLOT_F = {_F_SR12: 0, _F_SREM: 1, _F_CQ12: 2, _F_RRR: 3, _F_GAIN: 4}
_SLOT_WORD = 5            # float slot lane holding the patch word
_SLOT_F_W = 6
assert _SLOT_I_W * _N_PATCH <= _LANES and _SLOT_F_W * _N_PATCH <= _LANES


def patch_word_lane(k: int) -> int:
    """Lane of patch slot k's word in the packed [M, 256] float plane."""
    return _LANES + _SLOT_F_W * k + _SLOT_WORD

# chip // 1023: the TPU kernel multiplies by 1/1023 rounded UP in f32,
# trunc(f32(chip) * _INV1023); the CUDA kernel and the twin take the
# multiply-high (chip * _DIV1023) >> 32 with _DIV1023 = ceil(2^32/1023).
# Both equal chip // 1023 for every chip < 2^20, i.e. every value a u32
# tq >> 12 can take (tests/test_torch_synth_tables.py checks all of them)
_INV1023 = np.float32(np.nextafter(np.float32(1.0 / 1023.0),
                                   np.float32(np.inf)))
_DIV1023 = 0x401005

# distinct nonzero |T| over both LUT halves, for the gain-trunc patch
# detector (see _SLOT_I): trunc is odd, so checking each magnitude once
# covers all four quadrant entries carrying +-T
_MAGS64 = np.unique(np.abs(np.concatenate(
    [np.asarray(COS_TABLE_512, np.int64),
     np.asarray(SIN_TABLE_512, np.int64)])))
_MAGS64 = _MAGS64[_MAGS64 > 0].astype(np.float64)
_MAGS32 = _MAGS64.astype(np.float32)     # exact: magnitudes are <= 512
# gain-nudge search radius, in f32 ulps of the gain (see the nudge pass
# in build_block_params): each gain ulp moves every product by ~2-4
# product-ulps, so +-4 ulps sweeps +-~8 product-ulps — far more than the
# half-ulp rounding window a mismatch sits in
_NUDGE_ULPS = 4
_MAG_IN_COS = np.isin(_MAGS64.astype(np.int64),
                      np.abs(np.asarray(COS_TABLE_512, np.int64)))
_MAG_IN_SIN = np.isin(_MAGS64.astype(np.int64),
                      np.abs(np.asarray(SIN_TABLE_512, np.int64)))


class BlockParams(NamedTuple):
    """build_block_params output: the two packed parameter planes plus
    per-call accounting.  patch_dropped counts gain-trunc patch words
    dropped to the per-block slot cap (_N_PATCH) — each dropped word
    leaves one LUT entry at the kernel's f32 trunc, a +-1 LSB effect on
    that block's dwell samples.  Returned (not a module global) so
    concurrent streams / Monte-Carlo batches / sharded hosts can each
    attribute their own drops (IqStream.patch_dropped aggregates)."""

    prmi: np.ndarray           # [M, 256] int32 parameter plane
    prmf: np.ndarray           # [M, 256] float32 parameter plane
    patch_dropped: int


def build_block_params(dp, nudge: bool = True) -> BlockParams:
    """ops.synth_jnp.DevicePlan -> packed ([M,256] i32, [M,256] f32)
    parameter planes + the call's dropped-patch count (BlockParams).

    nudge=True (production default) resolves gain-trunc mismatches by
    moving the f32 gain lane a few ulps (see the nudge pass below)
    before falling back to patch words; nudge=False pins the pure
    patch-word path (kept for the overflow-degradation regression
    tests)."""
    return build_group_params([dp], nudge=nudge)


def build_group_params(dps: list, nudge: bool = True) -> BlockParams:
    """build_block_params over a whole dispatch group in ONE pass.

    The per-superframe form ran ~60 numpy ops on [300, 12] arrays whose
    per-op dispatch overhead dominated on a 1-core host (~1.9 ms per
    superframe, on the pipelined stream's host-bound critical path);
    concatenating the group's plans first amortizes that overhead over
    K superframes (~4x at K=8).  Output planes are bit-identical to
    concatenating per-plan build_block_params results: every step is
    row-independent elementwise math except the nav-bit table pack,
    which stays per-superframe (each superframe has its own bits
    table), and the gain-interval patch prefilter, whose wider
    per-group intervals only admit MORE candidate pairs into the exact
    f32 trigger check (the trigger itself is unchanged)."""
    assert dps, "empty dispatch group"
    block_samples = dps[0].block_samples
    assert all(d.block_samples == block_samples for d in dps), \
        "dispatch group mixes block sizes"
    # Q24 residual ramp bound: r24*n must stay inside int32
    assert block_samples <= MAX_BLOCK_SAMPLES, \
        "block too long for the Q24 code NCO (needs <=5.24 MHz at 0.1 s blocks)"
    act = np.concatenate([d.active for d in dps], axis=0)
    gain64 = np.concatenate([d.gain for d in dps], axis=0)
    v = np.concatenate([d.v for d in dps], axis=0)
    # the JAX package's bound, kept so both refuse the same plans: the TPU
    # kernel's f32 reciprocal division is exact only for chip < 600k
    assert float(np.max(np.abs(v))) <= 1.1, \
        "code rate out of range for the kernel's chip arithmetic"
    # biased-accumulator budget: |trunc(table*gain)| <= 1024
    assert float(np.max(np.abs(gain64))) <= 2.0, \
        "channel gain out of range for the biased packed accumulator"
    M, C = act.shape
    c0 = np.where(act, np.concatenate([d.c0 for d in dps], axis=0), 0.0)
    u = np.where(act, np.concatenate([d.u for d in dps], axis=0), 0.0)
    cp0 = np.where(act, np.concatenate([d.cp0 for d in dps], axis=0), 0.0)
    v = np.where(act, v, 0.0)

    # FLOOR anchor + sub-unit Q12 digit (see _F_CQ12 comment): the f64
    # product frac(c0)*2^32 is exact (power-of-two scale), so both the
    # integer anchor and its Q12 digit are exact digit extractions
    phase0_f = (c0 - np.floor(c0)) * 2.0**32
    phase0 = np.floor(phase0_f).astype(np.int64)
    cq12 = np.floor((phase0_f - phase0) * 4096.0).astype(np.float32)
    step_exact = (u - np.floor(u)) * 2.0**32
    step = np.round(step_exact).astype(np.int64)
    phase0_u32 = (phase0 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    step_u32 = (step & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    # two-level carrier step residual (see _F_SR12 comment)
    sres = (step_exact - step) * 4096.0          # f64, |.| <= 2048
    sr12 = np.floor(sres)
    srem = (sres - sr12).astype(np.float32)      # [0, 1)
    sr12 = sr12.astype(np.float32)               # exact: |sr12| <= 2048

    cp0q = np.floor(cp0 * 4096.0)
    f12 = cp0 * 4096.0 - cp0q                 # q12 fraction in [0, 1)
    res0q24 = np.floor(f12 * 4096.0)
    res0q36 = np.floor((f12 * 4096.0 - res0q24) * 4096.0)
    vq = np.floor(v * 4096.0)
    r4 = v * 4096.0 - vq                      # q12 residual per sample
    r24 = np.floor(r4 * 4096.0)               # q24 integer step
    r4b = r4 * 4096.0 - r24                   # q24 fraction in [0, 1)
    r36 = np.floor(r4b * 4096.0)              # q36 integer step
    rrr = ((r4b - r36 / 4096.0) * 4096.0).astype(np.float32)  # 4th level

    # nav-bit mask: bit q = 0/1 value of nav bit at index B0 + q
    b0 = np.where(act, np.concatenate([d.b0 for d in dps], axis=0), 0)
    ic0 = np.where(act, np.concatenate([d.ic0 for d in dps], axis=0),
                   0).astype(np.int32)
    # enforce the 32-bit mask width: q = (ic0 + code_periods)//20 must
    # stay < 32 for every sample of the block (worst case today is 29)
    max_w = (cp0 + np.abs(v) * block_samples) // CA_SEQ_LEN
    assert int(np.max((ic0 + max_w) // 20)) < 32, \
        "nav-bit index exceeds the 32-bit per-block mask"
    # bit q of the mask = nav bit at B0+q as 0/1 (+1 -> 0, -1 -> 1).
    # Pack each channel's 1800 bits ONCE per superframe (replicating the
    # final bit so windows straddling the end reproduce the old
    # clip-to-last-bit semantics), assemble a sliding uint64 view over
    # the packed bytes, and extract every block's 32-bit window with a
    # [M, C] gather + shift — O(C*1800) setup instead of the O(M*C*32)
    # per-bit gather + packbits this replaces (which was itself ~2x
    # cheaper than the shift-or loop before it; this is another ~10x,
    # this function sits on the host-bound pipelined critical path).
    # This stage is the one per-SUPERFRAME part of the group pass: each
    # superframe has its own bits table.
    nbmask = np.empty((M, C), np.int32)
    row = 0
    v64_cache: dict = {}   # Monte-Carlo receivers on a shared clock and
    # NavCache carry byte-identical bits tables, so the packed sliding
    # view dedups across the B x n_superframes segments (stream groups
    # have distinct tables per superframe — the cache is a no-op there)
    for d in dps:
        m_sf = d.active.shape[0]
        # the old per-bit form clipped b0+q to the table end; clamp b0
        # the same way so an out-of-range start reads the replicated
        # final bit
        b0s = np.minimum(b0[row:row + m_sf], d.bits.shape[1] - 1)
        key = d.bits.tobytes()
        v64 = v64_cache.get(key)
        if v64 is None:
            bits01 = d.bits < 0                            # [C, n_bits]
            ext = np.concatenate(
                [bits01, np.repeat(bits01[:, -1:], 39, axis=1)], axis=1)
            pb = np.packbits(ext, axis=1, bitorder="little")  # [C, /8]
            pb = np.concatenate([pb, np.zeros((C, 7), np.uint8)], axis=1)
            sw = np.lib.stride_tricks.sliding_window_view(pb, 8, axis=1)
            # explicit little-endian byte assembly (endian-neutral,
            # unlike a .view(uint64) of host-order bytes)
            v64 = (sw.astype(np.uint64)
                   << (np.uint64(8) * np.arange(8, dtype=np.uint64))).sum(
                       axis=2, dtype=np.uint64)            # [C, n_wins]
            v64_cache[key] = v64
        win = v64[np.arange(C)[None, :], b0s >> 3]         # [m_sf, C]
        nbmask[row:row + m_sf] = (
            (win >> (b0s & 7).astype(np.uint64))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        row += m_sf
    assert row == M

    gain = np.where(act, gain64, 0.0).astype(np.float32)

    # ---- gain-trunc patch words (see _SLOT_I) -----------------------------
    # f32 prefilter: a trunc mismatch needs |T*g| within |p32 - p64| <=
    # p*2^-23.6 <= 2^-13.6 of an integer, so products whose f32 value sits
    # >= 2^-12 from every integer are provably clean; the exact f64-vs-f32
    # comparison runs only on the surviving ~1e-4 of entries.  Cost control
    # (the pipelined stream is host-bound): active pairs only, round via
    # the 1.5*2^23 magic add (exact rint for |p| < 2^22), and a per-pair
    # any() reduction before materializing candidate indices.
    patch = np.zeros((M, _N_PATCH), np.float32)
    slot_owner = []                                # (block, slot, channel)
    dropped = 0
    # Interval exoneration first (the pipelined stream is host-bound and
    # the old dense [active pairs x 223] f32 sweep was ~30% of this
    # function): over one superframe a channel's gain spans a narrow
    # interval, so T*g can only straddle an integer if that interval
    # (widened by delta = 2^-11, a strict bound on the f32 prefilter's
    # |p32 - p64| <= p*2^-23 + 2^-12 trigger window) contains one.
    # ~12x223 f64 interval tests replace ~2100x223 f32 products; the
    # dense test runs only on the surviving (channel, magnitude) pairs.
    # Intervals are taken PER SUPERFRAME segment (not over the whole
    # group): a channel's gain spans ~1e-4 over 30 s but sweeps wide
    # over a K=8 group, and group-wide intervals admitted hundreds of
    # false-positive pairs into the dense pass (measured as a 2x cost
    # regression when this function first went group-batched).
    delta = 2.0 ** -11
    cand = []                            # (m, c, j); sorted() below owns order
    magic = np.float32(12582912.0)                 # 1.5 * 2^23
    row = 0
    for d in dps:
        m_sf = d.active.shape[0]
        seg = slice(row, row + m_sf)
        acts = act[seg]
        gmin = np.min(np.where(acts, gain64[seg], np.inf), axis=0)   # [C]
        gmax = np.max(np.where(acts, gain64[seg], -np.inf), axis=0)
        plo = gmin[:, None] * _MAGS64[None, :] - delta         # [C, 223]
        phi = gmax[:, None] * _MAGS64[None, :] + delta
        has_int = (np.floor(phi) >= np.ceil(plo)) \
            & acts.any(axis=0)[:, None]
        cs, js = np.nonzero(has_int)     # surviving (channel, mag) pairs
        if cs.size:
            # one [m_sf, n_pairs] f32 pass over every surviving pair at
            # once (the f32 product expression is unchanged, so the
            # candidate set is identical to the old per-channel sweep);
            # inactive blocks have gain 0 -> frac 0, masked out by act
            p32 = gain[seg][:, cs] \
                * _MAGS64[js].astype(np.float32)[None, :]
            frac = p32 - ((p32 + magic) - magic)
            near = (np.abs(frac) < np.float32(2.0 ** -12)) & acts[:, cs]
            for mi, pi in zip(*np.nonzero(near)):
                cand.append((row + int(mi), int(cs[pi]), int(js[pi])))
        row += m_sf
    # exact f64-vs-f32 trunc check, vectorized over the few candidates
    # (a scalar-numpy loop here cost ~50 us per candidate)
    cand.sort()
    deltas = []
    if cand:
        ca_ = np.array(cand, np.int64)               # [n, 3] (m, c, j)
        gg_ = gain64[ca_[:, 0], ca_[:, 1]]
        t64 = np.trunc(_MAGS64[ca_[:, 2]] * gg_)
        t32 = np.trunc(_MAGS64[ca_[:, 2]].astype(np.float32)
                       * gg_.astype(np.float32))
        deltas = (t64 - t32.astype(np.float64)).astype(np.int64)

    # ---- gain nudging: eliminate mismatches instead of patching them ------
    # A mismatching (block, channel) almost always mismatches because its
    # gain sits within ~2^-25 of a rational p/q: every LUT magnitude that
    # is a multiple of q straddles an integer in the SAME direction, so
    # moving the f32 gain LANE a few ulps toward the f64 side clears all
    # of them at once (the kernel's product is trunc(f32(T)*f32(lane)),
    # so the lane value — not f32(g64) — is the free variable; the f64
    # target truncs trunc(T*g64) are untouched).  Each candidate lane is
    # verified host-side against ALL 223 magnitudes, and the one with the
    # fewest residual mismatches (ties: smallest |ulp| step, so behavior
    # is unchanged wherever the nudge cannot help) is kept; residuals —
    # only mixed-direction straddles, measured 0 on the bench deep
    # scenario and the hour soak — still get patch words below.  This is
    # what retired the _N_PATCH overflow as a correctness hole: the old
    # worst case (g ~ 17/31 - 3e-9, 32 same-direction words, 25 dropped)
    # nudges to zero.
    fixes: list[tuple[int, int, int, int]] = []      # (m, c, j, delta)
    if nudge:
        by_mc: dict[tuple[int, int], bool] = {}
        for (m, c, j), d in zip(cand, deltas):
            if d != 0:
                by_mc[(m, c)] = True
        for m, c in sorted(by_mc):
            g64 = gain64[m, c]
            t64_all = np.trunc(_MAGS64 * g64)
            # all 2*_NUDGE_ULPS+1 candidate lanes in one vector pass,
            # then pick by (mismatch count, |ulp| step) preference
            g0 = np.float32(g64)
            ups = [g0]
            dns = [g0]
            for _ in range(_NUDGE_ULPS):
                ups.append(np.nextafter(ups[-1], np.float32(np.inf)))
                dns.append(np.nextafter(dns[-1], np.float32(-np.inf)))
            order = [g0]
            for k in range(1, _NUDGE_ULPS + 1):
                order += [ups[k], dns[k]]
            gc_arr = np.array(order, np.float32)              # [9]
            d_all = t64_all[None, :] \
                - np.trunc(_MAGS32[None, :] * gc_arr[:, None]
                           ).astype(np.float64)               # [9, 223]
            counts = np.count_nonzero(d_all, axis=1)
            best = int(np.argmin(counts))   # argmin = first = smallest |k|
            gain[m, c] = gc_arr[best]
            for j in np.nonzero(d_all[best])[0]:
                fixes.append((m, c, int(j), int(d_all[best, j])))
    else:
        fixes = [(m, c, j, int(d))
                 for (m, c, j), d in zip(cand, deltas) if d != 0]
    # fill slots in the dense sweep's (block, channel, magnitude) order
    # so slot assignment/overflow behavior is unchanged
    fixes.sort()
    nslot = np.zeros(M, np.int32)
    for m, c, j, d in fixes:
        # truncs of two reals within 2^-12 differ by at most 1
        assert abs(d) == 1, "gain-trunc delta out of range"
        for half, member in ((0, _MAG_IN_COS[j]),
                             (1, _MAG_IN_SIN[j])):
            if not member:
                continue
            k = int(nslot[m])
            # with nudging, residual words are rare mixed-direction
            # straddles (0-2 per block); without it (nudge=False), a
            # gain within ~2^-25 of a small rational p/q flips MANY
            # multiples of q at once (measured: g ~ 17/31 - 3e-9 -> 32
            # words; q=3 could need ~148).  Overflow degrades
            # gracefully: the dropped entries keep the kernel's
            # f32 trunc, a +-1 LSB effect on one block's dwell
            # samples (~95+ dB), counted in the returned
            # BlockParams.patch_dropped.
            if k >= _N_PATCH:
                dropped += 1
                continue
            patch[m, k] = float(
                (int(_MAGS64[j]) << 6) | (c << 2)
                | (half << 1) | (1 if d < 0 else 0))
            slot_owner.append((m, k, c))
            nslot[m] = k + 1

    prmi = np.zeros((M, 2 * _LANES), dtype=np.int32)
    prmf = np.zeros((M, 2 * _LANES), dtype=np.float32)
    prmi[:, _P_PHASE0:_P_PHASE0 + C] = phase0_u32
    prmi[:, _P_STEP:_P_STEP + C] = step_u32
    prmi[:, _P_CP0Q:_P_CP0Q + C] = cp0q.astype(np.int32)
    prmi[:, _P_VQ:_P_VQ + C] = vq.astype(np.int32)
    prmi[:, _P_NBM:_P_NBM + C] = nbmask
    prmi[:, _P_IC0:_P_IC0 + C] = ic0
    prmi[:, _P_RES0Q24:_P_RES0Q24 + C] = res0q24.astype(np.int32)
    prmi[:, _P_R24:_P_R24 + C] = r24.astype(np.int32)
    prmi[:, _P_RES0Q36:_P_RES0Q36 + C] = res0q36.astype(np.int32)
    prmi[:, _P_R36:_P_R36 + C] = r36.astype(np.int32)
    prmf[:, _F_SR12:_F_SR12 + C] = sr12
    prmf[:, _F_SREM:_F_SREM + C] = srem
    prmf[:, _F_CQ12:_F_CQ12 + C] = cq12
    prmf[:, _F_RRR:_F_RRR + C] = rrr
    prmf[:, _F_GAIN:_F_GAIN + C] = gain
    # patch slots: the word plus copies of the owning channel's params
    # at the slot's static lanes (see _SLOT_I/_SLOT_F)
    for m, k, c in slot_owner:
        for base, j in _SLOT_I.items():
            prmi[m, _LANES + _SLOT_I_W * k + j] = prmi[m, base + c]
        for base, j in _SLOT_F.items():
            prmf[m, _LANES + _SLOT_F_W * k + j] = prmf[m, base + c]
        prmf[m, _LANES + _SLOT_F_W * k + _SLOT_WORD] = patch[m, k]
    return BlockParams(prmi, prmf, dropped)


def unpack_iq(packed, block_samples: int | None = None) -> np.ndarray:
    """Packed int32 IQ [..., S] -> interleaved int16 [..., S', 2].

    The kernel packs (I & 0xffff) | (Q << 16) per sample (see module
    docstring); this is the one inverse every consumer shares.
    block_samples trims each row's tile padding first.

    On little-endian hosts the packed word's bytes ARE the interleaved
    int16 pair ([I_lo, I_hi, Q_lo, Q_hi]), so the unpack is one
    contiguous copy + reinterpreting view — ~4x less memory traffic
    than the mask/shift/stack form (which remains as the big-endian
    fallback); the delivered-IQ path runs this over the full stream."""
    packed = np.asarray(packed)
    if block_samples is not None:
        packed = packed[..., :block_samples]
    if sys.byteorder == "little":
        out = np.ascontiguousarray(packed)
        return out.view(np.int16).reshape(*out.shape, 2)
    return np.stack(
        [(packed & 0xFFFF).astype(np.uint16).view(np.int16),
         (packed >> 16).astype(np.int16)], axis=-1)


def pack_ca_tables(ca2_list: list[np.ndarray]) -> np.ndarray:
    """Per-superframe +-1 C/A tables -> bit-packed [NS, C, 1, 128] int32.

    Chip k lives in bit (k & 31) of word (k >> 5); bit 1 encodes chip -1
    (sign = 1 - 2*bit).  Words 32..127 are zero padding."""
    ns = len(ca2_list)
    ca2 = np.stack(ca2_list)                              # [NS, C, 1023]
    bits01 = (1 - ca2.astype(np.int64)) // 2              # -1 -> 1, +1 -> 0
    bits01 = np.concatenate(
        [bits01, np.zeros((ns, _C, 32 * 32 - CA_SEQ_LEN), np.int64)],
        axis=-1).reshape(ns, _C, 32, 32)
    words = (bits01 << np.arange(32, dtype=np.int64)).sum(axis=-1)
    out = np.zeros((ns, _C, 1, _LANES), dtype=np.int64)
    out[:, :, 0, :32] = words
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


# quadrant-0 raw pair table: (cos[j]+512) | (sin[j]+512)<<16, j in [0,128)
_RAWTAB = ((((np.asarray(COS_TABLE_512[:128], np.int64) + 512)
             | ((np.asarray(SIN_TABLE_512[:128], np.int64) + 512) << 16))
            & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
           .reshape(1, _LANES))


def _check_quadrant_identities() -> None:
    """The kernel reconstructs all 512 LUT entries from the 128-entry
    quadrant-0 table via exact identities of the reference's hand-written
    int tables (cos[128+j] = 2-sin[j], sin[128+j] = cos[j], half-wave
    x[256+i] = 2-x[i]) plus the single cos[384] exception.  Assert the
    full reconstruction at import time so any table regeneration that
    breaks the identities fails loudly instead of silently degrading
    bit-exactness."""
    raw = _RAWTAB.reshape(-1).view(np.uint32).astype(np.int64)
    want = (((np.asarray(COS_TABLE_512, np.int64) + 512)
             | ((np.asarray(SIN_TABLE_512, np.int64) + 512) << 16))
            & 0xFFFFFFFF)
    got = np.empty(512, np.int64)
    for itab in range(512):
        j = itab & 127
        p = raw[j]
        if (itab >> 7) & 1:                      # swap + complement low
            rot = ((p << 16) | (p >> 16)) & 0xFFFFFFFF
            p = (rot + 1026 - 2 * (rot & 0xFFFF)) & 0xFFFFFFFF
        if itab >> 8:                            # half-wave complement
            p = ((1026 | (1026 << 16)) - p) & 0xFFFFFFFF
        if itab == 384:                          # hand-written exception
            p = (p - 1) & 0xFFFFFFFF
        got[itab] = p
    assert np.array_equal(got, want), \
        "sin/cos tables no longer satisfy the kernel's quadrant identities"


_check_quadrant_identities()


# full 512-entry biased pair table the CUDA kernel and the twin read:
# (cos[i]+512) | (sin[i]+512)<<16, bit-identical to the quadrant
# reconstruction from _RAWTAB that _check_quadrant_identities asserts
_PAIRTAB = ((((np.asarray(COS_TABLE_512, np.int64) + 512)
              | ((np.asarray(SIN_TABLE_512, np.int64) + 512) << 16))
             & 0xFFFFFFFF).astype(np.uint32).view(np.int32))

# the TPU kernel's _INV1023 bits, and the CUDA source's kDiv1023
assert int(np.array(_INV1023).view(np.uint32)) == 0x3A802009
assert _DIV1023 == -(-2**32 // CA_SEQ_LEN)

# the NCO ramps stay inside their 32-bit ranges only for sample indices
# n < 524288: the Q36 residual res0 + r*n + trunc(rrr*n) (each term
# <= 4095, 4095*n, n-1) fits int32 only for n <= (2^31-1-4095)/4096
MAX_KERNEL_SAMPLES = 524_288

_PLANE = 2 * _LANES

# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """CUDA kernel launches made by synth_blocks since the last reset."""
    with _count_lock:
        return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _count_launch() -> None:
    global _launches
    with _count_lock:
        _launches += 1


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

def _as_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a tensor or ndarray, got {type(a)!r}")
    if a.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {a.dtype}")
    return a


def _check_args(prmi, prmf, ca_tabs, sf_map, block_samples: int):
    prmi = _as_tensor(prmi, torch.int32)
    prmf = _as_tensor(prmf, torch.float32)
    ca_tabs = _as_tensor(ca_tabs, torch.int32)
    sf_map = _as_tensor(sf_map, torch.int32)
    m = prmi.shape[0]
    if prmi.shape != (m, _PLANE) or prmf.shape != (m, _PLANE):
        raise ValueError(f"parameter planes must be [M, {_PLANE}], got "
                         f"{tuple(prmi.shape)} and {tuple(prmf.shape)}")
    if ca_tabs.dim() != 4 or ca_tabs.shape[1:] != (_C, 1, _LANES) \
            or ca_tabs.shape[0] < 1:
        raise ValueError(f"ca_tabs must be [NS, {_C}, 1, {_LANES}], got "
                         f"{tuple(ca_tabs.shape)}")
    if sf_map.shape != (m,):
        raise ValueError(f"sf_map must be [{m}], got {tuple(sf_map.shape)}")
    if not 1 <= block_samples <= MAX_KERNEL_SAMPLES:
        raise ValueError(f"block_samples {block_samples} outside "
                         f"[1, {MAX_KERNEL_SAMPLES}] (split the plan)")
    dev = prmi.device
    if any(t.device != dev for t in (prmf, ca_tabs, sf_map)):
        raise ValueError("synth_blocks inputs lie on different devices")
    if not all(t.is_contiguous() for t in (prmi, prmf, ca_tabs, sf_map)):
        raise ValueError("synth_blocks inputs must be contiguous")
    if dev.type == "cpu":
        check_sf_map(sf_map, ca_tabs.shape[0])
    return prmi, prmf, ca_tabs, sf_map


def check_sf_map(sf_map, n_sf: int) -> None:
    """Raise unless every entry of a host-resident sf_map lies in
    [0, n_sf).  The wrapper checks CPU inputs itself; a caller staging
    the map to the card checks it here first, since reading a device
    map back would synchronize (the kernel traps on an entry out of
    range rather than read another table)."""
    sf = np.asarray(sf_map)
    if sf.size and (int(sf.min()) < 0 or int(sf.max()) >= n_sf):
        raise ValueError(f"sf_map entries must lie in [0, {n_sf})")


_pair_lock = threading.Lock()
_pair_on: dict[torch.device, torch.Tensor] = {}


def _pairtab_on(device: torch.device) -> torch.Tensor:
    with _pair_lock:
        t = _pair_on.get(device)
        if t is None:
            t = torch.from_numpy(_PAIRTAB.copy()).to(device)
            _pair_on[device] = t
        return t


@functools.cache
def _cuda_lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from .cuda_build import load_kernel
    lib = load_kernel("synth_blocks")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.synth_blocks_launch.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.synth_blocks_launch.restype = ci
    lib.synth_blocks_error_string.argtypes = [ci]
    lib.synth_blocks_error_string.restype = ctypes.c_char_p
    return lib


def synth_blocks(prmi, prmf, ca_tabs, sf_map, block_samples: int,
                 packed: bool = True):
    """Synthesize M blocks of composite IQ.

    prmi/prmf: [M, 256] int32 / float32 parameter planes
    (build_group_params); ca_tabs: [NS, 12, 1, 128] int32 bit-packed C/A
    tables (pack_ca_tables); sf_map: [M] int32 block -> superframe index
    into ca_tabs, each in [0, NS) (checked here for CPU inputs; stage a
    map to the card only after check_sf_map).  Returns packed int32 IQ
    [M, block_samples], or the int32 pair (I, Q) when packed=False.

    CUDA tensors launch the CUDA kernel on the current stream (the
    output is allocated with torch.empty and not synchronized); a build
    or launch failure raises, a refused request for the kernel's 48 KB
    of dynamic shared memory included.  CPU tensors (or numpy arrays)
    run the plain twin synth_blocks_plain.  There is no other fallback."""
    block_samples = int(block_samples)
    prmi, prmf, ca_tabs, sf_map = _check_args(prmi, prmf, ca_tabs, sf_map,
                                              block_samples)
    dev = prmi.device
    if dev.type == "cpu":
        return synth_blocks_plain(prmi, prmf, ca_tabs, sf_map,
                                  block_samples, packed=packed)
    if dev.type != "cuda":
        raise ValueError(f"synth_blocks runs on cuda or cpu, not {dev}")
    m = prmi.shape[0]
    out0 = torch.empty((m, block_samples), dtype=torch.int32, device=dev)
    out1 = (out0 if packed else
            torch.empty((m, block_samples), dtype=torch.int32, device=dev))
    if m == 0:
        return out0 if packed else (out0, out1)
    lib = _cuda_lib()
    with torch.cuda.device(dev):
        pair = _pairtab_on(dev)
        stream = torch.cuda.current_stream(dev)
        rc = lib.synth_blocks_launch(
            sf_map.data_ptr(), prmi.data_ptr(), prmf.data_ptr(),
            ca_tabs.data_ptr(), pair.data_ptr(), out0.data_ptr(),
            out1.data_ptr(), m, int(ca_tabs.shape[0]), block_samples,
            int(bool(packed)), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "synth_blocks kernel launch failed: "
            f"{lib.synth_blocks_error_string(rc).decode()} (cudaError {rc})")
    _count_launch()
    return out0 if packed else (out0, out1)


# ---------------------------------------------------------------------------
# the plain twin: the kernel's op sequence in torch, uint32 as int64
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_TWIN_CHUNK_SAMPLES = 1 << 23   # samples per row chunk of the twin


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits as an unsigned value (int64 tensor)."""
    return x & _M32


def _s32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits reinterpreted as a signed int32 value (int64 tensor)."""
    return ((x + 2**31) & _M32) - 2**31


def _trunc_i(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncation toward zero, widened to int64."""
    return x.to(torch.int32).to(torch.int64)


def _div1023(chip: torch.Tensor) -> torch.Tensor:
    """chip // 1023 by the kernel's multiply-high (exact for chip < 2^20)."""
    return (chip * _DIV1023) >> 32


def _chan_key(pi, pf, ca_rows, n, nf):
    """The kernel's per-sample chain for one channel on R rows.

    pi: [R, 10] int64 (PHASE0, STEP, CP0Q, VQ, NBM, IC0, RES0Q24, R24,
    RES0Q36, R36); pf: [R, 4] float32 (SR12, SREM, CQ12, RRR);
    ca_rows: [R, 128] int64 u32 words; n: [S] int64; nf: [S] float32.
    Returns the [R, S] int64 key itab | sign << 9: the 9-bit LUT index
    and the 0/1 spreading sign (C/A chip XOR nav bit)."""
    (phase0, step, cp0q, vq, nbm, ic0,
     res0q24, r24, res0q36, r36) = (pi[:, j:j + 1] for j in range(10))
    sr12, srem = _trunc_i(pf[:, 0:1]), pf[:, 1:2]
    cq12, rrr = _trunc_i(pf[:, 2:3]), pf[:, 3:4]

    resc = _s32(sr12 * n + cq12 + _trunc_i(srem * nf)) >> 12  # arithmetic
    itab = _u32(phase0 + step * n + resc) >> 23

    rq36 = _u32(res0q36 + r36 * n + _trunc_i(rrr * nf))
    rq24 = _u32(res0q24 + r24 * n + (rq36 >> 12))
    chip = _u32(cp0q + vq * n + (rq24 >> 12)) >> 12
    w = _div1023(chip)
    cidx = chip - w * CA_SEQ_LEN                   # in [0, 1022]

    q = _u32((ic0 + w) * 3277) >> 16
    nbit = torch.where(q < 32, (_u32(nbm) >> q.clamp(max=31)) & 1, 0)
    word = torch.gather(ca_rows, 1, cidx >> 5)
    cbit = (word >> (cidx & 31)) & 1
    return itab | ((cbit ^ nbit) << 9)


def gain_sign_table_plain(prmf) -> torch.Tensor:
    """The kernel's per-row gain-and-sign tables: [M, 12, 1024] int64
    holding u32 words, entry itab | s << 9 of channel c being
    u = (trunc(f32(tc)*g) + 1024) | (trunc(f32(ts)*g) + 1024) << 16 for
    the LUT pair (tc, ts) at itab and the channel's f32 gain g, or
    kBias2 - u (mod 2^32) where the spreading sign s negates the sample.
    prmf: the [M, 256] float32 plane (only its gain lanes are read)."""
    prmf = _as_tensor(prmf, torch.float32)
    g = prmf[:, _F_GAIN:_F_GAIN + _C, None]                 # [M, 12, 1]
    e = torch.arange(1024, dtype=torch.int64, device=prmf.device)
    p = _pairtab_on(prmf.device).to(torch.int64)[e & 511]
    iv = _trunc_i(((p & 0xFFFF) - 512).to(torch.float32) * g)
    qv = _trunc_i(((p >> 16) - 512).to(torch.float32) * g)
    u = (iv + 1024) | ((qv + 1024) << 16)
    return _u32(torch.where((e >> 9) == 1, 0x08000800 - u, u))


def _twin_rows(prmi, prmf, ca, pair, n, nf):
    """Biased packed accumulators [R, S] (int64, u32 values) and the
    executed-channel counts [R, 1] for R rows; ca is [R, 12, 128]."""
    pi_all = prmi.to(torch.int64)
    acc = torch.zeros((prmi.shape[0], n.shape[0]), dtype=torch.int64,
                      device=n.device)
    active = prmf[:, _F_GAIN:_F_GAIN + _C] != 0.0
    tab = gain_sign_table_plain(prmf)
    # K1: every channel slot with nonzero gain (rows without it add 0)
    for c in range(_C):
        act = active[:, c:c + 1]
        if not bool(act.any()):
            continue
        pi = pi_all[:, c:_P_R36 + c + 1:_C]
        pf = prmf[:, c:_F_RRR + c + 1:_C]
        key = _chan_key(pi, pf, ca[:, c], n, nf)
        acc += torch.where(act, torch.gather(tab[:, c], 1, key), 0)
    # K2: gain-trunc patch words (an empty slot self-cancels)
    zero_row = torch.zeros((1, _LANES), dtype=torch.int64, device=n.device)
    for k in range(_N_PATCH):
        wk = _trunc_i(prmf[:, patch_word_lane(k)])
        rows = torch.nonzero(wk != 0).flatten()
        if rows.numel() == 0:
            continue
        uw = _u32(wk[rows])[:, None]
        c = (uw >> 2) & 15
        mag = uw >> 6
        half = (uw >> 1) & 1
        a = torch.where((uw & 1) == 0, mag, -mag)
        b = -a
        base_i = _LANES + _SLOT_I_W * k
        base_f = _LANES + _SLOT_F_W * k
        pi = pi_all[rows, base_i:base_i + _SLOT_I_W]
        pf = prmf[rows, base_f:base_f + 4]
        ca_pad = torch.cat([ca[rows], zero_row.expand(rows.numel(), 1,
                                                      _LANES)], dim=1)
        ca_rows = ca_pad[torch.arange(rows.numel(), device=n.device),
                         c.clamp(max=_C).flatten()]
        key = _chan_key(pi, pf, ca_rows, n, nf)
        pr = pair[key & 511]
        tgt = torch.where(half == 0, (pr & 0xFFFF) - 512, (pr >> 16) - 512)
        p = (tgt == a).to(torch.int64) - (tgt == b).to(torch.int64)
        term = torch.where((key >> 9) == 1, -p, p)
        acc[rows] = _u32(acc[rows] + _u32(_u32(term) << (half * 16)))
    nact = active.sum(dim=1, keepdim=True).to(torch.int64)
    return _u32(acc), nact


def synth_blocks_plain(prmi, prmf, ca_tabs, sf_map, block_samples: int,
                       packed: bool = True):
    """The plain PyTorch twin of the CUDA kernel, on the inputs' device.

    Same inputs and outputs as synth_blocks; the same integer and f32
    op sequence, with uint32 arithmetic carried in int64 and wrapped
    explicitly (torch has no uint32 shifts or adds on the CPU).  Rows
    are processed about _TWIN_CHUNK_SAMPLES samples at a time to bound
    the int64 temporaries."""
    block_samples = int(block_samples)
    prmi, prmf, ca_tabs, sf_map = _check_args(prmi, prmf, ca_tabs, sf_map,
                                              block_samples)
    if sf_map.device.type != "cpu":
        check_sf_map(sf_map.cpu(), ca_tabs.shape[0])
    dev = prmi.device
    m = prmi.shape[0]
    n = torch.arange(block_samples, dtype=torch.int64, device=dev)
    nf = n.to(torch.float32)
    pair = _pairtab_on(dev).to(torch.int64)
    ca_all = _u32(ca_tabs[:, :, 0, :].to(torch.int64))      # [NS, 12, 128]
    out0 = torch.empty((m, block_samples), dtype=torch.int32, device=dev)
    out1 = out0 if packed else torch.empty_like(out0)
    step = max(1, _TWIN_CHUNK_SAMPLES // block_samples)
    for r0 in range(0, m, step):
        sl = slice(r0, min(m, r0 + step))
        acc, nact = _twin_rows(prmi[sl], prmf[sl],
                               ca_all[sf_map[sl].to(torch.int64)],
                               pair, n, nf)
        bias = nact * 1024
        i_val = (acc & 0xFFFF) - bias
        q_val = (acc >> 16) - bias
        if packed:
            out0[sl] = _s32((i_val & 0xFFFF) | (q_val << 16)).to(torch.int32)
        else:
            out0[sl] = i_val.to(torch.int32)
            out1[sl] = q_val.to(torch.int32)
    return out0 if packed else (out0, out1)
