"""Host packing of superframe plans for the synthesis kernel.

The counterpart of the JAX package's ``ops/synth_jnp.py`` up to its
synthesis paths: the closed-form phase ramps that replace the
reference's sequential per-sample NCO cascade (plutogpssim.c:2690-2756)
with embarrassingly parallel math over (block, channel, sample):

  carrier   phase(n) = frac(c0 + u*n),  u = fl(f_carr*delt)
  code      P(n)     = cp0 + v*n chips, v = fl(f_code*delt)
            chip(n)  = floor(P);  wraps w = chip//1023; chip_idx = chip%1023
            bit(n)   = bits[B0 + (C0 + w)//20]       (B0 = iword*30+ibit)
  mixing    ip = s * trunc(cosTable[idx] * gain)      (s = chip_pm * bit_pm)

``pack_plan`` turns a scheduler plan into these per-(block, channel)
arrays (all numpy, f64 on the host) and ``split_plan`` re-anchors blocks
beyond the kernel's range into shorter sub-blocks.  The f64 precise and
tiled synthesis paths of ``synth_jnp`` are not ported yet; the kernel in
``ops/synth_cuda`` is the only synthesis path of this package.

Channel masking: inactive channels get zeroed parameters, so slots stay
static-shape and contribute 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import CA_SEQ_LEN, MAX_CHAN
from ..models.tables import COS_TABLE_512, SIN_TABLE_512

__all__ = ["DevicePlan", "pack_plan", "split_plan", "TILE"]

TILE = 2048  # samples per tile of the tiled path's per-tile anchors


@dataclass
class DevicePlan:
    """Kernel-ready arrays for one superframe (all numpy, host-built)."""

    n_blocks: int
    block_samples: int
    n_tiles: int
    # per-channel tables
    ca2: np.ndarray         # [C, 1023] int8  chips +-1
    bits: np.ndarray        # [C, 1800] int8  nav bits +-1
    # per-(block, channel)
    active: np.ndarray      # [M, C] bool
    u: np.ndarray           # [M, C] f64   carrier cycles/sample
    v: np.ndarray           # [M, C] f64   code chips/sample
    c0: np.ndarray          # [M, C] f64   carrier phase at block start
    cp0: np.ndarray         # [M, C] f64   code phase (chips) at block start
    b0: np.ndarray          # [M, C] int32 word*30+bit index
    ic0: np.ndarray         # [M, C] int32 code-period counter
    gain: np.ndarray        # [M, C] f64 signal gain (for in-kernel LUTs)
    qcos_pm: np.ndarray     # [M, C, 1024] int32  +-trunc(cos*gain)
    qsin_pm: np.ndarray     # [M, C, 1024] int32
    # tiled-path NCO levels (per channel) and per-tile f64-exact anchors
    v_q12: np.ndarray       # [M, C] int32  floor(v*4096)         Q12/sample
    r24: np.ndarray         # [M, C] int32  Q24 code step/sample
    r36: np.ndarray         # [M, C] int32  Q36 code step/sample
    rrr: np.ndarray         # [M, C] f32    Q36 fourth-level residual/sample
    step_u32: np.ndarray    # [M, C] int32  carrier u32 step/sample
    sr12: np.ndarray        # [M, C] int32  floor(step residual * 4096)
    srem: np.ndarray        # [M, C] f32    its [0,1) remainder
    code_q12: np.ndarray    # [M, C, nt] int32  floor(P*4096) at tile start
    code_q24: np.ndarray    # [M, C, nt] int32  Q24 fraction at tile start
    code_q36: np.ndarray    # [M, C, nt] int32  Q36 fraction at tile start
    carr_u32: np.ndarray    # [M, C, nt] int32  floor u32 phase at tile start
    carr_q12: np.ndarray    # [M, C, nt] int32  its sub-unit Q12 digit


def pack_plan(plan, tile: int = TILE, tables: bool = True) -> DevicePlan:
    """Convert a runtime.scheduler.SuperframePlan into device arrays.

    tables=False skips the tiled/precise-path LUTs and per-tile anchors
    (~15 MB of f64 work per 300-block superframe); the synthesis kernel
    builds its gain tables in-kernel and never reads them."""
    M, C = plan.n_blocks, MAX_CHAN
    N = plan.block_samples
    act = plan.active

    u = np.where(act, plan.f_carr * plan.delt, 0.0)
    v = np.where(act, plan.f_code * plan.delt, 0.0)
    c0 = np.where(act, plan.carr_phase, 0.0)
    cp0 = np.where(act, plan.code_phase, 0.0)
    b0 = np.where(act, plan.iword * 30 + plan.ibit, 0).astype(np.int32)
    ic0 = np.where(act, plan.icode, 0).astype(np.int32)
    gain = np.where(act, plan.gain, 0.0)

    nt = -(-N // tile)
    if tables:
        # +-truncated gain LUTs, f64 exact (C's (int)(table*gain))
        qcos = np.trunc(COS_TABLE_512[None, None, :] * gain[..., None])
        qsin = np.trunc(SIN_TABLE_512[None, None, :] * gain[..., None])
        qcos_pm = np.concatenate([qcos, -qcos], axis=-1).astype(np.int32)
        qsin_pm = np.concatenate([qsin, -qsin], axis=-1).astype(np.int32)

        # per-tile anchors (f64 on host; in-tile device math f32/int32)
        tj = (np.arange(nt, dtype=np.float64) * tile)[None, None, :]
        P_t = cp0[..., None] + v[..., None] * tj
        pq = P_t * 4096.0
        code_q12 = np.floor(pq)
        f12 = (pq - code_q12) * 4096.0
        code_q24 = np.floor(f12)
        code_q36 = np.floor((f12 - code_q24) * 4096.0).astype(np.int32)
        code_q24 = code_q24.astype(np.int32)
        code_q12 = code_q12.astype(np.int32)
        # FLOOR anchors + the sub-unit Q12 digit seeding the residual
        # cascade: a round()ed anchor is off by up to 0.5 u32 units, which
        # flips the 9-bit LUT index whenever the true phase sits within
        # that offset of a boundary (~124 components per 990-block run);
        # floor + seed makes the integer phase an exact floor of the f64
        # phase down to the f32 trunc level (2^-12 units, the precise
        # path's own f64 rounding class — window 2^-34, ~0.03/990 blocks)
        carr_t = c0[..., None] + u[..., None] * tj
        carr_f = (carr_t - np.floor(carr_t)) * 2.0**32   # exact: 2^32 scale
        carr_anchor = np.floor(carr_f)
        carr_q12 = np.floor((carr_f - carr_anchor) * 4096.0).astype(np.int32)
        carr_u32 = (carr_anchor.astype(np.int64) & 0xFFFFFFFF)
        carr_u32 = carr_u32.astype(np.uint32).view(np.int32)
    else:
        z = np.zeros((M, C, 0), np.int32)
        qcos_pm = qsin_pm = z
        code_q12 = code_q24 = code_q36 = carr_u32 = carr_q12 = z

    v_q12 = np.floor(v * 4096.0).astype(np.int32)
    r4 = v * 4096.0 - v_q12                    # Q12 residual per sample
    r24 = np.floor(r4 * 4096.0)
    r4b = r4 * 4096.0 - r24                    # Q24 fraction in [0, 1)
    r36 = np.floor(r4b * 4096.0)
    rrr = ((r4b - r36 / 4096.0) * 4096.0).astype(np.float32)
    r24 = r24.astype(np.int32)
    r36 = r36.astype(np.int32)

    step_exact = (u - np.floor(u)) * 2.0**32
    step = np.round(step_exact).astype(np.int64)
    step_u32 = (step & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    # two-level carrier step residual (synth_cuda._F_SR12 rationale):
    # a single f32 trunc level (error +-1 u32 unit) lets Doppler-resonant
    # blocks collect adjacent-LUT picks; the Q12 level puts the ramp
    # error at 2^-12 units — the f64 closed form's own rounding class
    sres = (step_exact - step) * 4096.0
    sr12 = np.floor(sres).astype(np.int32)
    srem = (sres - sr12).astype(np.float32)

    # Q12 int32 overflow guard: chips*4096 must stay below 2^31 (a 0.1 s
    # block is always ~102.3k chips, so this holds at any fs)
    assert float((cp0 + np.abs(v) * N).max(initial=0.0)) * 4096 < 2**31, \
        "block spans too many chips for the Q12 code NCO"

    return DevicePlan(
        n_blocks=M, block_samples=N, n_tiles=nt,
        ca2=plan.ca2, bits=plan.bits, active=act,
        u=u, v=v, c0=c0, cp0=cp0, b0=b0, ic0=ic0, gain=gain,
        qcos_pm=qcos_pm, qsin_pm=qsin_pm,
        v_q12=v_q12, r24=r24, r36=r36, rrr=rrr,
        step_u32=step_u32, sr12=sr12, srem=srem,
        code_q12=code_q12, code_q24=code_q24, code_q36=code_q36,
        carr_u32=carr_u32, carr_q12=carr_q12,
    )


def split_plan(dp: DevicePlan, max_samples: int) -> DevicePlan:
    """Split every block of a (tables=False) DevicePlan into K equal
    sub-blocks of <= max_samples samples, with re-anchored closed-form
    parameters — this is what lifts the synthesis kernel's Q24 range
    cap (synth_cuda.MAX_BLOCK_SAMPLES, fs <= 5.24 MHz at 0.1 s
    blocks) to ANY sample rate: the reference accepts any -s >= 1 MHz
    (plutogpssim.c:2326-2329), and sub-blocks are just shorter rows of
    the kernel's outer grid axis.

    Sub-block k of block m starts at sample offset k*sub and carries:
      carrier   c0' = c0 + u*(k*sub)          (f64; frac'd at pack time)
      code      total chips t = cp0 + v*(k*sub), re-based into a code
                period: cp0' = t - 1023*w, ic0' = ic0 + w (w = whole
                periods since block start) so the Q12 plane stays far
                inside int32 at any fs and the nav-bit index
                q = (ic0' + w')//20 reconstructs the absolute period
                count exactly
    The last sub-block extrapolates past the true block end (K*sub >=
    N); consumers trim the reassembled [M, K*sub] row to N samples
    (IqStream does).  Re-anchoring rounds once in f64 (~1e-10 chips),
    the same class as the closed form's own floor — the split-precise
    vs unsplit-precise residual is a rare chip-edge straddle, orders
    below the reference A/B gates.  Plans already inside the cap pass
    through unchanged."""
    N = dp.block_samples
    if N <= max_samples:
        return dp
    K = -(-N // max_samples)
    sub = -(-N // K)
    M, C = dp.active.shape
    offs = np.arange(K, dtype=np.float64) * sub            # [K] exact ints

    # Re-anchor with a Dekker-split two-term product: a plain
    # c0 + u*(k*sub) rounds once at magnitude ~|u|*K*sub (~500 carrier
    # cycles at fs=10 MHz), i.e. ~2.4e-4 u32 units — enough for ~24
    # adjacent-LUT straddles per 96M samples on the compiled gate.
    # Splitting u = u_hi + u_lo (26-bit u_hi) makes u_hi*T exact
    # (26+20 < 53 bits), its frac extraction exact, and the remaining
    # sum |c0 + frac| <= 2 rounds at ~4e-6 units — the same class as
    # the unsplit path's own f64 floor.  Same trick for the code
    # anchor, with the exact multiple of 1023 peeled off u_hi*T by an
    # exact fmod so the rebase error sits at ~1e-12 chips (below the
    # kernel's 1.5e-11 Q36 truncation).
    def dekker_hi(x):
        c = x * (2.0 ** 27 + 1.0)
        hi = c - (c - x)
        return hi

    u = dp.u[:, None, :]
    u_hi = dekker_hi(u)
    p1 = u_hi * offs[None, :, None]                        # exact
    c0 = dp.c0[:, None, :] + (p1 - np.floor(p1)) \
        + (u - u_hi) * offs[None, :, None]

    v = dp.v[:, None, :]
    v_hi = dekker_hi(v)
    q1 = v_hi * offs[None, :, None]                        # exact
    m1 = np.fmod(q1, float(CA_SEQ_LEN))                    # exact
    w1 = (q1 - m1) / CA_SEQ_LEN                            # exact integer
    rest = dp.cp0[:, None, :] + m1 + (v - v_hi) * offs[None, :, None]
    w2 = np.floor(rest / CA_SEQ_LEN)
    cp0 = rest - CA_SEQ_LEN * w2                           # [M, K, C]
    ic0 = dp.ic0[:, None, :] + (w1 + w2).astype(np.int32)

    def rep(a):
        """[M, C, ...] -> [M*K, C, ...] with each row repeated K times."""
        return np.repeat(a, K, axis=0)

    # per-sub-block gain LUTs repeat (gain is per block); the tiled
    # path's per-tile anchors would need recomputation and the tiled
    # path has no range cap to lift, so they come back empty — split
    # plans feed the pallas and precise paths only
    z = np.zeros((M * K, C, 0), np.int32)
    return DevicePlan(
        n_blocks=M * K, block_samples=sub, n_tiles=-(-sub // TILE),
        ca2=dp.ca2, bits=dp.bits,
        active=rep(dp.active), u=rep(dp.u), v=rep(dp.v),
        c0=c0.reshape(M * K, C), cp0=cp0.reshape(M * K, C),
        b0=rep(dp.b0), ic0=ic0.reshape(M * K, C).astype(np.int32),
        gain=rep(dp.gain),
        qcos_pm=rep(dp.qcos_pm) if dp.qcos_pm.size else z,
        qsin_pm=rep(dp.qsin_pm) if dp.qsin_pm.size else z,
        v_q12=rep(dp.v_q12), r24=rep(dp.r24), r36=rep(dp.r36),
        rrr=rep(dp.rrr), step_u32=rep(dp.step_u32), sr12=rep(dp.sr12),
        srem=rep(dp.srem),
        code_q12=z, code_q24=z, code_q36=z, carr_u32=z, carr_q12=z,
    )
