"""Host packing of superframe plans, and the two tensor synthesis paths.

The counterpart of the JAX package's ``ops/synth_jnp.py``: the
closed-form phase ramps that replace the reference's sequential
per-sample NCO cascade (plutogpssim.c:2690-2756) with embarrassingly
parallel math over (block, channel, sample):

  carrier   phase(n) = frac(c0 + u*n),  u = fl(f_carr*delt)
  code      P(n)     = cp0 + v*n chips, v = fl(f_code*delt)
            chip(n)  = floor(P);  wraps w = chip//1023; chip_idx = chip%1023
            bit(n)   = bits[B0 + (C0 + w)//20]       (B0 = iword*30+ibit)
  mixing    ip = s * trunc(cosTable[idx] * gain)      (s = chip_pm * bit_pm)

``pack_plan`` turns a scheduler plan into these per-(block, channel)
arrays (all numpy, f64 on the host) and ``split_plan`` re-anchors blocks
beyond the kernel's range into shorter sub-blocks.  Two synthesis paths
run on those arrays as plain tensor math on any torch device, beside the
CUDA kernel of ``ops/synth_cuda``:

  * precise (``synth_superframe_precise``, synth_jnp.py:284-321): the
    f64 closed form itself, the golden reference.  The JAX package runs
    it on the CPU only (a TPU has no f64); a CUDA card has f64, so here
    it also runs on the card and must equal its CPU run word for word;
  * tiled (``synth_superframe_tiled``, synth_jnp.py:328-430): the kernel's
    multi-level integer NCOs (Q12+Q24+Q36+f32 code, u32 + Q12-seeded
    residual carrier) restarted at per-tile f64 anchors, in int32/f32
    arithmetic carried in int64 and wrapped to 32 bits explicitly
    (torch has no logical int32 shift on the CPU).

Channel masking: inactive channels get zeroed parameters, so slots stay
static-shape and contribute 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import CA_SEQ_LEN, MAX_CHAN
from ..models.tables import COS_TABLE_512, SIN_TABLE_512

__all__ = ["DevicePlan", "pack_plan", "split_plan", "resolve_device",
           "synth_superframe_precise", "synth_superframe_precise_async",
           "synth_superframe_tiled",
           "synth_superframe_tiled_async", "TILE"]

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


def pack_plan(plan, tables: bool = True) -> DevicePlan:
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

    nt = -(-N // TILE)
    if tables:
        # +-truncated gain LUTs, f64 exact (C's (int)(table*gain))
        qcos = np.trunc(COS_TABLE_512[None, None, :] * gain[..., None])
        qsin = np.trunc(SIN_TABLE_512[None, None, :] * gain[..., None])
        qcos_pm = np.concatenate([qcos, -qcos], axis=-1).astype(np.int32)
        qsin_pm = np.concatenate([qsin, -qsin], axis=-1).astype(np.int32)

        # per-tile anchors (f64 on host; in-tile device math f32/int32)
        tj = (np.arange(nt, dtype=np.float64) * TILE)[None, None, :]
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


# ---------------------------------------------------------------------------
# the tensor synthesis paths
# ---------------------------------------------------------------------------

# (rows x channels x samples) elements per chunk of the tensor paths: the
# f64/int64 temporaries of one chunk stay near 32 MB on the CPU and 512 MB
# on a card, where larger chunks keep the launch count per superframe low
_CHUNK_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}
_LUT = 1024                  # entries of a +- gain LUT row (qcos_pm/qsin_pm)


def resolve_device(device) -> torch.device:
    """The torch.device a synthesis path runs on: cuda (a CUDA device
    torch can see, else RuntimeError) or cpu.  Nothing is chosen
    automatically and nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch sees no CUDA device")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _rows_per_chunk(dev: torch.device, per_row: int) -> int:
    return max(1, _CHUNK_ELEMS[dev.type] // max(1, per_row))


def _mix_gather(s, itab, qcos_pm, qsin_pm):
    """Fold the +-1 spreading sign into the LUT index and gather I/Q
    (synth_jnp.py:271-277).  s, itab: [R, C, S]; qcos_pm/qsin_pm:
    [R, C, 1024] integer LUTs.  Returns int64 [R, C, S] pairs.

    jnp.take fills an index past the row end with INT32_MIN; the
    precise path reaches index 1024 only when frac(c0 + u*n) rounds up
    to exactly 1.0 under a negative spreading sign, and the fill is
    mirrored so the two packages stay word-equal even there."""
    idx = itab + torch.where(s < 0, 512, 0)
    past = idx >= _LUT
    idx = idx.clamp(max=_LUT - 1)
    ival = torch.gather(qcos_pm, 2, idx).to(torch.int64)
    qval = torch.gather(qsin_pm, 2, idx).to(torch.int64)
    fill = -2**31
    return torch.where(past, fill, ival), torch.where(past, fill, qval)


def _spread_sign(ca2, bits, cidx, bidx):
    """C/A chip times nav bit (+-1) per (row, channel, sample).  ca2:
    [C, 1023], bits: [C, n_bits] int64; indexing clamps past the table
    end, as jnp indexing does."""
    r = cidx.shape[0]
    chip = torch.gather(ca2.expand(r, -1, -1), 2, cidx)
    bit = torch.gather(bits.expand(r, -1, -1), 2,
                       bidx.clamp(0, bits.shape[-1] - 1))
    return chip * bit


def _iq16(i_acc, q_acc):
    """Channel sums -> int16 [..., 2], wrapping as astype(int16) does."""
    iq = torch.stack([i_acc, q_acc], dim=-1)
    return (((iq + 2**15) & 0xFFFF) - 2**15).to(torch.int16)


def _precise_rows(u, v, c0, cp0, b0, ic0, qcos_pm, qsin_pm, ca2, bits, n):
    """R blocks, all channels, f64 ramps (synth_jnp.py:284-305).  u, v,
    c0, cp0: [R, C] f64; b0, ic0: [R, C] int64; n: [N] f64."""
    # c0 + u*n stays a separate multiply and add: an FMA rounds once
    # where the reference rounds twice, and the floors below see it
    ph = c0[..., None] + u[..., None] * n
    ph = ph - torch.floor(ph)
    itab = (ph * 512.0).to(torch.int64)          # ph >= 0: trunc == floor

    p = cp0[..., None] + v[..., None] * n
    chip = torch.floor(p).to(torch.int64)
    w = torch.div(chip, CA_SEQ_LEN, rounding_mode="floor")
    cidx = chip - w * CA_SEQ_LEN
    bidx = b0[..., None] + torch.div(ic0[..., None] + w, 20,
                                     rounding_mode="floor")
    s = _spread_sign(ca2, bits, cidx, bidx)
    ival, qval = _mix_gather(s, itab, qcos_pm, qsin_pm)
    return _iq16(ival.sum(dim=1), qval.sum(dim=1))


def synth_superframe_precise_async(dp: DevicePlan,
                                   device="cuda") -> torch.Tensor:
    """f64 golden synthesis -> int16 tensor [M, N, 2] on `device`
    (enqueued on the current CUDA stream there; cuda by default, which
    raises without a card, as resolve_device says).  Needs a tables=True
    DevicePlan (the f64 gain LUTs)."""
    dev = resolve_device(device)
    m, c, n = dp.n_blocks, MAX_CHAN, dp.block_samples
    if dp.qcos_pm.shape != (m, c, _LUT):
        raise ValueError("the precise path needs pack_plan(tables=True)")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    ca2, bits = put(dp.ca2, torch.int64), put(dp.bits, torch.int64)
    nf = torch.arange(n, dtype=torch.float64, device=dev)
    out = torch.empty((m, n, 2), dtype=torch.int16, device=dev)
    step = _rows_per_chunk(dev, c * n)
    for r0 in range(0, m, step):
        sl = slice(r0, min(m, r0 + step))
        out[sl] = _precise_rows(
            put(dp.u[sl], torch.float64), put(dp.v[sl], torch.float64),
            put(dp.c0[sl], torch.float64), put(dp.cp0[sl], torch.float64),
            put(dp.b0[sl], torch.int64), put(dp.ic0[sl], torch.int64),
            put(dp.qcos_pm[sl], torch.int64),
            put(dp.qsin_pm[sl], torch.int64), ca2, bits, nf)
    return out


def synth_superframe_precise(dp: DevicePlan, device="cuda") -> np.ndarray:
    """f64 golden synthesis -> int16 [M, N, 2] on the host, computed on
    `device` (cuda or cpu; the two agree word for word)."""
    return synth_superframe_precise_async(dp, device).cpu().numpy()


def synth_superframe_tiled_async(dp: DevicePlan,
                                 device="cuda") -> torch.Tensor:
    """Tiled-path synthesis -> int16 tensor [M, N, 2] on `device`
    (enqueued on the current CUDA stream there; cuda by default, which
    raises without a card, as resolve_device says).  Needs a tables=True
    DevicePlan (gain LUTs and per-tile anchors at TILE).

    The NCOs are the synthesis kernel's multi-level scheme on per-tile
    f64-exact anchors (synth_jnp.py:328-406): carrier = floor u32 anchor
    + step*j + a Q12-seeded two-level (Q12 + f32) step residual whose
    >> 12 is arithmetic; code = Q12 + Q24 + Q36 integer ramps + an f32
    fourth level.  int32 wraparound is int64 arithmetic masked to 32
    bits, and every other shift is logical (on the masked value)."""
    from .synth_cuda import _s32, _trunc_i, _u32

    dev = resolve_device(device)
    m, c, n, nt = dp.n_blocks, MAX_CHAN, dp.block_samples, dp.n_tiles
    if dp.code_q12.shape != (m, c, nt) or dp.qcos_pm.shape[-1] != _LUT:
        raise ValueError("the tiled path needs pack_plan(tables=True) "
                         "and an unsplit plan")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ji = torch.arange(TILE, dtype=torch.int64, device=dev)
    jf = torch.arange(TILE, dtype=torch.float32, device=dev)
    ca2, bits = put(dp.ca2).to(torch.int64), put(dp.bits).to(torch.int64)
    out = torch.empty((m, n, 2), dtype=torch.int16, device=dev)
    step = _rows_per_chunk(dev, c * nt * TILE)
    for r0 in range(0, m, step):
        sl = slice(r0, min(m, r0 + step))

        def per_chan(a):          # [R, C] -> [R, C, 1, 1] on dev
            return put(a[sl])[..., None, None]

        def per_tile(a):          # [R, C, nt] -> [R, C, nt, 1] int64
            return put(a[sl]).to(torch.int64)[..., None]

        vq, r24, r36, su32, s12, b0, ic0 = (
            per_chan(a).to(torch.int64)
            for a in (dp.v_q12, dp.r24, dp.r36, dp.step_u32, dp.sr12,
                      dp.b0, dp.ic0))
        rrr, srem = per_chan(dp.rrr), per_chan(dp.srem)
        cq12, cq24, cq36, cu32, cuq12 = (
            per_tile(a) for a in (dp.code_q12, dp.code_q24, dp.code_q36,
                                  dp.carr_u32, dp.carr_q12))
        # carrier: u32 NCO, residual >> 12 arithmetic (floor for a
        # negative sr12), then the 9 index bits by a logical shift
        res = _s32(s12 * ji + cuq12 + _trunc_i(srem * jf)) >> 12
        itab = _u32(cu32 + su32 * ji + res) >> 23
        # code: Q12 + Q24 + Q36 integer ramps + f32 fourth level
        rq36 = _u32(cq36 + r36 * ji + _trunc_i(rrr * jf))
        rq24 = _u32(cq24 + r24 * ji + (rq36 >> 12))
        chip = _u32(cq12 + vq * ji + (rq24 >> 12)) >> 12
        w = torch.div(chip, CA_SEQ_LEN, rounding_mode="floor")
        cidx = chip - w * CA_SEQ_LEN
        bidx = b0 + torch.div(ic0 + w, 20, rounding_mode="floor")
        r = vq.shape[0]
        s = _spread_sign(ca2, bits, cidx.reshape(r, c, -1),
                         bidx.reshape(r, c, -1))
        ival, qval = _mix_gather(s, itab.reshape(r, c, -1),
                                 put(dp.qcos_pm[sl]).to(torch.int64),
                                 put(dp.qsin_pm[sl]).to(torch.int64))
        out[sl] = _iq16(ival.sum(dim=1)[:, :n], qval.sum(dim=1)[:, :n])
    return out


def synth_superframe_tiled(dp: DevicePlan, device="cuda") -> np.ndarray:
    """Tiled-path synthesis -> int16 [M, N, 2] on the host."""
    return synth_superframe_tiled_async(dp, device).cpu().numpy()
