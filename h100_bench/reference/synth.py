"""The reference's synthesis: the f64 closed form, block by block.

A frozen copy of the program's precise path (plain torch tensor math on
any device), for the blocks of one superframe plan:

  carrier   phase(n) = frac(c0 + u*n),  u = f_carr*delt
  code      P(n)     = cp0 + v*n chips, v = f_code*delt
            chip(n)  = floor(P);  wraps w = chip//1023; chip_idx = chip%1023
            bit(n)   = bits[B0 + (C0 + w)//20]      (B0 = iword*30+ibit)
  mixing    ip = s * trunc(cosTable[idx] * gain)    (s = chip_pm * bit_pm)

summed over the 12 channel slots into int16 I and Q (the upstream
sample loop, plutogpssim.c:2690-2756).  ``dtype`` is the precision of
the carrier and code ramps: float64 as the configuration states, and
float32 for the control that must fail.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import CA_SEQ_LEN
from .models.tables import COS_TABLE_512, SIN_TABLE_512

__all__ = ["synth_blocks"]

_LUT = 1024


def _luts(gain: np.ndarray):
    """+-trunc(table*gain) rows [R, C, 1024] (C's (int)(table*gain))."""
    qcos = np.trunc(COS_TABLE_512[None, None, :] * gain[..., None])
    qsin = np.trunc(SIN_TABLE_512[None, None, :] * gain[..., None])
    return (np.concatenate([qcos, -qcos], axis=-1).astype(np.int64),
            np.concatenate([qsin, -qsin], axis=-1).astype(np.int64))


def synth_blocks(plan, rows, device, dtype=torch.float64) -> np.ndarray:
    """int16 IQ [len(rows), N, 2] of the given block rows of one plan."""
    rows = np.asarray(rows, np.int64)
    act = plan.active[rows]
    u = np.where(act, plan.f_carr[rows] * plan.delt, 0.0)
    v = np.where(act, plan.f_code[rows] * plan.delt, 0.0)
    c0 = np.where(act, plan.carr_phase[rows], 0.0)
    cp0 = np.where(act, plan.code_phase[rows], 0.0)
    b0 = np.where(act, plan.iword[rows] * 30 + plan.ibit[rows], 0)
    ic0 = np.where(act, plan.icode[rows], 0)
    qcos, qsin = _luts(np.where(act, plan.gain[rows], 0.0))

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    n = torch.arange(plan.block_samples, dtype=dtype, device=device)
    ca2 = put(plan.ca2, torch.int64)
    bits = put(plan.bits, torch.int64)
    out = []
    for r in range(len(rows)):          # one block at a time: it fits
        sl = slice(r, r + 1)
        # c0 + u*n as a separate multiply and add, as the upstream
        # loop rounds it
        ph = put(c0[sl], dtype)[..., None] + put(u[sl], dtype)[..., None] * n
        ph = ph - torch.floor(ph)
        itab = (ph * 512.0).to(torch.int64)
        p = put(cp0[sl], dtype)[..., None] + put(v[sl], dtype)[..., None] * n
        chip = torch.floor(p).to(torch.int64)
        w = torch.div(chip, CA_SEQ_LEN, rounding_mode="floor")
        cidx = chip - w * CA_SEQ_LEN
        bidx = put(b0[sl], torch.int64)[..., None] + torch.div(
            put(ic0[sl], torch.int64)[..., None] + w, 20,
            rounding_mode="floor")
        chipv = torch.gather(ca2.expand(1, -1, -1), 2,
                             cidx.clamp(0, CA_SEQ_LEN - 1))
        bitv = torch.gather(bits.expand(1, -1, -1), 2,
                            bidx.clamp(0, bits.shape[-1] - 1))
        s = chipv * bitv
        idx = itab + torch.where(s < 0, 512, 0)
        # an index past the row (a phase that rounds up to 1.0 under a
        # negative sign) reads as INT32_MIN, as the program's tables do
        past = idx >= _LUT
        idx = idx.clamp(0, _LUT - 1)
        ival = torch.gather(put(qcos[sl], torch.int64), 2, idx)
        qval = torch.gather(put(qsin[sl], torch.int64), 2, idx)
        ival = torch.where(past, -2**31, ival).sum(dim=1)
        qval = torch.where(past, -2**31, qval).sum(dim=1)
        iq = torch.stack([ival, qval], dim=-1)
        iq = (((iq + 2**15) & 0xFFFF) - 2**15).to(torch.int16)
        out.append(iq.cpu().numpy()[0])
    return np.stack(out)
