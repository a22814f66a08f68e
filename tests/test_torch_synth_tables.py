"""The exact rewrites inside the CUDA synthesis kernel and its twin.

The kernel (and synth_blocks_plain) read each channel's gain-scaled,
signed LUT pair from a per-row table, gain_sign_table_plain, instead of
evaluating trunc(f32(T) * f32(g)) per sample as the Pallas kernel does,
and divide chip // 1023 by a multiply-high instead of the Pallas
kernel's f32 reciprocal.  Both must be exact, not close: the table is
held here to the per-sample expression of the Pallas kernel, written
out again in numpy, on every (LUT index, sign) entry, and the division
to // on every chip a u32 ramp can reach.  Tolerance: exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu_torch.constants import R2D
from pluto_gps_sim_tpu_torch.ingest import read_rinex2
from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan
from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                             setup_scenario)
from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
BIAS2 = 2048 | (2048 << 16)


def test_div1023_multiply_high_exhaustive():
    """(chip * 0x401005) >> 32 == chip // 1023 == trunc(f32(chip) *
    _INV1023) for every chip < 2^20: chip = tq >> 12 of a u32 never
    reaches 2^20, so this covers every value the kernel can see."""
    chip = np.arange(2**20, dtype=np.int64)
    want = chip // 1023
    got = sc._div1023(torch.from_numpy(chip)).numpy()
    assert np.array_equal(got, want)
    recip = (chip.astype(np.float32) * sc._INV1023).astype(np.int64)
    assert np.array_equal(recip, want)


def _funnelshift_rc(lo, hi, shift):
    """CUDA's __funnelshift_rc: the low 32 bits of (hi:lo) >> min(shift, 32)."""
    v = (hi << np.uint64(32)) | lo
    return (v >> np.minimum(shift, 32)) & np.uint64(0xFFFFFFFF)


def test_nav_bit_funnel_identity():
    """The kernel takes nav bit q of the 32-bit mask nbm at bit 9 as
    __funnelshift_rc(nbm << 9, nbm >> 23, q) (0 for q >= 32, as the
    Pallas kernel's logical shift), and the sign as bit 9 of
    (chip << 9) + that: equal to the Pallas kernel's
    chip ^ ((nbm >> q) & 1) for every q a 16-bit shift can give."""
    rng = np.random.RandomState(5)
    nbm = rng.randint(0, 2**32, 64, dtype=np.uint64)[:, None]
    q = np.concatenate([np.arange(70, dtype=np.uint64),
                        rng.randint(70, 2**16, 64).astype(np.uint64)])[None]
    m32 = np.uint64(0xFFFFFFFF)
    nav9 = _funnelshift_rc((nbm << np.uint64(9)) & m32,
                           nbm >> np.uint64(23), q)
    want = np.where(q < 32, (nbm >> np.minimum(q, 31)) & np.uint64(1), 0)
    for chip in (0, 1):
        s9 = ((np.uint64(chip) << np.uint64(9)) + nav9) & m32
        assert np.array_equal((s9 >> np.uint64(9)) & np.uint64(1),
                              want ^ np.uint64(chip))


def _fixture_gains(fixture_paths):
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    plan = Scheduler(rin, g0, select_ephemeris_set(rin, g0),
                     np.asarray(llh2xyz(TOKYO)), fs=2_600_000.0).plan(3)
    return sc.build_block_params(pack_plan(plan, tables=False)).prmf


def _lane_gains(g: float):
    prmf = np.zeros((1, 256), np.float32)
    prmf[0, sc._F_GAIN:sc._F_GAIN + 12] = [g, 0.5, 0.0, 1.0, 2.0, 0.25,
                                            0.9, 0.1, 1.5, 0.75, 0.3, 0.6]
    return prmf


@pytest.mark.parametrize("case", ["fixture", "above_unity",
                                  "trunc_boundary"])
def test_gain_sign_table_matches_per_sample_expression(fixture_paths, case):
    """Every entry itab | s << 9 of every channel's table equals the
    Pallas kernel's per-sample u + ((BIAS2 - (u << 1)) & m) at that LUT
    index and sign: at the fixture's gain lanes, at a gain above unity
    (test_pallas_gain_above_unity's 1.0503761437), and at a gain whose
    products straddle an integer in f32 (chip_smoke's patch case)."""
    prmf = {"fixture": lambda: _fixture_gains(fixture_paths),
            "above_unity": lambda: _lane_gains(1.0503761437),
            "trunc_boundary": lambda: _lane_gains(0.9086419713826426)}[case]()
    got = sc.gain_sign_table_plain(torch.from_numpy(prmf)).numpy()
    assert got.shape == (prmf.shape[0], 12, 1024)

    pair = sc._PAIRTAB.view(np.uint32).astype(np.int64)        # [512]
    tc = ((pair & 0xFFFF) - 512).astype(np.float32)
    ts = ((pair >> 16) - 512).astype(np.float32)
    g = prmf[:, sc._F_GAIN:sc._F_GAIN + 12, None]              # f32
    iv = np.trunc(tc * g).astype(np.int64)                     # f32 product
    qv = np.trunc(ts * g).astype(np.int64)
    u = ((iv + 1024) | ((qv + 1024) << 16)) & 0xFFFFFFFF       # [M, 12, 512]
    for s, m in ((0, 0), (1, 0xFFFFFFFF)):
        want = (u + ((BIAS2 - (u << 1)) & m)) & 0xFFFFFFFF
        assert np.array_equal(got[..., s * 512:(s + 1) * 512], want), s
