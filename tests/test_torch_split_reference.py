"""The port's split-block stream against an independent reference.

A block past the kernel's Q24 range (ops.synth_cuda.MAX_BLOCK_SAMPLES)
is synthesized as K re-anchored sub-blocks (ops.synth_torch.split_plan)
and reassembled and trimmed in IqStream._finish.  Here the range is
lowered to 40,000 samples, so a 1 MHz block of 100,000 samples splits
into K=3 sub-blocks of 33,334 (K x sub > N: the trim runs), and the
stream's blocks, from the kernel's plain twin on the CPU, are held
against the H100 benchmark's plain reference (``h100_bench/reference``:
a frozen numpy control plane and the f64 closed form over the whole,
unsplit block) within the limits of the benchmark's `correct` gate
(``h100_bench/harness/judge.py``).  The same reference with its carrier
and code ramps in float32 fails them.  Nothing here imports JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu_torch.ingest import read_rinex2
from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                             setup_scenario)
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream

sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100_bench"))

import reference  # noqa: E402  (h100_bench/reference)
from harness import judge  # noqa: E402  (h100_bench/harness)

TOKYO = np.array([35.681298 / 57.2957795131, 139.766247 / 57.2957795131,
                  10.0])
FS = 1_000_000.0
CAP = 40_000
BLOCKS = 4


@pytest.fixture(scope="module")
def split_run(fixture_paths):
    """(stream's split_k, sub_block_samples, its first BLOCKS blocks)
    with the kernel's range lowered to CAP."""
    mp = pytest.MonkeyPatch()
    mp.setattr(sc, "MAX_BLOCK_SAMPLES", CAP)
    try:
        rin = read_rinex2(fixture_paths["rinex2"])
        g0 = setup_scenario(rin, None)
        st = IqStream(rin, g0, select_ephemeris_set(rin, g0),
                      np.asarray(llh2xyz(TOKYO)), fs=FS, mode="kernel",
                      device="cpu", superframes_per_dispatch=2)
        iq = np.concatenate(list(st.superframes(BLOCKS, max_blocks=3)))
    finally:
        mp.undo()
    return st.split_k, st.sub_block_samples, iq


def _reference(fixture_paths, dtype):
    return reference.replay(fixture_paths["rinex2"], 0.0,
                            np.asarray(llh2xyz(TOKYO)), FS,
                            range(BLOCKS), "cpu", dtype)


def test_blocks_split_and_trim(split_run):
    k, sub, iq = split_run
    assert (k, sub) == (3, 33_334)
    assert k * sub > int(FS / 10)
    assert iq.shape == (BLOCKS, int(FS / 10), 2) and iq.dtype == np.int16


def test_split_stream_within_correct_limits(split_run, fixture_paths):
    _, _, iq = split_run
    want = _reference(fixture_paths, torch.float64)
    r = judge.compare({b: iq[b] for b in range(BLOCKS)}, want)
    assert r["blocks"] == BLOCKS
    assert r["mismatch_frac"] <= judge.LIMITS["mismatch_frac"], r
    assert r["max_err"] <= judge.LIMITS["max_err"], r
    assert judge.verdict(r)[0]


def test_float32_control_fails_a_limit(fixture_paths):
    want = _reference(fixture_paths, torch.float64)
    ctl = _reference(fixture_paths, torch.float32)
    r = judge.compare(ctl, want)
    assert (r["mismatch_frac"] > judge.LIMITS["mismatch_frac"]
            or r["max_err"] > judge.LIMITS["max_err"]), r
    assert not judge.verdict(r)[0]


# A wide-10m.stream run of the H100 benchmark (seed 2147516201) failed
# `correct` on one sample of its kept blocks: block 53,562 of the stream
# started 73,285.5 s after the day file's first time of clock, sample
# 978,987 (sub-row 1, sample 478,987), I and Q off by 296 and 164.
STRADDLE_SEED = 2147516201
STRADDLE = (73_285.5, 53_562, 978_987, 1)     # offset, block, sample, slot


def test_split_keeps_the_chip_at_a_kernel_straddle(tmp_path):
    """Channel slot 1's code phase there lies 1.8e-12 chips past a chip
    edge.  split_plan's re-anchored sub-row keeps the exact phase within
    1e-13 chips, and the split block through the f64 precise path equals
    the unsplit block word for word, and the reference at that sample:
    the miss is the kernel's Q36 code-phase floor, not the split."""
    from fractions import Fraction

    from harness import runner, spec as specmod
    from pluto_gps_sim_tpu_torch.ops.synth_torch import (
        pack_plan, split_plan, synth_superframe_precise_async)
    offset, block, n, slot = STRADDLE
    cfg = specmod.config(specmod.load_spec(), "wide-10m")
    scen, _ = runner.make_scenario(cfg, STRADDLE_SEED, tmp_path)
    assert scen.start_offset_s == offset
    st = runner.Program(scen, "cpu").stream(offset)
    st.fast_forward(block)
    dp = pack_plan(st.sched.plan(1), tables=True)
    dps = split_plan(dp, sc.MAX_BLOCK_SAMPLES)
    assert (dps.n_blocks, dps.block_samples) == (2, 500_000)

    v = Fraction(float(dp.v[0, slot]))
    exact = Fraction(float(dp.cp0[0, slot])) + v * n
    assert 0 < exact - round(exact) < Fraction(2, 10**12)
    j = n - dps.block_samples
    split = (Fraction(float(dps.cp0[1, slot])) + v * j
             + 1023 * int(dps.ic0[1, slot] - dp.ic0[0, slot]))
    assert abs(split - exact) < Fraction(1, 10**13)

    unsplit = synth_superframe_precise_async(dp, "cpu").numpy()[0]
    joined = synth_superframe_precise_async(dps, "cpu").numpy()
    assert np.array_equal(joined.reshape(-1, 2)[:dp.block_samples], unsplit)
    want = reference.replay(scen.nav_path, offset, scen.xyz, scen.fs,
                            [block], "cpu", torch.float64)[block]
    assert np.array_equal(unsplit[n], want[n])
