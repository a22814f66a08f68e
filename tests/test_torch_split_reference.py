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
