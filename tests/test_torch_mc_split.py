"""The Monte-Carlo batch over blocks past the kernel's Q24 range.

Such a block (ops.synth_cuda.MAX_BLOCK_SAMPLES) is synthesized as K
re-anchored sub-rows (runtime.launch.split_geometry, ops.synth_torch
.split_plan), as IqStream does, and the batch yields whole blocks.  Here
the range is lowered to 40,000 samples, so a 1 MHz block of 100,000
samples splits into K=3 sub-rows of 33,334 (K x sub > N: the trim runs).
A batch of 3 receivers, started 0.4 s before a 30 s boundary so that its
calls cross it, is held word for word to per-receiver split streams, to
itself through the lookahead (a hit and a miss), as_device and in chunks
that do not divide it, and to the H100 benchmark's plain reference
(``h100_bench/reference``: the unsplit f64 closed form) within the
limits of the benchmark's `correct` gate, which the same reference in
float32 fails.  Nothing here imports JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu_torch.ingest import read_rinex2
from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz
from pluto_gps_sim_tpu_torch.models.gpstime import inc_gps_time
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch
from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                             setup_scenario)
from pluto_gps_sim_tpu_torch.runtime.launch import split_geometry
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream

sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100_bench"))

import reference  # noqa: E402  (h100_bench/reference)
from harness import judge  # noqa: E402  (h100_bench/harness)

FS = 1_000_000.0
N = 100_000
CAP = 40_000
LEAD_S = 0.4              # the start, this long before a 30 s boundary
BLOCKS = 7                # calls of 2, 2, 2 and 1 blocks
CALLS = (2, 2, 2, 1)


@pytest.fixture(scope="module")
def split_cap():
    mp = pytest.MonkeyPatch()
    mp.setattr(sc, "MAX_BLOCK_SAMPLES", CAP)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def scenario(fixture_paths, split_cap):
    """(rin, the start, its set, 3 receivers ~1 km apart, the start's
    offset after the file's first time of clock)."""
    rin = read_rinex2(fixture_paths["rinex2"])
    first = setup_scenario(rin, None)
    offset = (30.0 - first.sec % 30.0) % 30.0 + 30.0 - LEAD_S
    g0 = setup_scenario(rin, inc_gps_time(first, offset))
    rng = np.random.default_rng(18)
    base = np.array([35.681298 / 57.2957795131,
                     139.766247 / 57.2957795131, 10.0])
    xyz = np.stack([np.asarray(llh2xyz(base + [rng.uniform(-1e-4, 1e-4),
                                               rng.uniform(-1e-4, 1e-4),
                                               rng.uniform(0.0, 100.0)]))
                    for _ in range(3)])
    return rin, g0, select_ephemeris_set(rin, g0), xyz, offset


def _batch(scenario) -> MonteCarloBatch:
    rin, g0, ieph, xyz, _ = scenario
    return MonteCarloBatch(rin, g0, ieph, xyz, fs=FS)


def _calls(mc, sizes, **kw) -> np.ndarray:
    """superframes() calls of the given sizes, as [B, sum(sizes), N, 2]."""
    parts = []
    for n_blocks in sizes:
        iq = np.concatenate([iq for _, iq in mc.superframes(n_blocks, "cpu",
                                                             **kw)])
        parts.append(iq.reshape(mc.B, n_blocks, *iq.shape[1:]))
    return np.concatenate(parts, axis=1)


@pytest.fixture(scope="module")
def plain(scenario) -> np.ndarray:
    """The batch's BLOCKS blocks from one generate(): no lookahead."""
    mc = _batch(scenario)
    assert (mc.split_k, mc.sub_block_samples) == (3, 33_334)
    iq = mc.generate(BLOCKS, "cpu")
    assert mc.lookahead_hits == mc.lookahead_misses == 0
    assert mc.patch_dropped == 0
    return iq


@pytest.mark.parametrize("n,cap,want", [
    (100_000, 524_000, (1, 100_000)),
    (524_000, 524_000, (1, 524_000)),
    (524_001, 524_000, (2, 262_001)),
    (1_000_000, 524_000, (2, 500_000)),
    (100_000, 40_000, (3, 33_334)),
])
def test_split_geometry(monkeypatch, n, cap, want):
    """One block, K rows of sub samples: one row within the range, else
    the fewest equal sub-rows within it, covering the block."""
    monkeypatch.setattr(sc, "MAX_BLOCK_SAMPLES", cap)
    k, sub = split_geometry(n)
    assert (k, sub) == want
    assert sub <= cap and k * sub >= n > (k - 1) * sub


def test_split_batch_matches_split_streams(scenario, plain):
    """Every receiver's blocks, across the 30 s boundary, equal its own
    split kernel IqStream word for word."""
    rin, g0, ieph, xyz, _ = scenario
    assert plain.shape == (3, BLOCKS, N, 2)
    for b in range(3):
        st = IqStream(rin, g0, ieph, xyz[b], fs=FS, mode="kernel",
                      device="cpu")
        assert (st.split_k, st.sub_block_samples) == (3, 33_334)
        assert np.array_equal(plain[b], st.generate(BLOCKS)), b


def test_split_batch_lookahead_hit_and_miss(scenario, plain):
    """Calls of 2, 2, 2 and 1 blocks: the third takes the lookahead the
    second started (a hit), the fourth discards the third's (a miss);
    the bytes equal the batch that never looked ahead."""
    mc = _batch(scenario)
    got = _calls(mc, CALLS)
    assert (mc.lookahead_hits, mc.lookahead_misses) == (1, 1)
    assert np.array_equal(got, plain)


def test_split_batch_as_device_in_uneven_chunks(scenario, plain):
    """as_device=True with chunk_blocks=4, which divides none of the
    batch's 21 blocks: offsets and lengths count whole blocks, each a
    [len, N] view of its sub-rows, and the words equal the host rows."""
    mc = _batch(scenario)
    seen, words = [], []
    for off, dev in mc.superframes(BLOCKS, "cpu", chunk_blocks=4,
                                   as_device=True):
        assert dev.dtype == torch.int32 and dev.shape[1] == N
        assert dev._base is not None           # a view, nothing copied
        seen.append((off, dev.shape[0]))
        words.append(dev.numpy())
    assert seen == [(0, 4), (4, 4), (8, 4), (12, 4), (16, 4), (20, 1)]
    iq = judge.iq_of_words(np.concatenate(words)).reshape(plain.shape)
    assert np.array_equal(iq, plain)


def _reference(fixture_paths, scenario, dtype) -> dict:
    _, _, _, xyz, offset = scenario
    out = {}
    for b in range(3):
        iq = reference.replay(fixture_paths["rinex2"], offset, xyz[b], FS,
                              range(BLOCKS), "cpu", dtype)
        out.update({(b, k): v for k, v in iq.items()})
    return out


def test_split_batch_within_correct_limits(fixture_paths, scenario, plain):
    """Against the unsplit f64 closed form the batch passes the gate;
    the reference with float32 ramps, in the batch's place, fails it."""
    want = _reference(fixture_paths, scenario, torch.float64)
    got = {(b, k): plain[b, k] for b in range(3) for k in range(BLOCKS)}
    ok, checks = judge.verdict(judge.compare(got, want))
    assert ok and checks["blocks"]["value"] == 3 * BLOCKS, checks
    ctl = _reference(fixture_paths, scenario, torch.float32)
    ok, checks = judge.verdict(judge.compare(ctl, want))
    assert not ok, checks


def test_mesh_refuses_split_batch(scenario):
    mc = _batch(scenario)
    with pytest.raises(ValueError, match="split"):
        next(mc.superframes(2, "cpu", mesh=object()))
