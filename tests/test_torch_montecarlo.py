"""The PyTorch package's MonteCarloBatch against the JAX package's.

Mirrors tests/test_montecarlo.py (all but its two mesh tests, which need
more than one device) with device="cpu", where the batch runs the
kernel's plain twin.  Tolerance: np.array_equal against the JAX
MonteCarloBatch.generate(interpret=True) (the Pallas kernel in
interpret mode) and against per-receiver port streams, since every
path evaluates the same planes with the same arithmetic; the JAX test's
SNR/exact bounds where it compares with the tiled path.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu.constants import R2D
from pluto_gps_sim_tpu.ingest import read_rinex2 as j_read
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.models.gpstime import inc_gps_time
from pluto_gps_sim_tpu.parallel import MonteCarloBatch as JBatch
from pluto_gps_sim_tpu.parallel.synthetic import synthetic_params as j_syn
from pluto_gps_sim_tpu.runtime import scenario as j_scen

import pluto_gps_sim_tpu_torch.parallel.montecarlo as mcm
from pluto_gps_sim_tpu_torch.ingest import read_rinex2 as t_read
from pluto_gps_sim_tpu_torch.models.lnav import NavCache
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan
from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch, \
    synthetic_params
from pluto_gps_sim_tpu_torch.runtime import scenario as t_scen
from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream

FS = 1_000_000.0
BS = 16_384  # small blocks keep the twin and interpret mode fast


@pytest.fixture(scope="module")
def scenario(fixture_paths):
    rin = t_read(fixture_paths["rinex2"])
    g0 = t_scen.setup_scenario(rin, None)
    return rin, g0, t_scen.select_ephemeris_set(rin, g0)


@pytest.fixture(scope="module")
def j_scenario(fixture_paths):
    rin = j_read(fixture_paths["rinex2"])
    g0 = j_scen.setup_scenario(rin, None)
    return rin, g0, j_scen.select_ephemeris_set(rin, g0)


def _perturbed_receivers(b: int) -> np.ndarray:
    """B receivers scattered ~km around Tokyo."""
    rng = np.random.RandomState(5)
    base = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
    out = []
    for i in range(b):
        llh = base + np.array([rng.uniform(-1e-4, 1e-4),
                               rng.uniform(-1e-4, 1e-4),
                               rng.uniform(0, 100)])
        out.append(np.asarray(llh2xyz(llh)))
    return np.stack(out)


def _boundary_start(g0):
    """The scenario clock moved to 0.4 s before the next 30 s boundary."""
    rem = (30.0 - (g0.sec % 30.0)) % 30.0
    return inc_gps_time(g0, rem + 30.0 - 0.4)


def test_mc_matches_individual_streams(scenario, j_scenario):
    rin, g0, ieph = scenario
    xyz = _perturbed_receivers(3)
    mc = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    batch = mc.generate(4, "cpu")
    assert batch.shape == (3, 4, BS, 2)
    jr, jg, jieph = j_scenario
    want = JBatch(jr, jg, jieph, xyz, fs=FS, block_samples=BS).generate(
        n_blocks=4, interpret=True)
    assert np.array_equal(batch, want)

    for b in range(3):
        solo = IqStream(rin, g0, ieph, xyz[b], fs=FS, block_samples=BS,
                        mode="tiled", device="cpu").generate(4)
        # twin vs tiled path: not bit-identical paths, compare by SNR
        # and near-total sample equality
        ref = solo.astype(np.float64)
        diff = ref - batch[b].astype(np.float64)
        snr = 10 * np.log10(ref.var() / max(diff.var(), 1e-30))
        exact = np.mean(solo == batch[b])
        assert snr > 70.0 and exact > 0.995, (b, snr, exact)


def test_mc_rejects_bad_shapes(scenario):
    rin, g0, ieph = scenario
    with pytest.raises(ValueError):
        MonteCarloBatch(rin, g0, ieph, np.zeros((2, 3, 3, 1)), fs=FS)


def test_mc_chunked_launches_match_single(scenario):
    """generate(chunk_blocks=...) must be bit-identical to one launch
    (it exists to bound device memory at B=256-scale batches)."""
    rin, g0, ieph = scenario
    xyz = _perturbed_receivers(3)
    mc1 = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    one = mc1.generate(4, "cpu")
    mc2 = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    chunked = mc2.generate(4, "cpu", chunk_blocks=5)
    assert np.array_equal(one, chunked)


def test_mc_boundary_branch_matches_individual(scenario, j_scenario):
    """The batched 30 s-boundary path (alloc precomp with the
    post-rollover eph set, shared NavCache init=False refresh), started
    0.4 s before a boundary: 8 blocks equal the unbatched per-receiver
    kernel streams and the JAX batch bit for bit."""
    rin, g0, ieph = scenario
    g0b = _boundary_start(g0)
    xyz = _perturbed_receivers(3)

    mc = MonteCarloBatch(rin, g0b, ieph, xyz, fs=FS, block_samples=BS)
    batch = mc.generate(8, "cpu")
    assert mc.nav_cache.hits > 0, "shared nav cache never hit"
    assert mc.control_seconds > 0 and mc.patch_dropped == 0

    for b in range(xyz.shape[0]):
        solo = IqStream(rin, g0b, ieph, xyz[b], fs=FS, block_samples=BS,
                        mode="kernel", device="cpu").generate(8)
        assert np.array_equal(batch[b], solo), f"receiver {b} diverges " \
            "across the 30 s boundary"
    jr, jg, jieph = j_scenario
    want = JBatch(jr, _boundary_start(jg), jieph, xyz, fs=FS,
                  block_samples=BS).generate(n_blocks=8, interpret=True)
    assert np.array_equal(batch, want)


def test_mc_streaming_superframes_match_monolithic(scenario):
    """superframes() streams (offset, chunk) pairs whose concatenation
    equals generate() — the bounded-host-RSS consumer for batches whose
    full IQ (B=256 x 300 blocks ~ 80 GB) must never materialize."""
    rin, g0, ieph = scenario
    mc = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(3), fs=FS,
                         block_samples=BS)
    mono = mc.generate(7, "cpu")                    # [3, 7, N, 2]

    mc2 = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(3), fs=FS,
                          block_samples=BS)
    crc_mono = [zlib.crc32(mono.reshape(21, BS, 2)[r].tobytes())
                for r in range(21)]
    seen = 0
    for off, iq in mc2.superframes(7, "cpu", chunk_blocks=4):
        assert off == seen and iq.shape[0] <= 4
        for j in range(iq.shape[0]):
            assert zlib.crc32(iq[j].tobytes()) == crc_mono[off + j], \
                f"chunk CRC mismatch at global block {off + j}"
        seen += iq.shape[0]
    assert seen == 21


def test_mc_streaming_as_device(scenario):
    """as_device=True yields packed int32 tensors (no host fetch); their
    manual unpack equals the host path."""
    rin, g0, ieph = scenario
    mc = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(2), fs=FS,
                         block_samples=BS)
    mono = mc.generate(3, "cpu").reshape(6, BS, 2)
    mc2 = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(2), fs=FS,
                          block_samples=BS)
    got = []
    for off, dev in mc2.superframes(3, "cpu", chunk_blocks=3,
                                    as_device=True):
        assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int32
        packed = dev.numpy()[:, :BS]
        got.append(np.stack(
            [(packed & 0xFFFF).astype(np.uint16).view(np.int16),
             (packed >> 16).astype(np.int16)], axis=-1))
    assert np.array_equal(np.concatenate(got, axis=0), mono)


def test_mc_union_resolve_branch_matches_per_receiver(scenario, j_scenario):
    """plan_blocks' union-of-allocated-SVs solve has a re-solve guard
    for boundary re-allocations that claim an SV outside the solved
    union.  Drive 40 superframes (20 min, with real rise/set churn) at
    B=2 and assert (a) the guard FIRED (more batched solves than
    eph-run/epoch-cap chunks), (b) the packed planes are bit-identical
    to independent per-receiver Schedulers planning the same span, and
    (c) planes, sf_map and C/A tables equal the JAX batch's (whose table
    list only adds power-of-two padding past the deduped tables)."""
    rin, g0, ieph = scenario
    xyz = _perturbed_receivers(2)
    n_blocks = 40 * 300
    mc = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)

    spans = mc.scheds[0].simulate_spans(total_blocks=n_blocks)
    chunks = 0
    i = 0
    while i < len(spans):
        j, total = i, spans[i][1]
        while (j + 1 < len(spans) and spans[j + 1][2] == spans[i][2]
               and total + spans[j + 1][1] + 1
               <= MonteCarloBatch._SOLVE_CHUNK_EPOCHS):
            j += 1
            total += spans[j][1]
        chunks += 1
        i = j + 1

    sv0 = [s.state.sv_idx.copy() for s in mc.scheds]
    calls = []
    orig = mcm.solve_ranges_batch_lean

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    mcm.solve_ranges_batch_lean = spy
    try:
        prmi, prmf, ca2, sf_map = mc.plan_blocks(n_blocks)
    finally:
        mcm.solve_ranges_batch_lean = orig

    assert any(not np.array_equal(a, s.state.sv_idx)
               for a, s in zip(sv0, mc.scheds)), \
        "scenario never re-allocated channels; guard untested"
    assert len(calls) > chunks, \
        (len(calls), chunks,
         "union re-solve branch never fired; pin a churnier span")
    assert mc.patch_dropped == 0

    for b in range(2):
        sched = Scheduler(rin, g0, ieph, xyz[b], fs=FS, block_samples=BS,
                          nav_cache=NavCache())
        plans, done = [], 0
        while done < n_blocks:
            p = sched.plan(n_blocks - done)
            plans.append(p)
            done += p.n_blocks
        bp = sc.build_group_params(
            [pack_plan(p, tables=False) for p in plans])
        lo = b * n_blocks
        assert np.array_equal(prmi[lo:lo + n_blocks], bp.prmi), b
        assert np.array_equal(prmf[lo:lo + n_blocks], bp.prmf), b

    jr, jg, jieph = j_scenario
    jprmi, jprmf, jca2, jsf = JBatch(jr, jg, jieph, xyz, fs=FS,
                                     block_samples=BS).plan_blocks(n_blocks)
    assert np.array_equal(prmi, jprmi) and np.array_equal(prmf, jprmf)
    assert np.array_equal(sf_map, jsf)
    assert np.array_equal(ca2, jca2[:ca2.shape[0]])
    assert int(sf_map.max()) == ca2.shape[0] - 1


def test_mc_rejects_blocks_beyond_kernel_range(scenario):
    """fs > 5.24 MHz exceeds the kernel's Q24 block range; the
    single-receiver stream splits transparently but the batch path does
    not — MonteCarloBatch fails with guidance at construction."""
    rin, g0, ieph = scenario
    with pytest.raises(ValueError, match="Q24 range"):
        MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(2), fs=10e6)


def test_mc_cuda_without_gpu_raises(scenario, monkeypatch):
    """device="cuda" without a GPU raises; the batch never moves to the
    CPU twin on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rin, g0, ieph = scenario
    mc = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(2), fs=FS,
                         block_samples=BS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mc.generate(1, "cuda")


def test_cpu_batch_never_counts_kernel_launches(scenario):
    rin, g0, ieph = scenario
    mc = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(2), fs=FS,
                         block_samples=BS)
    sc.reset_launch_count()
    mc.generate(2, "cpu")
    assert sc.launch_count() == 0


@pytest.mark.parametrize("n_blocks,block_samples,seed",
                         [(3, 4096, 3), (2, 260_000, 9)])
def test_synthetic_params_match_jax(n_blocks, block_samples, seed):
    got = synthetic_params(n_blocks, block_samples, seed=seed)
    want = j_syn(n_blocks, block_samples, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
