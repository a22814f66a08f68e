"""The CUDA synthesis kernel's plain twin against the Pallas kernel.

synth_cuda.synth_blocks on CPU tensors runs synth_blocks_plain, the
kernel's integer and f32 op sequence in torch.  It is held here against
the JAX package's synth_blocks_pallas in interpret mode (the same
sequence run by XLA on the CPU) on the JAX package's own kernel
scenarios.  Tolerance: exact equality of every packed word (trimmed to
block_samples), since both sides evaluate the same arithmetic on the
same f32/int32 inputs; where the JAX tests require the f64 precise path
to agree exactly, the twin must agree exactly too.  The CUDA kernel
itself is held to this twin on the card by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu.constants import MAX_CHAN, R2D
from pluto_gps_sim_tpu.ingest import read_rinex2
from pluto_gps_sim_tpu.models.cacode import CA_TABLE
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.ops import synth_pallas as sp
from pluto_gps_sim_tpu.ops.synth_jnp import (pack_plan, split_plan,
                                             synth_superframe_precise)
from pluto_gps_sim_tpu.runtime import select_ephemeris_set, setup_scenario
from pluto_gps_sim_tpu.runtime.scheduler import Scheduler, SuperframePlan

from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])


@pytest.fixture(scope="module")
def scenario(fixture_paths):
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    return rin, g0, select_ephemeris_set(rin, g0), np.asarray(llh2xyz(TOKYO))


def _pallas(prmi, prmf, ca, sf_map, n, packed=True):
    out = sp.synth_blocks_pallas((prmi, prmf), ca, sf_map, n,
                                 packed=packed, interpret=True)
    if packed:
        return np.asarray(out)[:, :n]
    return tuple(np.asarray(o)[:, :n] for o in out)


def _twin(prmi, prmf, ca, sf_map, n, packed=True):
    out = sc.synth_blocks(prmi, prmf, ca, sf_map, n, packed=packed)
    if packed:
        return out.numpy()
    return tuple(o.numpy() for o in out)


def _check(prmi, prmf, ca, sf_map, n, golden=None):
    """Twin == Pallas interpret word for word (and == the f64 precise
    path when given); returns the twin's int16 IQ."""
    want = _pallas(prmi, prmf, ca, sf_map, n)
    got = _twin(prmi, prmf, ca, sf_map, n)
    assert got.shape == want.shape == (prmi.shape[0], n)
    bad = int((got != want).sum())
    assert bad == 0, f"twin differs from pallas in {bad} words"
    iq = sc.unpack_iq(got)
    if golden is not None:
        assert np.array_equal(iq, golden), (
            f"{int((iq != golden).sum())} components differ from precise")
    return iq


def _synthetic_plan(seed, n_active, f_carr_active, gain_fn, n=65536,
                    fs=2_600_000.0):
    """One synthetic block, built as the JAX package's kernel tests
    build theirs (seeded nav bits, code phases and carrier phases)."""
    C = MAX_CHAN
    rng = np.random.RandomState(seed)
    active = np.zeros((1, C), bool)
    active[0, :n_active] = True
    f_carr = np.zeros((1, C))
    f_carr[0, :n_active] = f_carr_active
    return SuperframePlan(
        n_blocks=1, block_samples=n, delt=1.0 / fs,
        prn=np.where(active[0], np.arange(1, C + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=1_023_000.0 + f_carr / 1540.0,
        code_phase=rng.uniform(0, 1023, (1, C)),
        icode=rng.randint(0, 20, (1, C)).astype(np.int32),
        ibit=rng.randint(0, 30, (1, C)).astype(np.int32),
        iword=rng.randint(0, 10, (1, C)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (1, C)),
        gain=gain_fn(active), azel=np.zeros((1, C, 2)))


def _one_plane(dp, nudge=True):
    prm = sp.build_block_params(dp, nudge=nudge)
    return (prm.prmi, prm.prmf, sp.pack_ca_tables([dp.ca2]),
            np.zeros(dp.n_blocks, np.int32), dp.block_samples)


def test_twin_matches_pallas_and_precise(scenario):
    """The test_pallas_matches_precise scenario: 2 blocks at 2.6 MHz."""
    rin, g0, ieph, xyz = scenario
    dp = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=2_600_000.0).plan(2))
    prmi, prmf, ca, sf_map, n = _one_plane(dp)
    _check(prmi, prmf, ca, sf_map, n, golden=synth_superframe_precise(dp))


def test_twin_gain_above_unity(scenario):
    """One channel pushed above unity gain (the biased accumulator's
    budget), as test_pallas_gain_above_unity builds it."""
    rin, g0, ieph, xyz = scenario
    plan = Scheduler(rin, g0, ieph, xyz, fs=1_000_000.0,
                     block_samples=65_536).plan(1)
    first = int(np.flatnonzero(plan.active[0])[0])
    act = np.zeros_like(plan.active)
    act[:, first] = True
    plan.active = act
    gain = plan.gain.copy()
    gain[:, first] *= 1.0503761437 / gain[:, first].max()
    plan.gain = gain
    dp = pack_plan(plan)
    iq = _check(*_one_plane(dp))
    golden = synth_superframe_precise(dp)
    assert golden.min() < -520, "scenario failed to exceed unity gain"
    assert int(np.abs(iq.astype(np.int64) - golden).max()) <= 1


def test_twin_doppler_resonant_block():
    """A Doppler that keeps the 9-bit LUT index on a boundary for the
    whole block (test_doppler_resonant_block_tracks_precise)."""
    fs = 2_600_000.0
    dp = pack_plan(_synthetic_plan(
        11, 4, [((3.0 + 1e-9) / 512.0) * fs, -2717.3, 395.9, -967.7],
        lambda act: np.where(act, 0.8, 0.0), fs=fs))
    _check(*_one_plane(dp), golden=synth_superframe_precise(dp))


def _boundary_dp():
    g_boundary = 0.9086419713826426

    def gain(act):
        g = np.where(act, 0.5, 0.0)
        g[0, 1] = g_boundary
        return g
    return pack_plan(_synthetic_plan(7, 3, [-2717.3, 395.9, -967.7], gain))


def test_twin_patch_words_exact():
    """nudge=False keeps two gain-trunc patch words, which the patch
    pass (K2) must apply: exact against pallas and the f64 path, and
    with the words zeroed the twin must show the 1-LSB error they fix."""
    dp = _boundary_dp()
    golden = synth_superframe_precise(dp)
    prmi, prmf, ca, sf_map, n = _one_plane(dp, nudge=False)
    words = [prmf[0, sc.patch_word_lane(k)] for k in range(sc._N_PATCH)]
    assert sum(w != 0 for w in words) == 2
    _check(prmi, prmf, ca, sf_map, n, golden=golden)

    prmf_no = prmf.copy()
    for k in range(sc._N_PATCH):
        prmf_no[:, sc.patch_word_lane(k)] = 0.0
    iq = _check(prmi, prmf_no, ca, sf_map, n)
    err = np.abs(iq.astype(np.int64) - golden)
    assert int((err > 0).sum()) > 0 and int(err.max()) == 1


def test_twin_patch_overflow():
    """Seven saturated patch slots (the overflow case): equal to pallas,
    within 1 LSB of the f64 path."""
    def gain(act):
        g = np.where(act, 0.5, 0.0)
        g[0, 0] = 0.5483870934593348
        return g
    dp = pack_plan(_synthetic_plan(5, 2, [-2717.3, 395.9], gain))
    prmi, prmf, ca, sf_map, n = _one_plane(dp, nudge=False)
    words = [prmf[0, sc.patch_word_lane(k)] for k in range(sc._N_PATCH)]
    assert sum(w != 0 for w in words) == sc._N_PATCH
    iq = _check(prmi, prmf, ca, sf_map, n)
    golden = synth_superframe_precise(dp)
    assert int(np.abs(iq.astype(np.int64) - golden).max()) <= 1


def test_twin_split_plan(scenario):
    """Sub-blocks of a split plan (test_split_plan_lifts_block_cap):
    exact against pallas and the precise path on the split plan."""
    rin, g0, ieph, xyz = scenario
    plan = Scheduler(rin, g0, ieph, xyz, fs=1_000_000.0,
                     block_samples=49152).plan(4)
    dp_s = split_plan(pack_plan(plan), 16384)
    assert dp_s.n_blocks == 12 and dp_s.block_samples == 16384
    prm = sp.build_group_params([dp_s])
    _check(prm.prmi, prm.prmf, sp.pack_ca_tables([dp_s.ca2]),
           np.zeros(dp_s.n_blocks, np.int32), dp_s.block_samples,
           golden=synth_superframe_precise(dp_s))


def test_twin_multi_superframe_sf_map(scenario):
    """Several superframes in one dispatch, each block selecting its C/A
    table through sf_map: a real plan_group, plus the same planes with
    tables permuted so a wrong table choice would show."""
    rin, g0, ieph, xyz = scenario
    plans = Scheduler(rin, g0, ieph, xyz, fs=1_000_000.0,
                      block_samples=8192).plan_group(3, 3)
    dps = [pack_plan(p, tables=False) for p in plans]
    prm = sp.build_group_params(dps)
    ca = sp.pack_ca_tables([dp.ca2 for dp in dps])
    sf_map = np.concatenate([np.full(dp.n_blocks, i, np.int32)
                             for i, dp in enumerate(dps)])
    assert len(dps) == 3 and sf_map.size == 9
    ca_mixed = np.concatenate([ca, np.roll(ca, 3, axis=1)])
    sf_mixed = np.array([0, 3, 1, 4, 2, 5, 0, 4, 2], np.int32)
    mixed = _check(prm.prmi, prm.prmf, ca_mixed, sf_mixed, 8192)
    own = sc.unpack_iq(_twin(prm.prmi, prm.prmf, ca, sf_map, 8192))
    # each block reads the table sf_map names: the blocks that kept
    # their own superframe's table are unchanged, and every block sent
    # to a channel-rolled table (index >= 3) changed
    keep = sf_mixed == sf_map
    assert np.array_equal(mixed[keep], own[keep])
    assert all(not np.array_equal(mixed[i], own[i])
               for i in np.flatnonzero(sf_mixed >= 3))


def test_twin_unpacked_epilogue(scenario):
    """packed=False emits separate int32 I and Q (the sharded form)."""
    rin, g0, ieph, xyz = scenario
    dp = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=1_000_000.0,
                             block_samples=20000).plan(3), tables=False)
    prmi, prmf, ca, sf_map, n = _one_plane(dp)
    want = _pallas(prmi, prmf, ca, sf_map, n, packed=False)
    got = _twin(prmi, prmf, ca, sf_map, n, packed=False)
    for w, g in zip(want, got):
        assert g.dtype == np.int32 and np.array_equal(w, g)
    packed = _twin(prmi, prmf, ca, sf_map, n)
    iq = sc.unpack_iq(packed)
    assert np.array_equal(iq[..., 0], got[0]) and \
        np.array_equal(iq[..., 1], got[1])


def test_twin_chunked_rows_match(scenario, monkeypatch):
    """Row chunking of the twin's int64 temporaries is invisible."""
    rin, g0, ieph, xyz = scenario
    dp = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=1_000_000.0,
                             block_samples=4096).plan(5), tables=False)
    prmi, prmf, ca, sf_map, n = _one_plane(dp)
    args = [torch.from_numpy(a) for a in (prmi, prmf, ca, sf_map)]
    whole = sc.synth_blocks_plain(*args, n)
    for rows in (1, 2, 3):
        monkeypatch.setattr(sc, "_TWIN_CHUNK_SAMPLES", rows * n)
        assert torch.equal(sc.synth_blocks_plain(*args, n), whole)


def test_check_sf_map_range():
    """The host-side range check the stream runs before staging a map
    to the card."""
    sc.check_sf_map(np.array([0, 1, 2, 2], np.int32), 3)
    sc.check_sf_map(np.zeros(0, np.int32), 1)
    for bad in ([0, 3], [-1, 0]):
        with pytest.raises(ValueError):
            sc.check_sf_map(np.array(bad, np.int32), 3)


@pytest.mark.parametrize("bad", ["dtype", "plane_shape", "ca_shape",
                                 "sf_shape", "block_samples", "contiguity",
                                 "sf_range"])
def test_wrapper_rejects_bad_inputs(bad):
    M, n = 2, 1000
    prmi = np.zeros((M, 256), np.int32)
    prmf = np.zeros((M, 256), np.float32)
    ca = np.zeros((1, 12, 1, 128), np.int32)
    sf_map = np.zeros(M, np.int32)
    args = [torch.from_numpy(a) for a in (prmi, prmf, ca, sf_map)]
    err = ValueError
    if bad == "dtype":
        args[1] = args[1].double()
        err = TypeError
    elif bad == "plane_shape":
        args[0] = args[0][:, :128]
    elif bad == "ca_shape":
        args[2] = args[2][:, :11]
    elif bad == "sf_shape":
        args[3] = args[3][:1]
    elif bad == "block_samples":
        n = sc.MAX_KERNEL_SAMPLES + 1
    elif bad == "contiguity":
        args[0] = torch.zeros((256, M), dtype=torch.int32).t()
    else:
        args[3] = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(err):
        sc.synth_blocks(*args, n)


def test_cpu_tensors_never_count_as_kernel_launches(scenario):
    """On the CPU the wrapper runs the twin, and only a real kernel
    launch counts."""
    prmi = np.zeros((1, 256), np.int32)
    prmf = np.zeros((1, 256), np.float32)
    sc.reset_launch_count()
    out = sc.synth_blocks(prmi, prmf, np.zeros((1, 12, 1, 128), np.int32),
                          np.zeros(1, np.int32), 64)
    assert out.device.type == "cpu" and not bool(out.any())
    assert sc.launch_count() == 0
