"""The PyTorch package's multi-device modules against the JAX package's.

parallel/{mesh,shard,multiproc_dryrun} and the mesh= arguments of
IqStream and MonteCarloBatch run over torch.distributed with one process
per rank; here every rank is a CPU process in a gloo group and runs the
kernel's plain twin.  In process: the numpy sharding helpers are
byte-equal to the JAX package's, and the sum over channel shards of the
twin's packed=False output, packed after the sum, equals the twin's
packed output and the Pallas kernel in interpret mode.  One spawned
4-rank world (module-scoped, so its start-up is paid once) runs the
sharded stream and batches; the pytest process holds what each rank
wrote against the port's single-rank runs and the JAX package's mesh
runs (8 virtual CPU devices).  Tolerance: np.array_equal everywhere —
every path evaluates the same planes with the same integer arithmetic.
"""

from __future__ import annotations

import json
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pluto_gps_sim_tpu.constants import MAX_CHAN, R2D
from pluto_gps_sim_tpu.ingest import read_rinex2 as j_read
from pluto_gps_sim_tpu.models.cacode import CA_TABLE
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.ops import synth_pallas as sp
from pluto_gps_sim_tpu.parallel import MonteCarloBatch as JBatch
from pluto_gps_sim_tpu.parallel import mesh as j_mesh
from pluto_gps_sim_tpu.parallel import shard as j_shard
from pluto_gps_sim_tpu.runtime import scenario as j_scen
from pluto_gps_sim_tpu.runtime.scheduler import SuperframePlan
from pluto_gps_sim_tpu.runtime.stream import IqStream as JStream

from pluto_gps_sim_tpu_torch.ingest import read_rinex2 as t_read
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan
from pluto_gps_sim_tpu_torch.parallel import (MonteCarloBatch,
                                              factor_devices, make_mesh,
                                              pad_time_shards,
                                              shard_channel_params)
from pluto_gps_sim_tpu_torch.parallel import mesh as t_mesh
from pluto_gps_sim_tpu_torch.parallel import multiproc_dryrun as mpd
from pluto_gps_sim_tpu_torch.parallel.shard import pack_iq
from pluto_gps_sim_tpu_torch.runtime import scenario as t_scen
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream

FS = 1_000_000.0
TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
SPAWN_TIMEOUT = 240.0


def _perturbed_receivers(b: int) -> np.ndarray:
    """B receivers scattered ~km around Tokyo (test_montecarlo's)."""
    rng = np.random.RandomState(5)
    out = []
    for _ in range(b):
        llh = TOKYO + np.array([rng.uniform(-1e-4, 1e-4),
                                rng.uniform(-1e-4, 1e-4),
                                rng.uniform(0, 100)])
        out.append(np.asarray(llh2xyz(llh)))
    return np.stack(out)


@pytest.fixture(scope="module")
def scenarios(fixture_paths):
    """(JAX, port) scenario triples from the RINEX fixture."""
    out = []
    for read, scen in ((j_read, j_scen), (t_read, t_scen)):
        rin = read(fixture_paths["rinex2"])
        g0 = scen.setup_scenario(rin, None)
        out.append((rin, g0, scen.select_ephemeris_set(rin, g0)))
    return out


# ---------------------------------------------------------------------------
# numpy sharding helpers, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_factor_devices_matches_jax(n):
    assert factor_devices(n) == j_mesh.factor_devices(n)


@pytest.mark.parametrize("m", [1, 3, 5])
@pytest.mark.parametrize("n_time", [1, 2, 4])
def test_pad_time_shards_matches_jax(m, n_time):
    rng = np.random.RandomState(m * 10 + n_time)
    prmi = rng.randint(-2**31, 2**31 - 1, (m, 256)).astype(np.int32)
    prmf = rng.uniform(-1, 1, (m, 256)).astype(np.float32)
    sf_map = rng.randint(0, 3, m).astype(np.int32)
    got = pad_time_shards(prmi, prmf, sf_map, n_time)
    want = j_shard.pad_time_shards(prmi, prmf, sf_map, n_time)
    assert got[0].shape[0] % n_time == 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _patch_plan():
    """One 16,384-sample block at 2.6 MHz with all 12 channel slots
    active; channels 1 and 7 sit on a gain whose f32 trunc straddles an
    integer (test_torch_synth_kernel's boundary gain), so a nudge=False
    build keeps two patch words for each, in different channel shards."""
    rng = np.random.RandomState(7)
    C, fs = MAX_CHAN, 2_600_000.0
    active = np.ones((1, C), bool)
    f_carr = rng.uniform(-4500.0, 4500.0, (1, C))
    gain = rng.uniform(0.3, 0.9, (1, C))
    gain[0, [1, 7]] = 0.9086419713826426
    return pack_plan(SuperframePlan(
        n_blocks=1, block_samples=16384, delt=1.0 / fs,
        prn=np.arange(1, C + 1, dtype=np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=1_023_000.0 + f_carr / 1540.0,
        code_phase=rng.uniform(0, 1023, (1, C)),
        icode=rng.randint(0, 20, (1, C)).astype(np.int32),
        ibit=rng.randint(0, 30, (1, C)).astype(np.int32),
        iword=rng.randint(0, 10, (1, C)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (1, C)),
        gain=gain, azel=np.zeros((1, C, 2))), tables=False)


@pytest.fixture(scope="module")
def patch_case():
    """Kernel inputs of _patch_plan (nudge=False) and the Pallas kernel's
    packed output on them (interpret mode)."""
    dp = _patch_plan()
    bp = sc.build_group_params([dp], nudge=False)
    ca = sc.pack_ca_tables([dp.ca2])
    sf_map = np.zeros(1, np.int32)
    words = [int(bp.prmf[0, sc.patch_word_lane(k)])
             for k in range(sc._N_PATCH)]
    chans = sorted({(w >> 2) & 15 for w in words if w})
    assert chans == [1, 7], words
    want = np.asarray(sp.synth_blocks_pallas(
        (bp.prmi, bp.prmf), ca, sf_map, dp.block_samples,
        interpret=True))[:, :dp.block_samples]
    return bp.prmi, bp.prmf, ca, sf_map, dp.block_samples, want


@pytest.mark.parametrize("n_chan", [1, 2, 3, 4])
def test_shard_channel_params_matches_jax(patch_case, n_chan):
    _, prmf, *_ = patch_case
    got = shard_channel_params(prmf, n_chan)
    want = j_shard.shard_channel_params(prmf, n_chan)
    assert got.shape == (n_chan,) + prmf.shape
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _sum_of_shards(prmi, shards, ca, sf_map, n):
    i_sum = q_sum = 0
    for prmf_s in shards:
        i, q = sc.synth_blocks(prmi, prmf_s, ca, sf_map, n, packed=False)
        i_sum = i_sum + i
        q_sum = q_sum + q
    return pack_iq(i_sum, q_sum).numpy()


@pytest.mark.parametrize("n_chan", [1, 2, 3, 4])
def test_sum_over_channel_shards_matches_packed(patch_case, n_chan):
    """Each shard's packed=False twin output, summed and then packed,
    equals the twin's packed output and the Pallas kernel's; without
    the per-shard filter the sum no longer matches."""
    prmi, prmf, ca, sf_map, n, want = patch_case
    twin = sc.synth_blocks(prmi, prmf, ca, sf_map, n).numpy()
    assert np.array_equal(twin, want)
    got = _sum_of_shards(prmi, shard_channel_params(prmf, n_chan), ca,
                         sf_map, n)
    assert np.array_equal(got, want)
    if n_chan == 1:
        return
    # np.repeat alone: every shard synthesizes every channel
    bare = _sum_of_shards(prmi, np.repeat(prmf[None], n_chan, axis=0), ca,
                          sf_map, n)
    assert not np.array_equal(bare, want)
    # foreign gains zeroed but patch words left replicated: each word
    # is applied once per shard
    gains_only = shard_channel_params(prmf, n_chan)
    for k in range(sc._N_PATCH):
        gains_only[:, :, sc.patch_word_lane(k)] = \
            prmf[None, :, sc.patch_word_lane(k)]
    bad = _sum_of_shards(prmi, gains_only, ca, sf_map, n)
    diff = np.abs(sc.unpack_iq(bad).astype(np.int64)
                  - sc.unpack_iq(want).astype(np.int64))
    assert diff.max() > 0


def test_pack_iq_matches_jax_shift():
    """pack_iq == JAX's (i & 0xFFFF) | shift_left(q, 16) in int32, for
    negative, extreme and wrapping I and Q."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(1)
    edge = np.array([0, 1, -1, 32767, -32768, 65535, -65536, 2**31 - 1,
                     -2**31], np.int32)
    i = np.concatenate([edge, np.repeat(edge, edge.size),
                        rng.randint(-2**31, 2**31 - 1, 500)]).astype(np.int32)
    q = np.concatenate([edge[::-1], np.tile(edge, edge.size),
                        rng.randint(-2**31, 2**31 - 1, 500)]).astype(np.int32)
    with jax.enable_x64(False):
        want = np.asarray((jnp.asarray(i) & jnp.int32(0xFFFF))
                          | jax.lax.shift_left(jnp.asarray(q),
                                               jnp.int32(16)))
    got = pack_iq(torch.from_numpy(i), torch.from_numpy(q))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# a one-rank process group in this process: refusals and the mesh= plumbing
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_refuses_bad_shapes_and_shared_cards(world1):
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"time": 1, "chan": 1} and mesh.coord == (0, 0)
    assert mesh.backend == "gloo" and mesh.device == torch.device("cpu")
    for shape in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="!= 1 ranks"):
            make_mesh(*shape, device="cpu")
    t_mesh.check_distinct_cards(["h/GPU-a", "h/GPU-b", "g/GPU-a"])
    with pytest.raises(ValueError, match="NCCL refuses duplicate GPUs"):
        t_mesh.check_distinct_cards(["h/GPU-a", "h/GPU-b", "h/GPU-a"])


def test_mesh_needs_the_kernel_and_the_mesh_device(world1, scenarios):
    rin, g0, ieph = scenarios[1]
    mesh = make_mesh(device="cpu")
    xyz = np.asarray(llh2xyz(TOKYO))
    with pytest.raises(ValueError, match="mode='kernel'"):
        IqStream(rin, g0, ieph, xyz, fs=FS, mode="tiled", device="cpu",
                 mesh=mesh)
    with pytest.raises(ValueError, match="not the mesh's device"):
        IqStream(rin, g0, ieph, xyz, fs=FS, device="cuda", mesh=mesh)
    mc = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(1), fs=FS,
                         block_samples=16384)
    with pytest.raises(ValueError, match="not the mesh's device"):
        mc.generate(1, "cuda", mesh=mesh)


def test_one_rank_mesh_stream_matches_unsharded(world1, scenarios):
    """The mesh= branch of launch_blocks in process (a 1x1 mesh):
    the same stream, and the as_device words, as without a mesh."""
    rin, g0, ieph = scenarios[1]
    xyz = np.asarray(llh2xyz(TOKYO))
    mesh = make_mesh(device="cpu")
    kw = dict(fs=FS, block_samples=16384, device="cpu")
    want = IqStream(rin, g0, ieph, xyz, **kw).generate(2)
    got = IqStream(rin, g0, ieph, xyz, mesh=mesh, **kw).generate(2)
    assert np.array_equal(got, want)
    words = next(IqStream(rin, g0, ieph, xyz, mesh=mesh, **kw).superframes(
        2, as_device=True))
    assert words.dtype == torch.int32
    assert np.array_equal(sc.unpack_iq(words.numpy()), want)
    assert mesh.stats["launches"] == 2


# ---------------------------------------------------------------------------
# one spawned 4-rank gloo world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh4")
    np.save(out / "xyz.npy", np.asarray(llh2xyz(TOKYO)))
    np.save(out / "xyz_mc.npy", _perturbed_receivers(4))
    t0 = time.perf_counter()
    mpd.spawn_world(4, "gloo", "torch_mesh_worker:rank_body", (str(out),),
                    timeout=SPAWN_TIMEOUT)
    return out, time.perf_counter() - t0


def _ranks(out, name):
    return [np.load(out / f"{name}_{r}.npy") for r in range(4)]


def test_stream_mesh_2x2_matches_single_and_jax(world4, scenarios):
    """IqStream(mode="kernel", mesh=2x2).generate(3) on every rank ==
    the port's single-rank stream == the JAX IqStream(mode="pallas",
    mesh=make_mesh(8 CPU devices)), as
    test_stream_mesh_sharded_matches_single does."""
    import jax
    out, _ = world4
    (jr, jg, jieph), (tr, tg, tieph) = scenarios
    xyz = np.asarray(llh2xyz(TOKYO))
    single = IqStream(tr, tg, tieph, xyz, fs=FS, block_samples=32768,
                      device="cpu").generate(3)
    jax_mesh = JStream(jr, jg, jieph, xyz, fs=FS, block_samples=32768,
                       mode="pallas",
                       mesh=j_mesh.make_mesh(jax.devices("cpu")[:8])
                       ).generate(3)
    assert np.array_equal(single, jax_mesh)
    for r, got in enumerate(_ranks(out, "stream")):
        assert np.array_equal(got, single), f"rank {r}"


def test_stream_mesh_abandoned_generator_resumes(world4, scenarios):
    """Abandoning a mesh stream while its planners run ahead leaves no
    rank a collective ahead (the world finished), and the rollback
    resumes right after the delivered block on every rank."""
    out, _ = world4
    tr, tg, tieph = scenarios[1]
    want = IqStream(tr, tg, tieph, np.asarray(llh2xyz(TOKYO)), fs=FS,
                    block_samples=32768, device="cpu").generate(4)
    for r, got in enumerate(_ranks(out, "abandon")):
        assert np.array_equal(got, want), f"rank {r}"
    # the same 4 blocks in dispatch groups of 1 and 2 superframes,
    # yielded as packed words (as_device)
    for r, got in enumerate(_ranks(out, "k2")):
        assert np.array_equal(got, want), f"rank {r}"


def test_stream_mesh_split_sub_blocks(world4, scenarios):
    """fs = 6 MHz: each 600,000-sample block is 2 sub-blocks of the
    kernel's grid, sharded over time and reassembled on every rank."""
    out, _ = world4
    tr, tg, tieph = scenarios[1]
    single = IqStream(tr, tg, tieph, np.asarray(llh2xyz(TOKYO)), fs=6e6,
                      device="cpu")
    assert single.split_k == 2
    want = single.generate(1)
    for r, got in enumerate(_ranks(out, "split")):
        assert got.shape == (1, 600_000, 2)
        assert np.array_equal(got, want), f"rank {r}"


def test_mc_mesh_2x2_matches_unsharded_and_jax(world4, scenarios):
    """B=4 x 2 blocks at 1 MHz / 16,384 over 2x2 == the unsharded batch
    == the JAX batch over its 8-device mesh (test_montecarlo's
    test_mc_sharded_matches_unsharded)."""
    import jax
    out, _ = world4
    (jr, jg, jieph), (tr, tg, tieph) = scenarios
    xyz = _perturbed_receivers(4)
    want = MonteCarloBatch(tr, tg, tieph, xyz, fs=FS,
                           block_samples=16384).generate(2, "cpu")
    jax_mesh = JBatch(jr, jg, jieph, xyz, fs=FS, block_samples=16384
                      ).generate(n_blocks=2, mesh=j_mesh.make_mesh(
                          jax.devices("cpu")[:8]))
    assert np.array_equal(want, jax_mesh)
    for r, got in enumerate(_ranks(out, "mc22")):
        assert got.shape == (4, 2, 16384, 2)
        assert np.array_equal(got, want), f"rank {r}"


def test_mc_mesh_padding_small_batch(world4, scenarios):
    """B=1 x 1 block over a 4x1 mesh (padding beyond the batch, as
    test_mc_mesh_padding_small_batch) == the unsharded batch."""
    out, _ = world4
    tr, tg, tieph = scenarios[1]
    want = MonteCarloBatch(tr, tg, tieph, _perturbed_receivers(1), fs=FS,
                           block_samples=16384).generate(1, "cpu")
    for r, got in enumerate(_ranks(out, "mc41")):
        assert got.shape == (1, 1, 16384, 2)
        assert np.array_equal(got, want), f"rank {r}"


def test_world_ranks_sit_at_their_coordinates(world4):
    """Rank r at (t, c) = divmod(r, 2); every sharded launch on every
    rank went through the mesh; CPU ranks never count a CUDA launch."""
    out, _ = world4
    for r in range(4):
        st = json.loads((out / f"stats_{r}.json").read_text())
        assert st["coord"] == list(divmod(r, 2))
        # the stream, the abandoned and the resumed stream, the batch
        assert st["stats"]["launches"] >= 4
        assert st["stats41"]["launches"] == 1
        assert st["launches"] == 0


# ---------------------------------------------------------------------------
# the dryruns and the launcher's failure handling
# ---------------------------------------------------------------------------

def test_run_multiprocess_dryrun_four_gloo_ranks():
    out = mpd.run_multiprocess_dryrun(4, "gloo", "cpu",
                                      timeout=SPAWN_TIMEOUT)
    assert out.count(mpd.OK_TAG) == 4
    assert "chan spans processes" in out
    for r in range(4):
        assert f"{mpd.OK_TAG}: process {r}/4," in out


def test_dryrun_multichip_four_gloo_ranks():
    out = mpd.dryrun_multichip(4, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
    assert out.count(mpd.MULTICHIP_TAG) == 8
    assert "real-RINEX scheduler group" in out


def test_spawn_world_fails_fast_and_kills_every_rank():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 exited 1"):
        mpd.spawn_world(4, "gloo", "torch_mesh_worker:fail_on_rank1",
                        timeout=SPAWN_TIMEOUT)
    assert time.perf_counter() - t0 < 60


def test_spawn_world_times_out_and_kills_every_rank():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="timed out after 10 s"):
        mpd.spawn_world(2, "gloo", "torch_mesh_worker:sleep_forever",
                        timeout=10.0)
    assert time.perf_counter() - t0 < 40
