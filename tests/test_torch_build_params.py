"""The parameter planes of a Monte-Carlo batch and of a stream, built by
ops.synth_cuda.build_params, against the host build.

CPU tests: MonteCarloBatch.plan_blocks(n) and plan_blocks(n,
device="cpu") return the planes, C/A tables and sf_map of the host build
(one pack_plan(tables=False) per plan, the C/A tables deduped by bytes,
one build_group_params) byte for byte, across a 30 s boundary and through
the union re-solve branch; the wrapper's plain version equals
build_group_params on plans forced through the gain nudge, patch words
and the slot overflow; the wrapper refuses what the host build refuses;
IqStream builds on the card only on the kernel path on a CUDA device,
unsharded and unsplit; and its patch_dropped sums host and card counts
into an int.

Tests marked `cuda` hold the CUDA kernel to the host build byte for byte
on a card, a batch that plans ahead on the card to one that does not, and
a stream whose planes are built on the card to the same stream built on
the host, and sum dropped patch words added on two CUDA streams, and skip
elsewhere.  Run them on a machine with a CUDA card and
nvcc from the repository root (this file imports no JAX, so the suite's
conftest can be left out):

    python -m pytest --noconftest -m cuda tests/test_torch_build_params.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from fixtures import ensure_fixtures

from pluto_gps_sim_tpu_torch.constants import MAX_CHAN, R2D
from pluto_gps_sim_tpu_torch.ingest import read_rinex2
from pluto_gps_sim_tpu_torch.models.cacode import CA_TABLE
from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz
from pluto_gps_sim_tpu_torch.models.gpstime import GpsTime, inc_gps_time
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan
from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch
from pluto_gps_sim_tpu_torch.runtime import scenario as scen
from pluto_gps_sim_tpu_torch.runtime import stream as stream_mod
from pluto_gps_sim_tpu_torch.runtime.launch import DroppedCount, pack_group
from pluto_gps_sim_tpu_torch.runtime.scheduler import (Scheduler,
                                                       SuperframePlan)
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream, builds_on_card

FS = 1_000_000.0
BS = 16_384

# gains whose f32 products straddle the f64 truncs (synth_cuda._SLOT_I):
# ~17/31 - 3e-9 is cleared by nudging the lane one ulp down; the double
# nearest 0.7 keeps one mismatching magnitude on every lane tried (a
# patch word); the double nearest 6/11 keeps ten, more words than a
# row's seven slots hold
NUDGED, PATCHED, OVERFLOWED = 0.5483870934593348, 0.7, 6 / 11


@pytest.fixture(scope="module")
def scenario():
    rin = read_rinex2(ensure_fixtures()["rinex2"])
    g0 = scen.setup_scenario(rin, None)
    return rin, g0, scen.select_ephemeris_set(rin, g0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _receivers(b: int, seed: int = 5) -> np.ndarray:
    """B receivers scattered ~km around Tokyo."""
    rng = np.random.RandomState(seed)
    base = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
    return np.stack([np.asarray(llh2xyz(base + np.array(
        [rng.uniform(-1e-4, 1e-4), rng.uniform(-1e-4, 1e-4),
         rng.uniform(0, 100)]))) for _ in range(b)])


def _host_build(plans):
    """The batch's kernel inputs as the host build makes them."""
    dps = [pack_plan(p, tables=False) for p in plans]
    seen, ca_tabs, sf_map = {}, [], []
    for dp in dps:
        idx = seen.setdefault(dp.ca2.tobytes(), len(seen))
        if idx == len(ca_tabs):
            ca_tabs.append(dp.ca2)
        sf_map.append(np.full(dp.n_blocks, idx, np.int32))
    bp = sc.build_group_params(dps)
    return (bp.prmi, bp.prmf, sc.pack_ca_tables(ca_tabs),
            np.concatenate(sf_map)), bp.patch_dropped


def _assert_args_equal(got, want):
    for name, g, w in zip(("prmi", "prmf", "ca2", "sf_map"), got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def _forced_plan(gains, seed: int, n_blocks: int = 3):
    """A synthetic plan whose active channels carry `gains` (one per
    channel, every block), the rest inactive."""
    C = MAX_CHAN
    rng = np.random.RandomState(seed)
    n_act = len(gains)
    active = np.zeros((n_blocks, C), bool)
    active[:, :n_act] = True
    f_carr = np.where(active, rng.uniform(-4000, 4000, (n_blocks, C)), 0.0)
    gain = np.zeros((n_blocks, C))
    gain[:, :n_act] = gains
    return SuperframePlan(
        n_blocks=n_blocks, block_samples=65536, delt=1.0 / 2_600_000.0,
        prn=np.where(active[0], np.arange(1, C + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=1_023_000.0 + f_carr / 1540.0,
        code_phase=rng.uniform(0, 1023, (n_blocks, C)),
        icode=rng.randint(0, 20, (n_blocks, C)).astype(np.int32),
        ibit=rng.randint(0, 30, (n_blocks, C)).astype(np.int32),
        iword=rng.randint(0, 10, (n_blocks, C)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (n_blocks, C)),
        gain=gain, azel=np.zeros((n_blocks, C, 2)))


# nudged, patched and overflowing channels, alone and mixed in one row
FORCED = [_forced_plan([NUDGED, 0.5, 0.5], 1),
          _forced_plan([0.5, PATCHED, 0.61], 2),
          _forced_plan([OVERFLOWED, 0.5], 3),
          _forced_plan([PATCHED, NUDGED, OVERFLOWED, PATCHED, 0.9], 4, 5)]


def _fields(plans):
    """build_params' inputs for plans, nav tables one per plan."""
    act = np.concatenate([p.active for p in plans])
    real = np.stack([np.concatenate([getattr(p, k) for p in plans])
                     for k in sc._REAL_FIELDS])
    ints = np.stack([np.concatenate([getattr(p, k) for p in plans])
                     for k in sc._INT_FIELDS])
    bits = np.stack([p.bits for p in plans])
    bits_map = np.repeat(np.arange(len(plans), dtype=np.int32),
                         [p.n_blocks for p in plans])
    return (sc.PlanFields(act, real, ints.astype(np.int32), plans[0].delt),
            bits, bits_map)


@pytest.mark.parametrize("case", ["boundary", "union"])
def test_plan_blocks_on_cpu_equals_host_build(scenario, case):
    """plan_blocks(n) and plan_blocks(n, device="cpu") both return the
    host build's planes, tables and sf_map, and its dropped count: B=3
    over 8 blocks from 0.4 s before a 30 s boundary (two plans a
    receiver), and B=2 over 40 superframes, whose boundary re-allocations
    fire the union re-solve (test_torch_montecarlo)."""
    rin, g0, ieph = scenario
    if case == "boundary":
        rem = (30.0 - (g0.sec % 30.0)) % 30.0
        g0, b, n_blocks = inc_gps_time(g0, rem + 30.0 - 0.4), 3, 8
    else:
        b, n_blocks = 2, 40 * 300
    xyz = _receivers(b)
    mcs = [MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
           for _ in range(3)]
    plans = mcs[0]._plan_blocks(n_blocks)
    if case == "boundary":
        assert len(plans) == 2 * b, "the batch does not straddle"
    want, dropped = _host_build(plans)
    _assert_args_equal(mcs[1].plan_blocks(n_blocks), want)
    _assert_args_equal(mcs[2].plan_blocks(n_blocks, device="cpu"), want)
    assert mcs[1].patch_dropped == mcs[2].patch_dropped == dropped


def test_build_params_plain_forced_plans():
    """The wrapper's plain version equals build_group_params on plans
    forced through the nudge, patch words and the slot overflow, and
    counts the same dropped words."""
    fields, bits, bits_map = _fields(FORCED)
    prmi, prmf, dropped = sc.build_params(fields, bits, bits_map, 65536)
    want = sc.build_group_params([pack_plan(p, tables=False)
                                  for p in FORCED])
    assert prmi.numpy().tobytes() == want.prmi.tobytes()
    assert prmf.numpy().tobytes() == want.prmf.tobytes()
    assert int(dropped) == want.patch_dropped > 0
    words = want.prmf[:, [sc.patch_word_lane(k) for k in range(7)]]
    assert (words != 0).any(), "no patch word: the patch path is untested"
    nudged = want.prmf[0, sc._F_GAIN]
    assert nudged != np.float32(NUDGED), "the nudge never moved a lane"


def _bad(field: str):
    fields, bits, bits_map = _fields([_forced_plan([0.5, 0.6], 7)])
    real, ints = fields.real.copy(), fields.ints.copy()
    if field == "code_rate":
        real[1, 0, 0] = 1.2 / fields.delt
    elif field == "gain":
        real[4, 1, 1] = -2.5
    elif field == "nav_index":
        ints[2, 2, 0] = 700
    elif field == "q12":
        real[3, 0, 1] = 2**31 / 4096
    elif field == "negative_bit":
        ints[0, 0, 0], ints[1, 0, 0] = 0, -1
    else:
        bits_map = bits_map + 1
    return fields._replace(real=real, ints=ints), bits, bits_map


@pytest.mark.parametrize("field,match", [
    ("code_rate", "code rate"), ("gain", "channel gain"),
    ("nav_index", "nav-bit index exceeds"), ("q12", "Q12 code NCO"),
    ("negative_bit", "negative nav-bit index"), ("bits_map", "bits_map")])
def test_build_params_refusals(field, match):
    """The host build's refusals (|v| <= 1.1, |gain| <= 2, the nav-bit
    index < 32, pack_plan's Q12 guard), plus a nav table or bit index
    the kernel could not read, raise ValueError from the host checks,
    which build_params runs for every device before anything goes up
    (so a CUDA device raises here without a card)."""
    fields, bits, bits_map = _bad(field)
    with pytest.raises(ValueError, match=match):
        sc._check_plan_fields(fields, bits, bits_map, 65536)
    for device in (None, "cpu", "cuda"):
        with pytest.raises(ValueError, match=match):
            sc.build_params(fields, bits, bits_map, 65536, device=device)


def test_build_params_rejects_bad_shapes():
    fields, bits, bits_map = _fields(FORCED[:1])
    with pytest.raises(ValueError, match="bits_map must be"):
        sc.build_params(fields, bits, bits_map[1:], 65536)
    with pytest.raises(ValueError, match="bits_tabs must be"):
        sc.build_params(fields, bits[:, :5], bits_map, 65536)
    with pytest.raises(TypeError):
        sc.build_params(fields._replace(ints=fields.ints.astype(np.int64)),
                        bits, bits_map, 65536)


def test_build_params_takes_host_inputs():
    """Fields already on a device are refused (they could not be checked
    without reading them back), and so is a device that is neither the
    CPU nor a card."""
    fields, bits, bits_map = _fields(FORCED[:1])
    meta = fields._replace(**{k: torch.from_numpy(getattr(fields, k))
                              .to("meta") for k in ("active", "real",
                                                    "ints")})
    with pytest.raises(ValueError, match="on the host"):
        sc.build_params(meta, torch.from_numpy(bits).to("meta"),
                        torch.from_numpy(bits_map).to("meta"), 65536)
    with pytest.raises(ValueError, match="lie on different devices"):
        sc.build_params(meta, bits, bits_map, 65536)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        sc.build_params(fields, bits, bits_map, 65536, device="meta")


@pytest.mark.parametrize("mesh", [None, "mesh"])
@pytest.mark.parametrize("fs", [2.6e6, 5e6, 10e6])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_stream_builds_on_card_rule(scenario, device, fs, mesh):
    """A kernel stream builds its planes on the card on a CUDA device,
    without a mesh, its blocks unsplit (2.6 and 5 MHz); at 10 MHz the
    blocks split, and split, the mesh and the CPU keep the host build."""
    rin, g0, ieph = scenario
    split_k = IqStream(rin, g0, ieph, _receivers(1)[0], fs=fs,
                       device="cpu").split_k
    assert split_k == (2 if fs == 10e6 else 1)
    want = device == "cuda" and mesh is None and fs < 10e6
    got = builds_on_card(torch.device(device),
                         None if mesh is None else object(), split_k)
    assert got is want


@pytest.mark.parametrize("mode", ["kernel", "tiled"])
def test_stream_asks_rule_on_kernel_path(scenario, monkeypatch, mode):
    """The kernel path asks builds_on_card once a group and, where it
    holds, packs with the stream's device; the tensor paths read no
    planes and ask nothing."""
    rin, g0, ieph = scenario
    real, asked, devices = stream_mod.pack_group, [], []

    def rule(*args):
        asked.append(args)
        return True

    def pack(plans, device=None):
        devices.append(device)
        return real(plans, device)

    monkeypatch.setattr(stream_mod, "builds_on_card", rule)
    monkeypatch.setattr(stream_mod, "pack_group", pack)
    stream = IqStream(rin, g0, ieph, _receivers(1)[0], fs=FS,
                      block_samples=BS, mode=mode, device="cpu")
    assert len(list(stream.superframes(4, max_blocks=2))) == 2
    if mode == "kernel":
        assert asked == [(stream.device, None, 1)] * 2
        assert devices == [stream.device] * 2
    else:
        assert asked == devices == []


@pytest.mark.parametrize("form", ["ints", "tensors", "mixed"])
def test_stream_patch_dropped_sums_to_int(scenario, monkeypatch, form):
    """IqStream.patch_dropped sums its groups' counts, ints of host builds
    and one-element tensors of card builds alike, into an int, and reads
    the same twice."""
    rin, g0, ieph = scenario
    real = stream_mod.pack_group
    counts = []

    def pack(plans, device=None):
        group = real(plans, device)
        i = len(counts)
        counts.append(i + 2)
        as_tensor = form == "tensors" or (form == "mixed" and i % 2)
        return group._replace(patch_dropped=torch.tensor(
            [i + 2], dtype=torch.int32) if as_tensor else i + 2)

    monkeypatch.setattr(stream_mod, "pack_group", pack)
    stream = IqStream(rin, g0, ieph, _receivers(1)[0], fs=FS,
                      block_samples=BS, device="cpu")
    assert stream.patch_dropped == 0
    assert len(list(stream.superframes(6, max_blocks=2))) == 3
    for _ in range(2):
        got = stream.patch_dropped
        assert type(got) is int and got == sum(counts) == 2 + 3 + 4


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_equals_host_build_on_batch(scenario, cuda):
    """A B=64 batch over 8 blocks across a 30 s boundary: the card build's
    planes, tables and sf_map equal the host build's byte for byte, one
    build_params launch a plan_blocks call, the same dropped count."""
    rin, g0, ieph = scenario
    rem = (30.0 - (g0.sec % 30.0)) % 30.0
    g0 = inc_gps_time(g0, rem + 30.0 - 0.4)
    xyz = _receivers(64, seed=11)
    host = MonteCarloBatch(rin, g0, ieph, xyz, fs=2.6e6)
    card = MonteCarloBatch(rin, g0, ieph, xyz, fs=2.6e6)
    sc.reset_launch_count()
    for _ in range(2):
        want = host.plan_blocks(8)
        got = card.plan_blocks(8, device=cuda)
        assert all(t.device.type == "cuda" for t in got)
        _assert_args_equal(got, want)
    assert sc.build_params_launch_count() == 2
    assert card.patch_dropped == host.patch_dropped


@pytest.mark.cuda
def test_lookahead_on_card_equals_one_launch(scenario, cuda):
    """Four superframes(4, "cuda") calls in a row on a B=16 batch from
    0.4 s before a 30 s boundary: the third and fourth launch on planes
    their predecessor's lookahead built on the batch's stream while its
    kernels ran, and the 16 blocks equal one generate(16) of a batch that
    never looks ahead, byte for byte."""
    rin, g0, ieph = scenario
    rem = (30.0 - (g0.sec % 30.0)) % 30.0
    g0 = inc_gps_time(g0, rem + 30.0 - 0.4)
    xyz = _receivers(16, seed=13)
    want = MonteCarloBatch(rin, g0, ieph, xyz, fs=2.6e6).generate(16, cuda)
    mc = MonteCarloBatch(rin, g0, ieph, xyz, fs=2.6e6)
    got = []
    for _ in range(4):
        iq = np.concatenate([iq for _, iq in mc.superframes(
            4, cuda, chunk_blocks=24)])
        got.append(iq.reshape(16, 4, *iq.shape[1:]))
    assert np.concatenate(got, axis=1).tobytes() == want.tobytes()
    assert (mc.lookahead_hits, mc.lookahead_misses) == (2, 0)
    assert mc.patch_dropped == 0


@pytest.mark.cuda
def test_split_batch_on_card_equals_host_build(scenario, cuda):
    """A B=8 batch at 10 MHz, every block past the kernel's range: the
    card's plan_blocks builds and splits on the host (no build_params
    launch) and uploads planes, tables and sf_map equal to the host
    build's byte for byte; its as_device blocks, each a view of 2
    sub-rows, equal the host rows generate() fetches."""
    rin, g0, ieph = scenario
    xyz = _receivers(8, seed=19)
    host = MonteCarloBatch(rin, g0, ieph, xyz, fs=10e6)
    card = MonteCarloBatch(rin, g0, ieph, xyz, fs=10e6)
    sc.reset_launch_count()
    got = card.plan_blocks(3, device=cuda)
    assert all(t.device.type == "cuda" for t in got)
    _assert_args_equal(got, host.plan_blocks(3))
    assert got[0].shape[0] == 8 * 3 * 2
    assert sc.build_params_launch_count() == 0
    want = MonteCarloBatch(rin, g0, ieph, xyz, fs=10e6).generate(3, cuda)
    words = torch.cat([d for _, d in MonteCarloBatch(
        rin, g0, ieph, xyz, fs=10e6).superframes(3, cuda, chunk_blocks=5,
                                                 as_device=True)])
    torch.cuda.synchronize()
    assert words.shape == (24, 1_000_000)
    assert words.cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.cuda
def test_kernel_equals_host_build_forced(cuda):
    """Plans forced through the nudge, patch words and a row that
    overflows its 7 slots: the kernel's planes equal build_group_params'
    byte for byte and it counts the same dropped words."""
    fields, bits, bits_map = _fields(FORCED)
    sc.reset_launch_count()
    prmi, prmf, dropped = sc.build_params(fields, bits, bits_map, 65536,
                                          device=cuda)
    assert prmi.device.type == prmf.device.type == "cuda"
    assert sc.build_params_launch_count() == 1
    want = sc.build_group_params([pack_plan(p, tables=False)
                                  for p in FORCED])
    assert prmi.cpu().numpy().tobytes() == want.prmi.tobytes()
    assert prmf.cpu().numpy().tobytes() == want.prmf.tobytes()
    assert int(dropped) == want.patch_dropped > 0


@pytest.mark.cuda
def test_stream_card_build_equals_host_build(cuda, monkeypatch):
    """A K=8 IqStream(mode="kernel") at 2.6 MHz from 0.4 s before a 30 s
    boundary, through the 2 h ephemeris-set change: for each dispatch
    group, pack_group(plans, "cuda") equals pack_group(plans) word for
    word in every array and in patch_dropped; the stream builds each
    group's planes with one build_params launch, and its IQ equals the
    same stream's through the host build word for word."""
    rin = read_rinex2(ensure_fixtures()["rinex2"])
    toc0 = GpsTime(int(rin.eph[0].toc_week[0]), float(rin.eph[0].toc_sec[0]))
    g0 = scen.setup_scenario(rin, inc_gps_time(toc0, 3569.6))
    ieph = scen.select_ephemeris_set(rin, g0)
    xyz = _receivers(1, seed=17)[0]
    n_blocks, k, fs = 4500, 8, 2.6e6

    sched = Scheduler(rin, g0, ieph, xyz, fs=fs)
    ramp, rem, sizes = IqStream.dispatch_ramp(k), n_blocks, []
    while rem > 0:
        plans = sched.plan_group(next(ramp), 300, total_blocks=rem)
        rem -= sum(p.n_blocks for p in plans)
        sizes.append([p.n_blocks for p in plans])
        card, host = pack_group(plans, cuda), pack_group(plans)
        assert all(t.device.type == "cuda" for t in card.arrays)
        _assert_args_equal(card.arrays, host.arrays)
        assert (card.block_samples, card.n_orig) == (host.block_samples,
                                                     host.n_orig)
        assert int(card.patch_dropped) == host.patch_dropped
    assert sizes[0] == [4] and len(sizes) == 5, sizes
    assert (ieph, sched.ieph) == (0, 1), "no ephemeris-set change"

    def run():
        stream = IqStream(rin, g0, ieph, xyz, fs=fs, mode="kernel",
                          device=cuda, superframes_per_dispatch=k)
        before = sc.build_params_launch_count()
        out = list(stream.superframes(n_blocks, as_device=True))
        torch.cuda.synchronize()
        return stream, out, sc.build_params_launch_count() - before

    card_stream, card_out, card_builds = run()
    monkeypatch.setattr(stream_mod, "builds_on_card", lambda *a: False)
    host_stream, host_out, host_builds = run()
    assert (card_builds, host_builds) == (len(sizes), 0)
    assert [g.shape[0] for g in card_out] == [sum(s) for s in sizes]
    for i, (got, want) in enumerate(zip(card_out, host_out, strict=True)):
        assert torch.equal(got, want), f"group {i}"
    dropped = card_stream.patch_dropped
    assert type(dropped) is int and dropped == host_stream.patch_dropped


@pytest.mark.cuda
def test_dropped_count_across_streams(cuda):
    """launch.DroppedCount sums one-element card tensors added on two
    CUDA streams in turn, and host ints, into an int, the same twice."""
    count = DroppedCount()
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for i in range(4):
        with torch.cuda.stream(streams[i % 2]):
            count.add(torch.full((1,), i + 1, dtype=torch.int32,
                                 device=cuda))
    count.add(5)
    for _ in range(2):
        got = count.value
        assert type(got) is int and got == 1 + 2 + 3 + 4 + 5
