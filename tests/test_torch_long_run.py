"""The long-run hazards at small sizes, held to the JAX package.

On the card chip_smoke.phase_long_run runs the JAX package's long-run
device gates at full size: the ephemeris-set rollover through the K=8
dispatch path, the hour soak, dynamic motion.  Here small cases of the
same hazards go through the port on the CPU (IqStream(device="cpu") and
the kernel's plain twin) and through the JAX package (IqStream in pallas
mode and synth_blocks_pallas, both in interpret mode).  Tolerance: word
for word in every case, since both sides evaluate the same integer and
f32 arithmetic on the same inputs.  Also: the multi-process dryruns run
on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu.constants import MAX_CHAN, R2D
from pluto_gps_sim_tpu.ingest import read_rinex2 as j_read
from pluto_gps_sim_tpu.ingest import read_user_motion as j_motion
from pluto_gps_sim_tpu.models.cacode import CA_TABLE
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.models.gpstime import GpsTime, inc_gps_time
from pluto_gps_sim_tpu.ops import synth_pallas as sp
from pluto_gps_sim_tpu.ops.synth_jnp import pack_plan as j_pack
from pluto_gps_sim_tpu.ops.synth_jnp import synth_superframe_precise
from pluto_gps_sim_tpu.runtime import scenario as j_scen
from pluto_gps_sim_tpu.runtime.scheduler import Scheduler, SuperframePlan
from pluto_gps_sim_tpu.runtime.stream import IqStream as JStream

from pluto_gps_sim_tpu_torch.ingest import read_rinex2 as t_read
from pluto_gps_sim_tpu_torch.ingest import read_user_motion as t_motion
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan as t_pack
from pluto_gps_sim_tpu_torch.parallel import multiproc_dryrun as mpd
from pluto_gps_sim_tpu_torch.runtime import scenario as t_scen
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream as TStream

from test_torch_control_plane import _rollover_start

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
FS = 1_000_000.0
BLOCK = 8192
BOUNDARY_GAIN = 0.9086419713826426   # 405*g straddles an integer in f32


@pytest.fixture(scope="module")
def rinex_pair(fixture_paths):
    return j_read(fixture_paths["rinex2"]), t_read(fixture_paths["rinex2"])


def _streams(pair, starts=None, xyz=None, **kw):
    """The JAX stream (pallas, interpret mode) and the port's stream on
    the CPU over the same scenario, fs = 1 MHz, 8,192-sample blocks."""
    jr, tr = pair
    jg, tg = starts if starts is not None else (
        j_scen.setup_scenario(jr, None), t_scen.setup_scenario(tr, None))
    xyz = np.asarray(llh2xyz(TOKYO)) if xyz is None else xyz
    j = JStream(jr, jg, j_scen.select_ephemeris_set(jr, jg), xyz, fs=FS,
                block_samples=BLOCK, mode="pallas", **kw)
    t = TStream(tr, tg, t_scen.select_ephemeris_set(tr, tg), xyz, fs=FS,
                block_samples=BLOCK, device="cpu", **kw)
    return j, t


def test_stream_matches_jax_across_rollover(rinex_pair):
    """Two blocks either side of the ephemeris-set switch (block 600 of
    _rollover_start's scenario), dispatch groups of up to 2 superframes
    of 2 blocks: the streams are equal, both switch, no patch word is
    dropped."""
    j, t = _streams(rinex_pair, _rollover_start(rinex_pair),
                    superframes_per_dispatch=2)
    for s in (j, t):
        s.fast_forward(598)
        assert s.sched.ieph == 0
    a = list(j.superframes(4, max_blocks=2))
    b = list(t.superframes(4, max_blocks=2))
    assert [p.shape for p in a] == [p.shape for p in b] == \
        [(2, BLOCK, 2), (2, BLOCK, 2)]
    assert np.array_equal(np.concatenate(a), np.concatenate(b))
    assert j.sched.ieph == t.sched.ieph == 1
    assert j.patch_dropped == t.patch_dropped == 0


def test_stream_matches_jax_user_motion(rinex_pair, fixture_paths):
    """Dynamic motion over the circle CSV's wrap: blocks 298-301 use
    motion samples 297, 298, 299 and then 0 ((k-1) mod numd), across a
    30 s boundary."""
    xyz = j_motion(fixture_paths["motion"])
    assert np.array_equal(xyz, t_motion(fixture_paths["motion"]))
    assert xyz.shape[0] == 300
    j, t = _streams(rinex_pair, xyz=xyz, static_mode=False)
    for s in (j, t):
        s.fast_forward(298)
    a, b = j.generate(4), t.generate(4)
    assert b.shape == (4, BLOCK, 2)
    assert np.array_equal(a, b)


def _holes_plan():
    """Two synthetic blocks at 2.6 MHz whose inactive slots sit between
    active ones (a different pattern per block, as a satellite that
    sets mid-run leaves them), with one gain on the first block at an
    f32 trunc boundary."""
    C, n, fs = MAX_CHAN, 65536, 2_600_000.0
    rng = np.random.RandomState(13)
    active = np.ones((2, C), bool)
    active[0, [1, 4, 5, 8, 10]] = False
    active[1, [0, 3, 6, 7, 11]] = False
    gain = np.where(active, 0.5, 0.0)
    gain[0, 2] = BOUNDARY_GAIN
    f_carr = np.repeat(rng.uniform(-4500.0, 4500.0, (1, C)), 2, 0)
    return SuperframePlan(
        n_blocks=2, block_samples=n, delt=1.0 / fs,
        prn=np.arange(1, C + 1, dtype=np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=1_023_000.0 + f_carr / 1540.0,
        code_phase=rng.uniform(0, 1023, (2, C)),
        icode=rng.randint(0, 20, (2, C)).astype(np.int32),
        ibit=rng.randint(0, 30, (2, C)).astype(np.int32),
        iword=rng.randint(0, 10, (2, C)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (2, C)),
        gain=gain, azel=np.zeros((2, C, 2)))


def test_twin_matches_pallas_active_holes():
    """Active slots with holes plus one straddling gain kept as patch
    words (nudge=False; its I and Q halves make two words): the port's
    parameter planes equal the JAX package's, and the twin equals the
    Pallas kernel in interpret mode and the f64 precise path word for
    word."""
    plan = _holes_plan()
    jdp = j_pack(plan)
    jp = sp.build_block_params(jdp, nudge=False)
    tp = sc.build_group_params([t_pack(plan, tables=False)], nudge=False)
    assert np.array_equal(jp.prmi, tp.prmi)
    assert np.array_equal(jp.prmf, tp.prmf)
    words = tp.prmf[:, [sc.patch_word_lane(k) for k in range(sc._N_PATCH)]]
    assert (words != 0).sum(axis=1).tolist() == [2, 0]
    assert tp.patch_dropped == 0
    ca = sp.pack_ca_tables([jdp.ca2])
    sf_map = np.zeros(2, np.int32)
    n = jdp.block_samples
    want = np.asarray(sp.synth_blocks_pallas((jp.prmi, jp.prmf), ca, sf_map,
                                             n, interpret=True))[:, :n]
    got = sc.synth_blocks(tp.prmi, tp.prmf, ca, sf_map, n).numpy()
    assert got.shape == want.shape == (2, n)
    assert int((got != want).sum()) == 0
    assert np.array_equal(sc.unpack_iq(got), synth_superframe_precise(jdp))


@pytest.mark.parametrize("block,n_diff,max_err",
                         [(276, 2, 4), (1150, 2, 3), (2229, 1, 5)])
def test_twin_floor_blocks_match_pallas(rinex_pair, block, n_diff, max_err):
    """Blocks of the card's rollover gate (4,500 blocks at 2.6 MHz from
    toc0 + 3,540 s) where the kernel, word-equal to its twin there,
    differs from the tiled and precise paths by a carrier-phase straddle:
    the port's planes equal the JAX package's, the twin equals the Pallas
    kernel in interpret mode word for word, and both differ from the JAX
    precise path in n_diff components, the largest by max_err.  The
    floor is the JAX kernel's own."""
    jr, _ = rinex_pair
    toc0 = GpsTime(int(jr.eph[0].toc_week[0]), float(jr.eph[0].toc_sec[0]))
    g0 = j_scen.setup_scenario(jr, inc_gps_time(toc0, 3540.0))
    sched = Scheduler(jr, g0, j_scen.select_ephemeris_set(jr, g0),
                      np.asarray(llh2xyz(TOKYO)), fs=2_600_000.0)
    sched.skip(block)
    plan = sched.plan(1)
    jdp = j_pack(plan)
    jp = sp.build_block_params(jdp)
    tp = sc.build_group_params([t_pack(plan, tables=False)])
    assert np.array_equal(jp.prmi, tp.prmi)
    assert np.array_equal(jp.prmf, tp.prmf)
    ca = sp.pack_ca_tables([jdp.ca2])
    sf_map = np.zeros(1, np.int32)
    n = jdp.block_samples
    want = np.asarray(sp.synth_blocks_pallas((jp.prmi, jp.prmf), ca, sf_map,
                                             n, interpret=True))[:, :n]
    got = sc.synth_blocks(tp.prmi, tp.prmf, ca, sf_map, n).numpy()
    assert np.array_equal(got, want)
    d = np.abs(sc.unpack_iq(got).astype(np.int64)
               - synth_superframe_precise(jdp))
    assert (int((d != 0).sum()), int(d.max())) == (n_diff, max_err)


@pytest.mark.parametrize("entry", ["run_multiprocess_dryrun",
                                   "dryrun_multichip", "main"])
def test_dryrun_entry_points_default_to_cuda(monkeypatch, entry):
    """The dryruns default to the card, and without one they raise
    before any rank is spawned; the rank bodies take the device from
    their caller."""
    def spawned(*a, **k):
        raise AssertionError("a rank was spawned")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mpd, "spawn_world", spawned)
    fn = getattr(mpd, entry)
    if entry == "main":
        call = lambda: fn([])                      # noqa: E731
    else:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        call = fn
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    for body in (mpd.worker_body, mpd.multichip_body):
        assert inspect.signature(body).parameters["device"].default is \
            inspect.Parameter.empty


def test_dryrun_cuda_rank_needs_a_card_per_rank(monkeypatch):
    """device="cuda:rank" puts rank r on card r: a world larger than the
    cards torch sees is refused before any rank is spawned."""
    def spawned(*a, **k):
        raise AssertionError("a rank was spawned")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(mpd, "spawn_world", spawned)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        mpd.run_multiprocess_dryrun(4, "nccl", "cuda:rank")
