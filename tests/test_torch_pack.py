"""The PyTorch package's kernel-input packing against the JAX package's.

pack_plan, split_plan, build_group_params (gain nudge, patch words and
the patch-slot overflow count), pack_ca_tables, unpack_iq and the sin/cos
pair tables are numpy on both sides and must agree byte for byte: the
planes one package builds feed the other's kernel.  runtime.launch's
pack_group, which dedupes a group's C/A tables, is held to the JAX
stream's layout of one table a superframe.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu.constants import MAX_CHAN, R2D
from pluto_gps_sim_tpu.ingest import read_rinex2
from pluto_gps_sim_tpu.models.cacode import CA_TABLE
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.ops import synth_jnp as jj
from pluto_gps_sim_tpu.ops import synth_pallas as sp
from pluto_gps_sim_tpu.runtime import select_ephemeris_set, setup_scenario
from pluto_gps_sim_tpu.runtime.scheduler import Scheduler, SuperframePlan

from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.ops import synth_torch as st
from pluto_gps_sim_tpu_torch.runtime.launch import pack_group

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])


def assert_bytes_equal(a, b, where: str = "") -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert a.tobytes() == b.tobytes(), where


def assert_plans_equal(a, b) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert_bytes_equal(x, y, f.name)
        else:
            assert x == y, f.name


def assert_params_equal(a, b) -> None:
    assert_bytes_equal(a.prmi, b.prmi, "prmi")
    assert_bytes_equal(a.prmf, b.prmf, "prmf")
    assert a.patch_dropped == b.patch_dropped


@pytest.fixture(scope="module")
def scenario(fixture_paths):
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    return rin, g0, select_ephemeris_set(rin, g0), np.asarray(llh2xyz(TOKYO))


def _plans(scenario, fs, n_blocks, **kw):
    rin, g0, ieph, xyz = scenario
    return Scheduler(rin, g0, ieph, xyz, fs=fs, **kw).plan(n_blocks)


def _boundary_plan(gain_value, n_active, seed):
    """One synthetic block whose channel 0 (or 1) sits on a gain-trunc
    boundary, as the JAX package's patch tests build it."""
    C = MAX_CHAN
    rng = np.random.RandomState(seed)
    active = np.zeros((1, C), bool)
    active[0, :n_active] = True
    f_carr = np.zeros((1, C))
    f_carr[0, :n_active] = [-2717.3, 395.9, -967.7][:n_active]
    gain = np.where(active, 0.5, 0.0)
    gain[0, 1 if n_active == 3 else 0] = gain_value
    return SuperframePlan(
        n_blocks=1, block_samples=65536, delt=1.0 / 2_600_000.0,
        prn=np.where(active[0], np.arange(1, C + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=1_023_000.0 + f_carr / 1540.0,
        code_phase=rng.uniform(0, 1023, (1, C)),
        icode=rng.randint(0, 20, (1, C)).astype(np.int32),
        ibit=rng.randint(0, 30, (1, C)).astype(np.int32),
        iword=rng.randint(0, 10, (1, C)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (1, C)),
        gain=gain, azel=np.zeros((1, C, 2)))


@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("fs", [1_000_000.0, 2_600_000.0])
def test_pack_plan_matches(scenario, fs, tables):
    plan = _plans(scenario, fs, 20)
    assert_plans_equal(jj.pack_plan(plan, tables=tables),
                       st.pack_plan(plan, tables=tables))


@pytest.mark.parametrize("n,cap", [(49152, 16384), (1_000_000, 524_000),
                                   (16384, 16384)])
def test_split_plan_matches(scenario, n, cap):
    rin, g0, ieph, xyz = scenario
    plan = Scheduler(rin, g0, ieph, xyz, fs=1e7 if n > 524_000 else 1e6,
                     block_samples=n).plan(4)
    a = jj.split_plan(jj.pack_plan(plan, tables=False), cap)
    b = st.split_plan(st.pack_plan(plan, tables=False), cap)
    assert_plans_equal(a, b)
    assert b.block_samples <= cap


@pytest.mark.parametrize("nudge", [True, False,
                                   pytest.param(None, id="pack_group")])
def test_build_group_params_matches(scenario, nudge):
    """A real three-superframe dispatch group (sf boundaries, rise/set
    bookkeeping, per-superframe nav-bit tables).  nudge None: the group
    runtime.launch.pack_group packs from three one-block superframes
    around the first 30 s boundary whose re-allocation changes the
    channels' satellites: its planes are build_group_params' (nudged),
    its C/A tables the two distinct ones, and the twin reads the same
    words through its sf_map as through one table a superframe."""
    rin, g0, ieph, xyz = scenario
    if nudge is None:
        sched = Scheduler(rin, g0, ieph, xyz, fs=1_000_000.0,
                          block_samples=8192)
        for _ in range(100):
            sched.skip(sched._blocks_to_boundary() - 1)
            plans = sched.plan_group(3, 1)
            if len({p.ca2.tobytes() for p in plans}) > 1:
                break
        got = pack_group(plans)
        prmi, prmf, ca_tabs, sf_map = got.arrays
        assert ca_tabs.shape[0] == 2 and sf_map.tolist() == [0, 1, 1]
        assert (got.block_samples, got.n_orig) == (8192, 8192)
        assert_params_equal(
            sc.BlockParams(prmi, prmf, got.patch_dropped),
            sc.build_group_params([st.pack_plan(p, tables=False)
                                   for p in plans]))
        one_per_sf = (prmi, prmf, sc.pack_ca_tables([p.ca2 for p in plans]),
                      np.arange(3, dtype=np.int32))
        words = [sc.synth_blocks_plain(*map(torch.from_numpy, a), 8192)
                 for a in (got.arrays, one_per_sf)]
        assert torch.equal(*words)
        return
    plans = Scheduler(rin, g0, ieph, xyz, fs=2_600_000.0).plan_group(3, 40)
    assert len(plans) == 3
    dps = [jj.pack_plan(p, tables=False) for p in plans]
    assert_params_equal(sp.build_group_params(dps, nudge=nudge),
                        sc.build_group_params(dps, nudge=nudge))
    assert_params_equal(sp.build_block_params(dps[0], nudge=nudge),
                        sc.build_block_params(dps[0], nudge=nudge))


@pytest.mark.parametrize("nudge", [True, False])
@pytest.mark.parametrize("case", ["single_boundary", "overflow"])
def test_build_params_patch_words_match(case, nudge):
    """The gain-trunc boundary of test_gain_trunc_patch_exact (two patch
    words without the nudge) and the slot overflow of
    test_gain_trunc_patch_overflow_degrades_gracefully (seven words kept,
    the rest counted as dropped)."""
    if case == "single_boundary":
        plan = _boundary_plan(0.9086419713826426, 3, seed=7)
    else:
        plan = _boundary_plan(0.5483870934593348, 2, seed=5)
    dp = jj.pack_plan(plan, tables=False)
    a = sp.build_block_params(dp, nudge=nudge)
    b = sc.build_block_params(dp, nudge=nudge)
    assert_params_equal(a, b)
    words = [b.prmf[0, sc.patch_word_lane(k)] for k in range(sc._N_PATCH)]
    n_words = sum(w != 0 for w in words)
    if nudge:
        assert n_words == 0 and b.patch_dropped == 0
    elif case == "single_boundary":
        assert n_words == 2 and b.patch_dropped == 0
    else:
        assert n_words == sc._N_PATCH and b.patch_dropped > 0


def test_pack_ca_tables_matches(scenario):
    plans = [_plans(scenario, 1e6, 3)]
    ca2s = [plans[0].ca2, np.roll(plans[0].ca2, 5, axis=0),
            (CA_TABLE[np.arange(MAX_CHAN)] * 2 - 1).astype(np.int8)]
    assert_bytes_equal(sp.pack_ca_tables(ca2s), sc.pack_ca_tables(ca2s))


@pytest.mark.parametrize("trim", [None, 1000])
def test_unpack_iq_matches(trim):
    rng = np.random.RandomState(3)
    packed = rng.randint(-2**31, 2**31, (3, 1536), dtype=np.int64) \
        .astype(np.int32)
    assert_bytes_equal(sp.unpack_iq(packed, trim), sc.unpack_iq(packed, trim))


def test_kernel_constants_match():
    """The plane layout, the quadrant table and the f32 reciprocal the
    kernel and twin read are the JAX package's."""
    assert_bytes_equal(sp._RAWTAB, sc._RAWTAB)
    assert_bytes_equal(sp._INV1023, sc._INV1023)
    assert_bytes_equal(sp._MAGS64, sc._MAGS64)
    for name in ("MAX_BLOCK_SAMPLES", "_N_PATCH", "_SLOT_I", "_SLOT_F",
                 "_SLOT_I_W", "_SLOT_F_W", "_SLOT_WORD", "_P_PHASE0",
                 "_P_R36", "_F_GAIN", "_F_RRR"):
        assert getattr(sp, name) == getattr(sc, name), name
    assert [sp.patch_word_lane(k) for k in range(7)] == \
        [sc.patch_word_lane(k) for k in range(7)]
    # the 512-entry pair table is the quadrant reconstruction's target
    raw = sc._RAWTAB.reshape(-1).view(np.uint32).astype(np.int64)
    assert np.array_equal(sc._PAIRTAB[:128].view(np.uint32), raw)
    sc._check_quadrant_identities()
