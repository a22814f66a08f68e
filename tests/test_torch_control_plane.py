"""The PyTorch package's host control plane against the JAX package's.

pluto_gps_sim_tpu_torch carries the f64 numpy control plane (RINEX
ingest, scenario time setup, channel allocation, the epoch solve and the
superframe scheduler) over from pluto_gps_sim_tpu with only its jax ties
removed, so every result must be equal, not close: the same inputs go
through both packages and every field is compared with array_equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from pluto_gps_sim_tpu import ingest as j_ingest
from pluto_gps_sim_tpu.constants import R2D
from pluto_gps_sim_tpu.models.geodesy import llh2xyz as j_llh2xyz
from pluto_gps_sim_tpu.models.gpstime import GpsTime as JGpsTime
from pluto_gps_sim_tpu.models.gpstime import inc_gps_time as j_inc
from pluto_gps_sim_tpu.runtime import scenario as j_scen
from pluto_gps_sim_tpu.runtime.scheduler import Scheduler as JScheduler

from pluto_gps_sim_tpu_torch import ingest as t_ingest
from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz as t_llh2xyz
from pluto_gps_sim_tpu_torch.models.gpstime import GpsTime as TGpsTime
from pluto_gps_sim_tpu_torch.models.gpstime import inc_gps_time as t_inc
from pluto_gps_sim_tpu_torch.runtime import scenario as t_scen
from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler as TScheduler

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
FS = 1_000_000.0


def assert_same(a, b, where: str = "") -> None:
    """Exact structural equality across the two packages' objects."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def rinex_pair(fixture_paths):
    return (j_ingest.read_rinex2(fixture_paths["rinex2"]),
            t_ingest.read_rinex2(fixture_paths["rinex2"]))


def _xyz_pair():
    return np.asarray(j_llh2xyz(TOKYO)), np.asarray(t_llh2xyz(TOKYO))


def _rollover_start(pair):
    """A start 30 s before the fixture's ephemeris-set rollover, in both
    packages' time types."""
    jr, tr = pair
    week, sec = int(jr.eph[0].toc_week[0]), float(jr.eph[0].toc_sec[0])
    return (j_scen.setup_scenario(jr, j_inc(JGpsTime(week, sec), 3570.0)),
            t_scen.setup_scenario(tr, t_inc(TGpsTime(week, sec), 3570.0)))


def _schedulers(pair, start=None, **kw):
    jr, tr = pair
    jg, tg = start if start is not None else (
        j_scen.setup_scenario(jr, None), t_scen.setup_scenario(tr, None))
    jx, tx = _xyz_pair()
    ja = JScheduler(jr, jg, j_scen.select_ephemeris_set(jr, jg), jx, **kw)
    ta = TScheduler(tr, tg, t_scen.select_ephemeris_set(tr, tg), tx, **kw)
    return ja, ta


@pytest.mark.parametrize("version", ["rinex2", "rinex3"])
def test_rinex_parse_matches(fixture_paths, version):
    read_j = getattr(j_ingest, f"read_{version}")
    read_t = getattr(t_ingest, f"read_{version}")
    a, b = read_j(fixture_paths[version]), read_t(fixture_paths[version])
    assert a.n_sets == b.n_sets and a.n_sets >= 2
    assert a.rinex_date == b.rinex_date
    assert_same(a.eph, b.eph, "eph")
    assert_same(a.ionoutc, b.ionoutc, "ionoutc")
    assert_same(a.t, b.t, "t")


def test_rinex_errors_match(tmp_path, fixture_paths):
    """A v3 file fed to the v2 parser fails the same way in both."""
    with pytest.raises(j_ingest.RinexError) as ej:
        j_ingest.read_rinex2(fixture_paths["rinex3"])
    with pytest.raises(t_ingest.RinexError) as et:
        t_ingest.read_rinex2(fixture_paths["rinex3"])
    assert str(ej.value) == str(et.value)


def test_user_motion_matches(fixture_paths):
    a = j_ingest.read_user_motion(fixture_paths["motion"])
    b = t_ingest.read_user_motion(fixture_paths["motion"])
    assert_same(a, b, "motion")


@pytest.mark.parametrize("offset", [None, 3570.0, 5400.0])
def test_scenario_setup_matches(rinex_pair, offset):
    jr, tr = rinex_pair
    if offset is None:
        jg, tg = j_scen.setup_scenario(jr, None), t_scen.setup_scenario(
            tr, None)
    else:
        week = int(jr.eph[0].toc_week[0])
        sec = float(jr.eph[0].toc_sec[0])
        jg = j_scen.setup_scenario(jr, j_inc(JGpsTime(week, sec), offset))
        tg = t_scen.setup_scenario(tr, t_inc(TGpsTime(week, sec), offset))
    assert (jg.week, jg.sec) == (tg.week, tg.sec)
    assert j_scen.select_ephemeris_set(jr, jg) == \
        t_scen.select_ephemeris_set(tr, tg)


def test_time_overwrite_matches(fixture_paths):
    """-T mode shifts every ephemeris set in place; both packages must
    shift them identically."""
    jr = j_ingest.read_rinex2(fixture_paths["rinex2"])
    tr = t_ingest.read_rinex2(fixture_paths["rinex2"])
    jg = j_scen.setup_scenario(jr, JGpsTime(2250, 7200.0),
                               timeoverwrite=True)
    tg = t_scen.setup_scenario(tr, TGpsTime(2250, 7200.0),
                               timeoverwrite=True)
    assert (jg.week, jg.sec) == (tg.week, tg.sec)
    assert_same(jr.eph, tr.eph, "eph")


def test_initial_allocation_matches(rinex_pair):
    ja, ta = _schedulers(rinex_pair, fs=FS)
    assert_same(ja.state, ta.state, "state")
    assert int((ta.state.prn > 0).sum()) >= 6


def test_plan_matches_across_rollover(rinex_pair):
    """Five sequential superframes, across 30 s nav refreshes and the
    ephemeris-set rollover: every SuperframePlan field is equal."""
    ja, ta = _schedulers(rinex_pair, _rollover_start(rinex_pair), fs=FS)
    ieph0 = ja.ieph
    for k in range(5):
        assert_same(ja.plan(300), ta.plan(300), f"plan {k}")
    assert ja.ieph == ta.ieph != ieph0
    assert_same(ja.state, ta.state, "state")


def test_plan_group_matches(rinex_pair):
    """plan_group (the batched range solve), as
    test_plan_group_matches_sequential drives it."""
    start = _rollover_start(rinex_pair)
    ja, ta = _schedulers(rinex_pair, start, fs=FS)
    assert_same(ja.plan_group(3) + ja.plan_group(2),
                ta.plan_group(3) + ta.plan_group(2), "groups")
    assert ja.ieph == ta.ieph
    jb, tb = _schedulers(rinex_pair, start, fs=FS)
    assert_same(jb.plan_group(8, total_blocks=750),
                tb.plan_group(8, total_blocks=750), "capped group")


@pytest.mark.parametrize("case", ["rollover", "mid_superframe", "ref_compat"])
def test_skip_matches(rinex_pair, case):
    """Scheduler.skip, as test_skip_matches_plan_loop_across_rollover
    drives it: the port's skip and the JAX skip leave equal states whose
    next plans are equal."""
    start = _rollover_start(rinex_pair)
    if case == "rollover":
        ja, ta = _schedulers(rinex_pair, start, fs=FS)
        n_skip, n_next = 900, 2
    elif case == "mid_superframe":
        ja, ta = _schedulers(rinex_pair, start, fs=FS)
        n_skip, n_next = 440, 2
    else:
        ja, ta = _schedulers(rinex_pair, start, fs=5_000_000.0,
                             block_samples=300_000)
        n_skip, n_next = 600, 1
    ja.skip(n_skip)
    ta.skip(n_skip)
    assert (ja.jblk, ja.ieph) == (ta.jblk, ta.ieph)
    assert_same(ja.state, ta.state, "state")
    for k in range(n_next):
        assert_same(ja.plan(300), ta.plan(300), f"plan {k}")


def test_user_motion_plan_matches(rinex_pair, fixture_paths):
    """Dynamic mode walks the motion file with the reference's
    off-by-one; both packages plan the same blocks from it."""
    jr, tr = rinex_pair
    jg, tg = j_scen.setup_scenario(jr, None), t_scen.setup_scenario(tr, None)
    jx = j_ingest.read_user_motion(fixture_paths["motion"])
    tx = t_ingest.read_user_motion(fixture_paths["motion"])
    ja = JScheduler(jr, jg, j_scen.select_ephemeris_set(jr, jg), jx,
                    fs=FS, static_mode=False)
    ta = TScheduler(tr, tg, t_scen.select_ephemeris_set(tr, tg), tx,
                    fs=FS, static_mode=False)
    assert_same(ja.plan(40), ta.plan(40), "plan")
