"""The plain reference against the program's CPU twin, at a tiny size:
1 MHz, a few blocks, both configurations.  (The test imports the
program; the reference does not.)"""

import ast
from pathlib import Path

import numpy as np
import pytest

from conftest import SEED
from harness import data

STATIC = data.llh_to_ecef(35.681298, 139.766247, 10.0)
FS = 1.0e6
# 0.3 s before a 30 s boundary, 5 h into the day: the blocks straddle a
# nav refresh and a re-allocation pass
OFFSET = 5 * 3600 + 29.7


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    nav = str(d / "day.23n")
    data.write_rinex2(nav, np.random.default_rng([SEED, 0]), 12, 31, 2.0)
    motion = str(d / "circle.csv")
    data.write_circle_motion(motion, 3000, (35.681298, 139.766247, 10.0),
                             50.0, 30.0)
    return nav, motion


def _program(nav, motion, offset, blocks, ionosphere=True):
    from pluto_gps_sim_tpu_torch.ingest import read_rinex2, read_user_motion
    from pluto_gps_sim_tpu_torch.models.gpstime import inc_gps_time
    from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                                 setup_scenario)
    from pluto_gps_sim_tpu_torch.runtime.stream import IqStream
    rin = read_rinex2(nav)
    rin.ionoutc.enable = np.array(ionosphere)
    g0 = setup_scenario(rin, inc_gps_time(setup_scenario(rin, None), offset))
    xyz = STATIC if motion is None else read_user_motion(motion)
    st = IqStream(rin, g0, select_ephemeris_set(rin, g0), xyz, fs=FS,
                  static_mode=motion is None, device="cpu",
                  superframes_per_dispatch=2)
    return np.concatenate(list(st.superframes(blocks)))


@pytest.mark.parametrize("config", ["static-2m6", "motion-5m"])
def test_reference_equals_the_cpu_twin(files, config):
    import reference
    nav, motion = files
    motion = motion if config == "motion-5m" else None
    got = _program(nav, motion, OFFSET, 6)
    want = reference.replay(nav, OFFSET, STATIC, FS, range(6), "cpu",
                            motion_path=motion)
    for b in range(6):
        assert np.array_equal(got[b], want[b]), b


def test_ionosphere_off_is_applied_alike(files):
    """Upstream's -i on both sides: the words agree, and differ from the
    words with the ionosphere on."""
    import reference
    nav, _ = files
    got = _program(nav, None, OFFSET, 2, ionosphere=False)
    off = reference.replay(nav, OFFSET, STATIC, FS, range(2), "cpu",
                           ionosphere=False)
    on = reference.replay(nav, OFFSET, STATIC, FS, range(2), "cpu")
    for b in range(2):
        assert np.array_equal(got[b], off[b]), b
        assert not np.array_equal(on[b], off[b]), b


def test_far_blocks_through_advance(files):
    """A block hours into the stream, reached by the reference's
    one-epoch advance, equals the program's fast-forwarded plan through
    its f64 precise path."""
    import reference
    from pluto_gps_sim_tpu_torch.ingest import read_rinex2
    from pluto_gps_sim_tpu_torch.models.gpstime import inc_gps_time
    from pluto_gps_sim_tpu_torch.ops.synth_torch import (
        pack_plan, synth_superframe_precise)
    from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                                 setup_scenario)
    from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
    nav, _ = files
    far = 7 * 36000 + 123           # 7 h later, past three set rollovers
    rin = read_rinex2(nav)
    g0 = setup_scenario(rin, inc_gps_time(setup_scenario(rin, None), 600.0))
    s = Scheduler(rin, g0, select_ephemeris_set(rin, g0), STATIC, FS)
    s.skip(far - 3)
    plan = s.plan(5)
    got = synth_superframe_precise(pack_plan(plan), "cpu")
    want = reference.replay(nav, 600.0, STATIC, FS, [far - 3, far], "cpu")
    assert np.array_equal(got[0], want[far - 3])
    assert np.array_equal(got[3], want[far])


def test_channel_counts_follow_the_allocation(files):
    import reference
    nav, _ = files
    counts = reference.channel_counts(nav, 600.0, STATIC, FS, 3000)
    sched = reference._scheduler(nav, 600.0, STATIC, FS, None)
    while sched.jblk < 3000:
        n, j = int(sched.state.active.sum()), sched.jblk
        m = sched.advance(300)
        assert (counts[0, j:j + m] == n).all()


def test_reference_imports_nothing_of_the_program():
    ref = Path(__file__).resolve().parent.parent / "reference"
    for path in ref.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                and node.level == 0 else []
            for name in names:
                top = name.split(".")[0]
                assert top not in ("pluto_gps_sim_tpu_torch",
                                   "pluto_gps_sim_tpu", "jax", "jaxlib",
                                   "harness"), (path, name)


def test_bench_imports_none_of_the_repo_tools():
    bench = Path(__file__).resolve().parent.parent
    for path in bench.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module or ""]
                for name in names:
                    assert name.split(".")[0] not in (
                        "bench", "chip_smoke", "tools", "tests", "jax",
                        "pluto_gps_sim_tpu"), (path, name)
