"""The cells' generated inputs."""

import numpy as np

from conftest import SEED
from harness import data


def test_day_file_parses_with_12_sets_of_31(tmp_path):
    import reference
    from reference.ingest.rinex import read_rinex2
    path = str(tmp_path / "day.23n")
    data.write_rinex2(path, np.random.default_rng([SEED, 0]), 12, 31, 2.0)
    rin = read_rinex2(path)
    assert rin.n_sets == 12
    for iset in range(12):
        assert int(np.asarray(rin.eph[iset].vflg).sum()) == 31
    tocs = [float(np.asarray(rin.eph[i].toc_sec)[0]) for i in range(12)]
    assert np.allclose(np.diff(tocs), 7200.0)
    assert reference.replay  # the reference reads the same file


def test_same_seed_same_file_other_seed_other_file(tmp_path):
    paths = []
    for k, seed in enumerate((SEED, SEED, SEED + 1)):
        p = tmp_path / f"{k}.23n"
        data.write_rinex2(str(p), np.random.default_rng([seed, 0]), 2, 31,
                          2.0)
        paths.append(p.read_bytes())
    assert paths[0] == paths[1] and paths[0] != paths[2]


def test_circle_wraps_3000_rows(tmp_path):
    from reference.ingest.motion import read_user_motion
    p = str(tmp_path / "c.csv")
    data.write_circle_motion(p, 3000, (35.681298, 139.766247, 10.0), 50.0,
                             30.0)
    xyz = read_user_motion(p)
    assert xyz.shape == (3000, 3)
    c = data.llh_to_ecef(35.681298, 139.766247, 10.0)
    assert np.allclose(np.linalg.norm(xyz - c, axis=1), 50.0, atol=0.01)
