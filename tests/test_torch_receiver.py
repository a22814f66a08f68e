"""The software receiver, run on the PyTorch package's IQ.

Mirrors tests/test_receiver.py and tests/test_acquisition.py with the
port's copies of utils/{acquisition,lnav_decode,receiver} on IQ the
port synthesized with its f64 precise path (the golden reference, which
the port's tiled path and kernel twin match, test_torch_golden; on the
CPU it is also the quickest of the three).  Acquisition results
must equal the JAX package's acquire() on the same IQ field for field
(same numpy code on the same input); the fix keeps the JAX test's
bounds (every planned PRN, < 8 m, |v| < 0.15 m/s).  chip_smoke.py runs
the same fix on a 40 s file the CLI writes with the CUDA kernel.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from pluto_gps_sim_tpu.utils import acquisition as j_acq
from pluto_gps_sim_tpu.utils import lnav_decode as j_dec

from pluto_gps_sim_tpu_torch.constants import CA_SEQ_LEN, R2D, \
    SPEED_OF_LIGHT
from pluto_gps_sim_tpu_torch.ingest import read_rinex2
from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz
from pluto_gps_sim_tpu_torch.models.gpstime import GpsTime
from pluto_gps_sim_tpu_torch.models.lnav import eph_to_subframes, \
    generate_nav_msg
from pluto_gps_sim_tpu_torch.ops.synth_torch import pack_plan, \
    synth_superframe_precise
from pluto_gps_sim_tpu_torch.runtime import select_ephemeris_set, \
    setup_scenario
from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream
from pluto_gps_sim_tpu_torch.utils import receiver as rx
from pluto_gps_sim_tpu_torch.utils.acquisition import acquire, acquire_all
from pluto_gps_sim_tpu_torch.utils.lnav_decode import (decode_frame,
                                                       decode_how,
                                                       parity_check)

FS = 2_600_000.0
TOKYO_LLH = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scenario(fixture_paths):
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    return rin, g0, ieph, np.asarray(llh2xyz(TOKYO_LLH))


@pytest.fixture(scope="module")
def one_block(scenario):
    """One precise-path block (0.1 s) plus the plan that produced it."""
    rin, g0, ieph, xyz = scenario
    plan = Scheduler(rin, g0, ieph, xyz, fs=FS).plan(1)
    return plan, synth_superframe_precise(pack_plan(plan), device="cpu")


def _active(plan):
    return [c for c in range(len(plan.prn))
            if plan.prn[c] > 0 and plan.active[0, c]]


def test_lnav_decode_roundtrip(scenario):
    """Encoder -> parity_check/decode_frame -> the original quantized
    fields, and the same decode as the JAX package's decoder."""
    rin, g0, ieph, _ = scenario
    eph, iono = rin.eph[ieph], rin.ionoutc
    sv = int(np.flatnonzero(np.asarray(eph.vflg))[0])
    sbf = eph_to_subframes(eph, sv, iono)
    dwrd = np.zeros(60, np.uint32)
    generate_nav_msg(GpsTime(g0.week, g0.sec + 30.0), sbf, dwrd, True)

    subs = {}
    prev = int(dwrd[9])
    tows = []
    for isbf in range(5):
        datas = []
        for iw in range(10):
            word = int(dwrd[10 + isbf * 10 + iw])
            ok, data = parity_check(word, prev)
            assert ok, f"parity fail sbf {isbf} word {iw}"
            assert (ok, data) == j_dec.parity_check(word, prev)
            datas.append(data)
            prev = word
        tow, sid = decode_how(datas[1])
        assert sid == isbf + 1
        tows.append(tow)
        subs[sid] = datas
    assert tows == list(range(tows[0], tows[0] + 5))

    dec = decode_frame(subs)
    assert dec == j_dec.decode_frame(subs)
    assert dec["wn"] == g0.week % 1024
    assert dec["iodc"] == int(eph.iodc[sv])
    assert dec["sf4_page"] == 56          # iono/UTC page present
    from pluto_gps_sim_tpu_torch.constants import (
        PI, POW2_M5, POW2_M19, POW2_M31, POW2_M33, POW2_M43)
    for name, scale in (("m0", POW2_M31 * PI), ("ecc", POW2_M33),
                        ("deltan", POW2_M43 * PI), ("af0", POW2_M31),
                        ("sqrta", POW2_M19), ("omg0", POW2_M31 * PI),
                        ("inc0", POW2_M31 * PI), ("aop", POW2_M31 * PI),
                        ("omgdot", POW2_M43 * PI), ("crs", POW2_M5),
                        ("idot", POW2_M43 * PI), ("tgd", POW2_M31)):
        q = int(float(getattr(eph, name)[sv]) / scale) * scale
        assert abs(dec[name] - q) <= 1e-18 + abs(q) * 1e-12, name
    assert abs(dec["alpha0"] - float(iono.alpha0)) <= 2 ** -30


def test_every_simulated_prn_acquires(one_block):
    """Every planned PRN acquires from port IQ at the planned Doppler
    and code phase, and the port's acquire() equals the JAX package's on
    the same IQ for all 32 PRNs."""
    plan, iq = one_block
    active = _active(plan)
    assert len(active) >= 4, "fixture scenario should have >=4 channels"
    n_per_code = int(round(FS * 1e-3))
    for prn in range(1, 33):
        assert dataclasses.asdict(acquire(iq, FS, prn)) == \
            dataclasses.asdict(j_acq.acquire(iq, FS, prn)), prn
    for c in active:
        prn = int(plan.prn[c])
        res = acquire(iq, FS, prn)
        assert res.detected and res.peak_ratio > 2.0, f"PRN {prn}: {res}"
        assert abs(res.doppler_hz - float(plan.f_carr[0, c])) <= 250.0
        cp0 = float(plan.code_phase[0, c]) % CA_SEQ_LEN
        v = float(plan.f_code[0, c]) / FS          # chips/sample
        n_true = ((CA_SEQ_LEN - cp0) % CA_SEQ_LEN) / v % n_per_code
        err = abs(res.code_offset - n_true)
        err = min(err, n_per_code - err)           # circular distance
        assert err <= 2.0, f"PRN {prn}: code offset err {err:.2f}"


def test_absent_prn_does_not_acquire(one_block):
    plan, iq = one_block
    present = {int(p) for p in plan.prn if p > 0}
    absent = [p for p in range(1, 33) if p not in present][:3]
    assert absent
    for prn in absent:
        res = acquire(iq, FS, prn)
        assert not res.detected, f"false acquisition: {res}"
        assert res.peak_ratio < 2.8, f"absent PRN {prn} too strong: {res}"


def test_acquire_all_matches_plan(one_block):
    plan, iq = one_block
    present = {int(plan.prn[c]) for c in _active(plan)}
    hits = {r.prn for r in acquire_all(iq, FS) if r.detected}
    assert hits == present, (sorted(hits), sorted(present))


def test_acquire_interleaved_flat_layout(one_block):
    """A .bin-file-shaped flat int16 stream acquires identically."""
    plan, iq = one_block
    flat = np.ascontiguousarray(iq).reshape(-1)
    prn = int(plan.prn[np.flatnonzero(plan.prn)[0]])
    a, b = acquire(iq, FS, prn), acquire(flat, FS, prn)
    assert b.detected
    assert (a.doppler_hz, a.code_offset) == (b.doppler_hz, b.code_offset)


@pytest.mark.parametrize("kind", ["noise", "silent"])
def test_no_signal_does_not_acquire(kind):
    """Noise, and an all-zero file (ratio 0, not inf), acquire nothing."""
    if kind == "noise":
        rng = np.random.RandomState(11)
        iq = rng.randint(-400, 400, size=(1, 3 * 2600, 2)).astype(np.int16)
    else:
        iq = np.zeros(4 * int(round(FS * 1e-3)) + 4, dtype=np.int16)
    for prn in (1, 7, 19, 32):
        res = acquire(iq, FS, prn)
        assert not res.detected, res
        if kind == "silent":
            assert res.peak_ratio == 0.0, res


def test_tracking_locks_on_plan(scenario):
    """PLL/DLL on 2 s of port-precise IQ converge on the planned carrier
    frequency, and the demodulated bits are a run of the planned ones."""
    rin, g0, ieph, xyz = scenario
    plan = Scheduler(rin, g0, ieph, xyz, fs=FS).plan(20)
    iq = synth_superframe_precise(pack_plan(plan), device="cpu")
    c = int(np.argmax(plan.gain[0] * plan.active[0]))
    prn = int(plan.prn[c])
    a = acquire(iq, FS, prn)
    assert a.detected
    tr = rx.track(iq, FS, prn, a, 1950)
    assert tr.locked_ratio > 0.95
    assert abs(tr.f_carr[-1] - float(plan.f_carr[19, c])) < 1.0

    off = rx._bit_sync(tr.i_p)
    nb = (len(tr.i_p) - off) // 20
    acc = tr.i_p[off:off + nb * 20].reshape(nb, 20).sum(axis=1)
    got = np.sign(acc).astype(np.int8)
    s = "".join("1" if b > 0 else "0" for b in got)
    hay = "".join("1" if b > 0 else "0" for b in plan.bits[c])
    inv = s.translate(str.maketrans("01", "10"))
    assert (s in hay) or (inv in hay), "bit stream not found in plan"


@pytest.fixture(scope="module")
def long_iq(scenario):
    """40 s of port precise-path IQ (covers SF1..SF5 of the second frame
    for every channel regardless of where tracking picks up)."""
    rin, g0, ieph, xyz = scenario
    return IqStream(rin, g0, ieph, xyz, fs=FS, mode="precise",
                    device="cpu").generate(400)


@pytest.fixture(scope="module")
def fix(scenario, long_iq):
    _, g0, _, _ = scenario
    return rx.receive_and_fix(long_iq, FS, ref_week=g0.week,
                              measure_sample=int(round(FS)))


def test_receiver_position_fix(scenario, fix):
    """The software receiver fixes from port IQ with only broadcast-
    decoded parameters, on the simulated receiver location."""
    rin, g0, ieph, xyz = scenario
    plan = Scheduler(rin, g0, ieph, xyz, fs=FS).plan(1)
    planned = sorted(int(plan.prn[c]) for c in _active(plan))
    sol, tracks = fix
    assert sorted(sol.prns) == planned
    err = np.linalg.norm(sol.xyz - xyz)
    assert err < 8.0, f"fix error {err:.1f} m (xyz {sol.xyz})"
    assert abs(sol.t_rx - (g0.sec + 1.0)) * SPEED_OF_LIGHT < 10.0
    assert sol.rms_residual < 5.0
    for prn, tr in tracks.items():
        assert tr.decoded, f"PRN {prn} no ephemeris decoded"
        assert {1, 2, 3} <= tr.subframes.keys()
    assert any(tr.decoded.get("sf4_page") == 56 for tr in tracks.values())
    v = sol.velocity
    assert v is not None and sorted(v.prns) == planned
    speed = float(np.linalg.norm(v.vel))
    assert speed < 0.15, f"static receiver velocity {speed:.3f} m/s"
    assert abs(v.cbdot) < 0.15
    assert v.rms_residual < 0.1


def test_transmit_time_matches_range_model(scenario, long_iq):
    """Tracked transmit time == the scenario's closed form at a block
    boundary, within DLL noise."""
    rin, g0, ieph, xyz = scenario
    plan = Scheduler(rin, g0, ieph, xyz, fs=FS).plan(11)
    c = int(np.argmax(plan.gain[0] * plan.active[0]))
    prn = int(plan.prn[c])
    a = acquire(long_iq, FS, prn)
    tr = rx.track(long_iq, FS, prn, a, 12_000)
    rx.frame_sync(tr)
    t_tx = rx.transmit_time(tr, int(round(FS)))

    from pluto_gps_sim_tpu_torch.models import orbits
    r = orbits.compute_range(rin.eph[ieph], rin.ionoutc, g0.sec + 1.0, xyz)
    rho = float(np.asarray(r["range"])[prn - 1])
    t_expect = (g0.sec + 1.0) - rho / SPEED_OF_LIGHT
    assert abs(t_tx - t_expect) * SPEED_OF_LIGHT < 5.0


def test_receiver_main_prints_fix(tmp_path, fix, scenario, monkeypatch,
                                  capsys):
    """The command-line entry reads the .bin as host int16 and prints
    the fix; the receiver chain itself is the fixture's (already run
    above), so this checks the entry's plumbing."""
    _, g0, _, xyz = scenario
    path = tmp_path / "iq.bin"
    np.arange(8, dtype=np.int16).tofile(path)
    seen = {}

    def fake(iq, fs, week, measure_sample, verbose):
        seen.update(dtype=iq.dtype, size=iq.size, fs=fs, week=week,
                    measure_sample=measure_sample)
        return fix

    monkeypatch.setattr(rx, "receive_and_fix", fake)
    assert rx._main([str(path), "--fs", "2600000", "--week",
                     str(g0.week)]) == 0
    assert seen == {"dtype": np.int16, "size": 8, "fs": FS,
                    "week": g0.week, "measure_sample": int(round(FS))}
    out = capsys.readouterr().out
    assert "FIX: ECEF" in out and "VEL" in out


def test_receiver_module_runs_as_program():
    """python -m pluto_gps_sim_tpu_torch.utils.receiver starts without
    jax."""
    code = ("import runpy, sys; sys.argv = ['receiver', '--help']\n"
            "try:\n"
            "    runpy.run_module('pluto_gps_sim_tpu_torch.utils.receiver',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "binfile" in proc.stdout and "--week" in proc.stdout
