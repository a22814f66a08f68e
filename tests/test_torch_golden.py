"""The PyTorch package's f64 precise and tiled paths against the JAX package's.

ops.synth_torch.synth_superframe_precise and synth_superframe_tiled run
here on CPU tensors and are held against pluto_gps_sim_tpu's
synth_jnp.synth_superframe_precise / synth_superframe_tiled (XLA on the
CPU) on the same scheduler plan.  Tolerance: np.array_equal, since both
evaluate the same f64 (precise) or int32/f32 (tiled) op sequence.  The
kernel's twin must equal port precise where the JAX tests require the
Pallas kernel to equal its precise path, and tiled tracks precise
within test_tiled_matches_precise's bounds (>= 0.999 exact, >= 70 dB).
On the card, chip_smoke.py holds the CUDA runs of both paths to these
CPU runs word for word.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu import cli as j_cli
from pluto_gps_sim_tpu.constants import MAX_CHAN, R2D
from pluto_gps_sim_tpu.ingest import read_rinex2 as j_read
from pluto_gps_sim_tpu.models.cacode import CA_TABLE
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.ops import synth_jnp as sj
from pluto_gps_sim_tpu.runtime import scenario as j_scen
from pluto_gps_sim_tpu.runtime.scheduler import Scheduler, SuperframePlan
from pluto_gps_sim_tpu.runtime.stream import IqStream as JStream

from pluto_gps_sim_tpu_torch.ingest import read_rinex2 as t_read
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.ops import synth_torch as st
from pluto_gps_sim_tpu_torch.runtime import scenario as t_scen
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream as TStream

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
LLH = "35.681298,139.766247,10.0"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (fs, block_samples, blocks): the reference's advertised rate, and the
# small-block 1 MHz setting of the JAX package's stream tests
RATES = [(2_600_000.0, None, 2), (1_000_000.0, 16_384, 4)]


@pytest.fixture(scope="module")
def scenario(fixture_paths):
    rin = j_read(fixture_paths["rinex2"])
    g0 = j_scen.setup_scenario(rin, None)
    return (rin, g0, j_scen.select_ephemeris_set(rin, g0),
            np.asarray(llh2xyz(TOKYO)))


def _plan(scenario, fs, block_samples, blocks):
    rin, g0, ieph, xyz = scenario
    return Scheduler(rin, g0, ieph, xyz, fs=fs,
                     block_samples=block_samples).plan(blocks)


def _snr_db(ref, got):
    ref = ref.astype(np.float64)
    d = ref - got.astype(np.float64)
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(d ** 2), 1e-30))


@pytest.mark.parametrize("fs,block_samples,blocks", RATES)
def test_precise_matches_jax(scenario, fs, block_samples, blocks):
    plan = _plan(scenario, fs, block_samples, blocks)
    want = sj.synth_superframe_precise(sj.pack_plan(plan))
    got = st.synth_superframe_precise(st.pack_plan(plan), device="cpu")
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.array_equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("fs,block_samples,blocks", RATES)
def test_tiled_matches_jax(scenario, fs, block_samples, blocks):
    plan = _plan(scenario, fs, block_samples, blocks)
    want = sj.synth_superframe_tiled(sj.pack_plan(plan))
    got = st.synth_superframe_tiled(st.pack_plan(plan), device="cpu")
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.array_equal(got, want), int((got != want).sum())


def test_precise_fill_past_lut_row_matches_jax():
    """frac(c0 + u*n) rounds up to exactly 1.0 when c0 = 0 and u is a
    tiny negative rate, so the precise LUT index reaches 512, and 1024
    under a negative spreading sign, which jnp.take fills with
    INT32_MIN: the port mirrors the fill instead of reading a neighbour
    or faulting."""
    c, n = MAX_CHAN, 4096
    rng = np.random.RandomState(11)
    active = np.zeros((1, c), bool)
    active[0, :4] = True
    f_carr = np.zeros((1, c))
    f_carr[0, :4] = -1e-290
    plan = SuperframePlan(
        n_blocks=1, block_samples=n, delt=1.0 / 1_000_000.0,
        prn=np.where(active[0], np.arange(1, c + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(c)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (c, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=np.full((1, c), 1_023_000.0),
        code_phase=rng.uniform(0, 1023, (1, c)),
        icode=rng.randint(0, 20, (1, c)).astype(np.int32),
        ibit=rng.randint(0, 30, (1, c)).astype(np.int32),
        iword=rng.randint(0, 10, (1, c)).astype(np.int32),
        carr_phase=np.zeros((1, c)), gain=np.where(active, 0.7, 0.0),
        azel=np.zeros((1, c, 2)))
    want = sj.synth_superframe_precise(sj.pack_plan(plan))
    got = st.synth_superframe_precise(st.pack_plan(plan), device="cpu")
    assert np.array_equal(got, want)


def test_pallas_matches_precise(scenario):
    """The twin (the kernel's op sequence) equals port precise on the
    JAX package's test_pallas_matches_precise scenario: 2 blocks at
    2.6 MHz, array_equal."""
    plan = _plan(scenario, 2_600_000.0, None, 2)
    dp = st.pack_plan(plan)
    golden = st.synth_superframe_precise(dp, device="cpu")
    bp = sc.build_block_params(dp)
    assert bp.patch_dropped == 0
    packed = sc.synth_blocks(bp.prmi, bp.prmf, sc.pack_ca_tables([dp.ca2]),
                             np.zeros(dp.n_blocks, np.int32),
                             dp.block_samples)
    iq = sc.unpack_iq(packed.numpy())
    assert np.array_equal(iq, golden), int((iq != golden).sum())


@pytest.fixture(scope="module")
def rinex_pair(fixture_paths):
    return j_read(fixture_paths["rinex2"]), t_read(fixture_paths["rinex2"])


def _streams(pair, mode, **kw):
    jr, tr = pair
    jg, tg = j_scen.setup_scenario(jr, None), t_scen.setup_scenario(tr, None)
    xyz = np.asarray(llh2xyz(TOKYO))
    j = JStream(jr, jg, j_scen.select_ephemeris_set(jr, jg), xyz,
                fs=1_000_000.0, mode={"kernel": "pallas"}.get(mode, mode),
                **kw)
    t = TStream(tr, tg, t_scen.select_ephemeris_set(tr, tg), xyz,
                fs=1_000_000.0, mode=mode, device="cpu", **kw)
    return j, t


def test_tiled_matches_precise(rinex_pair):
    """As the JAX package's test_tiled_matches_precise: 2 blocks of the
    fixture stream (1 MHz), tiled against precise."""
    _, a = _streams(rinex_pair, "precise")
    _, b = _streams(rinex_pair, "tiled")
    a, b = a.generate(2), b.generate(2)
    assert _snr_db(a.reshape(-1), b.reshape(-1)) >= 70.0
    assert float(np.mean(a == b)) >= 0.999


@pytest.mark.parametrize("mode", ["tiled", "precise", "kernel"])
def test_stream_mode_matches_jax(rinex_pair, mode):
    """IqStream(mode=...) on the CPU equals the JAX stream in the same
    mode: 9 blocks of 8192 samples, superframes of 3 blocks, dispatch
    groups ramping 1, 2 (the JAX stream's multi-plan handles), and the
    as_device tensors concatenate to the same IQ.  "kernel" (the JAX
    stream's "pallas") runs one superframe a dispatch, the CLI's default
    K=1, against K=2 and the JAX stream, from 2 blocks before a 30 s
    boundary."""
    if mode == "kernel":
        j, t2 = _streams(rinex_pair, mode, block_samples=8192,
                         superframes_per_dispatch=2)
        _, t1 = _streams(rinex_pair, mode, block_samples=8192)
        skip = t1.sched._blocks_to_boundary() - 2
        runs = []
        for s in (j, t1, t2):
            s.fast_forward(skip)
            runs.append(list(s.superframes(6, max_blocks=3)))
        assert [[p.shape[0] for p in r] for r in runs] == \
            [[2, 4], [2, 3, 1], [2, 4]]
        want = np.concatenate(runs[0])
        assert all(np.array_equal(np.concatenate(r), want) for r in runs)
        return
    j, t = _streams(rinex_pair, mode, block_samples=8192,
                    superframes_per_dispatch=2)
    a = list(j.superframes(9, max_blocks=3))
    b = list(t.superframes(9, max_blocks=3))
    assert [p.shape for p in a] == [p.shape for p in b] == \
        [(3, 8192, 2), (6, 8192, 2)]
    assert np.array_equal(np.concatenate(a), np.concatenate(b))
    _, t2 = _streams(rinex_pair, mode, block_samples=8192,
                     superframes_per_dispatch=2)
    raw = list(t2.superframes(9, max_blocks=3, as_device=True))
    assert all(isinstance(r, torch.Tensor) and r.dtype == torch.int16
               for r in raw)
    assert np.array_equal(torch.cat(raw).numpy(), np.concatenate(b))


def test_stream_rejects_unknown_mode(rinex_pair):
    _, tr = rinex_pair
    g0 = t_scen.setup_scenario(tr, None)
    for mode in ("pallas", "auto"):
        with pytest.raises(ValueError, match="unknown synthesis mode"):
            TStream(tr, g0, t_scen.select_ephemeris_set(tr, g0),
                    np.asarray(llh2xyz(TOKYO)), fs=1_000_000.0, mode=mode,
                    device="cpu")


def test_tensor_paths_need_tables(scenario):
    dp = st.pack_plan(_plan(scenario, 1_000_000.0, 4096, 1), tables=False)
    with pytest.raises(ValueError, match="tables=True"):
        st.synth_superframe_precise(dp, device="cpu")
    with pytest.raises(ValueError, match="tables=True"):
        st.synth_superframe_tiled(dp, device="cpu")


def test_tensor_paths_cuda_without_gpu_raise(scenario, monkeypatch):
    """device="cuda", the default, without a GPU raises; nothing falls
    back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dp = st.pack_plan(_plan(scenario, 1_000_000.0, 4096, 1))
    for fn in (st.synth_superframe_precise, st.synth_superframe_tiled,
               st.synth_superframe_precise_async,
               st.synth_superframe_tiled_async):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(dp, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(dp)
    with pytest.raises(ValueError, match="unsupported device"):
        st.synth_superframe_tiled(dp, device="meta")


@pytest.mark.parametrize("mode", ["tiled", "precise"])
def test_cli_mode_matches_jax_cli_bytes(tmp_path, fixture_paths, mode):
    """--mode tiled|precise --device cpu writes the bytes the JAX CLI
    writes with the same --mode, and never imports jax."""
    base = ["-e", fixture_paths["rinex2"], "-l", LLH, "-s", "1000000",
            "-d", "0.3"]
    ours, theirs = str(tmp_path / "torch.bin"), str(tmp_path / "jax.bin")
    argv = base + ["-o", ours, "--mode", mode, "--device", "cpu"]
    code = ("import sys; from pluto_gps_sim_tpu_torch.cli import main; "
            f"rc = main({argv!r}); "
            "assert 'jax' not in sys.modules, 'the port imported jax'; "
            "sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert j_cli.main(base + ["-o", theirs, "--mode", mode]) == 0
    a, b = open(ours, "rb").read(), open(theirs, "rb").read()
    assert len(a) == 300_000 * 4
    assert a == b
