"""The PyTorch package's stream and CLI against the JAX package's.

IqStream(device="cpu") runs the main path with the kernel's plain twin:
planner thread, dispatch ramp, split reassembly, snapshot/restore.  It is
held against the JAX IqStream in pallas mode (interpret mode on the CPU),
array-equal; snapshots cross between the packages; and the port's CLI
writes the same bytes as the JAX CLI without ever importing jax.
"""

from __future__ import annotations

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu import cli as j_cli
from pluto_gps_sim_tpu.constants import R2D
from pluto_gps_sim_tpu.ingest import read_rinex2 as j_read
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.ops import synth_pallas as sp
from pluto_gps_sim_tpu.runtime import scenario as j_scen
from pluto_gps_sim_tpu.runtime.stream import IqStream as JStream

from pluto_gps_sim_tpu_torch import cli as t_cli
from pluto_gps_sim_tpu_torch.ingest import read_rinex2 as t_read
from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
from pluto_gps_sim_tpu_torch.runtime import scenario as t_scen
from pluto_gps_sim_tpu_torch.runtime.stream import IqStream as TStream

from test_torch_io import fake_ftp, fake_iio  # noqa: F401  (fixtures)

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
LLH = "35.681298,139.766247,10.0"
FS = 1_000_000.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rinex_pair(fixture_paths):
    return j_read(fixture_paths["rinex2"]), t_read(fixture_paths["rinex2"])


def _streams(pair, *, j_mode="pallas", **kw):
    jr, tr = pair
    jg, tg = j_scen.setup_scenario(jr, None), t_scen.setup_scenario(tr, None)
    xyz = np.asarray(llh2xyz(TOKYO))
    j = JStream(jr, jg, j_scen.select_ephemeris_set(jr, jg), xyz, fs=FS,
                mode=j_mode, **kw)
    t = TStream(tr, tg, t_scen.select_ephemeris_set(tr, tg), xyz, fs=FS,
                device="cpu", **kw)
    return j, t


def test_stream_matches_jax_pallas_batched(rinex_pair):
    """As test_batched_dispatch_pallas_interpret: 9 blocks of 8192
    samples, superframes of 3 blocks, dispatch groups ramping 1, 2."""
    j, t = _streams(rinex_pair, block_samples=8192,
                    superframes_per_dispatch=2)
    a = list(j.superframes(9, max_blocks=3))
    b = list(t.superframes(9, max_blocks=3))
    assert [p.shape for p in a] == [p.shape for p in b] == \
        [(3, 8192, 2), (6, 8192, 2)]
    assert b[0].dtype == np.int16
    assert np.array_equal(np.concatenate(a), np.concatenate(b))
    assert t.patch_dropped == j.patch_dropped == 0


def test_stream_split_reassembly_matches(rinex_pair, monkeypatch):
    """Blocks beyond the (lowered) kernel cap split into re-anchored
    sub-blocks and reassemble to [M, N, 2], as in the JAX stream."""
    monkeypatch.setattr(sp, "MAX_BLOCK_SAMPLES", 16384)
    monkeypatch.setattr(sc, "MAX_BLOCK_SAMPLES", 16384)
    j, t = _streams(rinex_pair, block_samples=49152)
    assert j._split_k == t.split_k == 3
    assert t.sub_block_samples == 16384
    a = np.concatenate(list(j.superframes(4, max_blocks=2)))
    b = np.concatenate(list(t.superframes(4, max_blocks=2)))
    assert b.shape == (4, 49152, 2)
    assert np.array_equal(a, b)


def test_as_device_yields_packed_rows(rinex_pair):
    _, t = _streams(rinex_pair, block_samples=4096)
    host = t.generate(3)
    _, t2 = _streams(rinex_pair, block_samples=4096)
    raw = list(t2.superframes(3, as_device=True))
    assert all(isinstance(r, torch.Tensor) and r.dtype == torch.int32
               for r in raw)
    assert np.array_equal(sc.unpack_iq(torch.cat(raw).numpy()), host)


def _snapshot_roundtrip(src, dst, dump, load, n=3):
    """Generate n blocks on src, carry its snapshot through the npz
    format (dump, then load) into dst, and return dst's next n."""
    src.generate(n)
    buf = io.BytesIO()
    dump(src.snapshot(), buf)
    buf.seek(0)
    dst.restore(load(buf))
    return dst.generate(n)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_crosses_packages(rinex_pair, direction):
    """A snapshot written by one package resumes the other with the same
    continuation an uninterrupted stream gives."""
    _, full = _streams(rinex_pair, block_samples=8192)
    want = full.generate(6)[3:]
    j, t = _streams(rinex_pair, block_samples=8192)
    j2, t2 = _streams(rinex_pair, block_samples=8192)
    if direction == "jax_to_torch":
        got = _snapshot_roundtrip(j, t2, j_cli._dump_snapshot,
                                  t_cli._load_snapshot)
    else:
        got = _snapshot_roundtrip(t, j2, t_cli._dump_snapshot,
                                  j_cli._load_snapshot)
    assert np.array_equal(got, want)


def test_abandoned_generator_rolls_back(rinex_pair):
    """Abandoning superframes() mid-stream rolls the scheduler back to
    just after the last yielded superframe (the planner ran ahead)."""
    _, t = _streams(rinex_pair, block_samples=4096)
    want = t.generate(8)
    _, s = _streams(rinex_pair, block_samples=4096)
    it = s.superframes(8, max_blocks=2)
    first = next(it)
    it.close()
    assert s.snapshot()["jblk"] == 2
    rest = s.generate(6)
    assert np.array_equal(np.concatenate([first, rest]), want)


def test_host_partition_concatenates(rinex_pair):
    _, t = _streams(rinex_pair, block_samples=4096)
    want = t.generate(7)
    parts = []
    for h in range(3):
        _, s = _streams(rinex_pair, block_samples=4096, n_hosts=3,
                        host_id=h)
        parts.append(np.concatenate(list(s.superframes(7, max_blocks=2))))
    assert np.array_equal(np.concatenate(parts), want)


def _run_port_cli(args, cwd):
    """The port's CLI in a fresh interpreter; fails if it imported jax."""
    code = ("import sys; from pluto_gps_sim_tpu_torch.cli import main; "
            f"rc = main({args!r}); "
            "assert 'jax' not in sys.modules, 'the port imported jax'; "
            "sys.exit(rc)")
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_matches_jax_cli_bytes(tmp_path, fixture_paths):
    """--device cpu writes the bytes the JAX CLI writes with --mode
    pallas (interpret mode here), and never imports jax."""
    base = ["-e", fixture_paths["rinex2"], "-l", LLH, "-s", "1000000",
            "-d", "0.3"]
    ours = str(tmp_path / "torch.bin")
    theirs = str(tmp_path / "jax.bin")
    proc = _run_port_cli(base + ["-o", ours, "--device", "cpu", "--stats"],
                         str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert '"patch_dropped": 0' in proc.stderr
    assert j_cli.main(base + ["-o", theirs, "--mode", "pallas"]) == 0
    a, b = open(ours, "rb").read(), open(theirs, "rb").read()
    assert len(a) == 300_000 * 4
    assert a == b


def test_cli_resumes_jax_snapshot(tmp_path, fixture_paths):
    """--resume in the port takes the .npz the JAX CLI's --snapshot
    wrote, and the splice is seamless."""
    base = ["-e", fixture_paths["rinex2"], "-l", LLH, "-s", "1000000"]
    full, a, b = (str(tmp_path / f) for f in ("full.bin", "a.bin", "b.bin"))
    snap = str(tmp_path / "snap.npz")
    assert t_cli.main(base + ["-d", "0.6", "-o", full,
                              "--device", "cpu"]) == 0
    assert j_cli.main(base + ["-d", "0.3", "-o", a, "--snapshot", snap,
                              "--mode", "precise"]) == 0
    assert t_cli.main(base + ["-d", "0.3", "-o", b, "--resume", snap,
                              "--device", "cpu"]) == 0
    want = np.fromfile(full, np.int16)
    got = np.concatenate([np.fromfile(a, np.int16),
                          np.fromfile(b, np.int16)])
    assert np.array_equal(got, want)


def test_cli_cuda_without_gpu_fails_clearly(tmp_path, fixture_paths,
                                            monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = t_cli.main(["-e", fixture_paths["rinex2"], "-d", "0.1",
                     "-o", str(tmp_path / "x.bin")])
    assert rc != 0
    assert "--device cuda needs a CUDA GPU" in capsys.readouterr().err
    assert not (tmp_path / "x.bin").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _streams_cuda(fixture_paths)


def _streams_cuda(fixture_paths):
    rin = t_read(fixture_paths["rinex2"])
    g0 = t_scen.setup_scenario(rin, None)
    return TStream(rin, g0, t_scen.select_ephemeris_set(rin, g0),
                   np.asarray(llh2xyz(TOKYO)), fs=FS, device="cuda")


def _ported_case(name, tmp_path, monkeypatch, request):
    """Per-option setup: extra CLI args and a check of the option's
    effect (fakes stand in for the FTP server and the libiio binding)."""
    if name == "-f":
        from pluto_gps_sim_tpu_torch.ingest import fetch as fetch_mod
        srv = request.getfixturevalue("fake_ftp")
        monkeypatch.setattr(fetch_mod, "RINEX_FTP_URL",
                            f"ftp://127.0.0.1:{srv.port}/IGS/")
        monkeypatch.chdir(tmp_path)
        return [], lambda err: (tmp_path / "rinex2.gz").exists() \
            and "Fetched ftp://127.0.0.1" in err
    if name == "--realtime":
        return [], lambda err: '"producer_waits"' in err \
            and "WARNING" not in err
    if name == "--sink udp":
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(0.5)
        request.addfinalizer(rx.close)

        def received(err):
            got = 0
            try:
                while True:
                    got += len(rx.recvfrom(65536)[0])
            except socket.timeout:
                pass
            return got >= 260_000 * 4 // 2
        return ["--udp-port", str(rx.getsockname()[1])], received
    if name in ("--sink iio", "-U", "-N"):
        log = request.getfixturevalue("fake_iio")
        want = {"--sink iio": "default", "-U": "ip:pluto.local",
                "-N": "net:pluto"}[name]
        return [], lambda err: ("context", want) in log \
            and ("push", 260_000 * 4) in log
    if name == "--selfcheck":
        return [], lambda err: "selfcheck: PASS" in err
    assert name == "--profile"
    monkeypatch.chdir(tmp_path)

    def traced(err):
        with open(tmp_path / "prof" / "trace.json") as fp:
            return "traceEvents" in json.load(fp)
    return [], traced


@pytest.mark.parametrize("flags", [["-f"], ["--realtime"],
                                   ["--sink", "udp"], ["--sink", "iio"],
                                   ["-U", "ip:pluto.local"], ["-N", "pluto"],
                                   ["--selfcheck"], ["--profile", "prof"]])
def test_cli_ported_options_run(tmp_path, fixture_paths, capsys,
                                monkeypatch, request, flags):
    """Each option the JAX CLI has runs in the port (rc 0) and has its
    effect: FTP fetch, native pacing, UDP datagrams, the IIO sink (by
    --sink, -U or -N), the selfcheck verdict, a Chrome trace."""
    name = flags[0] if flags[0] != "--sink" else " ".join(flags)
    extra, check = _ported_case(name, tmp_path, monkeypatch, request)
    rc = t_cli.main(["-e", fixture_paths["rinex2"], "-d", "0.1",
                     "--device", "cpu", "-o", str(tmp_path / "x.bin")]
                    + flags + extra)
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "not ported" not in err
    assert check(err), err


def test_cli_parser_keeps_reference_surface():
    """The JAX parser's option surface and defaults, with --mode
    auto|pallas|tiled|precise replaced by --mode kernel|tiled|precise
    (default kernel) beside --device (default cuda)."""
    argv = ["-e", "nav.23n", "-l", "35,139,10", "-A", "-30", "-B", "2.5"]
    a, b = j_cli.parse_cli(argv), t_cli.parse_cli(argv)
    va, vb = vars(a), vars(b)
    assert va.pop("mode") == "auto"
    assert vb.pop("mode") == "kernel" and vb.pop("device") == "cuda"
    assert va == vb
    assert vb["gain_db"] == -30.0
    for mode in ("tiled", "precise"):
        assert t_cli.parse_cli(argv + ["--mode", mode]).mode == mode
    with pytest.raises(SystemExit):
        t_cli.parse_cli(argv + ["--device", "tpu"])


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_cli_parser_rejects_jax_only_modes(mode):
    """The port has no auto mode and no Pallas kernel."""
    with pytest.raises(SystemExit):
        t_cli.parse_cli(["-e", "nav.23n", "--mode", mode])
