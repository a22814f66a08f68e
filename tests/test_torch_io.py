"""The PyTorch package's I/O: native ring writer, UDP, IIO, realtime, fetch.

Mirrors the ring-writer, UDP, realtime and selfcheck tests of
tests/test_cli_sinks.py, all of tests/test_iio_sink.py (with its fake
`iio` module) and all of tests/test_fetch.py (with its fake local FTP
server; no network) against the port's copies of utils/native,
native/ring_writer.cpp, runtime/sinks, ingest/fetch and the CLI options
that drive them (--device cpu, so no GPU is needed).  The fakes are
copied here; this file imports nothing from the JAX package's tests.
"""

from __future__ import annotations

import calendar
import gzip
import os
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from pluto_gps_sim_tpu_torch.cli import _selfcheck, main
from pluto_gps_sim_tpu_torch.ingest.fetch import compose_rinex_url, \
    fetch_rinex
from pluto_gps_sim_tpu_torch.utils import native
from pluto_gps_sim_tpu_torch.utils.native import NativeBuildError, RingWriter

LLH = "35.681298,139.766247,10.0"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_base(fixture_paths, fs="1000000", dur="0.1"):
    return ["-e", fixture_paths["rinex2"], "-l", LLH, "-s", fs, "-d", dur,
            "--device", "cpu"]


# --------------------------------------------------------------------------
# native ring writer (C++ transport)


def test_ring_writer_integrity(tmp_path):
    """All bytes arrive, in order, across wrap-arounds."""
    path = str(tmp_path / "ring.bin")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    rng = np.random.RandomState(0)
    chunks = [rng.randint(-2**15, 2**15, rng.randint(100, 50_000),
                          dtype=np.int16) for _ in range(40)]
    try:
        rw = RingWriter(fd, capacity=64 * 1024)   # force many wraps
    except NativeBuildError as e:
        pytest.skip(f"no native toolchain: {e}")
    with rw:
        for c in chunks:
            rw.push(c)
    os.close(fd)
    want = np.concatenate(chunks)
    got = np.fromfile(path, dtype=np.int16)
    assert np.array_equal(want, got)
    assert rw.stats()["bytes_written"] == want.nbytes


def test_ring_writer_builds_into_port_package():
    """The library is built from this package's source into its own
    native/_build/, not the JAX package's."""
    native.load_ring_writer()
    pkg = os.path.join(REPO, "pluto_gps_sim_tpu_torch", "native")
    assert native._SRC == os.path.join(pkg, "ring_writer.cpp")
    assert os.path.exists(os.path.join(pkg, "_build", "ring_writer.so"))


def test_ring_writer_pacing(tmp_path):
    """Paced mode drains at ~bytes_per_sec, independent of push speed."""
    path = str(tmp_path / "paced.bin")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    n = 400_000
    try:
        rw = RingWriter(fd, capacity=2 * n, bytes_per_sec=1_000_000.0,
                        chunk_bytes=40_000)
    except NativeBuildError as e:
        pytest.skip(f"no native toolchain: {e}")
    t0 = time.time()
    rw.push(np.zeros(n, dtype=np.int8))
    rw.close()
    dt = time.time() - t0
    os.close(fd)
    assert os.path.getsize(path) == n
    assert 0.25 <= dt <= 1.5, f"paced drain took {dt:.3f}s, expected ~0.36s"


def test_ring_writer_partial_chunk_pacing(tmp_path):
    """Sustained partial-chunk pops pace to bytes_per_sec, not to
    whole-chunk periods."""
    path = str(tmp_path / "partial.bin")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    chunk = 50_000
    try:
        rw = RingWriter(fd, capacity=4 * chunk, bytes_per_sec=1_000_000.0,
                        chunk_bytes=chunk)
    except NativeBuildError as e:
        pytest.skip(f"no native toolchain: {e}")
    piece = np.zeros(chunk // 4, dtype=np.int8)
    t0 = time.time()
    for _ in range(24):                           # 300k bytes total
        rw.push(piece)
        time.sleep(0.005)
    rw.close()
    dt = time.time() - t0
    os.close(fd)
    assert os.path.getsize(path) == 24 * piece.nbytes
    assert dt <= 0.8, f"partial-chunk drain took {dt:.3f}s (paced slow)"
    assert dt >= 0.15, f"drained in {dt:.3f}s - pacing not applied"


def test_udp_realtime_pacing():
    """Native datagram pacing: fixed-size packets at ~4*fs bytes/s."""
    from pluto_gps_sim_tpu_torch.runtime.sinks import UdpRealtimeSink

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 * 1024 * 1024)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.5)
    port = rx.getsockname()[1]
    n = 400_000
    sizes = []
    done = threading.Event()

    def drain():
        got = 0
        while got < 4 * n:
            try:
                pkt, _ = rx.recvfrom(65536)
            except socket.timeout:
                if done.is_set():
                    break
                continue
            sizes.append(len(pkt))
            got += len(pkt)

    t = threading.Thread(target=drain)
    t.start()
    try:
        sink = UdpRealtimeSink("127.0.0.1", port, 1_000_000.0)
    except Exception as e:
        done.set()
        t.join(timeout=10)
        rx.close()
        pytest.skip(f"no native toolchain: {e}")
    t0 = time.time()
    sink.write(np.zeros((n, 2), dtype=np.int16))
    sink.close()
    dt = time.time() - t0
    done.set()
    t.join(timeout=10)
    assert not t.is_alive()
    rx.close()
    assert sum(sizes) >= 4 * n // 2, f"received only {sum(sizes)} bytes"
    assert set(sizes[:-1]) == {1440}, set(sizes)
    assert dt >= 0.25, f"drained in {dt:.3f}s - pacing not applied"


def test_udp_realtime_tolerates_absent_receiver():
    """Fire-and-forget: nobody listening must not abort the stream."""
    from pluto_gps_sim_tpu_torch.runtime.sinks import UdpRealtimeSink
    try:
        sink = UdpRealtimeSink("127.0.0.1", 9, 1_000_000.0)  # discard port
    except Exception as e:
        pytest.skip(f"no native toolchain: {e}")
    data = np.zeros((100_000, 2), dtype=np.int16)
    sink.write(data)
    sink.write(data)
    sink.close()
    assert sink.stats()["bytes_written"] == 2 * 400_000


def test_open_sink_warns_without_native(tmp_path, monkeypatch, capsys):
    """Without a C++ toolchain --realtime falls back to unpaced writes
    with the JAX package's printed WARNING (file and UDP alike)."""
    from pluto_gps_sim_tpu_torch.runtime import sinks

    def no_gxx():
        raise NativeBuildError("g++ not available: [Errno 2]")

    monkeypatch.setattr(native, "load_ring_writer", no_gxx)
    sink = sinks.open_sink("file", path=str(tmp_path / "x.bin"),
                           fs=1e6, realtime=True)
    assert type(sink) is sinks.FdSink
    sink.write(np.ones((10, 2), np.int16))
    sink.close()
    assert os.path.getsize(tmp_path / "x.bin") == 40
    err = capsys.readouterr().err
    assert "WARNING: native ring writer unavailable" in err
    udp = sinks.open_sink("udp", fs=1e6, realtime=True, udp_port=9)
    assert type(udp) is sinks.UdpSink
    udp.close()
    assert "WARNING: native paced UDP unavailable" in capsys.readouterr().err


# --------------------------------------------------------------------------
# the CLI's sinks


def test_cli_udp_sink(fixture_paths):
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 * 1024 * 1024)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.5)
    port = rx.getsockname()[1]
    got = bytearray()
    sender_done = threading.Event()

    def drain():
        while len(got) < 4 * 100_000:
            try:
                data, _ = rx.recvfrom(65536)
                got.extend(data)
            except socket.timeout:
                if sender_done.is_set():
                    break

    t = threading.Thread(target=drain)
    t.start()
    rc = main(_cli_base(fixture_paths) + [
        "--sink", "udp", "--udp-host", "127.0.0.1", "--udp-port", str(port)])
    sender_done.set()
    t.join(timeout=30)
    assert not t.is_alive()
    rx.close()
    assert rc == 0
    # loopback UDP can drop under load; require at least half the bytes
    assert len(got) >= 2 * 100_000, f"received only {len(got)} bytes"


def test_cli_realtime_matches_unpaced(tmp_path, fixture_paths, capsys):
    """--realtime paces the file through the native ring writer (no
    fallback WARNING, ring stats reported) and writes the same bytes."""
    paced, plain = str(tmp_path / "rt.bin"), str(tmp_path / "no.bin")
    t0 = time.time()
    assert main(_cli_base(fixture_paths, dur="0.5")
                + ["-o", paced, "--realtime"]) == 0
    wall = time.time() - t0
    err = capsys.readouterr().err
    assert "WARNING" not in err and '"producer_waits"' in err
    assert wall >= 0.4, f"0.5 s of signal written in {wall:.2f} s"
    assert main(_cli_base(fixture_paths, dur="0.5") + ["-o", plain]) == 0
    assert open(paced, "rb").read() == open(plain, "rb").read()
    assert os.path.getsize(paced) == 500_000 * 4


def test_cli_selfcheck(tmp_path, fixture_paths, capsys):
    """--selfcheck re-acquires every planned PRN from the written file
    and FAILs (rc=1) when the IQ does not carry them."""
    out = str(tmp_path / "sc.bin")
    rc = main(_cli_base(fixture_paths, fs="2600000", dur="0.2")
              + ["-o", out, "--selfcheck"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "selfcheck: PASS" in err
    assert err.count("HIT") >= 4

    n = np.fromfile(out, dtype=np.int16).size
    rng = np.random.RandomState(7)
    rng.randint(-500, 500, n).astype(np.int16).tofile(out)
    assert _selfcheck(out, 2_600_000.0, [3, 5, 6]) is False
    assert "selfcheck: FAIL" in capsys.readouterr().err


def test_cli_selfcheck_needs_file_and_shard_zero(tmp_path, fixture_paths,
                                                capsys):
    base = _cli_base(fixture_paths) + ["--selfcheck"]
    assert main(base + ["--sink", "null"]) == 1
    assert "needs a file sink" in capsys.readouterr().err
    assert main(base + ["-o", str(tmp_path / "x.bin"),
                        "--shard", "1/2"]) == 1
    assert "--shard 0/N" in capsys.readouterr().err


# --------------------------------------------------------------------------
# IIO sink against a recording fake of the libiio binding


class FakeAttr:
    def __init__(self, log, key):
        self._log = log
        self._key = key
        self._value = None

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self._value = v
        self._log.append((self._key, v))


class _AttrDict(dict):
    def __init__(self, log, key):
        super().__init__()
        self._log = log
        self._key = key

    def __missing__(self, name):
        a = FakeAttr(self._log, f"{self._key}.{name}")
        self[name] = a
        return a


class FakeChannel:
    def __init__(self, log, dev, name):
        self._log = log
        self._key = f"{dev}:{name}"
        self.attrs = _AttrDict(log, self._key)
        self._enabled = False

    @property
    def enabled(self):
        return self._enabled

    @enabled.setter
    def enabled(self, v):
        self._enabled = v
        self._log.append((f"{self._key}.enabled", v))


class FakeDevice:
    def __init__(self, log, name):
        self._log = log
        self.name = name
        self._channels: dict[str, FakeChannel] = {}

    def find_channel(self, name, is_output=False):
        if name not in self._channels:
            self._channels[name] = FakeChannel(self._log, self.name, name)
        return self._channels[name]

    def set_kernel_buffers_count(self, n):
        self._log.append((f"{self.name}.kernel_buffers", n))


class FakeContext:
    def __init__(self, log, kind):
        log.append(("context", kind))
        self._devices = {
            "ad9361-phy": FakeDevice(log, "ad9361-phy"),
            "cf-ad9361-dds-core-lpc": FakeDevice(log,
                                                 "cf-ad9361-dds-core-lpc"),
        }

    def find_device(self, name):
        return self._devices.get(name)


class FakeBuffer:
    def __init__(self, log, device, samples, cyclic):
        self._log = log
        self.data = b""
        log.append(("buffer_create", samples))

    def write(self, data):
        self.data = bytes(data)

    def push(self):
        self._log.append(("push", len(self.data)))


@pytest.fixture()
def fake_iio(monkeypatch):
    log: list = []
    mod = types.ModuleType("iio")
    mod.Context = lambda uri=None: FakeContext(log, uri or "default")
    mod.NetworkContext = lambda host: FakeContext(log, f"net:{host}")
    mod.Buffer = lambda dev, n, cyclic: FakeBuffer(log, dev, n, cyclic)
    monkeypatch.setitem(sys.modules, "iio", mod)
    return log


def _make_iio_sink(**kw):
    from pluto_gps_sim_tpu_torch.runtime.sinks import IioSink
    return IioSink(fs=2_600_000.0, bw_hz=3_000_000.0, gain_db=-20.0, **kw)


def test_phy_bringup_matches_reference(fake_iio):
    sink = _make_iio_sink(uri="usb:1.2.3")
    log = {k: v for k, v in fake_iio if k != "push"}
    assert ("context", "usb:1.2.3") in fake_iio
    assert log["cf-ad9361-dds-core-lpc.kernel_buffers"] == 12
    assert log["ad9361-phy:voltage0.rf_port_select"] == "A"
    assert log["ad9361-phy:voltage0.rf_bandwidth"] == "3000000"
    assert log["ad9361-phy:voltage0.sampling_frequency"] == "2600000"
    assert log["ad9361-phy:voltage0.hardwaregain"] == "-20.0"
    assert log["ad9361-phy:altvoltage0.powerdown"] == "1"
    assert log["ad9361-phy:altvoltage1.frequency"] == "1575420000"
    assert log["cf-ad9361-dds-core-lpc:voltage0.enabled"] is True
    assert log["cf-ad9361-dds-core-lpc:voltage1.enabled"] is True
    # TX LO must NOT be powered up before streaming starts (c:2139)
    assert ("ad9361-phy:altvoltage1.powerdown", "0") not in fake_iio
    sink.close()


def test_network_context(fake_iio):
    sink = _make_iio_sink(hostname="pluto.local")
    assert ("context", "net:pluto.local") in fake_iio
    sink.close()


def test_lo_power_sequencing_and_push(fake_iio):
    sink = _make_iio_sink()
    block = np.zeros((2, 1000, 2), dtype=np.int16)
    sink.write(block)
    sink.write(block)
    keys = [k for k, _ in fake_iio]
    up = fake_iio.index(("ad9361-phy:altvoltage1.powerdown", "0"))
    assert fake_iio.index(("buffer_create", 2000)) < up < keys.index("push")
    assert keys.count("push") == 2
    assert ("push", block.nbytes) in fake_iio
    assert sink.bytes_written == 2 * block.nbytes
    sink.close()
    assert fake_iio[-3:] == [
        ("ad9361-phy:altvoltage1.powerdown", "1"),
        ("cf-ad9361-dds-core-lpc:voltage0.enabled", False),
        ("cf-ad9361-dds-core-lpc:voltage1.enabled", False),
    ]
    assert sink.ctx is None


def test_buffer_recreated_on_block_size_change(fake_iio):
    sink = _make_iio_sink()
    sink.write(np.zeros((1, 1000, 2), dtype=np.int16))
    sink.write(np.zeros((1, 500, 2), dtype=np.int16))
    assert [v for k, v in fake_iio if k == "buffer_create"] == [1000, 500]
    ups = [1 for kv in fake_iio
           if kv == ("ad9361-phy:altvoltage1.powerdown", "0")]
    assert len(ups) == 1
    sink.close()


def test_missing_binding_is_clean_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "iio", None)
    from pluto_gps_sim_tpu_torch.runtime.sinks import IioSink
    with pytest.raises(RuntimeError, match="libiio"):
        IioSink(fs=2.6e6, bw_hz=3e6, gain_db=-20.0)


def test_open_sink_routes_to_iio(fake_iio):
    from pluto_gps_sim_tpu_torch.runtime.sinks import IioSink, open_sink
    sink = open_sink("iio", fs=2.6e6, bw_hz=3e6, gain_db=-20.0,
                     uri="ip:192.168.2.1")
    assert isinstance(sink, IioSink)
    assert ("context", "ip:192.168.2.1") in fake_iio
    sink.close()


# --------------------------------------------------------------------------
# FTP fetch against a fake local FTP server


def _ts(y, m, d, hh, mm=0):
    return calendar.timegm((y, m, d, hh, mm, 0, 0, 0, 0))


@pytest.mark.parametrize("rinex3,now,want", [
    (False, (2023, 6, 15, 14, 30),
     "ftp://igs.bkg.bund.de/IGS/nrt/166/13/ffmj166n.23n.gz"),
    (True, (2023, 6, 15, 14, 30),
     "ftp://igs.bkg.bund.de/IGS/nrt_v3/166/13/func166n.23n.gz"),
    # at hour 0 the reference wraps to hour 23 WITHOUT decrementing the
    # day (c:2434-2437) — quirk preserved
    (False, (2023, 6, 15, 0, 10),
     "ftp://igs.bkg.bund.de/IGS/nrt/166/23/ffmj166x.23n.gz"),
], ids=["v2", "v3", "midnight_quirk"])
def test_compose_rinex_url(rinex3, now, want):
    assert compose_rinex_url(use_rinex3=rinex3, now=_ts(*now)) == want


class FakeFtpServer:
    """Just enough of RFC 959 for urllib/ftplib's anonymous binary RETR
    (USER/PASS/CWD/TYPE/PASV/RETR/QUIT), serving one payload for every
    requested path, on a localhost port."""

    def __init__(self, payload: bytes):
        self.payload = payload
        self.retr_paths: list[str] = []
        self.cwd_trail: list[str] = []
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.sock.settimeout(20.0)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.sock.accept()
        except OSError:
            return
        conn.settimeout(20.0)
        fp = conn.makefile("rwb")

        def reply(line):
            fp.write(line.encode() + b"\r\n")
            fp.flush()

        reply("220 fake IGS NRT server")
        data_listener = None
        try:
            while True:
                raw = fp.readline()
                if not raw:
                    break
                cmd, _, arg = raw.decode().strip().partition(" ")
                cmd = cmd.upper()
                if cmd == "USER":
                    reply("331 anonymous ok, send password")
                elif cmd == "PASS":
                    reply("230 logged in")
                elif cmd == "CWD":
                    self.cwd_trail.append(arg)
                    reply("250 ok")
                elif cmd == "TYPE":
                    reply("200 type set")
                elif cmd == "PASV":
                    data_listener = socket.socket(socket.AF_INET,
                                                  socket.SOCK_STREAM)
                    data_listener.bind(("127.0.0.1", 0))
                    data_listener.listen(1)
                    data_listener.settimeout(20.0)
                    p = data_listener.getsockname()[1]
                    reply(f"227 Entering Passive Mode "
                          f"(127,0,0,1,{p >> 8},{p & 0xFF})")
                elif cmd == "RETR":
                    self.retr_paths.append(arg)
                    reply("150 opening BINARY connection")
                    dconn, _ = data_listener.accept()
                    dconn.sendall(self.payload)
                    dconn.close()
                    data_listener.close()
                    data_listener = None
                    reply("226 transfer complete")
                elif cmd == "QUIT":
                    reply("221 bye")
                    break
                else:
                    reply("502 not implemented")
        except OSError:
            pass
        finally:
            fp.close()
            conn.close()

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
        self.thread.join(timeout=25)


@pytest.fixture
def fake_ftp(fixture_paths):
    with open(fixture_paths["rinex2"], "rb") as f:
        payload = gzip.compress(f.read())
    srv = FakeFtpServer(payload)
    yield srv
    srv.close()


def test_fetch_download_gunzip_parse(fake_ftp, tmp_path):
    """fetch_rinex's download/write path: RETR from the fake server ->
    gz file on disk -> transparent-gunzip RINEX parse."""
    from pluto_gps_sim_tpu_torch.ingest import read_rinex2

    dest = str(tmp_path / "rinex2.gz")
    url = fetch_rinex(dest, base_url=f"ftp://127.0.0.1:{fake_ftp.port}/IGS/")
    assert url.startswith(f"ftp://127.0.0.1:{fake_ftp.port}/IGS/nrt/")
    assert fake_ftp.retr_paths or fake_ftp.cwd_trail
    with open(dest, "rb") as f:
        assert f.read() == fake_ftp.payload
    assert read_rinex2(dest).n_sets >= 1


def test_cli_ftp_end_to_end(fake_ftp, tmp_path, monkeypatch):
    """CLI -f: download -> gunzip -> parse -> scenario -> IQ, with the
    catalog server swapped for the local fake."""
    from pluto_gps_sim_tpu_torch.ingest import fetch as fetch_mod

    monkeypatch.setattr(fetch_mod, "RINEX_FTP_URL",
                        f"ftp://127.0.0.1:{fake_ftp.port}/IGS/")
    monkeypatch.chdir(tmp_path)  # the CLI writes ./rinex2.gz (c:33-34)
    out = str(tmp_path / "iq.bin")
    rc = main(["-f", "-l", LLH, "-s", "2600000", "-d", "0.3", "-o", out,
               "--device", "cpu"])
    assert rc == 0
    assert os.path.exists(tmp_path / "rinex2.gz")
    iq = np.fromfile(out, dtype=np.int16)
    assert iq.size == int(2600000 * 0.3) * 2
    assert np.any(iq != 0)


def test_port_modules_never_import_jax():
    """The slice's modules import neither jax nor the JAX package."""
    code = ("import sys\n"
            "import pluto_gps_sim_tpu_torch.parallel\n"
            "import pluto_gps_sim_tpu_torch.utils.receiver\n"
            "import pluto_gps_sim_tpu_torch.ingest.fetch\n"
            "import pluto_gps_sim_tpu_torch.runtime.sinks\n"
            "import pluto_gps_sim_tpu_torch.utils.native\n"
            "import pluto_gps_sim_tpu_torch.cli\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'pluto_gps_sim_tpu.'))"
            " or m == 'pluto_gps_sim_tpu']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
