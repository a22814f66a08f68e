"""Output sinks for the int16 IQ stream.

The reference has exactly one sink — the ADALM-Pluto SDR over libiio
(pluto_tx_thread_ep, plutogpssim.c:2058-2190).  This framework makes the
output stage pluggable:

  file    gps-sdr-sim-compatible interleaved int16 IQ .bin file
  stdout  same bytes to a pipe (feed gqrx, GNU Radio, nc, ...)
  null    discard (benchmarks)

The JAX package's udp and iio sinks and its real-time pacing (the native
C++ ring writer) are not ported yet.
"""

from __future__ import annotations

import os
import sys

import numpy as np

__all__ = ["open_sink", "FileSink", "FdSink", "NullSink", "StatsSink"]


def _as_bytes(block: np.ndarray) -> np.ndarray:
    """[..., 2] int16 IQ -> contiguous int16 view ready to write."""
    arr = np.ascontiguousarray(block)
    if arr.dtype != np.int16:
        raise TypeError(f"IQ blocks must be int16, got {arr.dtype}")
    return arr


class FdSink:
    """Writes interleaved int16 IQ to a file descriptor."""

    def __init__(self, fd: int, close_fd: bool = False):
        self.fd = fd
        self._close_fd = close_fd
        self.bytes_written = 0

    def write(self, block: np.ndarray) -> None:
        data = _as_bytes(block).tobytes()
        view = memoryview(data)
        while view:  # os.write may partial-write on pipes/sockets
            n = os.write(self.fd, view)
            view = view[n:]
        self.bytes_written += len(data)

    def close(self) -> None:
        if self._close_fd and self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileSink(FdSink):
    """gps-sdr-sim-compatible IQ file (interleaved little-endian int16)."""

    def __init__(self, path: str):
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        super().__init__(fd, close_fd=True)
        self.path = path


class NullSink:
    def __init__(self):
        self.bytes_written = 0

    def write(self, block: np.ndarray) -> None:
        self.bytes_written += _as_bytes(block).nbytes

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()



class StatsSink:
    """Observability wrapper: counts samples, tracks throughput and a
    running CRC32 of the stream (per-block checksums chained), so two
    runs can be compared without storing the IQ.  The reference has no
    metrics at all (stderr printfs only, SURVEY.md section 5)."""

    def __init__(self, inner):
        import time
        import zlib
        self._inner = inner
        self._crc32 = zlib.crc32
        self._t0 = time.time()
        self._time = time.time
        self.writes = 0
        self.samples = 0
        self.crc = 0

    def write(self, block: np.ndarray) -> None:
        data = _as_bytes(block)
        self._inner.write(data)
        self.writes += 1
        self.samples += data.size // 2
        self.crc = self._crc32(data.tobytes(), self.crc)

    def stats(self) -> dict:
        el = max(self._time() - self._t0, 1e-9)
        out = {"writes": self.writes, "samples": self.samples,
               "crc32": f"{self.crc:08x}",
               "samples_per_sec": round(self.samples / el, 1)}
        if hasattr(self._inner, "stats"):
            out["transport"] = self._inner.stats()
        return out

    def close(self) -> None:
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()



def open_sink(kind: str, *, path: str | None = None):
    """Factory: sink spec ('file', 'stdout' or 'null') -> sink object."""
    if kind == "null":
        return NullSink()
    if kind == "stdout":
        return FdSink(sys.stdout.fileno(), close_fd=False)
    if kind == "file":
        if not path:
            raise ValueError("file sink needs a path")
        return FileSink(path)
    raise ValueError(f"unknown sink {kind!r}")
