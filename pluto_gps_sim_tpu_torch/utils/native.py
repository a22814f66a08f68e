"""On-demand build + ctypes bindings for the native transport runtime.

A copy of the JAX package's ``utils/native.py:1-152``, building this package's
copy of ``native/ring_writer.cpp`` into ``native/_build/``.

The C++ ring-writer (native/ring_writer.cpp) is the framework's L1
transport: a bounded ring buffer with a paced consumer thread, replacing
the reference's TX-thread/double-buffer handoff (plutogpssim.c:2058-2190,
2689-2759).  It is compiled once per source change with g++ into
native/_build/ and loaded via ctypes (no pybind11 in this environment).

Everything degrades gracefully: if no C++ toolchain is available,
callers fall back to pure-Python buffered writes (see runtime/sinks.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["load_ring_writer", "RingWriter", "NativeBuildError"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "ring_writer.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "native", "_build")
_SO = os.path.join(_BUILD_DIR, "ring_writer.so")

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    tmp = _SO + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeBuildError(f"g++ not available: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"native build failed:\n{proc.stderr}")
    os.replace(tmp, _SO)
    return _SO


def load_ring_writer() -> ctypes.CDLL:
    """Build (if needed) and load the native library; cached."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.rw_create.restype = ctypes.c_void_p
        lib.rw_create.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                  ctypes.c_double, ctypes.c_size_t,
                                  ctypes.c_int]
        lib.rw_push.restype = ctypes.c_int
        lib.rw_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t]
        lib.rw_fill.restype = ctypes.c_size_t
        lib.rw_fill.argtypes = [ctypes.c_void_p]
        lib.rw_stats.restype = None
        lib.rw_stats.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_uint64)] * 3
        lib.rw_close.restype = ctypes.c_int
        lib.rw_close.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_uint64)] * 3
        _lib = lib
        return lib


class RingWriter:
    """Paced, double-buffered writer to a file descriptor.

    bytes_per_sec <= 0 disables pacing (drain at I/O speed); chunk_bytes
    sets the pacing granularity (default one 0.1 s block of the caller).
    """

    def __init__(self, fd: int, capacity: int, bytes_per_sec: float = 0.0,
                 chunk_bytes: int = 0, datagram: bool = False):
        self._lib = load_ring_writer()
        if datagram:
            # every consumer write() must emit one whole datagram: round
            # the capacity to a chunk multiple so the ring never splits a
            # chunk across the wrap boundary
            if chunk_bytes <= 0:
                raise ValueError("datagram mode needs chunk_bytes")
            capacity = -(-capacity // chunk_bytes) * chunk_bytes
        self._h = self._lib.rw_create(fd, capacity, float(bytes_per_sec),
                                      int(chunk_bytes), 1 if datagram else 0)
        if not self._h:
            raise NativeBuildError("rw_create failed")

    def push(self, data: np.ndarray | bytes) -> None:
        if self._h is None:
            raise IOError("ring writer is closed")
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data)
            buf, n = data.ctypes.data, data.nbytes
        else:
            buf, n = data, len(data)
        if self._lib.rw_push(self._h, buf, n) != 0:
            raise IOError("ring writer closed (I/O error on consumer)")

    @property
    def fill(self) -> int:
        return int(self._lib.rw_fill(self._h)) if self._h else 0

    def stats(self) -> dict:
        if self._h is None:
            return dict(self._final_stats)
        b = ctypes.c_uint64()
        pw = ctypes.c_uint64()
        cw = ctypes.c_uint64()
        self._lib.rw_stats(self._h, ctypes.byref(b), ctypes.byref(pw),
                           ctypes.byref(cw))
        return {"bytes_written": b.value, "producer_waits": pw.value,
                "consumer_underruns": cw.value}

    def close(self) -> int:
        if self._h:
            b = ctypes.c_uint64()
            pw = ctypes.c_uint64()
            cw = ctypes.c_uint64()
            rc = self._lib.rw_close(self._h, ctypes.byref(b),
                                    ctypes.byref(pw), ctypes.byref(cw))
            self._final_stats = {"bytes_written": b.value,
                                 "producer_waits": pw.value,
                                 "consumer_underruns": cw.value}
            self._h = None
            return rc
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
