"""Build and load the package's CUDA kernels: nvcc -> shared library -> ctypes.

Each kernel source under ``ops/csrc/`` exposes a plain C entry point and
is compiled at first use with nvcc for Hopper (``sm_90a``) into
``ops/_build/`` (git-ignored), named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads from the
previous build.  Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "KernelBuildError", "find_nvcc", "load_kernel"]

CSRC_DIR = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per build
build_logs: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """Path of the CUDA toolkit's nvcc (CUDA_HOME, PATH, or the usual
    install location, as torch.utils.cpp_extension resolves it)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelBuildError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.access(nvcc, os.X_OK):
        raise KernelBuildError(f"nvcc not found at {nvcc}")
    return nvcc


def load_kernel(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a shared library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _loaded[name] = lib
        return lib


def _build(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)     # atomic: concurrent builders never see half a file
    return out
