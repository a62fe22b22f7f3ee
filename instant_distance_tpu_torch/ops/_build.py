"""Build and load the package's CUDA kernels at first use.

``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), then
loaded with ``ctypes``.  The library lands in ``build/kernels/`` beside
the package, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the cached file — the pattern
of the JAX package's host engine (``instant_distance_tpu/native/cpu.py``).
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None

#: What the last build printed (nvcc's ptxas register/spill report) and
#: how long it took; empty and 0.0 when the cached library was loaded.
build_log = ""
build_seconds = 0.0


def _sources():
    return sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libidt_kernels_{h.hexdigest()[:12]}.so")


def _compile(path: str) -> None:
    global build_log, build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *_sources(), "-o", tmp]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, path)  # atomic: concurrent builders race harmlessly


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            c = ctypes
            lib.idt_packed_scan.restype = c.c_int
            lib.idt_packed_scan.argtypes = (
                [c.c_void_p] * 5 + [c.c_int] * 6 + [c.c_void_p])
            lib.idt_error_string.restype = c.c_char_p
            lib.idt_error_string.argtypes = [c.c_int]
            _lib = lib
        return _lib


def check(lib, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.idt_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} ({rc})")
