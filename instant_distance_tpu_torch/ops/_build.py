"""Build and load the package's CUDA kernels at first use.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds);
all of them start together and are loaded with ``ctypes``.  A library
lands in ``build/kernels/`` beside the package, named by its source and a
hash of that source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source rebuilds and an unchanged one loads the cached file
— the pattern of the JAX package's host engine
(``instant_distance_tpu/native/cpu.py``).  Nothing here runs at import:
the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: The C entry points of csrc/*.cu: name -> (restype, argtypes).
_SIGNATURES = {
    "idt_packed_scan": (_I, [_P] * 5 + [_I] * 6 + [_P]),
    "idt_bucket_scan": (_I, [_P] * 7 + [_I] * 6 + [_P]),
    "idt_bucket_scan_int": (_I, [_P] * 5 + [_I] * 5 + [_P]),
    "idt_topt_scan": (_I, [_P] * 9 + [_I] * 7 + [_P]),
    "idt_topt_merge": (_I, [_P] * 4 + [_I] * 4 + [_P]),
    "idt_probe_scan": (_I, [_P] * 4 + [_I] * 6 + [_P]),
    "idt_wg_plan": (_I, [_I, _P]),
    "idt_walk_search": (_I, [_P] * 8 + [_I] * 7 + [_P]),
    "idt_walk_smem": (_I, [_I] * 5),
    "idt_walk_occupancy": (_I, [_I] * 5),
    "idt_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib = None

#: What the last build printed (nvcc's ptxas register/spill report) and
#: how long it took; empty and 0.0 when the cached libraries were loaded.
build_log = ""
build_seconds = 0.0


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(src: str) -> str:
    """Where the library of source ``src`` is cached."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"libidt_{stem}_{h.hexdigest()[:12]}.so")


def _compile(todo: dict) -> None:
    """Build ``{source: library path}``: one nvcc per source, all
    running at once."""
    global build_log, build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, src, "-o", tmp]
        procs.append((src, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, path, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode})")
        else:
            os.replace(tmp, path)  # atomic: concurrent builders race harmlessly
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                           f"{build_log}")


def library():
    """The loaded kernels: one attribute per C entry point of
    ``_SIGNATURES``, and ``libraries`` (every source built on the first
    call)."""
    global _lib
    with _lock:
        if _lib is None:
            paths = {src: library_path(src) for src in _sources()}
            todo = {s: p for s, p in paths.items() if not os.path.exists(p)}
            if todo:
                _compile(todo)
            libs = [ctypes.CDLL(p) for p in paths.values()]
            fns = {"libraries": libs}   # keeps the handles alive
            for lib in libs:
                for name, (restype, argtypes) in _SIGNATURES.items():
                    if name not in fns and hasattr(lib, name):
                        fn = getattr(lib, name)
                        fn.restype, fn.argtypes = restype, argtypes
                        fns[name] = fn
            missing = sorted(set(_SIGNATURES) - set(fns))
            if missing:
                raise RuntimeError(f"kernel libraries lack {missing}")
            _lib = types.SimpleNamespace(**fns)
        return _lib


def check(lib, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.idt_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} ({rc})")
