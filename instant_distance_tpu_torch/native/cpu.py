"""ctypes wrapper for the host engine (the port's own copy of
``instant_distance_tpu/native/cpu.py``).

Compiles ``src/engine.cpp`` on first use (g++ -O3 -march=native -fopenmp)
into ``build/host/`` beside the package and exposes:

* ``NativeHnsw.build(...)``   — multithreaded host construction,
* ``NativeHnsw.search_batch`` — host queries (n_threads=1 is one query
  at a time, the reference's execution model),
* ``NativeHnsw.to_arrays``    — the graph as the dense arrays the card's
  batched search consumes,
* ``NativeHnsw.from_arrays``  — host queries over a graph built on the
  card (tensors on any device, or numpy).

``-march=native`` ties the library to the CPU that built it, so its file
name carries a hash of the source, the flags and the CPU's identity
(:func:`cpu_identity`): another CPU finds no file of its own and
compiles one instead of loading code it may not run.  Without a
compiler ``available()`` is False and ``load_error()`` says why; the
callers raise rather than fall back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "engine.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "host")
FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fopenmp", "-shared",
         "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None
_LIB_ERR: Optional[str] = None

_METRICS = {"sqeuclidean": 0, "euclidean": 1, "dot": 2, "cosine": 3}


def cpu_identity() -> str:
    """The machine type and the ``model name`` and ``flags`` lines of
    /proc/cpuinfo (the CPU features ``-march=native`` compiles for)."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and line not in lines:
                    lines.append(line)
                if len(lines) == 2:
                    break
    except OSError:
        pass
    return "\n".join([platform.machine(), *lines])


def lib_path() -> str:
    """Where the library for this source, these flags and this CPU
    lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(cpu_identity().encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libidt_host_{h.hexdigest()[:12]}.so")


def _compile(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, path)  # atomic: concurrent builders race harmlessly


def _load():
    global _LIB, _LIB_ERR
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            path = lib_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
        except Exception as exc:  # no compiler / load failure
            _LIB_ERR = getattr(exc, "stderr", None) or str(exc)
            return None
        c = ctypes
        lib.idtpu_build.restype = c.c_void_p
        lib.idtpu_build.argtypes = [
            c.c_void_p, c.c_int64, c.c_int64, c.c_int, c.c_int, c.c_float,
            c.c_uint64, c.c_int32, c.c_int, c.c_int, c.c_int, c.c_int]
        lib.idtpu_free.argtypes = [c.c_void_p]
        lib.idtpu_n.restype = c.c_int64
        lib.idtpu_n.argtypes = [c.c_void_p]
        lib.idtpu_dim.restype = c.c_int64
        lib.idtpu_dim.argtypes = [c.c_void_p]
        lib.idtpu_n_layers.restype = c.c_int32
        lib.idtpu_n_layers.argtypes = [c.c_void_p]
        lib.idtpu_layer_rows.restype = c.c_int64
        lib.idtpu_layer_rows.argtypes = [c.c_void_p, c.c_int32]
        lib.idtpu_export.argtypes = [c.c_void_p] + [c.c_void_p] * 3
        lib.idtpu_export_layer.argtypes = [c.c_void_p, c.c_int32, c.c_void_p]
        lib.idtpu_search.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int64, c.c_int, c.c_int, c.c_int,
            c.c_void_p, c.c_void_p]
        lib.idtpu_from_graph.restype = c.c_void_p
        lib.idtpu_from_graph.argtypes = [
            c.c_void_p, c.c_int64, c.c_int64, c.c_int, c.c_int32,
            c.c_void_p, c.c_int32, c.c_void_p, c.c_void_p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    _load()
    return _LIB_ERR


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_LIB_ERR}")
    return lib


def host_array(x, dtype) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a C-contiguous
    host array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32 if dtype == np.float32
                          else torch.int32).numpy()
    return np.ascontiguousarray(x, dtype)


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _cfg_seed(config) -> int:
    from ..config import resolve_seed

    return resolve_seed(config.seed)


class NativeHnsw:
    """Host-side HNSW engine handle."""

    def __init__(self, handle, metric: str):
        self._h = handle
        self.metric = metric
        lib = _lib()
        self.n = int(lib.idtpu_n(handle))
        self.dim = int(lib.idtpu_dim(handle))

    def __del__(self):
        lib = _LIB
        if lib is not None and getattr(self, "_h", None):
            lib.idtpu_free(self._h)
            self._h = None

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, points, config, n_threads: int = 0) -> "NativeHnsw":
        """Build with the reference's construction recipe on the host.
        ``n_threads=0`` uses all cores."""
        lib = _lib()
        pts = host_array(points, np.float32)
        n, dim = pts.shape
        metric = config.metric if isinstance(config.metric, str) else None
        if metric not in _METRICS:
            raise ValueError(
                "native engine supports named metrics only, got "
                f"{config.metric!r}")
        h = lib.idtpu_build(
            _as_c(pts), n, dim, config.m, config.ef_construction,
            ctypes.c_float(config.ml),
            ctypes.c_uint64(_cfg_seed(config)),
            _METRICS[metric],
            0 if config.heuristic is None else 1,
            1 if (config.heuristic and config.heuristic.extend_candidates)
            else 0,
            1 if (config.heuristic and config.heuristic.keep_pruned) else 0,
            n_threads)
        return cls(h, metric)

    @classmethod
    def from_arrays(cls, points, zero, layers, metric: str,
                    m: int) -> "NativeHnsw":
        """An engine over a given graph (``layers[l-1]`` is level l);
        tensors on any device are copied to the host."""
        lib = _lib()
        pts = host_array(points, np.float32)
        zero = host_array(zero, np.int32)
        layers = [host_array(l, np.int32) for l in layers]
        n, dim = pts.shape
        if metric not in _METRICS:
            raise ValueError(f"native engine supports named metrics only, "
                             f"got {metric!r}")
        if zero.shape != (n, 2 * m) or any(
                l.ndim != 2 or l.shape[1] != m for l in layers):
            raise ValueError(
                f"graph arrays do not fit n={n}, m={m}: zero "
                f"{zero.shape}, layers {[l.shape for l in layers]}")
        rows = np.array([l.shape[0] for l in layers], np.int64)
        ptrs = (ctypes.c_void_p * max(1, len(layers)))(
            *[l.ctypes.data_as(ctypes.c_void_p) for l in layers] or [None])
        h = lib.idtpu_from_graph(
            _as_c(pts), n, dim, m, _METRICS[metric], _as_c(zero),
            len(layers), _as_c(rows), ctypes.cast(ptrs, ctypes.c_void_p))
        return cls(h, metric)

    # ------------------------------------------------------------------
    def to_arrays(self, m: int):
        """Export (points, ids, zero, layers) as numpy arrays."""
        lib = _lib()
        pts = np.empty((self.n, self.dim), np.float32)
        ids = np.empty(self.n, np.uint32)
        zero = np.empty((self.n, 2 * m), np.int32)
        lib.idtpu_export(self._h, _as_c(pts), _as_c(ids), _as_c(zero))
        layers = []
        for l in range(int(lib.idtpu_n_layers(self._h))):
            rows = int(lib.idtpu_layer_rows(self._h, l))
            layer = np.empty((rows, m), np.int32)
            lib.idtpu_export_layer(self._h, l, _as_c(layer))
            layers.append(layer)
        return pts, ids.astype(np.int32), zero, layers

    def search_batch(self, queries, ef: int, k: Optional[int] = None,
                     n_threads: int = 0):
        """[B, D] queries (a tensor on any device, or numpy) -> numpy
        (dists [B, k], pids [B, k])."""
        lib = _lib()
        q = host_array(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be [B, {self.dim}], got "
                             f"{q.shape}")
        k = k or ef
        nq = q.shape[0]
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        lib.idtpu_search(self._h, _as_c(q), nq, ef, k, n_threads,
                         _as_c(out_i), _as_c(out_d))
        return out_d, out_i
