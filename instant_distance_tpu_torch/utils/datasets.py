"""Benchmark datasets (the port's own copy of
``instant_distance_tpu/utils/datasets.py``): synthetic generators, the
TexMex readers and the BASELINE.md config ladder.

The generators draw from numpy's seeded ``default_rng`` in the same
order as the JAX package's, so both packages get the very same points
from a seed, and ``load_config`` reads the same files under the same
``INSTANT_TPU_DATA`` directory (tests/test_torch_build.py and
tests/test_torch_scan.py check both).  Real datasets are read from disk
when present; otherwise synthetic stand-ins of the same shape are
generated, since nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def read_fvecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """TexMex .fvecs: each row = int32 dim + dim float32s."""
    data = np.fromfile(path, np.int32)
    dim = int(data[0])
    rows = data.reshape(-1, dim + 1)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 1:].view(np.float32).copy()


def read_ivecs(path: str, max_rows: Optional[int] = None) -> np.ndarray:
    """TexMex .ivecs: each row = int32 dim + dim int32s."""
    data = np.fromfile(path, np.int32)
    dim = int(data[0])
    rows = data.reshape(-1, dim + 1)
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows[:, 1:].copy()


def synthetic_clustered(n: int, dim: int, n_clusters: int = 1000,
                        seed: int = 0, scale: float = 0.15) -> np.ndarray:
    """Clustered Gaussian data [n, dim] f32: ``n_clusters`` standard
    normal centres, each point a centre plus ``scale`` * N(0, 1) noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    pts = centers[assign] + scale * rng.standard_normal(
        (n, dim)).astype(np.float32)
    return pts.astype(np.float32)


def synthetic_uniform(n: int, dim: int, seed: int = 0) -> np.ndarray:
    """Uniform [0, 1) data [n, dim] f32."""
    rng = np.random.default_rng(seed)
    return rng.random((n, dim), dtype=np.float32)


#: BASELINE.md config ladder (shape only; data substituted when absent).
CONFIGS = {
    "rgb": dict(dim=3, n=256),
    "fasttext": dict(dim=300, n=100_000),
    "sift1m": dict(dim=128, n=1_000_000),
    "gist1m": dict(dim=960, n=1_000_000),
    "deep10m": dict(dim=96, n=10_000_000),
}


def load_config(name: str, n: Optional[int] = None, seed: int = 0,
                data_dir: Optional[str] = None):
    """Return (points, queries) for a ladder config, preferring real data
    under ``data_dir`` (else ``$INSTANT_TPU_DATA``; e.g.
    sift/sift_base.fvecs and sift/sift_query.fvecs).  Synthetic data is
    ``n`` points plus 10,000 queries, clustered."""
    spec = CONFIGS[name]
    n = n or spec["n"]
    dim = spec["dim"]
    data_dir = data_dir or os.environ.get("INSTANT_TPU_DATA", "")
    base = {"sift1m": "sift/sift_base.fvecs",
            "gist1m": "gist/gist_base.fvecs"}.get(name)
    if base and data_dir and os.path.exists(os.path.join(data_dir, base)):
        pts = read_fvecs(os.path.join(data_dir, base), max_rows=n)
        qpath = os.path.join(data_dir, base.replace("base", "query"))
        queries = (read_fvecs(qpath) if os.path.exists(qpath)
                   else pts[:10_000])
        return pts, queries
    pts = synthetic_clustered(n + 10_000, dim,
                              n_clusters=max(100, n // 1000), seed=seed)
    return pts[:n], pts[n:]
