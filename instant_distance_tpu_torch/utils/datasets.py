"""Synthetic datasets (the port's own copy of the generators in
``instant_distance_tpu/utils/datasets.py``).

The generators draw from numpy's seeded ``default_rng`` in the same
order as the JAX package's, so both packages get the very same points
from a seed (tests/test_torch_build.py checks it).
"""

from __future__ import annotations

import numpy as np


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
