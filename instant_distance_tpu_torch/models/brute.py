"""Exact (brute-force) nearest-neighbour search (port of
``instant_distance_tpu/models/brute.py``): ground truth for the tests
and for ``chip_smoke.py``.

One pairwise-distance matmul per ``chunk`` points, a per-chunk top-k and
a (distance, id) merge.  Every chunk's top-k is capped at the chunk's
width, so a last chunk narrower than k is fine (the JAX package's
streamed path fails there, ROADMAP.md §3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import resolve
from ..ops.sort import sort2
from ..utils.convert import as_queries, as_tensor

_I32MAX = np.iinfo(np.int32).max


class BruteForce:
    """Exact k-NN index over a fixed point set, on ``points``' device
    (numpy input: ``device``, the CUDA card by default)."""

    def __init__(self, points, metric="sqeuclidean", chunk: int = 16384,
                 device=None):
        self.points = as_tensor(points, device, torch.float32)
        self.device = self.points.device
        self.metric = resolve(metric)
        self.chunk = int(min(chunk, max(1, self.points.shape[0])))

    def search_batch(self, queries, k: int):
        """Exact top-k for a [B, D] query batch -> (dists [B,k], ids [B,k])."""
        queries = as_queries(queries, self.device, self.points.shape[1])
        n = self.points.shape[0]
        b = queries.shape[0]
        k = int(min(k, n))
        best_d = torch.full((b, k), torch.inf, device=self.device)
        best_i = torch.full((b, k), _I32MAX, dtype=torch.int32,
                            device=self.device)
        for s in range(0, n, self.chunk):
            block = self.points[s:s + self.chunk]
            d = self.metric.pairwise(queries, block)            # [B, C]
            nd, nidx = torch.topk(d, min(k, d.shape[1]), dim=1,
                                  largest=False)
            cat_d = torch.cat([best_d, nd], dim=1)
            cat_i = torch.cat([best_i, (nidx + s).to(torch.int32)], dim=1)
            sd, si = sort2(cat_d, cat_i)
            best_d, best_i = sd[:, :k], si[:, :k]
        best_i = torch.where(torch.isfinite(best_d), best_i, -1)
        return best_d, best_i
