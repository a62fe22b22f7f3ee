"""Mesh-sharded quantized scan (port of
``instant_distance_tpu/parallel/scan.py``).

The points are split into ``mesh.size`` contiguous shards of ``n_s``
rows (the last zero-padded, its padding never eligible); every shard
scores the whole query batch against its own rows, reranks its
candidates exactly, and the shards' [B, ef] results merge with
:func:`~instant_distance_tpu_torch.parallel.mesh.gather_merge`.  Ids are
the input order: global id = shard * n_s + local id.

``fused=True`` scans each shard with the bucket kernel K2
(``models/scan._fused_search``, ``fused="bucket"`` of ``ScanIndex``) for
every named metric; the default is the streamed scan
(``models/scan.scan_candidates``).
"""

from __future__ import annotations

import json
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..models.hnsw import tombstoned
from ..models.scan import _fused_search, _scan_search
from ..ops.packed import quantize_points
from ..ops.scan_kernel import bucket_operands
from ..utils.convert import as_queries, as_tensor
from .mesh import Mesh, default_mesh, gather_merge

_MAGIC = "instant-distance-tpu/sharded-scan-v1"


class ShardedScanIndex:
    """Point-sharded int8-scan index over a device mesh.

    Per local shard j (on ``mesh.devices[j]``): ``points[j]`` [n_s, D]
    f32 and their per-point int8 ``codes[j]``, ``scales[j]`` and
    dequantized squared ``norms[j]``.
    """

    def __init__(self, points, metric: str = "sqeuclidean",
                 mesh: Optional[Mesh] = None, chunk: int = 1 << 17,
                 values: Optional[Sequence[Any]] = None):
        if not isinstance(metric, str):
            raise ValueError("ShardedScanIndex needs a matmul-form "
                             "metric name")
        self.mesh = mesh or default_mesh()
        self.metric_name = metric
        s = self.mesh.size
        pts = (points.detach() if isinstance(points, torch.Tensor)
               else torch.from_numpy(np.asarray(points, np.float32)))
        n, dim = pts.shape
        self.n = n
        n_s = max(1, -(-n // s))
        self.n_s = n_s
        self.chunk = int(min(chunk, n_s))
        self.points, self.codes, self.scales, self.norms = [], [], [], []
        for g, dev in zip(self.mesh.shard_ids(), self.mesh.devices):
            rows = pts[g * n_s:(g + 1) * n_s].to(dev, torch.float32)
            p = torch.zeros((n_s, dim), dtype=torch.float32, device=dev)
            p[:rows.shape[0]] = rows
            codes, scales = quantize_points(p)
            deq = codes.float() * scales[:, None]
            self.points.append(p)
            self.codes.append(codes)
            self.scales.append(scales)
            self.norms.append((deq * deq).sum(1))
        self.values = None if values is None else list(values)
        #: Tombstone mask over ids, bool [n] on ``mesh.first``.
        self._alive = None
        self.config = Config(metric=metric)
        self._fused = {}

    @classmethod
    def build(cls, points, config: Optional[Config] = None,
              mesh: Optional[Mesh] = None, values=None,
              **kw) -> "ShardedScanIndex":
        metric = config.metric if config is not None else "sqeuclidean"
        return cls(points, metric=metric, mesh=mesh, values=values, **kw)

    def __len__(self) -> int:
        return self.n

    def delete(self, ids) -> None:
        self._alive = tombstoned(self._alive, self.n, ids, self.mesh.first,
                                 "id")

    def _eligible(self, filter_mask):
        """Eligibility [n] on ``mesh.first``, or None for all."""
        eligible = self._alive
        if filter_mask is not None:
            fm = as_tensor(filter_mask, self.mesh.first, torch.bool)
            if tuple(fm.shape) != (self.n,):
                raise ValueError(f"filter_mask must be [N]={self.n}, got "
                                 f"{tuple(fm.shape)}")
            eligible = fm if eligible is None else (eligible & fm)
        return eligible

    def _shard_eligible(self, g: int, dev, eligible):
        """Shard ``g``'s rows that are points (the tail padding is not)
        and eligible."""
        base = g * self.n_s
        el = (base + torch.arange(self.n_s, device=dev)) < self.n
        if eligible is not None:
            part = eligible[base:base + self.n_s].to(dev)
            el = el & torch.nn.functional.pad(part,
                                              (0, self.n_s - part.shape[0]))
        return el

    def _fused_shard_arrays(self, j: int, cb: int, variant: str):
        """Shard j's K2 operands (``bucket_operands``: l2, dot or
        cosine), padded to a multiple of ``cb``, cached."""
        key = (j, cb, variant)
        if key not in self._fused:
            self._fused[key] = bucket_operands(
                self.codes[j], self.scales[j], self.norms[j], cb, variant)
        return self._fused[key]

    def search_batch(self, queries, k: int = 10, ef: Optional[int] = None,
                     filter_mask=None, fused: bool = False,
                     qb: int = 0, cb: int = 4096, lsub: int = 32):
        """[B, D] -> (exact dists [B, k], original ids [B, k]) on
        ``mesh.first``.

        ``fused=True`` runs each shard's scan through the bucket kernel
        K2 instead of the streamed scan, for any named metric; ``qb``
        (the TPU kernel's query block) is accepted and changes nothing.
        """
        queries = as_queries(queries, self.mesh.first,
                             self.points[0].shape[1])
        ef = ef or max(4 * k, 32)
        ef = int(min(ef, self.n_s))
        k = int(min(k, ef))
        eligible = self._eligible(filter_mask)
        metric_name = ("sqeuclidean" if self.metric_name == "euclidean"
                       else self.metric_name)
        fused = bool(fused) and metric_name in ("sqeuclidean", "dot",
                                                "cosine")
        if fused:
            cb = int(min(cb, -(-self.n_s // lsub) * lsub))
            variant = "l2" if metric_name == "sqeuclidean" else metric_name
        ds, gs = [], []
        for j, (g, dev) in enumerate(zip(self.mesh.shard_ids(),
                                         self.mesh.devices)):
            el = self._shard_eligible(g, dev, eligible)
            q = queries.to(dev)
            if fused:
                ct, sr, nr = self._fused_shard_arrays(j, cb, variant)
                sd, si = _fused_search(
                    q, ct, sr, nr, self.points[j], el,
                    metric_name=metric_name, ef=ef, k=ef, lsub=lsub,
                    topt=0, cb=cb, rerank=True, mode="bucket")
            else:
                sd, si = _scan_search(
                    q, self.codes[j], self.scales[j], self.norms[j],
                    self.points[j], el, metric_name=metric_name, ef=ef,
                    k=ef, chunk=self.chunk, rerank=True)
            gi = torch.where(si >= 0, g * self.n_s + si, -1)
            ds.append(torch.where(gi >= 0, sd, torch.inf))
            gs.append(gi)
        d, i = gather_merge(self.mesh, ds, gs, k)
        if self.metric_name == "euclidean":
            d = torch.sqrt(torch.clamp(d, min=0.0))
        return d, i

    def search_batch_values(self, queries, k: int = 10,
                            ef: Optional[int] = None, filter_mask=None):
        if self.values is None:
            raise ValueError("this index carries no values")
        d, i = self.search_batch(queries, k, ef, filter_mask=filter_mask)
        vals = [[self.values[j] if j >= 0 else None for j in row]
                for row in i.cpu().tolist()]
        return d, i, vals

    # ------------------------------------------------------------------
    def dump(self, fname: str) -> None:
        """Persist the scan index (points, metric, values, tombstones) to
        one npz, the JAX package's ``sharded-scan-v1`` file; quantization
        is recomputed on load.  A rank of a distributed mesh holds only
        its shards, so only a one-process mesh dumps."""
        if self.mesh.world > 1:
            raise ValueError("dump needs every shard in this process")
        pts = torch.cat([p.cpu() for p in self.points])[:self.n].numpy()
        arrays = {
            "magic": np.array(_MAGIC),
            "metric": np.array(self.metric_name),
            "chunk": np.array(self.chunk, np.int64),
            "points": pts,
        }
        if self.values is not None:
            arrays["values"] = np.array(json.dumps(list(self.values)))
        if self._alive is not None:
            arrays["alive"] = self._alive.cpu().numpy()
        with open(fname, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, fname: str,
             mesh: Optional[Mesh] = None) -> "ShardedScanIndex":
        """Load a ``dump`` onto ``mesh`` (default: every CUDA card; the
        scan shards by even partition, so any mesh size works)."""
        with np.load(fname, allow_pickle=False) as z:
            if str(z["magic"]) != _MAGIC:
                raise ValueError(f"{fname}: not a sharded scan index")
            values = (json.loads(str(z["values"]))
                      if "values" in z.files else None)
            idx = cls(z["points"], metric=str(z["metric"]), mesh=mesh,
                      chunk=int(z["chunk"]), values=values)
            if "alive" in z.files:
                idx._alive = as_tensor(z["alive"], idx.mesh.first,
                                       torch.bool)
        return idx
