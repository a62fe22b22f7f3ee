"""Query-data-parallel serving: a replicated index, batch-sharded queries
(port of ``instant_distance_tpu/parallel/replicated.py``).

The complement of ``ShardedHnsw``: when a whole index fits on one card,
each device of the mesh holds a copy and answers its slice of the query
batch, with no traffic between devices but the results.  The batch is
padded to a multiple of ``mesh.size`` (with copies of its first query),
split into equal slices in mesh order, and the padding cut off again;
across ranks the slices' results are gathered with ``all_gather``, so
every rank returns the whole batch's.  Results are tensors on
``mesh.first`` (the JAX package returns numpy after padding a batch; the
port does not copy that).

Each slice runs the single-device index's own ``search_batch`` on that
device's copy, so a replicated search equals the single index's.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..config import Config
from ..utils.convert import as_queries, as_tensor
from .mesh import Mesh, all_gather_rows, default_mesh


def _replicas(obj, mesh: Mesh, move):
    """``move(obj, dev)`` for each distinct device of the mesh: a copy
    without tombstones (the wrapper keeps its own snapshot), sharing
    ``obj``'s tensors on ``obj``'s own device."""
    return {dev: move(obj, dev) for dev in dict.fromkeys(mesh.devices)}


def _data_parallel(mesh: Mesh, queries, fn):
    """``fn(dev, slice)`` on each device's slice of the padded batch;
    returns the results of the whole batch on ``mesh.first``."""
    b0 = queries.shape[0]
    pad = (-b0) % mesh.size
    if pad:
        queries = torch.cat([queries, queries[:1].expand(pad, -1)])
    per = queries.shape[0] // mesh.size
    ds, ps = [], []
    for g, dev in zip(mesh.shard_ids(), mesh.devices):
        d, p = fn(dev, queries[g * per:(g + 1) * per].to(dev))
        ds.append(d.to(mesh.first))
        ps.append(p.to(mesh.first))
    d = all_gather_rows(mesh, torch.cat(ds))
    p = all_gather_rows(mesh, torch.cat(ps))
    return d[:b0], p[:b0]


class _Replicated:
    """Filters, tombstones and values, shared by the three forms."""

    def __len__(self) -> int:
        return int(self.points.shape[0])

    def _eligible(self, filter_mask):
        eligible = self._alive
        if filter_mask is not None:
            fm = as_tensor(filter_mask, self.mesh.first, torch.bool)
            if tuple(fm.shape) != (len(self),):
                raise ValueError(f"filter_mask must be [N]={len(self)}, "
                                 f"got {tuple(fm.shape)}")
            eligible = fm if eligible is None else (eligible & fm)
        return eligible

    def _queries(self, queries):
        return as_queries(queries, self.mesh.first, self.points.shape[1])

    def search_batch_values(self, queries, k: Optional[int] = None,
                            ef: Optional[int] = None, filter_mask=None):
        """Batched query returning (dists, pids, values nested list)."""
        if self.values is None:
            raise ValueError("this index carries no values")
        d, p = self.search_batch(queries, k, ef, filter_mask=filter_mask)
        vals = [[self.values[pid] if pid >= 0 else None for pid in row]
                for row in p.cpu().tolist()]
        return d, p, vals


def _hnsw_copy(index, dev):
    from ..models.hnsw import Hnsw

    return Hnsw(index.points.to(dev), index.zero.to(dev),
                [l.to(dev) for l in index.layers], index.config)


class ReplicatedHnsw(_Replicated):
    """A single-graph index served data-parallel over a mesh."""

    def __init__(self, index, mesh: Optional[Mesh] = None):
        self.mesh = mesh or default_mesh()
        self.config: Config = index.config
        self._copies = _replicas(index, self.mesh, _hnsw_copy)
        self.points = self._copies[self.mesh.first].points
        #: values[pid] (when built from an HnswMap) and tombstones are
        #: snapshotted at construction time.
        self.values = (list(index.values) if hasattr(index, "values")
                       else None)
        self._alive = (None if index._alive is None
                       else index._alive.to(self.mesh.first))

    @classmethod
    def build(cls, points, config: Optional[Config] = None,
              mesh: Optional[Mesh] = None, **kw) -> "ReplicatedHnsw":
        from ..models.hnsw import Hnsw

        index, _ = Hnsw.build(points, config, **kw)
        return cls(index, mesh)

    def search_batch(self, queries, k: Optional[int] = None,
                     ef: Optional[int] = None, filter_mask=None):
        """Batched query with the batch split over the mesh (any batch
        size).  ``filter_mask`` (bool [N], pid order) restricts results
        without affecting traversal; ``k`` defaults to ``ef``."""
        queries = self._queries(queries)
        ef = ef or self.config.ef_search
        k = k or ef
        eligible = self._eligible(filter_mask)

        def run(dev, q):
            el = None if eligible is None else eligible.to(dev)
            return self._copies[dev].search_batch(q, k=ef, ef=ef,
                                                  filter_mask=el)

        d, p = _data_parallel(self.mesh, queries, run)
        return d[:, :k], p[:, :k]


def _packed_copy(packed, dev):
    from ..models.packed import PackedHnsw

    return PackedHnsw(packed.points.to(dev),
                      tuple(t.to(dev) for t in packed.zero_pack),
                      tuple(tuple(t.to(dev) for t in u)
                            for u in packed.upper_packs), packed.config)


class ReplicatedPackedHnsw(_Replicated):
    """Query-DP serving over a packed (inline-int8) index: packed
    traversal on each device's copy (plain ops, the JAX package's
    ``packed_search``), batch split, no traffic but the results."""

    def __init__(self, packed, mesh: Optional[Mesh] = None):
        self.mesh = mesh or default_mesh()
        self.config = packed.config
        self._copies = _replicas(packed, self.mesh, _packed_copy)
        self.points = self._copies[self.mesh.first].points
        self.values = (None if getattr(packed, "values", None) is None
                       else list(packed.values))
        alive = getattr(packed, "_alive", None)
        self._alive = None if alive is None else alive.to(self.mesh.first)

    def search_batch(self, queries, k: Optional[int] = None,
                     ef: Optional[int] = None, filter_mask=None):
        """Batched packed query, the batch split over the mesh; ``k``
        defaults to min(10, ef).  The descent runs from the entry point
        (no seed scan), as in the JAX package."""
        queries = self._queries(queries)
        ef = ef or self.config.ef_search
        k = min(k or min(10, ef), ef)
        eligible = self._eligible(filter_mask)

        def run(dev, q):
            el = None if eligible is None else eligible.to(dev)
            return self._copies[dev].search_batch(q, k=k, ef=ef,
                                                  filter_mask=el,
                                                  entry_seeds=0)

        return _data_parallel(self.mesh, queries, run)


def _scan_copy(scan, dev):
    out = copy.copy(scan)
    out.device = dev
    for name in ("points", "codes", "scales", "norms"):
        setattr(out, name, getattr(scan, name).to(dev))
    out._alive = None
    out._fused, out._fused_int = {}, {}
    return out


class ReplicatedScanIndex(_Replicated):
    """Query-DP serving over the quantized exhaustive scan: each device's
    copy answers its slice of the batch (the streamed scan, or with
    ``fused=True`` the bucket kernel K2 for every named metric).
    Complements ShardedScanIndex, which shards the points instead."""

    def __init__(self, scan, mesh: Optional[Mesh] = None):
        self.mesh = mesh or default_mesh()
        self.config = scan.config
        self.metric_name = scan.metric_name
        self.chunk = scan.chunk
        self._copies = _replicas(scan, self.mesh, _scan_copy)
        self.points = self._copies[self.mesh.first].points
        self.values = None if scan.values is None else list(scan.values)
        self._alive = (None if scan._alive is None
                       else scan._alive.to(self.mesh.first))

    def search_batch(self, queries, k: int = 10, ef: Optional[int] = None,
                     filter_mask=None, fused=False, qb: int = 0,
                     cb: int = 4096, lsub: int = 32,
                     approx_topk: bool = True):
        """[B, D] -> (dists [B, k], ids [B, k]), B split over the mesh.
        ``fused=True`` scans with K2 (``ScanIndex`` ``fused="bucket"``)
        when the index holds at least ``cb`` points.  ``qb`` and
        ``approx_topk`` (TPU knobs) are accepted and change nothing: the
        selection is exact."""
        queries = self._queries(queries)
        n = len(self)
        ef = int(min(ef or max(4 * k, 32), n))
        k = int(min(k, ef))
        eligible = self._eligible(filter_mask)
        kw = dict(k=k, ef=ef)
        if fused and n >= cb:
            kw.update(fused="bucket", cb=cb, lsub=lsub)

        def run(dev, q):
            el = None if eligible is None else eligible.to(dev)
            return self._copies[dev].search_batch(q, filter_mask=el, **kw)

        return _data_parallel(self.mesh, queries, run)
