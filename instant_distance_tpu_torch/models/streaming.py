"""StreamingHnsw: chunked ingestion over a compiled serving form (port of
``instant_distance_tpu/models/streaming.py``).

The graph indices serve fastest from their compiled forms (PackedHnsw's
inline-quantized rows, ScanIndex's int8 layout), but those forms are
snapshots: recompiling them on every add would make streaming ingestion
O(N) a chunk.  So:

  - ``add()`` inserts the chunk into the owned graph (zero-layer wave
    insertion, ``ops/construct.extend_graph``) and tracks the rows newer
    than the serving snapshot as a PENDING SLAB;
  - ``search_batch()`` = the compiled form's search over the snapshot,
    merged with an exact scan of the pending slab (one pairwise distance
    product and a top-k, plain torch ops);
  - ``compact()`` recompiles the serving form from the full graph and
    empties the slab; ``add()`` runs it once the slab reaches
    ``repack_every`` rows.

The slab is scanned exactly, so a just-added point is found at once
(read-your-writes).  The JAX package pads the slab to power-of-two
sizes to bound its compiled programs; torch compiles nothing, so the
port scans the slab as it is (the results are the same, padding being
ineligible).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..ops.distance import resolve
from ..ops.sort import sort2
from ..utils.convert import as_queries, as_tensor
from .hnsw import Hnsw, HnswMap
from .packed import PackedHnsw
from .scan import ScanIndex

_I32MAX = np.iinfo(np.int32).max


def slab_search(queries, slab, eligible, metric, k: int):
    """Exact top-k over the pending slab: (dists [B, min(k, P)], slab
    rows [B, min(k, P)] int32, -1 where no eligible row is left).

    ``eligible`` (bool [P] or None) is False for tombstoned and filtered
    rows."""
    d = resolve(metric).pairwise(queries, slab)            # [B, P]
    if eligible is not None:
        d = torch.where(eligible[None, :], d, torch.inf)
    nd, ni = torch.topk(d, min(k, slab.shape[0]), dim=1, largest=False)
    ni = torch.where(torch.isfinite(nd), ni.to(torch.int32), -1)
    return nd, ni


def merge_slab(sd, si, pd, pi, snap_n: int, k: int):
    """The snapshot's (dist, pid) rows merged with the slab's (slab rows
    offset by ``snap_n``) in (dist, pid) order, as the JAX package's
    two-key sort; missing ids sort last as INT32_MAX and come back -1.
    Rows shorter than ``k`` are padded with (inf, -1)."""
    pi = torch.where(pi >= 0, pi + snap_n, _I32MAX).to(torch.int32)
    si = torch.where(si >= 0, si, _I32MAX).to(torch.int32)
    cd = torch.cat([sd.float(), pd.float()], dim=1)
    ci = torch.cat([si, pi], dim=1)
    if cd.shape[1] < k:
        pad = k - cd.shape[1]
        cd = torch.nn.functional.pad(cd, (0, pad), value=torch.inf)
        ci = torch.nn.functional.pad(ci, (0, pad), value=_I32MAX)
    md, mi = sort2(cd, ci)
    mi = torch.where(torch.isfinite(md), mi, -1)
    return md[:, :k], mi[:, :k]


class StreamingHnsw:
    """A graph index plus compiled serving form with chunked add().

    ``serving`` picks the compiled form: "packed" (PackedHnsw, a graph
    walk) or "scan" (ScanIndex, the int8 exhaustive scan).  Searches
    return the owned graph's pids, so ids are stable across compactions.
    """

    def __init__(self, graph, serving: str = "packed",
                 repack_every: int = 0, **serve_kw):
        if serving not in ("packed", "scan"):
            raise ValueError("serving must be 'packed' or 'scan'")
        self.graph = graph
        self.serving_mode = serving
        self.serve_kw = serve_kw
        self.repack_every = int(repack_every)
        self._compile()

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, points, values=None, config: Optional[Config] = None,
              serving: str = "packed", repack_every: int = 0,
              **build_kw) -> "StreamingHnsw":
        """Build the graph (``build_kw`` go to ``Hnsw.build``/
        ``HnswMap.build``, ``device=`` among them) and compile it."""
        if values is None:
            graph, _ = Hnsw.build(points, config, **build_kw)
        else:
            graph = HnswMap.build(points, values, config, **build_kw)
        return cls(graph, serving=serving, repack_every=repack_every)

    # -- sizes -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.graph)

    @property
    def n_pending(self) -> int:
        return len(self.graph) - self._snap_n

    @property
    def values(self):
        return getattr(self.graph, "values", None)

    def _auto_repack(self) -> int:
        if self.repack_every > 0:
            return self.repack_every
        # default: recompile once the slab reaches 1/8 of the snapshot
        return max(1024, self._snap_n // 8)

    # -- ingestion -----------------------------------------------------------
    def add(self, new_points, values=None) -> np.ndarray:
        """Insert a chunk: graph wave insertion and pending-slab tracking;
        compacts once the slab reaches the re-pack threshold.  Returns
        the new PointIds."""
        if values is not None:
            pids = self.graph.add(new_points, values=values)
        else:
            pids = self.graph.add(new_points)
        if self.n_pending >= self._auto_repack():
            self.compact()
        return pids

    def delete(self, pids) -> None:
        self.graph.delete(pids)  # one source of truth: graph._alive

    def compact(self) -> None:
        """Recompile the serving form from the full graph; empties the
        pending slab.  O(N), amortized across repack_every adds."""
        self._compile()

    def _compile(self) -> None:
        if self.serving_mode == "packed":
            self.serve = PackedHnsw.from_index(self.graph, **self.serve_kw)
        else:
            self.serve = ScanIndex.from_index(self.graph, **self.serve_kw)
        self._snap_n = len(self.graph)

    # -- search ----------------------------------------------------------
    def _graph_eligible(self, filter_mask):
        alive = self.graph._alive
        if filter_mask is None:
            return alive
        fm = as_tensor(filter_mask, self.graph.device, torch.bool)
        if tuple(fm.shape) != (len(self.graph),):
            raise ValueError(
                f"filter_mask must be [N]={len(self.graph)}, "
                f"got {tuple(fm.shape)}")
        return fm if alive is None else (fm & alive)

    def search_batch(self, queries, k: int = 10,
                     ef: Optional[int] = None, filter_mask=None, **kw):
        """[B, D] -> (dists [B, k], pids [B, k]): the compiled form's
        search over the snapshot merged with an exact scan of the
        pending slab.  Extra kwargs pass through to the serving form
        (``fused=`` for scan, ``entry_seeds=`` for packed)."""
        queries = as_queries(queries, self.graph.device,
                             self.graph.points.shape[1])
        eligible = self._graph_eligible(filter_mask)
        sn, n = self._snap_n, len(self.graph)
        snap_mask = None if eligible is None else eligible[:sn]
        sd, si = self.serve.search_batch(
            queries, k=k, ef=ef, filter_mask=snap_mask, **kw)
        if n == sn:
            return sd, si
        pd, pi = slab_search(
            queries, self.graph.points[sn:n],
            None if eligible is None else eligible[sn:n],
            self.graph.config.metric, k)
        return merge_slab(sd, si, pd, pi, sn, k)

    # -- persistence -------------------------------------------------------
    def dump(self, fname: str) -> None:
        """Persist the owned graph (native npz).  The serving form is
        compiled again from the graph on load."""
        self.graph.dump(fname)

    @classmethod
    def load(cls, fname: str, serving: str = "packed",
             repack_every: int = 0, device=None,
             **serve_kw) -> "StreamingHnsw":
        """Load a dumped graph onto ``device`` (default: the CUDA card)
        and compile its serving form."""
        from ..utils import serialize

        graph = serialize.load(fname, device=device)
        return cls(graph, serving=serving, repack_every=repack_every,
                   **serve_kw)

    def search_batch_values(self, queries, k: int = 10,
                            ef: Optional[int] = None, filter_mask=None,
                            **kw):
        vals = self.values
        if vals is None:
            raise ValueError("this index carries no values")
        d, p = self.search_batch(queries, k, ef,
                                 filter_mask=filter_mask, **kw)
        out = [[vals[pid] if pid >= 0 else None for pid in row]
               for row in p.cpu().tolist()]
        return d, p, out
