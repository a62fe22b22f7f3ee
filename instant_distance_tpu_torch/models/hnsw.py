"""Public index API: ``Hnsw``, ``HnswMap``, ``Search``, ``Neighbor`` (port
of ``instant_distance_tpu/models/hnsw.py``).

Same names, arguments and results as the JAX package, with torch tensors
where it returns jax arrays.  An index lives on the device of the tensors
it was built from (``index.device``); ``load`` takes a ``device``
(default: the CUDA card), and ``add`` puts new points on the index's
device.  ``build(backend="native")`` builds on the host engine
(``native/``) and puts the graph on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..ops.beam import hnsw_search
from ..ops.construct import BuiltGraph, build_graph, extend_graph
from ..ops.distance import resolve, torch_dtype
from ..utils.convert import as_queries, as_tensor, default_device


@dataclasses.dataclass
class Neighbor:
    """One search result (reference py src/lib.rs:327-357)."""

    distance: float
    pid: int
    value: Any = None
    #: Index backing the lazy ``point`` lookup (not part of repr/eq).
    _index: Any = dataclasses.field(default=None, repr=False,
                                    compare=False)

    @property
    def point(self) -> Optional[np.ndarray]:
        """The result's point vector (``index[pid]``), or None."""
        if self._index is None:
            return None
        return self._index[self.pid]

    def __repr__(self) -> str:
        if self.value is None:
            return (f"instant_distance.Item(distance={self.distance}, "
                    f"pid={self.pid})")
        return (f"instant_distance.Neighbor(distance={self.distance}, "
                f"pid={self.pid}, value={self.value!r})")


class Search:
    """Search buffer and result set (reference py src/lib.rs:159-209):
    holds the results of the most recent ``search``; iterate it for
    ``Neighbor``s."""

    def __init__(self) -> None:
        self._dists: Optional[np.ndarray] = None
        self._pids: Optional[np.ndarray] = None
        self._index: Optional["Hnsw"] = None
        self._map: Optional["HnswMap"] = None
        self._cur = 0

    def _arm(self, dists, pids, index=None, map_=None):
        self._dists, self._pids = dists, pids
        self._index, self._map = index, map_
        self._cur = 0

    def __iter__(self) -> "Search":
        self._cur = 0
        return self

    def __next__(self) -> Neighbor:
        while True:
            if self._pids is None or self._cur >= len(self._pids):
                raise StopIteration
            pid = int(self._pids[self._cur])
            dist = float(self._dists[self._cur])
            self._cur += 1
            if pid >= 0:
                break
        value = self._map.values[pid] if self._map is not None else None
        return Neighbor(dist, pid, value,
                        self._map if self._map is not None else self._index)

    def __len__(self) -> int:
        if self._pids is None:
            return 0
        return int((self._pids >= 0).sum())


def as_new_points(x, device, dim: int):
    """Points to append, as a [A, dim] f32 tensor on ``device`` (one
    point becomes a batch of one); ValueError on any other shape."""
    pts = as_tensor(x, device, torch.float32)
    if pts.dim() == 1:
        pts = pts[None]
    if pts.dim() != 2:
        raise ValueError(f"new points must be a [N, D] 2-D array, got "
                         f"shape {tuple(pts.shape)}")
    if pts.shape[0] and pts.shape[1] != dim:
        raise ValueError(f"new points dim {pts.shape[1]} != index dim "
                         f"{dim}")
    return pts


def extended(alive, a: int):
    """A new tombstone mask: ``alive`` (None stays None) and ``a`` alive
    rows after it."""
    if alive is None:
        return None
    return torch.cat([alive, torch.ones(a, dtype=torch.bool,
                                        device=alive.device)])


def tombstoned(alive, n: int, ids, device, what: str):
    """A new [n] bool mask: ``alive`` (None = all alive) with ``ids``
    cleared; IndexError for an id out of range.  Never writes into
    ``alive``, which ``from_index`` children may share."""
    idx = np.atleast_1d(np.asarray(ids, np.int64))
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"{what} out of range")
    out = (torch.ones(n, dtype=torch.bool, device=device) if alive is None
           else alive.clone())
    out[torch.as_tensor(idx, device=device)] = False
    return out


class Hnsw:
    """Immutable HNSW index: ``points`` [N, D], ``zero`` [N, M*2] int32
    adjacency, ``layers`` [end_l, M] upper-layer snapshots
    (layers[l-1] = level l, the reference's layout)."""

    def __init__(self, points, zero, layers, config: Config, alive=None):
        points = as_tensor(points)
        self.device = points.device
        self.points = points.to(torch_dtype(config.dtype))
        self.zero = as_tensor(zero, self.device, torch.int32)
        self.layers = [as_tensor(l, self.device, torch.int32)
                       for l in layers]
        self.config = config
        self.metric = resolve(config.metric)
        #: Tombstone mask, bool [N]; None = nothing deleted.
        self._alive = (None if alive is None
                       else as_tensor(alive, self.device, torch.bool))
        #: Neighbour-distance cache [N+1, m0] kept between adds (the
        #: reverse-edge re-selection reads it).
        self._adjd = None
        #: Reverse-edge additions lost to an explicit rev_rounds cap.
        self.reverse_drops = 0

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, points, config: Optional[Config] = None, *,
              progress=None, backend: str = "wave",
              checkpoint: Optional[str] = None, checkpoint_every: int = 64,
              device=None) -> tuple["Hnsw", np.ndarray]:
        """Build the index; returns (index, ids) where ids maps the
        original point order to PointIds.  Builds on ``points``' device
        when it is a tensor, else on ``device`` (the CUDA card by
        default; without one it raises).  ``backend``: "wave" = the
        card's batched insertion waves; "native" = the multithreaded C++
        host engine on all cores (the same construction recipe), its
        graph then moved to that device.  ``checkpoint``: a
        path where the build saves its wave state every
        ``checkpoint_every`` waves and from which a rerun resumes
        (``ops/construct.build_graph``)."""
        config = config or Config()
        if len(np.shape(points)) != 2:
            raise ValueError(f"points must be a [N, D] 2-D array, got "
                             f"shape {tuple(np.shape(points))}")
        if backend == "native":
            from ..native import NativeHnsw

            dev = (points.device if isinstance(points, torch.Tensor)
                   else default_device(device))
            eng = NativeHnsw.build(points, config)
            pts, ids, zero, layers = eng.to_arrays(config.m)
            return cls(as_tensor(pts, dev), zero, layers, config), ids
        g: BuiltGraph = build_graph(points, config, progress=progress,
                                    device=device, checkpoint=checkpoint,
                                    checkpoint_every=checkpoint_every)
        index = cls(g.points, g.zero, g.layers, config)
        index.reverse_drops = g.reverse_drops
        return index, g.ids

    def add(self, new_points, *, progress=None) -> np.ndarray:
        """Append points (zero-layer wave insertion against the frozen
        upper layers, ``ops/construct.extend_graph``); returns their new
        PointIds.  The points, graph and mask become new tensors, so a
        ``from_index`` child made before the add keeps its snapshot.
        Rebuild once the index has grown by ~2x: the upper layers only
        route."""
        new_pts = as_new_points(new_points, self.device,
                                self.points.shape[1])
        n_old = len(self)
        pts, zero, adjd, drops = extend_graph(
            self.points, self.zero, self.layers, new_pts, self.config,
            adjd=self._adjd, progress=progress)
        self.points = pts.to(torch_dtype(self.config.dtype))
        self.zero, self._adjd = zero, adjd
        self.reverse_drops += drops
        self._alive = extended(self._alive, new_pts.shape[0])
        return np.arange(n_old, n_old + new_pts.shape[0], dtype=np.int32)

    def delete(self, pids) -> None:
        """Tombstone points: excluded from results, still routed through.
        Makes a new mask, as the JAX package does, so an index and the
        ``from_index`` children that share its mask never see each
        other's deletes."""
        self._alive = tombstoned(self._alive, len(self), pids, self.device,
                                 "pid")

    def is_deleted(self, pid: int) -> bool:
        return self._alive is not None and not bool(self._alive[pid])

    @property
    def n_deleted(self) -> int:
        if self._alive is None:
            return 0
        return int((~self._alive).sum())

    # -- queries -----------------------------------------------------------
    def _eligible(self, filter_mask):
        eligible = self._alive
        if filter_mask is not None:
            fm = as_tensor(filter_mask, self.device, torch.bool)
            if tuple(fm.shape) != (len(self),):
                raise ValueError(f"filter_mask must be [N]={len(self)}, "
                                 f"got {tuple(fm.shape)}")
            eligible = fm if eligible is None else (eligible & fm)
        return eligible

    def search_batch(self, queries, k: Optional[int] = None,
                     ef: Optional[int] = None, filter_mask=None):
        """Batched query: [B, D] -> (dists [B, k], pids [B, k]).

        ``filter_mask`` (bool [N], pid order): only mask-true points may
        appear in results; traversal still routes through the rest.
        """
        queries = as_queries(queries, self.device, self.points.shape[1])
        cfg = self.config
        ef = ef or cfg.ef_search
        k = k or ef
        if k > ef:
            raise ValueError(f"k={k} > ef={ef}")
        d, p = hnsw_search(
            queries, self.zero, tuple(reversed(self.layers)), self.points,
            self.metric, ef=ef, m=cfg.m, zero_links=cfg.m0,
            max_iter_factor=cfg.max_iter_factor,
            expand=cfg.search_expand,
            eligible=self._eligible(filter_mask),
            entry_seeds=min(cfg.entry_seeds, len(self)))
        return d[:, :k], p[:, :k]

    def _search_one(self, point):
        d, p = self.search_batch(point)
        return d[0].cpu().numpy(), p[0].cpu().numpy()

    def search(self, point, search: Search) -> Iterator[Neighbor]:
        """Single-query API (py src/lib.rs:146-156): fills and arms the
        ``Search``; returns an iterator over it."""
        if len(self) == 0:
            search._arm(np.zeros(0, np.float32), np.zeros(0, np.int32),
                        index=self)
        else:
            search._arm(*self._search_one(point), index=self)
        return iter(search)

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return int(self.points.shape[0])

    def __getitem__(self, pid: int):
        return self.points[pid].float().cpu().numpy()

    def iter(self):
        pts = self.points.float().cpu().numpy()
        return ((i, pts[i]) for i in range(len(pts)))

    def get(self, i: int, search: Search) -> Optional[Neighbor]:
        if search._pids is None or i >= len(search._pids):
            return None
        pid = int(search._pids[i])
        if pid < 0:
            return None
        return Neighbor(float(search._dists[i]), pid, None, self)

    # -- persistence -------------------------------------------------------
    def dump(self, fname: str, format: str = "native") -> None:
        from ..utils import serialize

        serialize.dump(self, fname, format=format)

    @classmethod
    def load(cls, fname: str, format: str = "auto", device=None,
             **kw) -> "Hnsw":
        """Load a dumped index onto ``device`` (default: the CUDA card).
        Extra kwargs go to the format loader: for headerless bincode of
        another shape, ``dims=``/``m=`` (``utils/serialize.load_bincode``)."""
        from ..utils import serialize

        obj = serialize.load(fname, format=format, device=device, **kw)
        if not isinstance(obj, Hnsw) or isinstance(obj, HnswMap):
            raise ValueError(f"{fname} does not contain a plain Hnsw")
        return obj


class HnswMap(Hnsw):
    """Hnsw with values attached to points; ``values[pid]`` is the value
    of point ``pid`` (reordered at build, lib.rs:141-152)."""

    def __init__(self, points, zero, layers, config, values: Sequence):
        super().__init__(points, zero, layers, config)
        self.values = list(values)

    @classmethod
    def build(cls, points, values, config: Optional[Config] = None, *,
              progress=None, backend: str = "wave",
              checkpoint: Optional[str] = None, device=None) -> "HnswMap":
        if len(points) != len(values):
            raise ValueError("points and values must have the same length")
        config = config or Config()
        hnsw, ids = Hnsw.build(points, config, progress=progress,
                               backend=backend, checkpoint=checkpoint,
                               device=device)
        reordered = [None] * len(values)
        for src, pid in enumerate(ids):
            reordered[pid] = values[src]
        return cls(hnsw.points, hnsw.zero, hnsw.layers, config, reordered)

    def add(self, new_points, values=None, *, progress=None) -> np.ndarray:
        """Append (point, value) pairs; returns the new PointIds (values
        follow in pid order, in a new list)."""
        new_pts = as_new_points(new_points, self.device,
                                self.points.shape[1])
        if values is None or len(values) != new_pts.shape[0]:
            raise ValueError("values must match the number of new points")
        pids = super().add(new_pts, progress=progress)
        self.values = self.values + list(values)
        return pids

    def search(self, point, search: Search) -> Iterator[Neighbor]:
        if len(self) == 0:
            search._arm(np.zeros(0, np.float32), np.zeros(0, np.int32),
                        map_=self)
        else:
            search._arm(*self._search_one(point), map_=self)
        return iter(search)

    def search_batch_values(self, queries, k: Optional[int] = None):
        """Batched query returning (dists, pids, values-nested-list)."""
        d, p = self.search_batch(queries, k)
        vals = [[self.values[pid] if pid >= 0 else None for pid in row]
                for row in p.cpu().tolist()]
        return d, p, vals

    def get(self, i: int, search: Search) -> Optional[Neighbor]:
        item = super().get(i, search)
        if item is not None:
            item.value = self.values[item.pid]
        return item

    @classmethod
    def load(cls, fname: str, format: str = "auto", device=None,
             **kw) -> "HnswMap":
        """Load a dumped map (arguments as :meth:`Hnsw.load`)."""
        from ..utils import serialize

        obj = serialize.load(fname, format=format, device=device, **kw)
        if not isinstance(obj, HnswMap):
            raise ValueError(f"{fname} does not contain an HnswMap")
        return obj
