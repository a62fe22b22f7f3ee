"""Sequential host-side HNSW: the semantic oracle of the batched engine
(the port's own copy of ``instant_distance_tpu/utils/refimpl.py``).

A compact numpy re-statement of the reference's construction and search
semantics (Malkov & Yashunin Algs. 1-4 as implemented in
instant-distance/src/lib.rs:209-778).  It exists to:

* cross-validate the batched beam search (``ops/beam.hnsw_search``) on
  identical graphs,
* cross-validate wave-based construction recall against sequential
  insertion (the reference's model).

It is an oracle for tests, not a serving path: it runs on the host and
takes no device.  The same config and seed give the same ``ids``,
``points``, ``zero`` and ``layers`` as the JAX package's ``RefHnsw``,
bit for bit; a callable metric is called on CPU float32 tensors, where
the JAX package calls it on ``jnp`` arrays.

This is NOT a port of the Rust code: it is a from-scratch implementation of
the same published algorithm, structured around dense numpy adjacency rows
(the same arrays the batched engine uses) instead of ZeroNode/UpperNode
types.
"""

from __future__ import annotations

import heapq
from bisect import insort, bisect_left
from typing import Callable, Optional

import numpy as np

import torch

from ..config import Config, Heuristic, layer_sizes, resolve_seed


def _np_metric(name_or_fn) -> Callable:
    if callable(name_or_fn):
        # a torch callable (as the builds take), on CPU f32 tensors
        return lambda a, b: float(name_or_fn(torch.from_numpy(a),
                                             torch.from_numpy(b)))
    if name_or_fn == "sqeuclidean":
        return lambda a, b: float(np.dot(a - b, a - b))
    if name_or_fn == "euclidean":
        return lambda a, b: float(np.sqrt(np.dot(a - b, a - b)))
    if name_or_fn == "dot":
        return lambda a, b: -float(np.dot(a, b))
    if name_or_fn == "cosine":
        def cos(a, b):
            na = np.linalg.norm(a) or 1e-30
            nb = np.linalg.norm(b) or 1e-30
            return 1.0 - float(np.dot(a, b)) / (na * nb)
        return cos
    raise ValueError(f"unknown metric {name_or_fn!r}")


class _Search:
    """Single-query Alg. 2 state (paper's v / C / W sets)."""

    def __init__(self):
        self.visited: set[int] = set()
        self.candidates: list[tuple[float, int]] = []  # min-heap
        self.nearest: list[tuple[float, int]] = []     # sorted ascending
        self.ef = 1

    def reset(self):
        self.visited.clear()
        self.candidates.clear()
        self.nearest.clear()

    def push(self, pid: int, q, points, metric):
        if pid in self.visited:
            return
        self.visited.add(pid)
        d = metric(q, points[pid])
        entry = (d, pid)
        idx = bisect_left(self.nearest, entry)
        if idx >= self.ef:
            return
        self.nearest.insert(idx, entry)
        heapq.heappush(self.candidates, entry)

    def search(self, q, adj, points, metric, links: int):
        """Best-first expansion until the nearest candidate is too far."""
        while self.candidates:
            d, pid = heapq.heappop(self.candidates)
            if self.nearest and d > self.nearest[-1][0]:
                break
            for nb in adj[pid][:links]:
                if nb < 0:
                    break  # INVALID terminates the row (types.rs:178-191)
                self.push(int(nb), q, points, metric)
            del self.nearest[self.ef:]

    def cull(self):
        """Carry results down a layer as entry points (lib.rs:729-737)."""
        self.candidates = list(self.nearest)
        heapq.heapify(self.candidates)
        self.visited = {pid for _, pid in self.nearest}


def _select_heuristic(q_point, cand: list[tuple[float, int]], adj, points,
                      metric, params: Heuristic, m0: int,
                      visited: Optional[set] = None):
    """Paper Alg. 4: bridge-preserving neighbor selection (lib.rs:636-698).

    ``cand`` must be sorted ascending by (distance, pid).  Keeps a candidate
    only if it is closer to the query than to every already-kept result;
    optionally backfills pruned candidates (keep_pruned).
    """
    working = list(cand)
    if params.extend_candidates:
        seen = visited if visited is not None else {p for _, p in cand}
        extra = []
        for _, pid in cand:
            for hop in adj[pid]:
                if hop < 0:
                    break
                hop = int(hop)
                if hop in seen:
                    continue
                seen.add(hop)
                extra.append((metric(q_point, points[hop]), hop))
        working = sorted(working + extra)

    kept: list[tuple[float, int]] = []
    discarded: list[tuple[float, int]] = []
    for d, pid in working:
        if len(kept) >= m0:
            break
        p = points[pid]
        nearest = not any(metric(p, points[r]) < d for _, r in kept)
        (kept if nearest else discarded).append((d, pid))

    if params.keep_pruned:
        for c in discarded:
            if len(kept) >= m0:
                break
            kept.append(c)
    return kept


class RefHnsw:
    """Sequential HNSW with the reference's exact construction recipe."""

    def __init__(self, points, config: Config, progress=None):
        self.config = config
        self.metric = _np_metric(config.metric)
        points = np.asarray(points, np.float32)
        n = len(points)
        m, m0 = config.m, config.m0

        if n == 0:
            self.points = points
            self.zero = np.full((0, m0), -1, np.int32)
            self.layers = []
            self.ids = np.zeros(0, np.int32)
            return

        # --- random layer assignment via shuffle-sort (lib.rs:256-270) ----
        rng = np.random.default_rng(resolve_seed(config.seed))
        keys = rng.integers(0, n, size=n)
        order = np.lexsort((np.arange(n), keys))  # sort by (key, index)
        ids = np.empty(n, np.int32)
        ids[order] = np.arange(n, dtype=np.int32)
        self.ids = ids                       # original index -> pid
        self.points = points[order]

        sizes = layer_sizes(n, config.ml, m)
        top = len(sizes) - 1
        ranges = []
        for i, (size, cumulative) in enumerate(sizes):
            # top layer first; skip point 0, the fixed entry point
            ranges.append((top - i, max(cumulative - size, 1), cumulative))

        self.zero = np.full((n, m0), -1, np.int32)
        self.layers: list[np.ndarray] = [None] * top  # layers[l-1] = level l
        done = 0
        for layer, start, end in ranges:
            for pid in range(start, end):
                self._insert(pid, layer, top)
                done += 1
                if progress and done % 1000 == 0:
                    progress(done, n, f"layer {layer}")
            if layer > 0:
                self.layers[layer - 1] = self.zero[:end, :m].copy()

    # -- construction ------------------------------------------------------
    def _insert(self, new: int, layer: int, top: int):
        """Insert one point (paper Alg. 1; reference lib.rs:437-528)."""
        cfg = self.config
        m, m0 = cfg.m, cfg.m0
        q = self.points[new]
        search = _Search()
        search.ef = 1
        search.push(0, q, self.points, self.metric)
        links = m0 if layer == 0 else m

        for cur in range(top, -1, -1):
            search.ef = cfg.ef_construction if cur <= layer else 1
            if cur > layer:
                search.search(q, self.layers[cur - 1], self.points,
                              self.metric, links)
                search.cull()
            else:
                search.search(q, self.zero, self.points, self.metric, links)
                break

        if cfg.heuristic is None:
            found = search.nearest[:m0]
        else:
            found = _select_heuristic(q, search.nearest, self.zero,
                                      self.points, self.metric,
                                      cfg.heuristic, m0,
                                      visited=search.visited)

        for i, (d, pid) in enumerate(found):
            self.zero[new, i] = pid
            if cfg.heuristic is not None:
                self._add_reverse_heuristic(new, d, pid, cfg.heuristic, m0)
            else:
                self._add_reverse_simple(new, d, pid, m0)

    def _add_reverse_heuristic(self, new, d, pid, params, m0):
        """Re-select pid's neighbors including `new` (lib.rs:484-496)."""
        t = self.points[pid]
        cand = [(d, new)]
        for nb in self.zero[pid]:
            if nb < 0:
                break
            cand.append((self.metric(t, self.points[int(nb)]), int(nb)))
        cand.sort()
        cand = cand[:self.config.ef_construction]
        found = _select_heuristic(t, cand, self.zero, self.points,
                                  self.metric, params, m0,
                                  visited={p for _, p in cand})
        row = self.zero[pid]
        k = len(found)
        row[:k] = [p for _, p in found]
        row[k:] = -1

    def _add_reverse_simple(self, new, d, pid, m0):
        """Distance-sorted shift-insert into pid's row (lib.rs:498-514,
        types.rs:100-113).

        Deliberate deviation: the reference's comparator at lib.rs:502-511
        passes ``target.cmp(element)`` to ``binary_search_by`` (whose
        contract is ``element.cmp(target)``), yielding inverted positions.
        We insert at the correct ascending-by-distance position (keeping
        the nearest, dropping the furthest when full), which can only help
        recall; the reference's own recall floors are the parity bar.
        """
        row = self.zero[pid]
        t = self.points[pid]
        idx = m0
        for i in range(m0):
            nb = row[i]
            if nb < 0 or d < self.metric(t, self.points[int(nb)]):
                idx = i
                break
        if idx >= m0:
            return  # all current neighbors closer and row full; skip
        if row[idx] >= 0:
            row[idx + 1:] = row[idx:m0 - 1].copy()
        row[idx] = new

    # -- query -------------------------------------------------------------
    def search(self, q, ef: Optional[int] = None):
        """Single query (lib.rs:352-383) -> list[(distance, pid)]."""
        cfg = self.config
        q = np.asarray(q, np.float32)
        if len(self.points) == 0:
            return []
        search = _Search()
        search.push(0, q, self.points, self.metric)
        top = len(self.layers)
        for cur in range(top, -1, -1):
            if cur == 0:
                search.ef = ef or cfg.ef_search
                search.search(q, self.zero, self.points, self.metric,
                              cfg.m0)
            else:
                search.ef = 1
                search.search(q, self.layers[cur - 1], self.points,
                              self.metric, cfg.m)
                search.cull()
        return list(search.nearest)
