"""Mesh-sharded HNSW: one sub-index per shard, cross-shard top-k merge
(port of ``instant_distance_tpu/parallel/sharded.py``).

The point set is split into ``mesh.size`` shards of ``n_s`` points.  Each
shard holds an independent HNSW over its points on its device, every
shard answers the whole query batch, and the shards' results merge with
:func:`~instant_distance_tpu_torch.parallel.mesh.gather_merge` (a two-key
sort of the gathered candidates, across ranks by ``all_gather``).

The build shards exactly as the JAX package does (the same global
permutation, the same local shuffle, so the same global ids and shard
rows) and advances every shard by one wave at a time, in lockstep
(``ops/construct._run_waves``), with the resolved search mode, pool,
hop repair and exact-prefix hybrid.  Like the JAX sharded build it has no
capped sample and no split.  Each rank builds its own shards, from the
full point set.

Two faults of the JAX package are not copied.  It pads the last shard
with rows at ``_PAD_COORD``, mixes them into the shard's pid order and
inserts them as graph nodes (under ``dot`` a pad row is every query's
nearest point).  Here a padded shard takes its pad rows last in its
order, after the local shuffle, so its entry point and upper-layer
prefixes are real rows, no wave's scanned prefix reaches a pad row, and
no wave lane is one: a pad row gets no links and no real row links to
it.  The JAX package also quantizes each shard's scan operands over all
rows, so in a padded shard the packed-key kernel's single scale is set
by the pad rows and every real point quantizes to the all-zero code;
here only real rows set it.  A shard without padding builds as in the
JAX package, bit for bit.  A padded graph built by the JAX package and
loaded here keeps its pad links.  The JAX search also hands
``hnsw_search`` the upper layers bottom first, where it reads them top
first; the port descends top first, as ``Hnsw.search_batch`` does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config, layer_sizes, resolve_seed
from ..ops.beam import hnsw_search
from ..ops.construct import (_WaveGraph, _adjd_from, _adjd_np, _plan_of,
                             _pool_of, _run_waves, _scan_operands, _span,
                             _snapshots_from, _stacked_of,
                             _warn_reverse_drops)
from ..ops.distance import resolve, torch_dtype
from ..utils.convert import as_queries, as_tensor
from .mesh import Mesh, all_sum, default_mesh, gather_merge

#: Sentinel coordinate for shard-padding points: far from any real data
#: but finite, so squared distances stay finite in float32.
_PAD_COORD = 1e15


def _local(x, mesh: Mesh, dtype):
    """This process's shards of ``x``: a sequence with one entry per
    local shard, or an array whose leading axis is the global shard
    count.  Each goes to its shard's device as ``dtype``."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh.devices):
            raise ValueError(f"{len(x)} shards for a mesh of "
                             f"{len(mesh.devices)} local devices")
        parts = list(x)
    else:
        if x.shape[0] != mesh.size:
            raise ValueError(f"{x.shape[0]} shards for a mesh of "
                             f"{mesh.size}")
        parts = [x[j] for j in mesh.shard_ids()]
    return [as_tensor(p, dev, dtype) for p, dev in zip(parts, mesh.devices)]


def _shard_eligible(gids, eligible):
    """A global-id eligibility mask as a shard's local-pid mask (pad rows
    never eligible)."""
    e = eligible.to(gids.device)
    return (gids >= 0) & e[gids.clamp(min=0).long()]


def _to_global(gids, d, p):
    """Local pids -> global ids; pad rows and misses become (inf, -1)."""
    g = torch.where(p >= 0, gids[p.clamp(min=0).long()], -1)
    return torch.where(g >= 0, d, torch.inf), g


class _Sharded:
    """What both sharded HNSW forms share: ids, tombstones, filters and
    values over ORIGINAL global ids."""

    def _count(self) -> int:
        return all_sum(self.mesh, sum(int((g >= 0).sum())
                                      for g in self.gids))

    def __len__(self) -> int:
        return self.n

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    def delete(self, global_ids) -> None:
        """Tombstone points by ORIGINAL global id (result-filtered, graph
        untouched)."""
        from ..models.hnsw import tombstoned

        self._alive = tombstoned(self._alive, len(self), global_ids,
                                 self.mesh.first, "global id")

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
        return as_queries(queries, self.mesh.first, self.points[0].shape[1])

    def search_batch_values(self, queries, k: Optional[int] = None,
                            ef: Optional[int] = None, filter_mask=None):
        """Batched query returning (dists, global ids, values)."""
        if self.values is None:
            raise ValueError("this index carries no values")
        d, g = self.search_batch(queries, k, ef, filter_mask=filter_mask)
        vals = [[self.values[gid] if gid >= 0 else None for gid in row]
                for row in g.cpu().tolist()]
        return d, g, vals


class ShardedHnsw(_Sharded):
    """An HNSW index sharded over a device mesh.

    Per local shard j (on ``mesh.devices[j]``): ``points[j]`` [n_s, D],
    ``zero[j]`` [n_s, m0], ``layers[l][j]`` [end_l, m] (level l + 1),
    ``gids[j]`` [n_s] (global original index per local pid; -1 =
    padding).  The constructor takes these as arrays with a leading
    global shard axis (the JAX package's layout) or as lists of this
    process's shards.
    """

    def __init__(self, points, zero, layers, gids, config: Config,
                 mesh: Mesh, values=None):
        self.mesh = mesh
        dt = torch_dtype(config.dtype)
        self.points = [p.to(dt) for p in _local(points, mesh, torch.float32)]
        self.zero = _local(zero, mesh, torch.int32)
        self.layers = [_local(l, mesh, torch.int32) for l in layers]
        self.gids = _local(gids, mesh, torch.int32)
        self.config = config
        #: values indexed by ORIGINAL global id (the id space search
        #: results use), not by local pid.
        self.values = None if values is None else list(values)
        #: Tombstone mask over global ids, bool [n] on ``mesh.first``.
        self._alive = None
        #: Reverse-edge additions lost to an explicit rev_rounds cap,
        #: summed over all shards (0 unless set by ``build``).
        self.reverse_drops = 0
        self.n = self._count()

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, points, config: Optional[Config] = None,
              mesh: Optional[Mesh] = None, progress=None,
              values=None, checkpoint: Optional[str] = None,
              checkpoint_every: int = 64) -> "ShardedHnsw":
        """Shard the point set over the mesh and build every local
        shard's graph, one wave step for every shard at a time.

        ``values`` (optional): per-point payloads, indexed by original
        input order, the id space ``search_batch`` returns.
        ``checkpoint``: a path where the state of every local shard is
        saved each ``checkpoint_every`` waves, in the JAX package's npz
        fields and key, and resumed from (bit for bit) when a build with
        the same key finds it; a rank of a distributed mesh saves its
        shards to ``checkpoint + ".rank<r>"``.  The file is removed when
        the build ends.
        """
        config = config or Config()
        # pin the (possibly entropy-drawn) seed: the local shuffle, the
        # checkpoint key and the per-shard layer schedule must agree
        config = dataclasses.replace(config,
                                     seed=resolve_seed(config.seed))
        if values is not None and len(values) != len(points):
            raise ValueError("points and values must have the same length")
        mesh = mesh or default_mesh()
        s = mesh.size
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu()
        pts = np.asarray(points, np.float32)
        n, dim = pts.shape
        n_s = max(1, -(-n // s))

        # the global permutation and the local shuffle, verbatim from the
        # JAX package (sharded.py:126-147): same gids, same shard rows
        rng = np.random.default_rng(config.seed)
        perm = rng.permutation(n)
        pad = s * n_s - n
        gids_flat = np.concatenate(
            [perm, np.full(pad, -1, np.int64)]).astype(np.int32)
        pts_flat = np.concatenate(
            [pts[perm], np.full((pad, dim), _PAD_COORD, np.float32)])
        shard_pts = pts_flat.reshape(s, n_s, dim)
        shard_gids = gids_flat.reshape(s, n_s)
        lrng = np.random.default_rng(config.seed + 1)
        keys = lrng.integers(0, n_s, size=n_s)
        order = np.lexsort((np.arange(n_s), keys))
        # a shard that holds pad rows takes them last (a stable partition
        # of the shuffled order), so its pid 0 and every upper layer's
        # prefix are real rows; a shard without them keeps the JAX order
        pad_last = shard_gids[:, order] < 0
        orders = np.stack([np.concatenate([order[~p], order[p]])
                           for p in pad_last])
        local = list(mesh.shard_ids())
        shard_pts = shard_pts[np.asarray(local)[:, None], orders[local]]
        shard_gids = shard_gids[np.asarray(local)[:, None], orders[local]]
        del pts_flat, gids_flat

        pts_t = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                 for p, dev in zip(shard_pts, mesh.devices)]
        gids_t = [torch.from_numpy(np.ascontiguousarray(g)).to(dev)
                  for g, dev in zip(shard_gids, mesh.devices)]
        zero, layers, reverse_drops = _build_sharded(
            pts_t, gids_t, config, mesh, progress=progress,
            checkpoint=checkpoint, checkpoint_every=checkpoint_every,
            padded=pad > 0)
        idx = cls(pts_t, zero, layers, gids_t, config, mesh, values=values)
        idx.reverse_drops = reverse_drops
        return idx

    # ------------------------------------------------------------------
    def search_batch(self, queries, k: Optional[int] = None,
                     ef: Optional[int] = None, filter_mask=None):
        """Batched global query -> (dists [B, k], global ids [B, k]) on
        ``mesh.first``.

        Global ids index the *original* input order.  ``filter_mask``
        (bool [n], original order) restricts results without affecting
        traversal.  ``k`` defaults to ``ef``.
        """
        cfg = self.config
        queries = self._queries(queries)
        ef = ef or cfg.ef_search
        k = k or ef
        eligible = self._eligible(filter_mask)
        metric = resolve(cfg.metric)
        ds, gs = [], []
        for j, dev in enumerate(self.mesh.devices):
            gids, pts = self.gids[j], self.points[j]
            el = None if eligible is None else _shard_eligible(gids,
                                                               eligible)
            d, p = hnsw_search(
                queries.to(dev), self.zero[j],
                tuple(level[j] for level in reversed(self.layers)), pts,
                metric, ef=ef, m=cfg.m, zero_links=cfg.m0,
                max_iter_factor=cfg.max_iter_factor,
                expand=cfg.search_expand, eligible=el,
                entry_seeds=min(cfg.entry_seeds, pts.shape[0]))
            d, g = _to_global(gids, d, p)
            ds.append(d)
            gs.append(g)
        d, g = gather_merge(self.mesh, ds, gs, ef)
        return d[:, :k], g[:, :k]

    def pack(self, pack_links: int = 32) -> "ShardedPackedHnsw":
        """Compile every shard into the inline-int8 serving form
        (models/packed.py): packed traversal per shard, exact rerank,
        cross-shard merge."""
        return ShardedPackedHnsw.from_sharded(self, pack_links=pack_links)

    # ------------------------------------------------------------------
    def arrays(self):
        """This process's shards as numpy, with a leading shard axis:
        (points [L, n_s, D], zero [L, n_s, m0], layers [[L, end_l, m]],
        gids [L, n_s])."""
        def stack(ts, dtype):
            return np.stack([t.detach().cpu().float().numpy()
                             if t.dtype == torch.bfloat16
                             else t.detach().cpu().numpy()
                             for t in ts]).astype(dtype)

        return (stack(self.points, np.float32), stack(self.zero, np.int32),
                [stack(l, np.int32) for l in self.layers],
                stack(self.gids, np.int32))

    def dump(self, fname: str) -> None:
        """Persist all shards' graph arrays to one npz (the JAX package's
        ``sharded-v1`` file).  Serving forms (``pack()``) recompile from
        the loaded graph."""
        from ..utils import serialize

        serialize.dump_sharded(self, fname)

    @classmethod
    def load(cls, fname: str, mesh: Optional[Mesh] = None) -> "ShardedHnsw":
        """Load a ``dump`` onto ``mesh`` (default: the first S CUDA cards,
        where S is the dump's shard count; a mesh of another size raises:
        re-sharding is a rebuild)."""
        from ..utils import serialize

        return serialize.load_sharded(fname, mesh=mesh)


class ShardedPackedHnsw(_Sharded):
    """Mesh-sharded packed serving index: per local shard j,
    ``points[j]``, ``gids[j]``, ``zero_pack[j]`` = (ids, codes, scales)
    and ``upper_packs[j]``, those triples top first."""

    def __init__(self, points, gids, zero_pack, upper_packs,
                 config: Config, mesh: Mesh, values=None, alive=None):
        self.mesh = mesh
        self.points = list(points)
        self.gids = list(gids)
        self.zero_pack = [tuple(z) for z in zero_pack]
        self.upper_packs = [tuple(tuple(p) for p in u) for u in upper_packs]
        self.config = config
        self.values = None if values is None else list(values)
        self._alive = (None if alive is None
                       else as_tensor(alive, mesh.first, torch.bool))
        self.n = self._count()

    @classmethod
    def from_sharded(cls, idx: ShardedHnsw,
                     pack_links: int = 32) -> "ShardedPackedHnsw":
        """Pack every shard (``ops/packed.pack_layer``), the zero layer's
        first ``pack_links`` neighbours of each row."""
        from ..ops import packed as pk

        zero_pack, uppers = [], []
        for j in range(len(idx.mesh.devices)):
            codes, scales = pk.quantize_points(idx.points[j])
            zero_pack.append(pk.pack_layer(idx.zero[j], codes, scales,
                                           links=pack_links))
            uppers.append(tuple(pk.pack_layer(level[j], codes, scales)
                                for level in reversed(idx.layers)))
        return cls(idx.points, idx.gids, zero_pack, uppers, idx.config,
                   idx.mesh, values=idx.values, alive=idx._alive)

    def search_batch(self, queries, k: Optional[int] = None,
                     ef: Optional[int] = None, filter_mask=None):
        """Global packed query: per-shard approximate traversal and exact
        rerank (``ops/packed.packed_search``, plain ops), then the
        cross-shard merge.  ``filter_mask`` (bool [n], original order)
        restricts results without affecting traversal; ``k`` defaults to
        min(10, ef)."""
        from ..ops.packed import packed_search

        cfg = self.config
        queries = self._queries(queries)
        ef = ef or cfg.ef_search
        k = min(k or min(10, ef), ef)
        eligible = self._eligible(filter_mask)
        metric = resolve(cfg.metric)
        ds, gs = [], []
        for j, dev in enumerate(self.mesh.devices):
            gids = self.gids[j]
            el = None if eligible is None else _shard_eligible(gids,
                                                               eligible)
            d, p = packed_search(
                queries.to(dev), self.zero_pack[j], self.upper_packs[j],
                self.points[j], metric, ef=ef, k=ef,
                max_iter_factor=cfg.max_iter_factor,
                expand=cfg.search_expand, eligible=el)
            d, g = _to_global(gids, d, p)
            ds.append(d)
            gs.append(g)
        return gather_merge(self.mesh, ds, gs, k)


# ---------------------------------------------------------------------------
# mesh-parallel construction
# ---------------------------------------------------------------------------

def _ckpt_path(checkpoint: str, mesh: Mesh) -> str:
    return (checkpoint if not mesh.distributed
            else f"{checkpoint}.rank{mesh.rank}")


def _save_sharded_ckpt(path: str, key: str, graphs, sizes, m: int, li: int,
                       ws: int) -> None:
    """Write every local shard's wave state in the JAX package's sharded
    npz fields: ``adj``, ``adjd`` and ``stacked`` with a leading shard
    axis, the snapshot ``offsets`` and ``write_off`` the shards share,
    the total ``drops`` and the last wave's (``li``, ``ws``)."""
    parts = [_stacked_of(g.layers, sizes, m) for g in graphs]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, key=np.array(key),
                 adj=np.stack([g.adj.cpu().numpy() for g in graphs]),
                 adjd=np.stack([_adjd_np(g.adjd)[0] for g in graphs]),
                 stacked=np.stack([p[0] for p in parts]),
                 offsets=parts[0][1], write_off=parts[0][2],
                 drops=sum(int(g.drops) for g in graphs), li=li, ws=ws)
    os.replace(tmp, path)


def _build_sharded(shard_pts, shard_gids, config: Config, mesh: Mesh,
                   progress=None, checkpoint: Optional[str] = None,
                   checkpoint_every: int = 64, padded: bool = False):
    """Build this process's shards (``shard_pts[j]`` [n_s, D] on
    ``mesh.devices[j]``, ``shard_gids[j]`` -1 on pad rows) with every
    shard advancing one wave at a time.  No wave lane is a pad row, so
    pad rows link to nothing and nothing links to them.  ``padded``
    (some shard of the mesh holds pad rows, last in its order) marks the
    checkpoint key, so neither package resumes the other's padded state.

    Returns ``(zero [per shard], layers [level][shard], reverse_drops)``
    with ``layers[l - 1]`` level l; ``reverse_drops`` is summed over all
    ranks."""
    cfg = config
    s = mesh.size
    n_s, dim = shard_pts[0].shape
    m, m0 = cfg.m, cfg.m0
    sizes = layer_sizes(n_s, cfg.ml, m)
    top = len(sizes) - 1
    if top > 16:
        raise ValueError("more than 16 upper layers")
    ranges = [(top - i, max(c - sz, 1), c)
              for i, (sz, c) in enumerate(sizes)]
    # n_s, not n, sizes the layers; the JAX sharded build has no capped
    # sample and no split
    plan = dataclasses.replace(_plan_of(cfg, n_s, dim), sampling=False,
                               split=False)
    cache_dtype = torch_dtype(cfg.dist_cache_dtype)

    key = (f"sharded-v5:{s}:{n_s}:{dim}:{cfg.seed}:"
           f"{cfg.ef_construction}:{m}:{cfg.ml}:{plan.heuristic}:"
           f"{cfg.wave_size}:{plan.pend_cap}:{plan.rev_rounds}:"
           f"{cfg.max_iter_factor}:{cfg.construct_expand}:"
           f"{plan.search_mode}:{cfg.select_pd_dtype}:{plan.exact_prefix}:"
           f"{plan.hop}:{_pool_of(cfg, plan.search_mode)}"
           + (":padlast" if padded else ""))
    path = None if checkpoint is None else _ckpt_path(checkpoint, mesh)
    state = None
    if path is not None and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            if (str(z["key"]) == key
                    and z["adj"].shape[0] == len(mesh.devices)):
                state = {f: z[f] for f in ("adj", "adjd", "stacked",
                                           "offsets", "drops", "li", "ws")}

    graphs = []
    for j, (pts, gids) in enumerate(zip(shard_pts, shard_gids)):
        dev = pts.device
        real = gids >= 0
        real = None if bool(real.all()) else real
        ops, flat_ops = _scan_operands(pts, plan, real)
        if state is None:
            adj = torch.full((n_s + 1, m0), -1, dtype=torch.int32,
                             device=dev)
            adjd = torch.full((n_s + 1, m0), torch.inf, dtype=cache_dtype,
                              device=dev)
            drops = torch.zeros((), dtype=torch.int64, device=dev)
            layers = []
        else:
            adj = torch.from_numpy(state["adj"][j]).to(dev)
            adjd = _adjd_from(state["adjd"][j], None, cache_dtype, dev)
            # the saved total rides on the first shard
            drops = torch.tensor(int(state["drops"]) if j == 0 else 0,
                                 dtype=torch.int64, device=dev)
            layers = _snapshots_from(
                dict(stacked=state["stacked"][j], offsets=state["offsets"],
                     li=int(state["li"])), ranges, m, dev)
        graphs.append(_WaveGraph(pts, ops, flat_ops, adj, adjd, drops,
                                 layers, real))
    resume = ((-1, -1) if state is None
              else (int(state["li"]), int(state["ws"])))
    del state

    def save(li, ws):
        with _span("build.checkpoint"):
            _save_sharded_ckpt(path, key, graphs, sizes, m, li, ws)

    _run_waves(graphs, plan, ranges, cfg.wave_size, resume=resume,
               progress=progress, total=s * n_s, weight=s,
               save=None if path is None else save,
               save_every=checkpoint_every)
    if path is not None and os.path.exists(path):
        os.remove(path)  # build complete
    reverse_drops = all_sum(mesh, sum(int(g.drops) for g in graphs))
    _warn_reverse_drops(reverse_drops, plan.pend_cap, plan.rev_rounds)
    zero = [g.adj[:n_s] for g in graphs]
    layers = [[g.layers[li] for g in graphs]
              for li in range(len(graphs[0].layers))][::-1]
    return zero, layers, reverse_drops
