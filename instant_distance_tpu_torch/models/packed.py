"""PackedHnsw: the serving form of a built index (port of
``instant_distance_tpu/models/packed.py``).

``PackedHnsw.from_index(hnsw)`` inlines int8-quantized neighbour vectors
into every adjacency row (``ops/packed.py``) and serves batched queries
by approximate traversal and an exact rerank.  The graph is the index's;
only its storage changes.  Two routes:

* :meth:`PackedHnsw.search_batch`: plain torch ops (``packed_search``):
  the upper-layer descent or the seed scan, filters and tombstones;
* :meth:`PackedHnsw.search_batch_kernel`: the seed scan, then the whole
  zero-layer walk in kernel K4 (``ops/walk_kernel.py``), then the rerank.

The JAX package's TPU knobs ``bq`` and ``fused_rows`` are accepted and
change nothing, and its 128-lane points copy (``_points_lanes``) has no
counterpart: the card's kernel reads the three packed arrays as they
are, at any D, one query a thread block.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..ops import packed as pk
from ..ops.distance import resolve
from ..ops.walk_kernel import walk_search
from ..utils.convert import as_queries, as_tensor
from .hnsw import Hnsw, HnswMap, tombstoned

_MAGIC = "instant-distance-tpu/packed/v1"


class PackedHnsw:
    """Inline-quantized serving index (immutable graph; tombstones and
    result filters as in the exact index).  Lives on ``points``'
    device."""

    def __init__(self, points, zero_pack, upper_packs, config: Config,
                 values: Optional[Sequence[Any]] = None, alive=None):
        self.points = as_tensor(points)
        self.device = self.points.device
        #: (ids [N, K] int32, codes [N, K, D] int8, scales [N, K] f32)
        self.zero_pack = tuple(zero_pack)
        self.upper_packs = tuple(tuple(p) for p in upper_packs)  # top first
        self.config = config
        #: values[pid] -> value, when packed from an HnswMap
        self.values = None if values is None else list(values)
        self._alive = (None if alive is None
                       else as_tensor(alive, self.device, torch.bool))
        self._seed_cache = None

    @classmethod
    def from_index(cls, index: Hnsw, pack_links: int = 0) -> "PackedHnsw":
        """Compile a built index into the packed serving form, on the
        index's device.  ``pack_links`` keeps the first N (selection-
        ordered) neighbours of each zero row; 0 keeps all M * 2.  Values
        (HnswMap) and tombstones carry over."""
        codes, scales = pk.quantize_points(index.points)
        zero_pack = pk.pack_layer(index.zero, codes, scales,
                                  links=pack_links)
        uppers = tuple(pk.pack_layer(layer, codes, scales)
                       for layer in reversed(index.layers))  # top first
        values = index.values if isinstance(index, HnswMap) else None
        return cls(index.points, zero_pack, uppers, index.config,
                   values=values, alive=index._alive)

    @classmethod
    def build(cls, points, config: Optional[Config] = None,
              **kw) -> "PackedHnsw":
        index, _ = Hnsw.build(points, config, **kw)
        return cls.from_index(index)

    def __len__(self) -> int:
        return int(self.points.shape[0])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.zero_pack, *(a for p in self.upper_packs
                                                for a in p), self.points))

    # -- tombstones (same semantics as Hnsw.delete) -------------------------
    def delete(self, pids) -> None:
        self._alive = tombstoned(self._alive, len(self), pids, self.device,
                                 "pid")

    def _eligible(self, filter_mask):
        eligible = self._alive
        if filter_mask is not None:
            fm = as_tensor(filter_mask, self.device, torch.bool)
            if tuple(fm.shape) != (len(self),):
                raise ValueError(f"filter_mask must be [N]={len(self)}, "
                                 f"got {tuple(fm.shape)}")
            eligible = fm if eligible is None else (eligible & fm)
        return eligible

    def _seeds(self, entry_seeds: Optional[int]):
        """[S, D] bfloat16 seed matrix of the seed scan (None when the
        knob is 0): pids are a seeded uniform shuffle of the input, so
        the first S points are a uniform sample."""
        s = self.config.entry_seeds if entry_seeds is None else entry_seeds
        if not s:
            return None
        s = min(int(s), len(self))
        if self._seed_cache is None or self._seed_cache.shape[0] != s:
            self._seed_cache = self.points[:s].to(torch.bfloat16)
        return self._seed_cache

    def _queries(self, queries):
        return as_queries(queries, self.device, self.points.shape[1])

    # -- queries -------------------------------------------------------------
    def search_batch_kernel(self, queries, k: Optional[int] = None,
                            ef: Optional[int] = None, rerank: bool = True,
                            entry_seeds: Optional[int] = None,
                            expand: Optional[int] = None,
                            bq: int = 128, fused_rows: bool = True,
                            merge: str = "count"):
        """Batched query through the fused walk kernel K4.

        Same traversal as ``search_batch`` on valid graphs; needs
        ``entry_seeds`` > 0 (the seed scan makes the initial beams) and
        ``expand`` in {1, 2}.  ``merge`` ("count" or "extract", the JAX
        package's strategies) is accepted and, like the TPU layout knobs
        ``bq`` and ``fused_rows``, changes nothing: both names launch the
        one kernel, which returns the beam both strategies define.
        Result filters and tombstones are not routed here (use
        ``search_batch``).  Returns (dists [B, k], pids [B, k]).
        """
        cfg = self.config
        if self._alive is not None:
            raise ValueError("kernel engine does not support tombstones; "
                             "use search_batch")
        queries = self._queries(queries)
        ef = ef or cfg.ef_search
        k = k or min(10, ef)
        e_n = expand if expand is not None else min(2, cfg.search_expand)
        seeds = self._seeds(entry_seeds)
        if seeds is None:
            raise ValueError("kernel engine needs entry_seeds > 0")
        bd0, bp0 = pk.seeded_beam(queries, seeds, ef)
        ids, codes, scales = self.zero_pack
        bd, bp = walk_search(queries, bd0, bp0, ids, codes, scales,
                             expand=e_n, ef=ef,
                             max_iters=cfg.max_iter_factor * ef + 16,
                             merge=merge)
        if not rerank:
            return bd[:, :k], bp[:, :k]
        return pk.rerank_beam(queries, self.points, bp, resolve(cfg.metric),
                              k)

    def search_batch(self, queries, k: Optional[int] = None,
                     ef: Optional[int] = None, rerank: bool = True,
                     filter_mask=None, entry_seeds: Optional[int] = None,
                     expand: Optional[int] = None):
        """Batched query by plain torch ops.  ``entry_seeds``: S > 0
        starts at the seed scan over the first S points, 0 descends the
        upper layers, None takes ``Config.entry_seeds``; ``expand``
        overrides ``Config.search_expand``."""
        cfg = self.config
        queries = self._queries(queries)
        ef = ef or cfg.ef_search
        k = k or min(10, ef)
        return pk.packed_search(
            queries, self.zero_pack, self.upper_packs, self.points,
            resolve(cfg.metric), ef=ef, k=min(k, ef),
            max_iter_factor=cfg.max_iter_factor,
            expand=expand if expand is not None else cfg.search_expand,
            rerank=rerank, eligible=self._eligible(filter_mask),
            seed_vecs=self._seeds(entry_seeds))

    def search_batch_values(self, queries, k: Optional[int] = None,
                            ef: Optional[int] = None, filter_mask=None):
        """Batched query returning (dists, pids, values nested list)."""
        if self.values is None:
            raise ValueError("this index carries no values")
        d, p = self.search_batch(queries, k, ef, filter_mask=filter_mask)
        vals = [[self.values[pid] if pid >= 0 else None for pid in row]
                for row in p.cpu().tolist()]
        return d, p, vals

    # -- persistence ---------------------------------------------------------
    def dump(self, fname: str) -> None:
        """Save the serving form (packed layers + f32 points for the
        rerank) as one npz in the JAX package's format, so a serving
        process skips both the build and the packing."""
        cfgd = dataclasses.asdict(self.config)
        if not isinstance(cfgd.get("metric"), str):
            cfgd["metric"] = "custom"
        arrays = dict(
            magic=np.array(_MAGIC),
            config=np.array(json.dumps(cfgd)),
            n_upper=np.array(len(self.upper_packs), np.int64),
            points=self.points.float().cpu().numpy(),
        )
        for name, pack in (("zero", self.zero_pack),
                           *((f"u{i}", p)
                             for i, p in enumerate(self.upper_packs))):
            for part, t in zip(("ids", "codes", "scales"), pack):
                arrays[f"{name}_{part}"] = t.cpu().numpy()
        if self.values is not None:
            arrays["values"] = np.array(json.dumps(list(self.values)))
        if self._alive is not None:
            arrays["alive"] = self._alive.cpu().numpy()
        with open(fname, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, fname: str, device=None) -> "PackedHnsw":
        """Load a dump onto ``device`` (default: the CUDA card)."""
        from ..utils.serialize import _config_from_json

        with np.load(fname, allow_pickle=False) as z:
            if str(z["magic"]) != _MAGIC:
                raise ValueError(f"{fname}: not a PackedHnsw dump")
            cfg = _config_from_json(str(z["config"]))
            points = as_tensor(z["points"], device)

            def pack(name):
                return tuple(as_tensor(z[f"{name}_{part}"], points.device)
                             for part in ("ids", "codes", "scales"))

            uppers = tuple(pack(f"u{i}") for i in range(int(z["n_upper"])))
            values = (json.loads(str(z["values"]))
                      if "values" in z.files else None)
            alive = z["alive"] if "alive" in z.files else None
            return cls(points, pack("zero"), uppers, cfg, values=values,
                       alive=alive)
