"""The graph route: ``Hnsw.build(points, Config(seed, **build))`` and
``PackedHnsw.from_index`` in set-up (``counters["build_s"]``: the
build's seconds), then ``PackedHnsw.search_batch_kernel(queries, k,
**search)`` a call: the seed scan, K4's walk and the exact rerank.  The
answers' pids map back to the points' order through the build's ids,
which must be a permutation (check ``id_map_bad``, limit 0)."""

import time

import torch

import instant_distance_tpu_torch as idt
from instant_distance_tpu_torch.models import packed as packed_mod

from annbench.walkcount import walk_work


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Served:
    def __init__(self, points, spec, params, seed, counters):
        dev = points.device
        n = points.shape[0]
        cfg = idt.Config(seed=seed % (1 << 63), metric=spec["metric"],
                         **params["build"])
        _sync(dev)
        t0 = time.perf_counter()
        index, ids = idt.Hnsw.build(points, cfg)
        _sync(dev)
        counters["build_s"] = time.perf_counter() - t0
        self.packed = idt.PackedHnsw.from_index(index)
        del index
        ids = torch.as_tensor(ids, device=dev).long()
        inside = (ids >= 0) & (ids < n)
        hits = torch.bincount(ids[inside], minlength=n)
        self.id_map_bad = int((~inside).sum()) + int((hits != 1).sum())
        self.to_input = torch.full((n,), -1, dtype=torch.long, device=dev)
        self.to_input[ids[inside]] = torch.arange(n, device=dev)[inside]
        self.kw = dict(params["search"], k=spec["k"])

    def search(self, queries):
        return self.packed.search_batch_kernel(queries, **self.kw)

    def input_ids(self, pids):
        n = self.to_input.shape[0]
        pids = pids.long()
        ok = (pids >= 0) & (pids < n)
        return torch.where(ok, self.to_input[pids.clamp(0, n - 1)], -1)

    def checks(self):
        return {"id_map_bad": {"value": self.id_map_bad, "limit": 0,
                               "ok": self.id_map_bad == 0}}

    def layers(self, queries):
        """K4's work on this call's own inputs, counted by the frozen
        plain walk (the call's arguments recorded on the way in)."""
        seen = {}
        launch = packed_mod.walk_search

        def record(*args, **kw):
            seen["args"], seen["kw"] = args, kw
            return launch(*args, **kw)

        packed_mod.walk_search = record
        try:
            self.search(queries)
        finally:
            packed_mod.walk_search = launch
        args, kw = seen["args"], seen["kw"]
        expanded, scored = walk_work(*args, **kw)
        return {"k4": dict(expanded=expanded, scored=scored,
                           k=args[3].shape[1], d=args[0].shape[1],
                           b=args[0].shape[0], ef=kw["ef"])}

    def close(self):
        self.packed = None


def setup(points, spec, params, seed, counters):
    return Served(points, spec, params, seed, counters)
