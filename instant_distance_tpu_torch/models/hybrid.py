"""Latency-routed serving: small batches on the host, large ones on the
card (port of ``instant_distance_tpu/models/hybrid.py``).

The reference serves ONE query at a time: ``Hnsw::search`` is a
synchronous, single-threaded call on a host core
(instant-distance/src/lib.rs:352-383).  The card's paths are throughput
engines: a batched device step pays its launches and its host round
trip whatever the batch, so a batch of one can cost more there than a
warm host beam search.

``HybridIndex`` routes per call:

* ``B < threshold``  -> the C++ host engine (``native/``), searching the
  SAME graph (lifted once with ``NativeHnsw.from_arrays``), one
  sequential beam per query;
* ``B >= threshold`` -> the wrapped device index's ``search_batch``
  (pass a ``ScanIndex``/``PackedHnsw`` as ``tpu_index`` for the fastest
  large-batch engines).

Host results are numpy arrays and device results tensors on the card, as
the JAX package returns numpy and device arrays.  ``calibrate()``
measures both routes and sets ``threshold`` to the breakeven batch.

Tombstones and ``filter_mask`` are device features; calls carrying a
filter, and any call on an index with tombstones or grown since the
lift, go to the device whatever the batch size.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


def _batch(queries):
    """Queries as a 2-D f32 tensor or numpy array (kept where they are:
    each route moves them to its own side)."""
    if isinstance(queries, torch.Tensor):
        q = queries.float()
    else:
        q = np.asarray(queries, np.float32)
    return q[None] if q.ndim == 1 else q


class HybridIndex:
    """Route small batches to the host engine, large ones to the card.

    Args:
      index: a built ``Hnsw``/``HnswMap`` (the graph both paths serve).
      tpu_index: optional faster large-batch engine (``ScanIndex``,
        ``PackedHnsw``, ...) on the card; defaults to ``index`` itself.
        (The name is the JAX package's public parameter.)
      threshold: route batches strictly smaller than this to the host.
        Default 128; ``calibrate()`` measures the breakeven.
      ef: default search width for both paths (index config's ef_search
        if None).
      host_threads: OpenMP threads for host batches (1 = the reference's
        sequential model; 0 = all cores).
      host_engine: a prebuilt ``NativeHnsw`` over the same graph; skips
        the one-time device -> host lift.
    """

    def __init__(self, index, tpu_index=None, *, threshold: int = 128,
                 ef: Optional[int] = None, host_threads: int = 1,
                 host_engine=None):
        from ..native import NativeHnsw, available

        self.index = index
        self.tpu_index = tpu_index if tpu_index is not None else index
        self.threshold = int(threshold)
        self.ef = int(ef or index.config.ef_search)
        self.host_threads = int(host_threads)
        self._host = host_engine
        if self._host is None and available():
            metric = index.config.metric
            if isinstance(metric, str):
                # one-time lift of the device graph to the host: N*(D+2M)*4
                # bytes (768 MB at 1M x 128, m = 32), one array at a time
                self._host = NativeHnsw.from_arrays(
                    index.points, index.zero, index.layers, metric,
                    index.config.m)
        # Size at lift time: a later add grows the device graph, not the
        # host copy, so such calls route to the device (_host_stale).
        self._host_n = len(index) if self._host is not None else 0

    @property
    def host_available(self) -> bool:
        return self._host is not None

    def _has_tombstones(self) -> bool:
        return getattr(self.index, "_alive", None) is not None

    def _host_stale(self) -> bool:
        """True when the index grew or shrank after the host lift."""
        try:
            return len(self.index) != self._host_n
        except TypeError:
            return False

    def search_batch(self, queries, k: int = 10,
                     ef: Optional[int] = None, filter_mask=None):
        """[B, D] -> (dists [B, k], ids [B, k]), routed by B.

        Numpy arrays from the host path, tensors from the device path;
        both are row-per-query (dist, id) sorted ascending.
        """
        q = _batch(queries)
        ef_ = int(ef or self.ef)
        use_host = (self._host is not None
                    and q.shape[0] < self.threshold
                    and filter_mask is None
                    and not self._has_tombstones()
                    and not self._host_stale())
        if use_host:
            return self._host.search_batch(q, ef=max(ef_, k), k=k,
                                           n_threads=self.host_threads)
        kw = {}
        if filter_mask is not None:
            kw["filter_mask"] = filter_mask
        return self.tpu_index.search_batch(q, k=k, ef=ef_, **kw)

    def search(self, point, search) -> "iter":
        """Single-query API (fills a ``Search``, returns its iterator):
        B = 1, so the host path when it is available."""
        d, i = self.search_batch(_batch(point)[:1], k=self.ef)
        if isinstance(d, torch.Tensor):
            d, i = d.cpu(), i.cpu()
        map_ = self.index if hasattr(self.index, "values") else None
        search._arm(np.asarray(d[0]), np.asarray(i[0]),
                    index=None if map_ is not None else self.index,
                    map_=map_)
        return iter(search)

    def calibrate(self, sample_queries, k: int = 10,
                  ef: Optional[int] = None, iters: int = 8) -> int:
        """Measure both paths and set ``threshold`` to the breakeven
        batch size (host per-query seconds vs the device's per-batch
        seconds on ``sample_queries``-shaped traffic).  Returns the new
        threshold."""
        if self._host is None:
            self.threshold = 0
            return 0
        q = _batch(sample_queries)
        ef_ = int(ef or self.ef)
        # host: sequential per-query median
        lat = []
        for i in range(min(len(q), 16)):
            t0 = time.perf_counter()
            self._host.search_batch(q[i:i + 1], ef=max(ef_, k), k=k,
                                    n_threads=1)
            lat.append(time.perf_counter() - t0)
        host_s = float(np.median(lat))
        # device: small batches are launch-bound, large ones
        # throughput-bound.  Model t(B) = intercept + slope*B from two
        # batch sizes; the host wins while host_s*B < intercept + slope*B.
        # time_fn syncs the card after the timed calls.
        from ..utils.metrics import time_fn

        def device_s(batch):
            return time_fn(lambda x: self.tpu_index.search_batch(
                               x, k=k, ef=ef_), batch,
                           warmup=2, iters=iters).per_call_s

        b_small = min(32, len(q))
        t_small = device_s(q[:b_small])
        if len(q) > b_small:
            t_full = device_s(q)
            slope = max(0.0, (t_full - t_small) / (len(q) - b_small))
        else:
            slope = 0.0
        intercept = max(0.0, t_small - slope * b_small)
        if host_s <= slope:   # the host beats the marginal device cost
            self.threshold = 1 << 20
        else:
            self.threshold = max(1, int(np.ceil(
                intercept / (host_s - slope))))
        return self.threshold
