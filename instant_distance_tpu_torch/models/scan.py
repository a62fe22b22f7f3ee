"""ScanIndex: int8 exhaustive scan + exact rerank (port of
``instant_distance_tpu/models/scan.py``).

The search paths of the JAX package:

* ``fused=...``: one of the int8 scan kernels (``ops/scan_kernel.py``,
  CUDA on the GPU) scores every point and keeps one candidate per
  ``lsub``-wide stride group; the exact top-ef of those is reranked with
  exact f32 distances.  ``"bucket_pack"`` runs the packed-key kernel K1,
  ``"bucket_int"`` the shared-scale int kernel K3 (L2 only), ``"bucket"``
  (or ``True``) the per-point-scale f32 kernel K2 and ``"topt"`` K5,
  K2's minima cut to the ``topt`` best of each ``cb`` block in the
  kernel.  dot/cosine requests for the int kernels run ``"bucket"``,
  and ``"bucket_pack"`` runs ``"bucket_int"`` where packed keys could
  overflow (D * lsub > 16384), as in the JAX package.
* the default streamed scan: per-point-scale int8 products in column
  chunks with a running top-ef merge, then the same rerank.

Candidate selection is exact ``torch.topk`` where the JAX package used
``approx_min_k`` (exact on its CPU reference, approximate on the TPU).
``"bucket_pack"`` also takes the JAX package's grouped selections:
``sel_kgroup`` (K1's second-level group min) and ``sel_group``.  ``add``
appends rows; the kernels' layouts are rebuilt from all rows at the next
fused search.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..ops.distance import resolve, torch_dtype
from ..ops.packed import quantize_points
from ..ops.scan_kernel import (INT_RANK_LIMIT, PACK_OFFSET,
                               bucket_operands, bucket_queries, decode_keys,
                               fused_scan_bucket, fused_scan_bucket_int,
                               fused_scan_bucket_int_packed, fused_scan_topt,
                               int8_matmul, pack_operands, pack_w2,
                               quantize_batch)
from ..ops.sort import sort2
from ..utils.convert import as_queries, as_tensor
from .hnsw import as_new_points, extended, tombstoned

_I32MAX = np.iinfo(np.int32).max
_MAGIC = "instant-distance-tpu/scan/v1"


def _quantize_queries(queries):
    """Per-query symmetric int8 (same scheme as quantize_points)."""
    amax = queries.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(queries / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def scan_candidates(queries, codes, scales, norms, eligible, *,
                    metric_name: str, ef: int, chunk: int, tile: int = 0):
    """Streamed quantized scan: [B, D] queries vs [N] codes -> (approx
    dists [B, ef], ids [B, ef]) sorted by (dist, id), -1 padded.
    ``tile > 1`` keeps only each ``tile``-wide slice's best column."""
    b = queries.shape[0]
    n = codes.shape[0]
    dev = queries.device
    chunk = min(chunk, n)
    if tile > 1:
        if chunk < 4 * tile or chunk // tile < ef:
            tile = 0
        else:
            chunk = (chunk // tile) * tile
    ef = min(ef, n)

    qc, qs = _quantize_queries(queries)
    is_dot = metric_name in ("dot", "cosine")
    if metric_name == "cosine":
        qn = torch.sqrt((queries * queries).sum(1))
        qs = qs / torch.clamp(qn, min=1e-30)

    best_d = torch.full((b, ef), torch.inf, device=dev)
    best_i = torch.full((b, ef), _I32MAX, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dot = int8_matmul(qc, codes[s:e].T)                   # [B, C]
        prod = (qs[:, None] * scales[None, s:e]) * dot.float()
        if metric_name == "cosine":
            d = -prod * torch.rsqrt(torch.clamp(norms[s:e], min=1e-30))[None]
        elif is_dot:
            d = -prod
        else:  # squared L2 up to the per-query constant |q|^2
            d = norms[None, s:e] - 2.0 * prod
        if eligible is not None:
            d = torch.where(eligible[None, s:e], d, torch.inf)
        ids = torch.arange(s, e, dtype=torch.int32, device=dev)
        sel_ids = ids.expand(b, -1)
        if tile > 1:
            pad = (-(e - s)) % tile
            if pad:  # ragged last chunk: pad to whole tiles
                d = torch.nn.functional.pad(d, (0, pad), value=torch.inf)
                ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            d3 = d.view(b, -1, tile)
            am = d3.argmin(dim=2, keepdim=True)
            d = d3.gather(2, am)[..., 0]                      # [B, C/L]
            sel_ids = ids.view(1, -1, tile).expand(b, -1, -1).gather(
                2, am)[..., 0]
        nd, nidx = torch.topk(d, min(ef, d.shape[1]), dim=1, largest=False)
        ni = torch.where(torch.isfinite(nd), sel_ids.gather(1, nidx), -1)
        cat_d = torch.cat([best_d, nd], dim=1)
        cat_i = torch.cat([best_i, torch.where(ni >= 0, ni, _I32MAX)], dim=1)
        sd, si = sort2(cat_d, cat_i)
        best_d, best_i = sd[:, :ef], si[:, :ef]
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i


def rerank_exact(queries, points, bi, metric, k: int):
    """Exact top-k over candidate ids: one ef-row gather per query."""
    rows = points[bi.clamp(min=0)][..., :queries.shape[1]]
    exact = metric.gathered(queries, rows)
    exact = torch.where(bi >= 0, exact, torch.inf)
    sd, si = sort2(exact, bi)
    return sd[:, :k], si[:, :k]


def _scan_search(queries, codes, scales, norms, points, eligible, *,
                 metric_name, ef, k, chunk, rerank, tile=0):
    bd, bi = scan_candidates(queries, codes, scales, norms, eligible,
                             metric_name=metric_name, ef=ef, chunk=chunk,
                             tile=tile)
    if not rerank:
        bd, bi = bd[:, :k], bi[:, :k]
        # restore the per-query constants the streamed scan drops
        if metric_name == "sqeuclidean":
            qn2 = (queries * queries).sum(1, keepdim=True)
            bd = torch.where(torch.isfinite(bd), bd + qn2, bd)
        elif metric_name == "cosine":
            bd = torch.where(torch.isfinite(bd), bd + 1.0, bd)
        return bd, bi
    return rerank_exact(queries, points, bi, resolve(metric_name), k)


def _padded(eligible, npad: int):
    """Eligibility [N] padded with False to the operands' Npad."""
    return torch.nn.functional.pad(eligible, (0, npad - eligible.shape[0]))


def _fused_int_packed_search(queries, codes_t, norms_r, sg, points,
                             eligible, *, ef, k, lsub, cb, rerank,
                             sel_group=0, sel_kgroup=0):
    """Packed-key scan (K1) + top-ef + rerank (``_fused_int_packed_
    search_jit``, models/scan.py:239-338 of the JAX package).

    Selection, as the JAX package has it: with ``sel_kgroup = g > 1``
    K1 also emits ``og``, the min over g strided key columns, the top-ef
    groups are taken from ``og`` and each winner's g key columns gathered
    back; with ``sel_group = g > 1`` the top-ef of contiguous g-wide
    column groups of the keys; else the top-ef keys.  A grouped selection
    keeps one candidate a group (the exact rerank absorbs the loss)."""
    d = queries.shape[1]
    qc, qs = quantize_batch(queries)
    denom = 2.0 * qs * sg
    el = (None if eligible is None
          else _padded(eligible, norms_r.shape[1])[None, :])
    w2 = pack_w2(norms_r, denom, el, lsub=lsub, cb=cb, d=d)
    og = None
    if sel_kgroup > 1:
        od, og = fused_scan_bucket_int_packed(qc, w2, codes_t, lsub=lsub,
                                              cb=cb, groups=sel_kgroup)
    else:
        od = fused_scan_bucket_int_packed(qc, w2, codes_t, lsub=lsub, cb=cb)
    b = od.shape[0]
    efk = min(ef, od.shape[1])
    ct = cb // lsub
    if og is not None and og.shape[1] >= efk:
        # og column i covers key columns (i // ctg) * ct + g * ctg + i % ctg
        ctg = ct // sel_kgroup
        _, gidx = torch.topk(og, efk, dim=1, largest=False)    # [B, efk]
        base = (gidx // ctg) * ct + gidx % ctg
        memb = (base[:, :, None] + ctg * torch.arange(
            sel_kgroup, dtype=base.dtype, device=base.device))
        cand = od.gather(1, memb.reshape(b, -1)).reshape(b, efk, sel_kgroup)
        keys, j = cand.amin(dim=2), cand.argmin(dim=2)
        nidx = base + j * ctg
    elif sel_group > 1 and od.shape[1] % sel_group == 0 \
            and od.shape[1] // sel_group >= efk:
        groups = od.view(b, -1, sel_group)
        _, gidx = torch.topk(groups.amin(dim=2), efk, dim=1, largest=False)
        cand = groups.gather(1, gidx[:, :, None].expand(-1, -1, sel_group))
        keys, j = cand.amin(dim=2), cand.argmin(dim=2)
        nidx = gidx * sel_group + j
    else:
        keys, nidx = torch.topk(od, efk, dim=1, largest=False)
    bi = decode_keys(keys, nidx, lsub=lsub, cb=cb)
    if not rerank:
        shift = lsub.bit_length() - 1
        rank = ((keys >> shift) - PACK_OFFSET // lsub
                - 127 * 127 * d).float()
        qn2 = (queries * queries).sum(1, keepdim=True)
        bd = torch.where(bi >= 0, rank * denom + qn2, torch.inf)
        bd, bi = sort2(bd, bi)
        return bd[:, :k], bi[:, :k]
    return rerank_exact(queries, points, bi, resolve("sqeuclidean"), k)


def _int32_saturating(x):
    """f32 -> int32 as XLA converts: values past the int32 range take its
    ends, NaN gives 0 (a plain ``.to(torch.int32)`` leaves them
    undefined)."""
    y = torch.nan_to_num(x, nan=0.0).clamp(-2.0**31, 2.0**31 - 128)
    return torch.where(x >= 2.0**31, _I32MAX, y.to(torch.int32))


def _fused_int_search(queries, codes_t, norms_r, sg, points, eligible, *,
                      ef, k, lsub, cb, rerank):
    """Shared-scale int-epilogue scan (K3) + exact top-ef + rerank
    (``_fused_int_search_jit``, models/scan.py:197-231 of the JAX
    package): queries share ONE scale, so a point's rank weight
    ``w = round(|p_hat|^2 / (2 qs sg))`` serves every query."""
    big = _I32MAX // 2
    qc, qs = quantize_batch(queries)
    denom = 2.0 * qs * sg
    w = torch.where(torch.isfinite(norms_r),
                    _int32_saturating(torch.round(norms_r / denom)), big)
    if eligible is not None:
        w = torch.where(_padded(eligible, norms_r.shape[1])[None, :], w, big)
    od, oi = fused_scan_bucket_int(qc, w, codes_t, lsub=lsub, cb=cb)
    # as the JAX package selects: on the ranks converted to f32
    md, nidx = torch.topk(od.float(), min(ef, od.shape[1]), dim=1,
                          largest=False)
    bi = torch.where(md < INT_RANK_LIMIT, oi.gather(1, nidx), -1)
    if not rerank:
        qn2 = (queries * queries).sum(1, keepdim=True)
        bd = torch.where(bi >= 0, md * denom + qn2, torch.inf)
        bd, bi = sort2(bd, bi)
        return bd[:, :k], bi[:, :k]
    return rerank_exact(queries, points, bi, resolve("sqeuclidean"), k)


def _fused_search(queries, codes_t, scales_r, norms_r, points, eligible, *,
                  metric_name, ef, k, lsub, topt, cb, rerank, mode):
    """Per-point-scale scan, K2 (``mode="bucket"``) or K5 (``"topt"``),
    + exact top-ef + rerank (``_fused_search_jit``, models/scan.py:346-389
    of the JAX package)."""
    is_dot = metric_name in ("dot", "cosine")
    qc, qs = bucket_queries(queries, metric_name)
    if eligible is not None:
        norms_r = torch.where(_padded(eligible, norms_r.shape[1])[None, :],
                              norms_r, torch.inf)
    if mode == "bucket":
        od, oi = fused_scan_bucket(qc, qs, codes_t, scales_r,
                                   norms_r, lsub=lsub, cb=cb, is_dot=is_dot)
    else:
        od, oi = fused_scan_topt(qc, qs, codes_t, scales_r,
                                 norms_r, lsub=lsub, topt=topt, cb=cb,
                                 is_dot=is_dot)
    md, nidx = torch.topk(od, min(ef, od.shape[1]), dim=1, largest=False)
    bi = torch.where(torch.isfinite(md), oi.gather(1, nidx), -1)
    if not rerank:
        bd, bi = sort2(md, bi)
        bd, bi = bd[:, :k], bi[:, :k]
        # restore the per-query constants: sq-L2 drops |q|^2, cosine is
        # -cos against the metric's 1 - cos, dot is exact
        if metric_name == "cosine":
            bd = torch.where(torch.isfinite(bd), bd + 1.0, bd)
        elif not is_dot:
            qn2 = (queries * queries).sum(1, keepdim=True)
            bd = torch.where(torch.isfinite(bd), bd + qn2, bd)
        return bd, bi
    return rerank_exact(queries, points, bi, resolve(metric_name), k)


#: ``search_batch``'s ``fused`` modes.
_FUSED_MODES = ("bucket", "bucket_int", "bucket_pack", "topt")


class ScanIndex:
    """Quantized exhaustive-scan index (int8 scoring + exact rerank).

    Ids are the input order.  Supports values, tombstones and exact
    result filters.  Lives on ``points``' device (numpy input: the
    ``device`` argument, the CUDA card by default).
    """

    _FUSED_CB = 4096

    def __init__(self, points, metric: str = "sqeuclidean",
                 chunk: int = 1 << 17,
                 values: Optional[Sequence[Any]] = None,
                 store_dtype: str = "float32", device=None):
        if not isinstance(metric, str):
            raise ValueError(
                "ScanIndex needs a matmul-form metric name "
                "(sqeuclidean/euclidean/dot/cosine); use BruteForce for "
                "custom callables")
        pts = as_tensor(points, device, torch.float32)
        self.device = pts.device
        self.points = pts.to(torch_dtype(store_dtype))
        self.metric_name = metric
        n = self.points.shape[0]
        self.chunk = int(min(chunk, max(1, n)))
        self.codes, self.scales = quantize_points(self.points)
        deq = self.codes.float() * self.scales[:, None]
        self.norms = (deq * deq).sum(1)                  # |p_hat|^2 [N]
        self.values = None if values is None else list(values)
        self._alive = None
        self._fused = {}
        self._fused_int = {}
        self.config = Config(metric=metric)

    @classmethod
    def build(cls, points, config: Optional[Config] = None,
              values=None, **kw) -> "ScanIndex":
        metric = config.metric if config is not None else "sqeuclidean"
        return cls(points, metric=metric, values=values, **kw)

    @classmethod
    def from_index(cls, index, **kw) -> "ScanIndex":
        """Scan-serving index over a built Hnsw/HnswMap's points (pid
        order), values and tombstones."""
        metric = index.config.metric
        if not isinstance(metric, str):
            raise ValueError("from_index needs a named matmul metric")
        obj = cls(index.points, metric=metric,
                  values=getattr(index, "values", None), **kw)
        alive = getattr(index, "_alive", None)
        if alive is not None:
            obj._alive = as_tensor(alive, obj.device, torch.bool)
        return obj

    def __len__(self) -> int:
        return int(self.points.shape[0])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.points, self.codes, self.scales,
                             self.norms))

    def add(self, new_points, values=None) -> np.ndarray:
        """Append points (exact streaming: every row is scored, so the
        append is the whole update).  New rows get their own per-point
        codes and scales; the squared norms are recomputed over all rows,
        and the fused kernels' layouts are rebuilt from all rows at the
        next fused search, so a grown index scores exactly as one built
        on all its rows.  Every array becomes a new tensor (a
        ``from_index`` source is never written).  Returns the new ids,
        following the existing rows."""
        new_pts = as_new_points(new_points, self.device,
                                self.points.shape[1])
        a = new_pts.shape[0]
        if self.values is not None:
            if values is None or len(values) != a:
                raise ValueError(
                    "values must match the number of new points")
        elif values is not None:
            raise ValueError("this index carries no values")
        n_old = len(self)
        codes, scales = quantize_points(new_pts)
        self.points = torch.cat([self.points, new_pts.to(self.points.dtype)])
        self.codes = torch.cat([self.codes, codes])
        self.scales = torch.cat([self.scales, scales])
        deq = self.codes.float() * self.scales[:, None]
        self.norms = (deq * deq).sum(1)
        self._alive = extended(self._alive, a)
        if self.values is not None:
            self.values = self.values + list(values)
        self._fused = {}
        self._fused_int = {}
        self.chunk = int(min(max(self.chunk, 1), len(self)))
        return np.arange(n_old, n_old + a, dtype=np.int32)

    def delete(self, ids) -> None:
        """Tombstone ids: they are never scored into results again (a new
        mask each time, as in :meth:`Hnsw.delete`)."""
        self._alive = tombstoned(self._alive, len(self), ids, self.device,
                                 "id")

    def _eligible(self, filter_mask):
        eligible = self._alive
        if filter_mask is not None:
            fm = as_tensor(filter_mask, self.device, torch.bool)
            if tuple(fm.shape) != (len(self),):
                raise ValueError(f"filter_mask must be [N]={len(self)}, "
                                 f"got {tuple(fm.shape)}")
            eligible = fm if eligible is None else (eligible & fm)
        return eligible

    def _fused_arrays(self, cb: int, variant: str = "l2"):
        """Operands of K2/K5 (:func:`bucket_operands`, ``variant`` l2,
        dot or cosine), cached per padded length and variant."""
        key = (cb, variant)
        if key not in self._fused:
            self._fused[key] = bucket_operands(self.codes, self.scales,
                                               self.norms, cb, variant)
        return self._fused[key]

    def _fused_int_arrays(self, cb: int):
        """Operands of the packed-key scan (:func:`pack_operands`),
        cached per padded length."""
        if cb not in self._fused_int:
            self._fused_int[cb] = pack_operands(self.points.float(), cb)
        return self._fused_int[cb]

    def search_batch(self, queries, k: int = 10, ef: Optional[int] = None,
                     rerank: bool = True, filter_mask=None,
                     approx_topk: bool = False, tile: int = 0,
                     fused=False, topt: int = 8, lsub: int = 16,
                     qb: int = 0, cb: int = 0, inner: int = 1,
                     slab: bool = False, sel_group: int = 0,
                     sel_kgroup: int = 0, sel_target: float = 0.95):
        """[B, D] -> (dists [B, k], ids [B, k]); ids = input order.

        Arguments as in the JAX package.  ``fused`` picks the scan
        kernel (module docstring), ``topt`` is K5's candidates per
        ``cb`` block, ``lsub`` the stride-group width (16 becomes 32
        for the bucket modes at the default cb, as in the JAX package);
        ``inner`` only pads the point axis to ``cb * inner`` (the TPU
        grid's sub-chunking).  The JAX package's TPU tiling and
        approximate-selection knobs ``qb``, ``slab``, ``approx_topk`` and
        ``sel_target`` are accepted and change nothing: the port has one
        kernel body per mode and selects exactly, which is at least as
        good as any approximate selection.
        """
        queries = as_queries(queries, self.device, self.points.shape[1])
        ef = ef or max(4 * k, 32)
        ef = int(min(ef, len(self)))
        k = int(min(k, ef))
        metric_name = self.metric_name
        cb = cb or self._FUSED_CB
        if fused and len(self) >= cb * inner:
            mode = fused if isinstance(fused, str) else "bucket"
            is_l2 = metric_name in ("sqeuclidean", "euclidean")
            if mode in ("bucket_int", "bucket_pack") and not is_l2:
                mode = "bucket"  # the shared-scale rank trick is L2-only
            if mode.startswith("bucket") and lsub == 16 \
                    and cb == self._FUSED_CB:
                lsub = 32
            if mode == "bucket_pack" and queries.shape[1] * lsub > 16384:
                mode = "bucket_int"  # packed keys would overflow
            if mode not in _FUSED_MODES:
                raise ValueError(f"fused must be True or one of "
                                 f"{_FUSED_MODES}, got {fused!r}")
            eligible = self._eligible(filter_mask)
            if mode == "bucket_pack":
                codes_t, norms_r, sg = self._fused_int_arrays(cb * inner)
                d, i = _fused_int_packed_search(
                    queries, codes_t, norms_r, sg, self.points, eligible,
                    ef=ef, k=k, lsub=lsub, cb=cb, rerank=rerank,
                    sel_group=sel_group, sel_kgroup=sel_kgroup)
            elif mode == "bucket_int":
                codes_t, norms_r, sg = self._fused_int_arrays(cb * inner)
                d, i = _fused_int_search(
                    queries, codes_t, norms_r, sg, self.points, eligible,
                    ef=ef, k=k, lsub=lsub, cb=cb, rerank=rerank)
            else:
                fm = "sqeuclidean" if is_l2 else metric_name
                codes_t, scales_r, norms_r = self._fused_arrays(
                    cb * inner, "l2" if is_l2 else fm)
                d, i = _fused_search(
                    queries, codes_t, scales_r, norms_r, self.points,
                    eligible, metric_name=fm, ef=ef, k=k, lsub=lsub,
                    topt=topt, cb=cb, rerank=rerank, mode=mode)
        else:
            d, i = _scan_search(
                queries, self.codes, self.scales, self.norms, self.points,
                self._eligible(filter_mask),
                metric_name=("sqeuclidean" if metric_name == "euclidean"
                             else metric_name),
                ef=ef, k=k, chunk=self.chunk, rerank=rerank, tile=tile)
        if metric_name == "euclidean":
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

    # -- persistence ---------------------------------------------------------
    def dump(self, fname: str) -> None:
        """Save the serving arrays (codes/scales/norms + f32 points for
        the exact rerank) as one npz, in the JAX package's format."""
        arrays = dict(
            magic=np.array(_MAGIC),
            metric=np.array(self.metric_name),
            chunk=np.array(self.chunk, np.int64),
            points=self.points.float().cpu().numpy(),
            store_dtype=np.array(str(self.points.dtype).split(".")[-1]),
            codes=self.codes.cpu().numpy(),
            scales=self.scales.cpu().numpy(),
            norms=self.norms.cpu().numpy(),
        )
        if self.values is not None:
            arrays["values"] = np.array(json.dumps(list(self.values)))
        if self._alive is not None:
            arrays["alive"] = self._alive.cpu().numpy()
        with open(fname, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, fname: str, device=None) -> "ScanIndex":
        """Load a dump onto ``device`` (default: the CUDA card)."""
        with np.load(fname, allow_pickle=False) as z:
            if str(z["magic"]) != _MAGIC:
                raise ValueError(f"{fname}: not a ScanIndex dump")
            obj = cls.__new__(cls)
            obj.metric_name = str(z["metric"])
            obj.chunk = int(z["chunk"])
            points = as_tensor(z["points"], device)
            obj.device = points.device
            obj.points = points.to(torch_dtype(
                str(z["store_dtype"]) if "store_dtype" in z.files
                else "float32"))
            obj.codes = as_tensor(z["codes"], obj.device)
            obj.scales = as_tensor(z["scales"], obj.device)
            obj.norms = as_tensor(z["norms"], obj.device)
            obj.values = (json.loads(str(z["values"]))
                          if "values" in z.files else None)
            obj._alive = (as_tensor(z["alive"], obj.device, torch.bool)
                          if "alive" in z.files else None)
            obj._fused = {}
            obj._fused_int = {}
            obj.config = Config(metric=obj.metric_name)
            return obj
