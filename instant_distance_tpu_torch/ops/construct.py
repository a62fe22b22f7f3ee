"""Wave-based batched HNSW construction and incremental insertion (port
of ``instant_distance_tpu/ops/construct.py``).

Points are inserted layer by layer in waves of doubling size (up to
``Config.wave_size``).  Each wave:

1. finds each point's candidate pool (``search_select_core``) in one of
   the wave-search modes (``_resolve_search_mode``):

   * ``"scan_fused"`` (named metrics): an int8 scan of the inserted
     prefix, the packed-key kernel K1 for L2 metrics with D * 64 <=
     16384, the bucket kernel K2 (per-point scales, f32 epilogue) for
     dot/cosine and wider points (``ops/scan_kernel.py``), then the
     exact top pool;
   * ``"scan"``: the streamed per-point-scale scan of
     ``models/scan.scan_candidates``; scan_fused builds run it for the
     waves whose prefix is below ``construct_exact_prefix``;
   * ``"beam"`` (callable metrics): a greedy descent through the upper
     layers completed so far, then a batched beam search of the
     pre-wave graph (``ops/beam.py``);

   and reranks the pool with exact f32 distances;
2. optionally merges the graph neighbours of the pool's best candidates
   (``construct_hop_repair``; sampled builds, below);
3. merges each point's nearest same-wave peers (the batched stand-in for
   sequential insertion order);
4. selects forward neighbours (Alg. 3/4, ``ops/select.py``, with
   ``Heuristic.extend_candidates`` widening the pool first);
5. commits forward rows and re-selects every reverse-edge target's row
   in nearest-first rounds of ``pend_cap`` additions (``commit_core``),
   lossless by default.

``construct_sample_cols`` caps the scanned prefix at the first pids (a
uniform sample: insertion order is a seeded shuffle).  Neighbours
outside the sample come back through the graph: where the JAX package
would run split search and commit programs (``construct_split``, or its
8e9-byte estimate), the repair runs after the wave-peer merge, in the
commit (``repair_commit_core``); otherwise in the search, with
``max(construct_hop_repair, construct_sample_hops)`` hops.  The two
place the repair differently, so they build different graphs.

``build_graph(checkpoint=...)`` saves the wave state every
``checkpoint_every`` waves in the JAX package's npz fields and resumes
from a file whose key matches; ``extend_graph`` inserts new points at
layer 0 against the frozen upper layers (``Hnsw.add``).

Insertion order and layer assignment come from the JAX package's numpy
code, verbatim, so a port build and a reference build with the same
seed insert the same points in the same waves.  The adjacency is
[N+1, m0] with row N a write sink for padded wave lanes, updated in
place.  Left out, as workarounds for a 16 GB TPU: separate search and
commit programs, the lane-packed adjacency, ``dispatch_sync_every``,
the 4M-column scan chunks, 128-lane point padding and the environment
knobs ``INSTANT_TPU_NO_SPLIT``, ``INSTANT_TPU_NO_PK`` and
``INSTANT_TPU_FINAL_CKPT``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config, layer_sizes, resolve_seed
from ..utils.convert import default_device
from .beam import beam_search_layer, greedy_descent
from .distance import resolve, torch_dtype
from .packed import quantize_points
from .scan_kernel import (bucket_operands, bucket_queries, decode_keys,
                          fused_scan_bucket, fused_scan_bucket_int_packed,
                          pack_operands, pack_w2, quantize_batch)
from . import select as sel_ops
from .sort import argsort2, sort2

_I32MAX = np.iinfo(np.int32).max
#: Profiler spans (``build.*``) that attribute build time to its phases;
#: they cost ~1 us each when no profiler runs.
_span = torch.profiler.record_function

#: Bucket (K2) construction scan: point block and stride-group width,
#: as in the JAX package.
_FUSED_CB = 4096
_FUSED_LSUB = 32
#: Packed-key construction scan: point block and stride-group width
#: (cb/lsub = 128 output lanes), as in the JAX package.
_FUSED_PACK_CB = 8192
_FUSED_PACK_LSUB = 64
#: Reverse-commit targets re-selected per chunk.  Chunks touch disjoint
#: rows, so the size changes memory and launch count, never the graph;
#: 65536 targets x (m0 + pend_cap)^2 pairwise entries fit an H100 easily.
_REV_CHUNK = 1 << 16
#: Hop-repair neighbours whose exact distances are gathered at once
#: (columns of the [W, hops * m0] neighbour list), as in the JAX
#: ``repair_commit_core``: values never depend on it.
_HOP_CHUNK = 256
#: Upper-layer greedy descent's step cap (the JAX ``_greedy_stacked``).
_GREEDY_ITERS = 512


def _use_pack(metric_name, d: int) -> bool:
    """Whether the fused construction scan runs the packed-key int
    kernel (L2-only rank trick; packed keys need D*lsub <= 16384)."""
    return (isinstance(metric_name, str)
            and metric_name in ("sqeuclidean", "euclidean")
            and d * _FUSED_PACK_LSUB <= 16384)


def _resolve_search_mode(cfg, metric_name) -> str:
    """Config.construct_mode -> concrete wave-search mode, resolved as
    the JAX package resolves it off-CPU: named metrics scan with the
    fused kernel, callables walk the graph ("beam")."""
    mode = cfg.construct_mode or "auto"
    if mode not in ("auto", "beam", "scan", "scan_fused"):
        raise ValueError(
            f"construct_mode must be one of auto/beam/scan/scan_fused, "
            f"got {mode!r}")
    if mode == "auto":
        if not isinstance(metric_name, str):
            return "beam"
        mode = "scan"
    if mode == "scan" and metric_name in ("sqeuclidean", "euclidean",
                                          "dot", "cosine"):
        return "scan_fused"
    return mode


def _pool_of(cfg, search_mode: str) -> int:
    """Candidate pool of a wave search: ``ef_construction`` verbatim for
    beam (reference parity), ``construct_pool`` or 3 * ef_construction
    for the scans (pool depth is nearly free there; see the JAX
    ``_pool_of``)."""
    if not search_mode.startswith("scan"):
        return cfg.ef_construction
    return int(cfg.construct_pool or 3 * cfg.ef_construction)


def _rev_params(cfg, m0: int):
    """(pend_cap, rev_rounds): pend_cap defaults to min(m0, 32);
    rev_rounds 0 = auto (lossless: ceil(W / pend_cap) rounds)."""
    return cfg.pend_cap or min(m0, 32), cfg.rev_rounds or 0


def _wave_schedule(start: int, end: int, cap: int):
    """Doubling wave sizes: wave <= points already inserted."""
    s = start
    while s < end:
        w = min(max(s, 1), cap, end - s)
        yield s, s + w
        s += w


def _bucket(w: int, cap: int) -> int:
    """Wave lanes, padded to powers of 16 (capped) as in the JAX build.
    The padding is kept because it is visible in the results: padded
    lanes query point 0, which enters the wave's shared int8 scale."""
    b = 1
    while b < w and b < cap:
        b *= 16
    return min(b, cap) if b >= w else cap


@dataclasses.dataclass(frozen=True)
class _Plan:
    """A build's options, resolved once (``_plan_of``)."""

    metric_name: object
    search_mode: str
    m: int
    m0: int
    heuristic: Optional[tuple]     # (extend_candidates, keep_pruned)
    pend_cap: int
    rev_rounds: int
    pd_dtype: str
    max_iter_factor: int
    expand: int
    efc_beam: int                  # _pool_of(cfg, "beam")
    efc_scan: int                  # _pool_of(cfg, "scan")
    exact_prefix: int
    hop: int
    sampling: bool
    sample_cols: int
    sample_hops: int
    split: bool


def _plan_of(cfg, n: int, d: int, allow_split: bool = True) -> _Plan:
    """Resolve ``cfg`` for ``n`` points of dimension ``d``.  ``split`` is
    where the JAX package would run separate search and commit programs
    (``build_graph``, construct.py:1374-1382): only scan modes with no
    hop repair and no ``extend_candidates``, when ``construct_split``
    says so or, left None, when its memory estimate passes 8e9 bytes.
    Incremental adds never split (``allow_split=False``)."""
    metric_name = cfg.metric
    search_mode = _resolve_search_mode(cfg, metric_name)
    heur = (None if cfg.heuristic is None else
            (cfg.heuristic.extend_candidates, cfg.heuristic.keep_pruned))
    hop = int(cfg.construct_hop_repair)
    pend_cap, rev_rounds = _rev_params(cfg, cfg.m0)
    scan = search_mode.startswith("scan")
    can_split = scan and hop == 0 and not (heur is not None and heur[0])
    split = cfg.construct_split
    if split is None:
        dp_est = d + (-d) % 128
        split = n * (17 * cfg.m0 + 8 * dp_est) > 8_000_000_000
    sample_cols = cfg.construct_sample_cols
    return _Plan(
        metric_name=metric_name, search_mode=search_mode, m=cfg.m,
        m0=cfg.m0, heuristic=heur, pend_cap=pend_cap, rev_rounds=rev_rounds,
        pd_dtype=cfg.select_pd_dtype, max_iter_factor=cfg.max_iter_factor,
        expand=cfg.construct_expand, efc_beam=_pool_of(cfg, "beam"),
        efc_scan=_pool_of(cfg, "scan"),
        exact_prefix=int(cfg.construct_exact_prefix or 0), hop=hop,
        sampling=(sample_cols is not None and scan
                  and int(sample_cols) < n),
        sample_cols=int(sample_cols or 0),
        sample_hops=int(cfg.construct_sample_hops),
        split=allow_split and can_split and bool(split))


def _quantize_for_scan(points, metric_name, real=None):
    """Wave-search operands over the build's points (pid order), in the
    JAX ``_quantize_for_scan(fused=True)``'s order ``(codes_t, scales,
    norms_r)``: for the packed-key kernel ONE global scale ``sg``
    (:func:`pack_operands`), for K2 per-point scales [1, Npad] with the
    metric's norms (:func:`bucket_operands`).  ``real`` (bool [N] or
    None): the rows that are points; the others (a padded shard's pad
    rows, last in its order, so no wave's prefix reaches them) stay out
    of ``sg``."""
    if _use_pack(metric_name, points.shape[1]):
        codes_t, norms_r, sg = pack_operands(points, _FUSED_PACK_CB, real)
        return codes_t, sg, norms_r
    codes, scales = quantize_points(points)
    deq = codes.float() * scales[:, None]
    variant = ("l2" if metric_name in ("sqeuclidean", "euclidean")
               else metric_name)
    codes_t, scales_r, norms_r = bucket_operands(
        codes, scales, (deq * deq).sum(1), _FUSED_CB, variant)
    return codes_t, scales_r, norms_r


def _flat_operands(points):
    """Streamed-scan operands (the JAX ``_quantize_for_scan(fused=
    False)``): per-point int8 codes [N, D], scales [N] and the
    dequantized squared norms [N]."""
    codes, scales = quantize_points(points)
    deq = codes.float() * scales[:, None]
    return codes, scales, (deq * deq).sum(1)


def _scan_operands(points, plan: _Plan, real=None):
    """``(main, flat)`` wave-search operands: ``main`` for the plan's
    own mode (None for beam), ``flat`` the streamed-scan operands of the
    first ``exact_prefix`` points that a scan_fused build hands to the
    waves whose prefix is still below it (None without a prefix).
    ``real`` as in :func:`_quantize_for_scan`."""
    if not plan.search_mode.startswith("scan"):
        return None, None
    if plan.search_mode == "scan":
        return _flat_operands(points), None
    main = _quantize_for_scan(points, plan.metric_name, real)
    flat = None
    if plan.exact_prefix > 0:
        flat = _flat_operands(points[:min(points.shape[0],
                                          plan.exact_prefix)])
    return main, flat


def _cap_scan_ops(ops, plan: _Plan, d: int):
    """The scan operands cut to the first ~``sample_cols`` pids, rounded
    up to the kernel's point block (8192 for K1, 4096 for K2, 128 for
    the streamed scan), as contiguous copies: the full-size operands
    are not referenced any more."""
    if plan.search_mode == "scan_fused":
        mult = (_FUSED_PACK_CB if _use_pack(plan.metric_name, d)
                else _FUSED_CB)
        cap = min(-(-plan.sample_cols // mult) * mult, ops[0].shape[1])
        c0, c1, c2 = ops
        if c1.dim() > 0:                 # per-point scales [1, Npad]
            c1 = c1[:, :cap].contiguous()
        return c0[:, :cap].contiguous(), c1, c2[:, :cap].contiguous()
    cap = min(-(-plan.sample_cols // 128) * 128, ops[0].shape[0])
    return tuple(x[:cap].contiguous() for x in ops)


# ---------------------------------------------------------------------------
# reverse-edge grouping
# ---------------------------------------------------------------------------

def _group_reverse_edges(sel_d, sel_p, wave_pids):
    """Group the wave's forward edges by target pid.

    Returns (utgt [E], uid_s [E], rank [E], dist [E], src [E], valid [E]),
    E = W * m0: edges sorted by (target, distance); ``uid_s`` the dense
    segment id per edge (E for invalid), numbered by segment size
    descending then target ascending; ``rank`` the edge's position in
    its segment (nearest first); ``utgt[u]`` segment u's target (-1 for
    empty slots).
    """
    w, m0 = sel_p.shape
    e = w * m0
    dev = sel_p.device
    tgt = sel_p.reshape(e)
    dist = sel_d.reshape(e)
    src = wave_pids.repeat_interleave(m0)
    valid = (tgt >= 0) & (src >= 0)

    key = torch.where(valid, tgt, _I32MAX)
    key, dist, src = sort2(key, dist, src)
    valid = key != _I32MAX
    first = torch.cat([valid[:1], (key[1:] != key[:-1]) & valid[1:]])
    uid = first.cumsum(0) - 1
    pos = torch.arange(e, device=dev)
    seg_pos = torch.where(first, pos, -1).cummax(0).values
    rank = (pos - seg_pos).to(torch.int32)

    uid_s = torch.where(valid, uid, e)                           # int64
    utgt = torch.full((e + 1,), -1, dtype=torch.int32, device=dev)
    utgt[torch.where(first, uid_s, e)] = key      # slot e takes the rest
    utgt = utgt[:e]

    # renumber segments by (size desc, target asc); empty slots last
    sizes = torch.bincount(uid_s, minlength=e + 1)[:e]
    ord_key = torch.where(utgt >= 0, -sizes, 1)
    perm = argsort2(ord_key, utgt)                               # new->old
    new_of_old = torch.empty_like(perm)
    new_of_old[perm] = torch.arange(e, device=dev)
    utgt = utgt[perm]
    uid_s = torch.where(uid_s < e, new_of_old[uid_s.clamp(max=e - 1)], e)
    return utgt, uid_s, rank, dist, src, valid


def _pend_window(utgt, uid_s, rank, dist, src, valid, pend_cap: int,
                 r: int):
    """Round ``r``'s pending additions: each target's edges with rank in
    [r*cap, (r+1)*cap), nearest first.  Targets with no addition in the
    window get utgt -1 (their rows are not touched)."""
    e = utgt.shape[0]
    dev = utgt.device
    lo = r * pend_cap
    in_win = valid & (rank >= lo) & (rank < lo + pend_cap)
    slot = torch.where(in_win, rank - lo, pend_cap).long()
    # row e / column pend_cap are the drop slots of JAX's mode="drop"
    pend_p = torch.full((e + 1, pend_cap + 1), -1, dtype=torch.int32,
                        device=dev)
    pend_d = torch.full((e + 1, pend_cap + 1), torch.inf, device=dev)
    pend_p[uid_s, slot] = src
    pend_d[uid_s, slot] = dist
    part = torch.zeros(e + 1, dtype=torch.bool, device=dev)
    part[uid_s[in_win]] = True
    return (torch.where(part[:e], utgt, -1), pend_d[:e, :pend_cap],
            pend_p[:e, :pend_cap])


# ---------------------------------------------------------------------------
# one wave: search + select, then commit
# ---------------------------------------------------------------------------

def _dedup_sorted(cd, cp):
    """Invalidate repeated pids in rows where equal pids sit side by side
    (sorted by (dist, pid) or by pid: equal pids carry equal
    distances)."""
    dup = torch.cat([torch.zeros_like(cp[:, :1], dtype=torch.bool),
                     (cp[:, 1:] == cp[:, :-1]) & (cp[:, 1:] >= 0)], dim=1)
    return torch.where(dup, torch.inf, cd), torch.where(dup, -1, cp)


def _scan_pack(q, filled: int, codes_t, sg, norms_r, efc: int):
    """K1 wave search: packed keys of the prefix, exact top-efc keys ->
    candidate pids [W, <= efc], -1 for groups with no eligible point."""
    lsub, cb = _FUSED_PACK_LSUB, _FUSED_PACK_CB
    qc, qs = quantize_batch(q)
    denom = 2.0 * qs * sg
    col = torch.arange(norms_r.shape[1], device=q.device)[None, :]
    w2 = pack_w2(norms_r, denom, col < filled, lsub=lsub, cb=cb,
                 d=q.shape[1])
    od = fused_scan_bucket_int_packed(qc, w2, codes_t, lsub=lsub, cb=cb)
    keys, nidx = torch.topk(od, min(efc, od.shape[1]), dim=1,
                            largest=False, sorted=False)
    return decode_keys(keys, nidx, lsub=lsub, cb=cb)


def _scan_bucket(q, filled: int, codes_t, scales_r, norms_r, efc: int,
                 metric_name):
    """K2 wave search (JAX construct.py:415-451): per-query int8 codes
    (cosine divides the scale by |q|), non-prefix columns +inf, exact
    top-efc group minima -> candidate pids [W, <= efc], -1 where the
    minimum is not finite."""
    col = torch.arange(norms_r.shape[1], device=q.device)[None, :]
    nm = torch.where(col < filled, norms_r, torch.inf)
    qc, qs = bucket_queries(q, metric_name)
    od, oi = fused_scan_bucket(qc, qs, codes_t, scales_r, nm,
                               lsub=_FUSED_LSUB, cb=_FUSED_CB,
                               is_dot=metric_name in ("dot", "cosine"))
    md, nidx = torch.topk(od, min(efc, od.shape[1]), dim=1, largest=False,
                          sorted=False)
    return torch.where(torch.isfinite(md), oi.gather(1, nidx), -1)


def _scan_stream(q, filled: int, codes, scales, norms, efc: int,
                 metric_name):
    """Streamed-scan wave search (JAX construct.py:461-486): the exact
    top-efc of the int8 scores of pids below ``filled``; ``codes`` may
    cover only the exact prefix."""
    from ..models.scan import scan_candidates

    npts = codes.shape[0]
    prefix = torch.arange(npts, device=q.device) < filled
    _, cand_p = scan_candidates(
        q, codes, scales, norms, prefix,
        metric_name=(metric_name if isinstance(metric_name, str)
                     else "sqeuclidean"),
        ef=efc, chunk=min(1 << 17, npts))
    return cand_p


def _beam_candidates(q, points, adj, uppers, metric, *, m: int, efc: int,
                     links: int, max_iter_factor: int, expand: int):
    """Beam wave search (JAX construct.py:487-505): from pid 0, a greedy
    descent through ``uppers`` (the snapshots completed so far, top
    first), then an ``efc``-wide beam over the pre-wave adjacency's
    first ``links`` columns.  Returns the sorted (dists, pids)."""
    w = q.shape[0]
    cur_p = torch.zeros(w, dtype=torch.int32, device=q.device)
    cur_d = metric.gathered(q, points[cur_p[:, None].long()])[:, 0]
    for up in uppers:
        cur_d, cur_p = greedy_descent(q, up, points, metric, cur_d, cur_p,
                                      links=min(m, up.shape[1]),
                                      max_iters=_GREEDY_ITERS)
    beam_d = torch.full((w, efc), torch.inf, device=q.device)
    beam_p = torch.full((w, efc), -1, dtype=torch.int32, device=q.device)
    beam_d[:, 0] = cur_d
    beam_p[:, 0] = cur_p
    beam_e = torch.zeros((w, efc), dtype=torch.bool, device=q.device)
    return beam_search_layer(q, adj, points, metric, beam_d, beam_p, beam_e,
                             links=links,
                             max_iters=max_iter_factor * efc + 16,
                             expand=expand)


def _gathered_cols(metric, q, points, ids):
    """Exact distances of ``q`` [W, D] to ``points[ids]`` [W, C] (inf for
    -1), gathered ``_HOP_CHUNK`` columns at a time."""
    parts = []
    for cs in range(0, ids.shape[1], _HOP_CHUNK):
        sub = ids[:, cs:cs + _HOP_CHUNK]
        sd = metric.gathered(q, points[sub.clamp(min=0)])
        parts.append(torch.where(sub >= 0, sd, torch.inf))
    return torch.cat(parts, 1)


def _merge_dedup_rerank(cand_d, cand_p, nd, nb, efc: int):
    """Merge hop candidates (nd, nb) into the pool, dedup by pid, and
    re-rank by (dist, pid); the first ``efc`` survive.  Equal pids carry
    equal exact distances, so which copy survives is immaterial."""
    cp = torch.cat([cand_p, nb], 1)
    cd = torch.cat([cand_d, nd], 1)
    cp, order = torch.sort(cp, dim=1, stable=True)
    cd, cp = _dedup_sorted(cd.gather(1, order), cp)
    cd, cp = sort2(cd, cp)
    return cd[:, :efc], cp[:, :efc]


def _hop_repair(q, cand_d, cand_p, adj, points, metric, hops: int):
    """Merge the graph neighbours (whole adjacency rows) of the top-
    ``hops`` candidates into the pool, with exact distances: it repairs
    candidates a scan lost (stride-group collisions, or pids outside a
    capped sample) and brings in the graph-local candidates a beam pool
    would have held (the JAX ``_hop_repair``)."""
    w, efc = cand_p.shape
    h = min(hops, efc)
    top_p = cand_p[:, :h]
    nb = adj[top_p.clamp(min=0)]                              # [W, h, m0]
    nb = torch.where((top_p >= 0)[:, :, None], nb, -1).reshape(w, -1)
    nd = _gathered_cols(metric, q, points, nb)
    return _merge_dedup_rerank(cand_d, cand_p, nd, nb, efc)


def _select(q, cand_d, cand_p, wvalid, points, adj, metric, *, m0: int,
            heuristic, links: int, efc: int, pd_dtype):
    """Forward selection (lib.rs:465-473) of each wave point's pool;
    padded lanes get -1/inf rows."""
    if heuristic is None:
        sel_d, sel_p = sel_ops.select_simple(cand_d, cand_p, m0)
    else:
        extend, keep_pruned = heuristic
        if extend:
            cand_d, cand_p = sel_ops.extend_candidates(
                q, cand_d, cand_p, adj, points, metric, links=links,
                cap=efc + m0)
        with _span("build.select"):
            sel_d, sel_p = sel_ops.select_heuristic(
                q, cand_d, cand_p, points[cand_p.clamp(min=0)], metric, m0,
                keep_pruned=keep_pruned, pd_dtype=torch_dtype(pd_dtype))
    sel_p = torch.where(wvalid[:, None], sel_p, -1)
    sel_d = torch.where(sel_p >= 0, sel_d, torch.inf)
    return sel_d, sel_p


def search_select_core(wave_pids, filled: int, points, ops, adj=None,
                       uppers=(), *, metric_name, search_mode: str,
                       efc: int, m: int, m0: int, links: int, heuristic,
                       max_iter_factor: int = 8, expand: int = 1,
                       hop_repair: int = 0, return_pool: bool = False,
                       pd_dtype="bfloat16"):
    """Wave search + forward selection (lib.rs:447-473): each wave
    point's selected forward neighbours [W, m0], -1/inf for padded
    lanes.  ``filled`` is the first pid of the wave: pids below it are
    the inserted prefix.  ``ops`` are the scan operands of
    ``search_mode`` (:func:`_quantize_for_scan` for scan_fused,
    :func:`_flat_operands` for scan, None for beam); ``adj`` [N+1, m0]
    is read by beam, hop repair and ``extend_candidates``, ``uppers`` by
    beam; ``links`` caps the columns of ``adj`` a walk or an extension
    reads (m0 at layer 0, m above).  ``return_pool`` returns the
    reranked, peer-merged pool instead of selecting
    (:func:`repair_commit_core` selects)."""
    metric = resolve(metric_name)
    w = wave_pids.shape[0]
    wvalid = wave_pids >= 0
    q = points[wave_pids.clamp(min=0)]                          # [W, D]

    if search_mode.startswith("scan"):
        with _span("build.scan"):
            if search_mode == "scan":
                cand_p = _scan_stream(q, filled, *ops, efc, metric_name)
            elif _use_pack(metric_name, q.shape[1]):
                cand_p = _scan_pack(q, filled, *ops, efc)
            else:
                cand_p = _scan_bucket(q, filled, *ops, efc, metric_name)
        if search_mode == "scan_fused" and cand_p.shape[1] < efc:
            cand_p = torch.nn.functional.pad(
                cand_p, (0, efc - cand_p.shape[1]), value=-1)
        # exact rerank: selection runs on true distances
        cand_d = metric.gathered(q, points[cand_p.clamp(min=0)])
        cand_d = torch.where(cand_p >= 0, cand_d, torch.inf)
        cand_d, cand_p = sort2(cand_d, cand_p)
        if hop_repair > 0:
            cand_d, cand_p = _hop_repair(q, cand_d, cand_p, adj, points,
                                         metric, hop_repair)
    else:
        with _span("build.beam"):
            cand_d, cand_p = _beam_candidates(
                q, points, adj, uppers, metric, m=m, efc=efc, links=links,
                max_iter_factor=max_iter_factor, expand=expand)

    # --- intra-wave visibility: merge each point's nearest wave peers --
    if w > 1:
        pw = metric.pairwise(q, q)                              # [W, W]
        eye = torch.eye(w, dtype=torch.bool, device=q.device)
        bad = eye | ~wvalid[None, :] | ~wvalid[:, None]
        pw = torch.where(bad, torch.inf, pw)
        peer_d, pidx = torch.topk(pw, min(m0, w), dim=1, largest=False)
        peer_p = torch.where(torch.isfinite(peer_d), wave_pids[pidx], -1)
        cand_d, cand_p = sort2(torch.cat([cand_d, peer_d], 1),
                               torch.cat([cand_p, peer_p], 1))
        cand_d, cand_p = cand_d[:, :efc], cand_p[:, :efc]

    if return_pool:
        cand_p = torch.where(wvalid[:, None], cand_p, -1)
        return torch.where(cand_p >= 0, cand_d, torch.inf), cand_p
    return _select(q, cand_d, cand_p, wvalid, points, adj, metric, m0=m0,
                   heuristic=heuristic, links=links, efc=efc,
                   pd_dtype=pd_dtype)


def repair_commit_core(adj, adjd, wave_pids, points, cand_d, cand_p, *,
                       metric_name, m0: int, heuristic, pend_cap: int,
                       rev_rounds: int = 0, pd_dtype="bfloat16",
                       hops: int = 16):
    """Graph-hop pool repair, Alg. 3/4 selection and the commit of a
    sampled wave (JAX construct.py:725-789): ``cand_d``/``cand_p`` are
    the wave's peer-merged pool (``search_select_core(return_pool=
    True)``); the neighbours of its top ``hops`` candidates in the
    pre-wave graph join it before selection.  ``extend_candidates``
    never runs here (such builds do not split)."""
    metric = resolve(metric_name)
    q = points[wave_pids.clamp(min=0)]
    if min(hops, cand_p.shape[1]) > 0:
        cand_d, cand_p = _hop_repair(q, cand_d, cand_p, adj, points, metric,
                                     hops)
    sel_d, sel_p = _select(
        q, cand_d, cand_p, wave_pids >= 0, points, adj, metric, m0=m0,
        heuristic=heuristic, links=m0, efc=cand_p.shape[1], pd_dtype=pd_dtype)
    return commit_core(adj, adjd, wave_pids, points, sel_d, sel_p,
                       metric_name=metric_name, m0=m0, heuristic=heuristic,
                       pend_cap=pend_cap, rev_rounds=rev_rounds,
                       pd_dtype=pd_dtype)


def commit_core(adj, adjd, wave_pids, points, sel_d, sel_p, *,
                metric_name, m0: int, heuristic, pend_cap: int,
                rev_rounds: int = 0, pd_dtype="bfloat16"):
    """Commit one wave's selected edges in place: forward rows, then the
    grouped reverse re-selection (lib.rs:481-517).  ``adj``/``adjd`` are
    [N+1, m0] (row N is the padded-lane sink).  Returns the number of
    reverse-edge additions dropped by an explicit ``rev_rounds`` cap, as
    a 0-d tensor."""
    metric = resolve(metric_name)
    n = adj.shape[0] - 1
    w = wave_pids.shape[0]

    # --- forward rows (node.set(i, pid), lib.rs:516); padded lanes all
    # write the sink row, whose content is never read ------------------
    rows = torch.where(wave_pids >= 0, wave_pids, n)
    adj[rows] = sel_p
    adjd[rows] = sel_d.to(adjd.dtype)

    # --- reverse edges, in nearest-first rounds of pend_cap per target -
    utgt, uid_s, rank, gdist, gsrc, gvalid = _group_reverse_edges(
        sel_d, sel_p, wave_pids)
    max_rounds = rev_rounds if rev_rounds else -(-w // pend_cap)
    n_dropped = (gvalid & (rank >= max_rounds * pend_cap)).sum()

    def reselect(ut, pend_d, pend_p):
        ut_c = ut.clamp(min=0)
        row_p = adj[ut_c]
        row_d = torch.where(row_p >= 0, adjd[ut_c].float(), torch.inf)
        comb_p = torch.cat([row_p, pend_p], 1)
        comb_d = torch.cat([row_d, torch.where(pend_p >= 0, pend_d,
                                               torch.inf)], 1)
        comb_p = torch.where(torch.isfinite(comb_d), comb_p, -1)
        # the whole row + pending union goes to selection (see the JAX
        # commit_core); a wave point may both select and be selected by
        # a peer, so dedup first
        cd, cp = sort2(*_dedup_sorted(*sort2(comb_d, comb_p)))
        if heuristic is None:
            return sel_ops.select_simple(cd, cp, m0)
        return sel_ops.select_heuristic(
            points[ut_c], cd, cp, points[cp.clamp(min=0)], metric, m0,
            keep_pruned=heuristic[1], pd_dtype=torch_dtype(pd_dtype))

    for r in range(max_rounds):
        if not bool((gvalid & (rank >= r * pend_cap)).any()):
            break
        ut_r, pend_d, pend_p = _pend_window(
            utgt, uid_s, rank, gdist, gsrc, gvalid, pend_cap, r)
        # this round's participants are the dense uid prefix [0, n_part)
        n_part = int(torch.where(gvalid & (rank >= r * pend_cap),
                                 uid_s + 1, 0).max())
        for lo in range(0, n_part, _REV_CHUNK):
            hi = min(lo + _REV_CHUNK, n_part)
            ut = ut_r[lo:hi]
            new_d, new_p = reselect(ut, pend_d[lo:hi], pend_p[lo:hi])
            # chunks touch disjoint target rows
            trows = torch.where(ut >= 0, ut, n)
            adj[trows] = new_p
            adjd[trows] = new_d.to(adjd.dtype)
    return n_dropped


# ---------------------------------------------------------------------------
# host-side build loop
# ---------------------------------------------------------------------------

def _warn_reverse_drops(n_dropped: int, pend_cap: int,
                        rev_rounds: int = 1) -> None:
    if n_dropped > 0:
        import warnings

        warnings.warn(
            f"{n_dropped} reverse-edge additions exceeded the per-wave "
            f"commit capacity pend_cap*rev_rounds={pend_cap}*{rev_rounds} "
            "and were dropped (the farthest per target).  Consider raising "
            "Config(rev_rounds=...) or lowering wave_size.", stacklevel=3)


def _insert_wave(adj, adjd, wave, s: int, points, uppers, ops, flat_ops,
                 plan: _Plan, links: int):
    """Search, select and commit one wave of pids (``wave``, -1 padded,
    lowest pid ``s`` in lane 0) in place; returns the reverse-edge
    additions dropped, as a 0-d tensor."""
    if (plan.search_mode == "scan_fused" and flat_ops is not None
            and s < plan.exact_prefix):
        mode_w, wops = "scan", flat_ops
    else:
        mode_w, wops = plan.search_mode, ops
    scan = mode_w.startswith("scan")
    common = dict(metric_name=plan.metric_name, m0=plan.m0,
                  heuristic=plan.heuristic, pd_dtype=plan.pd_dtype)
    search = dict(common, search_mode=mode_w,
                  efc=plan.efc_scan if scan else plan.efc_beam,
                  m=plan.m, links=links,
                  max_iter_factor=plan.max_iter_factor, expand=plan.expand)
    commit = dict(common, pend_cap=plan.pend_cap, rev_rounds=plan.rev_rounds)
    if plan.split and plan.sampling and scan:
        # the JAX split programs' order: pool first, repair in the commit
        with _span("build.search_select"):
            pool_d, pool_p = search_select_core(
                wave, s, points, wops, adj, uppers, return_pool=True,
                **search)
        with _span("build.commit"):
            return repair_commit_core(adj, adjd, wave, points, pool_d,
                                      pool_p, hops=plan.sample_hops,
                                      **commit)
    hop = (max(plan.hop, plan.sample_hops) if plan.sampling and scan
           else plan.hop)
    with _span("build.search_select"):
        sel_d, sel_p = search_select_core(wave, s, points, wops, adj, uppers,
                                          hop_repair=hop, **search)
    with _span("build.commit"):
        return commit_core(adj, adjd, wave, points, sel_d, sel_p, **commit)


def _wave_of(s: int, e: int, cap: int, dev):
    wave = np.full(_bucket(e - s, cap), -1, np.int32)
    wave[:e - s] = np.arange(s, e, dtype=np.int32)
    return torch.as_tensor(wave, device=dev)


class _WaveGraph:
    """One graph's wave-loop state: its points in pid order and their scan
    operands, the adjacency [N+1, m0] and distance cache (row N is the
    padded-lane sink, both updated in place), the upper snapshots
    completed so far (top first) and the reverse-edge drops (a 0-d
    tensor).  ``real`` (bool [N] or None) marks the rows that are points:
    a padded shard's pad rows, last in its pid order, are not."""

    def __init__(self, pts, ops, flat_ops, adj, adjd, drops, layers=(),
                 real=None):
        self.pts, self.ops, self.flat_ops = pts, ops, flat_ops
        self.adj, self.adjd, self.drops = adj, adjd, drops
        self.layers = list(layers)
        self.real = real

    def insert(self, s: int, e: int, cap: int, plan: _Plan, links: int):
        """Insert the wave of pids [s, e) (``cap`` lanes at most); a row
        that is not ``real`` gets a -1 lane, so it selects nothing and
        nothing selects it."""
        wave = _wave_of(s, e, cap, self.pts.device)
        if self.real is not None:
            wave = torch.where(self.real[wave.clamp(min=0)], wave, -1)
        self.drops += _insert_wave(
            self.adj, self.adjd, wave, s, self.pts, self.layers, self.ops,
            self.flat_ops, plan, links)


def _run_waves(graphs, plan: _Plan, ranges, wave_size: int, *,
               resume=(-1, -1), progress=None, total: int = 0,
               weight: int = 1, save=None, save_every: int = 64) -> None:
    """The layer-by-layer wave schedule over ``graphs`` in lockstep: each
    wave is inserted into every graph before the next one starts, and
    each layer's snapshot is taken from every graph when it completes.
    Waves up to ``resume`` = (layer index, first pid) were inserted
    before (a checkpoint's state).  ``progress(done, total, phase)``
    counts ``weight`` points for each point of a wave, and ``save(li,
    s)`` runs after every ``save_every`` waves."""
    m, m0 = plan.m, plan.m0
    done = waves = 0
    for li, (layer, start, end) in enumerate(ranges):
        links = m0 if layer == 0 else m
        for s, e in _wave_schedule(start, end, wave_size):
            done += (e - s) * weight
            if (li, s) <= resume:
                continue           # inserted in the checkpointed state
            for g in graphs:
                g.insert(s, e, wave_size, plan, links)
            waves += 1
            if progress is not None:
                progress(done, total, f"layer {layer}")
            if save is not None and waves % save_every == 0:
                save(li, s)
        if layer > 0 and li >= resume[0]:
            for g in graphs:
                g.layers.append(g.adj[:end, :m].clone())


class BuiltGraph:
    """Result of construction: the dense tensors an index is made of."""

    def __init__(self, points, zero, layers, ids, config,
                 reverse_drops: int = 0):
        self.points = points      # [N, D] f32, pid order
        self.zero = zero          # [N, m0] int32
        self.layers = layers      # layers[l-1] = level l, [end_l, m]
        self.ids = ids            # np [N]: original index -> pid
        self.config = config
        #: Reverse-edge additions lost to an explicit rev_rounds cap.
        self.reverse_drops = reverse_drops


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_key(cfg, plan: _Plan, n: int, d: int) -> str:
    """The JAX package's v8 key (construct.py:1395-1406) with the
    lane-packed adjacency's factor fixed at 1.  A sampled build's key
    also carries the split flag, since the flag decides where the
    repair runs and so the graph (the JAX key leaves it out)."""
    key = (f"v8:{n}:{d}:{cfg.ef_construction}:{plan.m}:{cfg.ml}:"
           f"{plan.heuristic}:{cfg.wave_size}:{plan.pend_cap}:"
           f"{plan.rev_rounds}:{plan.max_iter_factor}:{plan.expand}:"
           f"{plan.search_mode}:{plan.pd_dtype}:{plan.exact_prefix}:"
           f"{plan.hop}:{_pool_of(cfg, plan.search_mode)}:1:"
           f"{cfg.dist_cache_dtype}")
    if plan.sampling:
        key += (f":sc{plan.sample_cols}:sh{plan.sample_hops}"
                f":split{int(plan.split)}")
    return key


def _pack_factor(m: int) -> int:
    """Rows of m ids per 128-id row of the checkpoint's ``stacked``
    field (the JAX package's lane-packed snapshot buffer)."""
    return 128 // m if m <= 128 and 128 % m == 0 else 1


def _load_ckpt(path: str, key: str, seed):
    """The state saved at ``path`` when its key matches and its seed
    matches ``seed`` (None adopts the stored one), else None."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if (str(z["key"]) != key or "seed" not in z.files
                or (seed is not None and int(z["seed"]) != seed)):
            return None
        adjd = z["adjd"]
        # bfloat16 is stored bit-viewed as uint16 with a dtype tag
        want = (str(z["adjd_dtype"]) if "adjd_dtype" in z.files
                else None)
        return dict(seed=int(z["seed"]), adj=z["adj"], adjd=adjd,
                    adjd_dtype=want, stacked=z["stacked"],
                    offsets=z["offsets"].copy(), li=int(z["li"]),
                    s=int(z["s"]),
                    drops=int(z["drops"]) if "drops" in z.files else 0)


def _adjd_from(arr, tag, dtype, dev):
    """A saved distance cache back as a tensor of ``dtype``."""
    if dtype == torch.bfloat16:
        if tag not in (None, "bfloat16") or arr.dtype.itemsize != 2:
            raise ValueError(f"checkpoint cache dtype {tag} is not bfloat16")
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(
                torch.bfloat16).to(dev)
    return torch.from_numpy(np.asarray(arr)).to(dev, dtype)


def _stacked_of(layers, sizes, m: int):
    """The JAX package's lane-packed snapshot buffer of the upper
    snapshots so far: ``(stacked [rows / pack, m * pack], offsets [16],
    write_off)``, each snapshot at ``offsets[li]`` rows padded to the
    pack factor."""
    pack = _pack_factor(m)

    def pal(x):
        return -(-x // pack) * pack

    cap_rows = max(pack, sum(pal(c) for _, c in sizes[:-1]))
    stacked = np.full((cap_rows, m), -1, np.int32)
    offsets = np.zeros(16, np.int32)
    write_off = 0
    for i, snap in enumerate(layers):
        stacked[write_off:write_off + snap.shape[0]] = snap.cpu().numpy()
        offsets[i] = write_off
        write_off += pal(snap.shape[0])
    return stacked.reshape(cap_rows // pack, m * pack), offsets, write_off


def _adjd_np(adjd):
    """A distance cache as numpy and its dtype tag (bfloat16 bit-viewed
    as uint16)."""
    if adjd.dtype == torch.bfloat16:
        return adjd.view(torch.int16).cpu().numpy().view(np.uint16), \
            "bfloat16"
    adjd_np = adjd.cpu().numpy()
    return adjd_np, str(adjd_np.dtype)


def _save_ckpt(path: str, key: str, seed: int, adj, adjd, layers, sizes,
               m: int, li: int, s: int, drops) -> None:
    """Write the wave state (adjacency, distance cache, the upper
    snapshots so far, the last wave's coordinates) in the JAX package's
    npz fields (:func:`_stacked_of`)."""
    stacked, offsets, write_off = _stacked_of(layers, sizes, m)
    adjd_np, tag = _adjd_np(adjd)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, key=np.array(key), seed=np.uint64(seed),
                 adj=adj.cpu().numpy(), adjd=adjd_np,
                 adjd_dtype=np.array(tag), stacked=stacked,
                 offsets=offsets, write_off=write_off, li=li, s=s,
                 drops=int(drops))
    os.replace(tmp, path)


def _snapshots_from(state, ranges, m: int, dev):
    """The upper snapshots of the layers a checkpoint completed (those
    before its wave's layer), top first."""
    flat = state["stacked"].reshape(-1, m)
    out = []
    for li in range(state["li"]):
        end = ranges[li][2]
        off = int(state["offsets"][li])
        out.append(torch.from_numpy(flat[off:off + end].copy()).to(dev))
    return out


def build_graph(points, config: Config, progress=None, device=None,
                checkpoint: Optional[str] = None,
                checkpoint_every: int = 64) -> BuiltGraph:
    """Build the layered graph with batched insertion waves.

    Reproduces the reference's schedule (``Hnsw::new``, lib.rs:209-345):
    geometric layer sizing, seeded shuffle into pid order, per-layer
    insertion ranges (point 0 is the entry and never inserted) and
    post-layer truncated snapshots.  The build runs on ``points``'
    device (a tensor) or on ``device`` (numpy input; the CUDA card by
    default, and without one it raises).

    ``checkpoint``: a path where the wave state is saved every
    ``checkpoint_every`` waves, and resumed from when a build with the
    same key finds it (an explicit seed must match too; a ``None`` seed
    adopts the stored one).  The file is removed when the build ends.
    """
    cfg = config
    if isinstance(points, torch.Tensor):
        dev = points.device
        pts_in = points.float()
    else:
        dev = default_device(device)
        pts_in = np.asarray(points, np.float32)
    n = pts_in.shape[0]
    m, m0 = cfg.m, cfg.m0
    if n == 0:
        d = pts_in.shape[1] if pts_in.ndim == 2 else 0
        return BuiltGraph(torch.zeros((0, d), device=dev),
                          torch.full((0, m0), -1, dtype=torch.int32,
                                     device=dev),
                          [], np.zeros(0, np.int32), cfg)
    if n >= 2**31:
        raise ValueError("point count must fit in int32")
    d = pts_in.shape[1]
    plan = _plan_of(cfg, n, d)

    key = _ckpt_key(cfg, plan, n, d)
    state = (None if checkpoint is None
             else _load_ckpt(checkpoint, key, cfg.seed))
    seed = resolve_seed(cfg.seed if state is None else state["seed"])

    # random layer assignment via shuffle-sort (lib.rs:256-270), verbatim
    # from the JAX package so both insert the same points in the same waves
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n, size=n)
    order = np.lexsort((np.arange(n), keys))
    ids = np.empty(n, np.int32)
    ids[order] = np.arange(n, dtype=np.int32)
    if isinstance(pts_in, torch.Tensor):
        pts = pts_in[torch.as_tensor(order, device=dev)].contiguous()
    else:
        pts = torch.as_tensor(pts_in[order], device=dev)

    sizes = layer_sizes(n, cfg.ml, m)
    top = len(sizes) - 1
    if top > 16:
        raise ValueError("more than 16 upper layers (n too large for ml)")
    ranges = [(top - i, max(c - s, 1), c) for i, (s, c) in enumerate(sizes)]

    ops, flat_ops = _scan_operands(pts, plan)
    if plan.sampling:
        ops = _cap_scan_ops(ops, plan, d)
    cache_dtype = torch_dtype(cfg.dist_cache_dtype)
    layers = []                                 # top first while building
    resume = (-1, -1)
    if state is None:
        adj = torch.full((n + 1, m0), -1, dtype=torch.int32, device=dev)
        adjd = torch.full((n + 1, m0), torch.inf, device=dev,
                          dtype=cache_dtype)
        drops = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        adj = torch.from_numpy(state["adj"]).to(dev)
        adjd = _adjd_from(state["adjd"], state["adjd_dtype"], cache_dtype,
                          dev)
        drops = torch.tensor(state["drops"], dtype=torch.int64, device=dev)
        layers = _snapshots_from(state, ranges, m, dev)
        resume = (state["li"], state["s"])
    del state
    g = _WaveGraph(pts, ops, flat_ops, adj, adjd, drops, layers)
    save = None
    if checkpoint is not None:
        def save(li, s):
            with _span("build.checkpoint"):
                _save_ckpt(checkpoint, key, seed, g.adj, g.adjd, g.layers,
                           sizes, m, li, s, g.drops)
    _run_waves([g], plan, ranges, cfg.wave_size, resume=resume,
               progress=progress, total=n, save=save,
               save_every=checkpoint_every)
    if checkpoint is not None and os.path.exists(checkpoint):
        os.remove(checkpoint)     # build complete
    layers = g.layers[::-1]  # as the reference stores them: layers[l-1] = l
    reverse_drops = int(g.drops)
    _warn_reverse_drops(reverse_drops, plan.pend_cap, plan.rev_rounds)
    return BuiltGraph(pts, adj[:n], layers, ids, cfg,
                      reverse_drops=reverse_drops)


# ---------------------------------------------------------------------------
# incremental insertion
# ---------------------------------------------------------------------------

def _recompute_adjd(points, adj, metric_name, dtype, chunk: int = 16384):
    """The neighbour-distance cache ``adjd[i, j] = d(p_i, adj[i, j])``
    (inf for -1) of an existing graph, ``chunk`` rows at a time: an add
    to an index whose build-time cache is gone (a loaded or freshly
    built index) starts here."""
    metric = resolve(metric_name)
    outs = []
    for s in range(0, adj.shape[0], chunk):
        rows = adj[s:s + chunk]
        dd = metric.gathered(points[s:s + rows.shape[0]],
                             points[rows.clamp(min=0)])
        outs.append(torch.where(rows >= 0, dd, torch.inf).to(dtype))
    if not outs:
        return torch.zeros((0, adj.shape[1]), dtype=dtype,
                           device=adj.device)
    return torch.cat(outs)


def extend_graph(points, zero, layers, new_points, config: Config,
                 adjd=None, progress=None):
    """Insert ``new_points`` [A, D] at layer 0 of an existing graph
    (``points`` [N, D], ``zero`` [N, m0], ``layers`` as stored) with the
    build's wave recipe against the frozen upper layers (the JAX
    ``extend_graph``): new pids N..N+A-1, in order.  ``adjd`` is the
    distance cache of an earlier add (None: recomputed).

    Returns ``(points [N+A, D] f32, zero [N+A, m0], adjd [N+A+1, m0],
    reverse_drops)``, all new tensors: nothing passed in is written,
    so objects sharing the old tensors keep their snapshot.
    """
    cfg = config
    m0 = cfg.m0
    dev = zero.device
    new_pts = new_points.to(dev, torch.float32)
    n_old = zero.shape[0]
    a = new_pts.shape[0]
    n_total = n_old + a
    if n_old == 0:
        raise ValueError("cannot add to an empty index; use build()")
    if n_total >= 2**31:
        raise ValueError("point count must fit in int32")

    all_pts = torch.cat([points.to(dev, torch.float32), new_pts])
    adj = torch.cat([zero.to(torch.int32),
                     torch.full((a + 1, m0), -1, dtype=torch.int32,
                                device=dev)])
    cache_dtype = torch_dtype(cfg.dist_cache_dtype)
    if adjd is not None and adjd.shape[0] >= n_old:
        old_d = adjd[:n_old].to(cache_dtype)
    else:
        old_d = _recompute_adjd(all_pts, adj[:n_old], cfg.metric,
                                cache_dtype)
    adjd = torch.cat([old_d, torch.full((a + 1, m0), torch.inf,
                                        dtype=cache_dtype, device=dev)])
    uppers = [l.to(dev, torch.int32) for l in reversed(layers)]
    plan = _plan_of(cfg, n_total, all_pts.shape[1], allow_split=False)
    ops, flat_ops = _scan_operands(all_pts, plan)
    if plan.sampling:
        # pids [0, cap) of the original build are a uniform sample (its
        # insertion order was a seeded shuffle)
        ops = _cap_scan_ops(ops, plan, all_pts.shape[1])
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    done = 0
    for s, e in _wave_schedule(n_old, n_total, cfg.wave_size):
        drops += _insert_wave(adj, adjd, _wave_of(s, e, cfg.wave_size, dev),
                              s, all_pts, uppers, ops, flat_ops, plan, m0)
        done += e - s
        if progress is not None:
            progress(done, a, "add")
    reverse_drops = int(drops)
    _warn_reverse_drops(reverse_drops, plan.pend_cap, plan.rev_rounds)
    return all_pts, adj[:n_total], adjd, reverse_drops
