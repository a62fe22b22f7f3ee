"""Wave-based batched HNSW construction, scan-fused route (port of
``instant_distance_tpu/ops/construct.py``).

Points are inserted layer by layer in waves of doubling size (up to
``Config.wave_size``).  Each wave:

1. finds its candidates with an int8 scan of the inserted prefix and an
   exact f32 rerank (``search_select_core``): the packed-key kernel K1
   for L2 metrics with D * 64 <= 16384, the bucket kernel K2 (per-point
   scales, f32 epilogue) for dot/cosine and wider points
   (``ops/scan_kernel.py``), then the exact top pool;
2. merges each point's nearest same-wave peers (the batched stand-in for
   sequential insertion order);
3. selects forward neighbours (Alg. 3/4, ``ops/select.py``);
4. commits forward rows and re-selects every reverse-edge target's row
   in nearest-first rounds of ``pend_cap`` additions (``commit_core``),
   lossless by default.

Insertion order and layer assignment come from the JAX package's numpy
code, verbatim, so a port build and a reference build with the same
seed insert the same points in the same waves.  The adjacency is
[N+1, m0] with row N a write sink for padded wave lanes, updated in
place.

Not ported yet (each raises NotImplementedError; ROADMAP.md §1 item 5):
beam and streamed-scan wave search (and so callable metrics), the
exact-prefix hybrid, sampled scans with hop repair,
``extend_candidates``, checkpoints and ``extend_graph``.  The 16 GB-chip
workarounds of the JAX build (split search/commit programs, lane-packed
adjacency, ``dispatch_sync_every``, 4M-column scan chunks, 128-lane
point padding) are left out: the H100 holds the whole wave state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, layer_sizes, resolve_seed
from ..utils.convert import default_device
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


def _pool_of(cfg) -> int:
    """Scan-mode candidate pool: ``construct_pool`` or 3 * ef_construction
    (pool depth is nearly free for the scan; see the JAX ``_pool_of``)."""
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


def _check_supported(cfg, search_mode: str, n: int) -> None:
    todo = "is not ported yet (ROADMAP.md §1 item 5)"
    if search_mode != "scan_fused":
        raise NotImplementedError(
            f"construct_mode resolving to {search_mode!r} {todo}; only the "
            "scan_fused route runs")
    if cfg.construct_exact_prefix:
        raise NotImplementedError(f"construct_exact_prefix {todo}")
    if cfg.construct_sample_cols is not None and cfg.construct_sample_cols < n:
        raise NotImplementedError(f"construct_sample_cols {todo}")
    if cfg.construct_hop_repair > 0:
        raise NotImplementedError(f"construct_hop_repair {todo}")
    if cfg.heuristic is not None and cfg.heuristic.extend_candidates:
        raise NotImplementedError(f"Heuristic(extend_candidates=True) {todo}")


def _quantize_for_scan(points, metric_name):
    """Wave-search operands over the build's points (pid order), in the
    JAX ``_quantize_for_scan(fused=True)``'s order ``(codes_t, scales,
    norms_r)``: for the packed-key kernel ONE global scale ``sg``
    (:func:`pack_operands`), for K2 per-point scales [1, Npad] with the
    metric's norms (:func:`bucket_operands`)."""
    if _use_pack(metric_name, points.shape[1]):
        codes_t, norms_r, sg = pack_operands(points, _FUSED_PACK_CB)
        return codes_t, sg, norms_r
    codes, scales = quantize_points(points)
    deq = codes.float() * scales[:, None]
    variant = ("l2" if metric_name in ("sqeuclidean", "euclidean")
               else metric_name)
    return bucket_operands(codes, scales, (deq * deq).sum(1), _FUSED_CB,
                           variant)


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
    """Invalidate repeated pids in (dist, pid)-sorted rows: equal pids
    carry equal distances, so they sit side by side."""
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


def search_select_core(wave_pids, filled: int, points, codes_t, scales,
                       norms_r, *, metric_name, efc: int, m0: int,
                       heuristic, pd_dtype="bfloat16"):
    """Wave search + forward selection (lib.rs:447-473): each wave
    point's selected forward neighbours [W, m0], -1/inf for padded
    lanes.  ``filled`` is the first pid of the wave: pids below it are
    the inserted prefix the scan may return.  ``codes_t, scales,
    norms_r`` are :func:`_quantize_for_scan` of ``points``."""
    metric = resolve(metric_name)
    w = wave_pids.shape[0]
    wvalid = wave_pids >= 0
    q = points[wave_pids.clamp(min=0)]                          # [W, D]

    # --- int8 scan of the prefix, exact top pool -----------------------
    with _span("build.scan"):
        if _use_pack(metric_name, q.shape[1]):
            cand_p = _scan_pack(q, filled, codes_t, scales, norms_r, efc)
        else:
            cand_p = _scan_bucket(q, filled, codes_t, scales, norms_r, efc,
                                  metric_name)
    k_sel = cand_p.shape[1]
    if k_sel < efc:
        cand_p = torch.nn.functional.pad(cand_p, (0, efc - k_sel), value=-1)
    # exact rerank: selection runs on true distances
    cand_d = metric.gathered(q, points[cand_p.clamp(min=0)])
    cand_d = torch.where(cand_p >= 0, cand_d, torch.inf)
    cand_d, cand_p = sort2(cand_d, cand_p)

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

    # --- forward selection (lib.rs:465-473) ----------------------------
    if heuristic is None:
        sel_d, sel_p = sel_ops.select_simple(cand_d, cand_p, m0)
    else:
        with _span("build.select"):
            sel_d, sel_p = sel_ops.select_heuristic(
                q, cand_d, cand_p, points[cand_p.clamp(min=0)], metric, m0,
                keep_pruned=heuristic[1], pd_dtype=torch_dtype(pd_dtype))
    sel_p = torch.where(wvalid[:, None], sel_p, -1)
    sel_d = torch.where(sel_p >= 0, sel_d, torch.inf)
    return sel_d, sel_p


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


def build_graph(points, config: Config, progress=None,
                device=None) -> BuiltGraph:
    """Build the layered graph with batched insertion waves.

    Reproduces the reference's schedule (``Hnsw::new``, lib.rs:209-345):
    geometric layer sizing, seeded shuffle into pid order, per-layer
    insertion ranges (point 0 is the entry and never inserted) and
    post-layer truncated snapshots.  The build runs on ``points``'
    device (a tensor) or on ``device`` (numpy input; the CUDA card by
    default, and without one it raises).
    """
    cfg = config
    metric_name = cfg.metric
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

    search_mode = _resolve_search_mode(cfg, metric_name)
    _check_supported(cfg, search_mode, n)
    heur = (None if cfg.heuristic is None else
            (cfg.heuristic.extend_candidates, cfg.heuristic.keep_pruned))
    pend_cap, rev_rounds = _rev_params(cfg, m0)
    efc = _pool_of(cfg)
    pd_dtype = cfg.select_pd_dtype
    seed = resolve_seed(cfg.seed)

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
    ranges = [(top - i, max(c - s, 1), c) for i, (s, c) in enumerate(sizes)]

    scan_ops = _quantize_for_scan(pts, metric_name)
    adj = torch.full((n + 1, m0), -1, dtype=torch.int32, device=dev)
    adjd = torch.full((n + 1, m0), torch.inf, device=dev,
                      dtype=torch_dtype(cfg.dist_cache_dtype))
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    layers = []
    done = 0
    for layer, start, end in ranges:
        for s, e in _wave_schedule(start, end, cfg.wave_size):
            wave = np.full(_bucket(e - s, cfg.wave_size), -1, np.int32)
            wave[:e - s] = np.arange(s, e, dtype=np.int32)
            wave = torch.as_tensor(wave, device=dev)
            with _span("build.search_select"):
                sel_d, sel_p = search_select_core(
                    wave, s, pts, *scan_ops,
                    metric_name=metric_name, efc=efc, m0=m0,
                    heuristic=heur, pd_dtype=pd_dtype)
            with _span("build.commit"):
                drops += commit_core(
                    adj, adjd, wave, pts, sel_d, sel_p,
                    metric_name=metric_name, m0=m0, heuristic=heur,
                    pend_cap=pend_cap, rev_rounds=rev_rounds,
                    pd_dtype=pd_dtype)
            done += e - s
            if progress is not None:
                progress(done, n, f"layer {layer}")
        if layer > 0:
            layers.append(adj[:end, :m].clone())
    layers.reverse()  # as the reference stores them: layers[l-1] = level l
    reverse_drops = int(drops)
    _warn_reverse_drops(reverse_drops, pend_cap, rev_rounds)
    return BuiltGraph(pts, adj[:n], layers, ids, cfg,
                      reverse_drops=reverse_drops)
