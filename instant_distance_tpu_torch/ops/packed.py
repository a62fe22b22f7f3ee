"""Packed (inline-quantized) traversal, the serving layout (port of
``instant_distance_tpu/ops/packed.py``).

Each node's row carries its neighbours' int8-quantized vectors inline:

    codes [N, K, D] int8,  scales [N, K] f32,  ids [N, K] int32

so one expansion reads ONE contiguous row of K * D bytes instead of K
scattered point rows.  Traversal runs on approximate (dequantized)
distances; the final beam is reranked with exact f32 distances.  The
memory cost is K * D bytes per node (1M x 128 at K = 64: ~8.2 GB).
The approximate distance sums its D terms in the walk kernel's order
(:func:`approx_dists`), so both routes score a neighbour bit for bit
alike.

The functions here are the plain-op route (``PackedHnsw.search_batch``);
the zero-layer walk of ``search_batch_kernel`` is kernel K4
(``ops/walk_kernel.py``).  ``lax.while_loop`` becomes a Python loop whose
``any``/``all`` condition is one device-to-host read per step, as in
``ops/beam.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .beam import chosen_slots, mask_eligible
from .distance import Metric
from .sort import sort2

_I32MAX = np.iinfo(np.int32).max
#: Lanes of one warp and the d values a lane reads at once, which fix
#: the order of :func:`approx_dists`' sum.
_LANES, _VEC = 32, 4


def quantize_points(points):
    """Per-point symmetric int8: v ~= scale * code (max-abs scaling)."""
    points = points.float()
    amax = points.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(points / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def pack_layer(adj, codes, scales, links: int = 0, chunk: int = 1 << 16):
    """Inline a layer's neighbour vectors: adj [R, K] -> (adj, codes
    [R, K, D], scales [R, K]).  An invalid slot (-1) gets point 0's codes
    and scale 0, so its dequantized vector is zero (and it is masked at
    search), as in the JAX package.

    ``links`` > 0 packs only the first ``links`` neighbours of each row
    (selection order puts the kept, nearest neighbours first).  Rows are
    gathered ``chunk`` at a time straight into the output, so the only
    transient is one chunk's index row.
    """
    if links and links < adj.shape[1]:
        adj = adj[:, :links].contiguous()
    r, k = adj.shape
    d = codes.shape[1]
    out_c = torch.empty((r, k, d), dtype=torch.int8, device=codes.device)
    out_s = torch.empty((r, k), dtype=torch.float32, device=codes.device)
    for s in range(0, r, chunk):
        rows = adj[s:s + chunk]
        safe = rows.clamp(min=0).reshape(-1).long()
        torch.index_select(codes, 0, safe, out=out_c[s:s + chunk].view(-1, d))
        out_s[s:s + chunk] = torch.where(rows >= 0,
                                         scales[safe].view(rows.shape), 0.0)
    return adj, out_c, out_s


def approx_dists(q, codes, scales):
    """[B, D] f32 x ([B, C, D] int8, [B, C] f32) -> [B, C] squared L2 to
    the dequantized vectors, each step rounded in the JAX order
    (``deq = code * scale``, ``diff = q - deq``, ``diff * diff``) and
    the D terms summed in the walk kernel's fixed order (lane ``l`` of 32
    sums ``d = 128 i + 4 l + c`` in (i, c) order, then a butterfly folds
    lanes 16, 8, 4, 2, 1), so the plain ops and kernel K4 agree bit for
    bit.  Terms past D are zeros, which add exactly 0."""
    b, c, d = codes.shape
    step = _LANES * _VEC
    dp = -(-d // step) * step
    deq = codes.float() * scales[..., None]
    diff = q[:, None, :] - deq
    sq = torch.nn.functional.pad(diff * diff, (0, dp - d))
    sq = sq.view(b, c, dp // step, _LANES, _VEC)
    acc = torch.zeros((b, c, _LANES), device=q.device)
    for i in range(dp // step):
        for v in range(_VEC):
            acc = acc + sq[:, :, i, :, v]
    w = _LANES // 2
    while w:
        acc = acc[..., :w] + acc[..., w:2 * w]
        w //= 2
    return acc[..., 0]


def greedy_descent_packed(queries, ids, codes, scales, cur_d, cur_p,
                          max_iters: int = 512):
    """ef=1 greedy descent over a packed layer (approx distances)."""
    done = torch.zeros(queries.shape[0], dtype=torch.bool,
                       device=queries.device)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        safe = cur_p.clamp(min=0).long()
        nb = ids[safe]                                      # [B, K]
        nd = approx_dists(queries, codes[safe], scales[safe])
        nd = torch.where((nb >= 0) & ~done[:, None], nd, torch.inf)
        md = nd.amin(dim=1)
        mp = torch.where(nd == md[:, None], nb, _I32MAX).amin(dim=1)
        better = (md < cur_d) | ((md == cur_d) & (mp < cur_p))
        step = better & ~done
        cur_d = torch.where(step, md, cur_d)
        cur_p = torch.where(step, mp, cur_p)
        done = done | ~better
    return cur_d, cur_p


def beam_search_packed(queries, ids, codes, scales, beam_d, beam_p, beam_e,
                       max_iters: int, expand: int = 1, eligible=None,
                       return_iters: bool = False):
    """Packed-layer beam search: the wavefront semantics of
    ``ops.beam.beam_search_layer`` with inline approx distances.

    ``eligible`` (bool [N], optional) filters the RESULT beam; traversal
    still routes through every node.  With ``return_iters`` the step
    count comes last.
    """
    b, ef = beam_p.shape
    k = ids.shape[1]
    e_n = max(1, min(expand, ef))
    ek = e_n * k
    tril = torch.ones((ek, ek), dtype=torch.bool,
                      device=beam_p.device).tril(-1)
    filtered = eligible is not None
    bd, bp, be = beam_d, beam_p, beam_e
    if filtered:
        rd, rp = sort2(*mask_eligible(bd, bp, eligible))
    it = 0
    while it < max_iters and bool(((bp >= 0) & ~be).any()):
        chosen, cur = chosen_slots(bp, be, e_n)
        be = be | chosen
        safe = cur.clamp(min=0).long()                      # [B, E]
        nb = ids[safe]                                      # [B, E, K]
        nd = approx_dists(queries, codes[safe].view(b, ek, -1),
                           scales[safe].view(b, ek)).view(b, e_n, k)
        nvalid = (nb >= 0) & (cur >= 0)[:, :, None]
        nb = torch.where(nvalid, nb, -1).reshape(b, ek)
        nd = torch.where(nvalid, nd, torch.inf).reshape(b, ek)
        dup = ((nb[:, :, None] == bp[:, None, :])
               & (bp >= 0)[:, None, :]).any(2)
        dup |= ((nb[:, :, None] == nb[:, None, :]) & tril).any(2)
        nd = torch.where(dup, torch.inf, nd)
        nb = torch.where(dup, -1, nb)
        if filtered:
            fd, fp = mask_eligible(nd, nb, eligible)
            dup_r = ((fp[:, :, None] == rp[:, None, :])
                     & (rp >= 0)[:, None, :]).any(2)
            fd = torch.where(dup_r, torch.inf, fd)
            fp = torch.where(dup_r, -1, fp)
            rd, rp = sort2(torch.cat([rd, fd], 1), torch.cat([rp, fp], 1))
            rd, rp = rd[:, :ef], rp[:, :ef]
        fresh = torch.zeros_like(nb, dtype=torch.bool)
        bd, bp, be = sort2(torch.cat([bd, nd], 1), torch.cat([bp, nb], 1),
                           torch.cat([be, fresh], 1))
        bd, bp, be = bd[:, :ef], bp[:, :ef], be[:, :ef]
        it += 1
    out = (rd, rp) if filtered else (bd, bp)
    return (*out, it) if return_iters else out


def seed_entry(queries, seed_vecs, n_init: int):
    """Seed scan, the replacement for the upper-layer descent: the
    ``n_init`` nearest of the first S points (a uniform sample, since
    pids are a seeded shuffle) by approximate squared L2.

    ``seed_vecs``: [S, D] bfloat16.  The product is the JAX package's
    bf16 x bf16 with f32 accumulation: bf16 products are exact in f32, so
    it is an f32 matmul of the bf16-rounded values.  Returns (d [B,
    n_init] f32, p [B, n_init] int32), sorted ascending.
    """
    q = queries.to(torch.bfloat16).float()
    s = seed_vecs.float()
    qs = q @ s.T                                            # [B, S]
    sn = (s * s).sum(1)
    scores = sn[None, :] - 2.0 * qs
    nd, np_ = torch.topk(scores, n_init, dim=1, largest=False)
    qf = queries.float()
    qn = (qf * qf).sum(1)
    return nd + qn[:, None], np_.to(torch.int32)


def seeded_beam(queries, seed_vecs, ef: int):
    """The initial beam [B, ef] of a seeded search: the nearest seeds in
    the leading slots, (inf, -1) after them."""
    b = queries.shape[0]
    n_init = min(ef, seed_vecs.shape[0])
    sd, sp = seed_entry(queries, seed_vecs, n_init)
    beam_d = torch.full((b, ef), torch.inf, device=queries.device)
    beam_p = torch.full((b, ef), -1, dtype=torch.int32, device=queries.device)
    beam_d[:, :n_init] = sd
    beam_p[:, :n_init] = sp
    return beam_d, beam_p


def rerank_beam(queries, points, bp, metric: Metric, k: int):
    """Exact distances of the final beam's pids, sorted by (dist, pid):
    (dists [B, k], pids [B, k])."""
    exact = metric.gathered(queries, points[bp.clamp(min=0).long()])
    exact = torch.where(bp >= 0, exact, torch.inf)
    sd, sp = sort2(exact, bp)
    return sd[:, :k], sp[:, :k]


def packed_search(queries, zero_pack, upper_packs, points, metric: Metric,
                  ef: int, k: int, max_iter_factor: int = 8,
                  expand: int = 4, rerank: bool = True, eligible=None,
                  seed_vecs=None):
    """Full packed query: approx descent (or the seed scan when
    ``seed_vecs`` is given) + approx zero-layer beam + exact rerank.

    ``zero_pack``/``upper_packs``: (ids, codes, scales) tuples, uppers
    top first.  ``points`` are the exact vectors, read only for the
    rerank.  Returns (dists [B, k], pids [B, k]).
    """
    b = queries.shape[0]
    dev = queries.device
    if seed_vecs is not None:
        beam_d, beam_p = seeded_beam(queries, seed_vecs, ef)
    else:
        cur_p = torch.zeros(b, dtype=torch.int32, device=dev)
        cur_d = metric.gathered(queries, points[cur_p.long()[:, None]])[:, 0]
        for uids, ucodes, uscales in upper_packs:
            cur_d, cur_p = greedy_descent_packed(queries, uids, ucodes,
                                                 uscales, cur_d, cur_p)
        beam_d = torch.full((b, ef), torch.inf, device=dev)
        beam_p = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
        beam_d[:, 0] = cur_d
        beam_p[:, 0] = cur_p
    zids, zcodes, zscales = zero_pack
    beam_e = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    bd, bp = beam_search_packed(
        queries, zids, zcodes, zscales, beam_d, beam_p, beam_e,
        max_iters=max_iter_factor * ef + 16, expand=expand,
        eligible=eligible)
    if not rerank:
        return bd[:, :k], bp[:, :k]
    return rerank_beam(queries, points, bp, metric, k)
