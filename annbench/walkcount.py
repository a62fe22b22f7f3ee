"""The work of one K4 call, counted apart from the kernel it judges.

A frozen copy of the steps of ``walk_search_plain``
(``instant_distance_tpu_torch/ops/walk_kernel.py``) with its
``chosen_slots``, ``approx_dists`` and two-key sort: the same beam
search over the whole batch in plain torch, which counts the rows
expanded and the valid neighbours scored, the ``E`` and ``V`` of K4's
bound.  Its distances sum the D terms in the kernel's order, so on
valid graphs it walks the kernel's path.
"""

from __future__ import annotations

import torch

_LANES, _VEC = 32, 4


def _sort2(primary, secondary, *payload):
    _, by_second = torch.sort(secondary, dim=-1, stable=True)
    _, by_first = torch.sort(primary.gather(-1, by_second), dim=-1,
                             stable=True)
    order = by_second.gather(-1, by_first)
    return tuple(x.gather(-1, order) for x in (primary, secondary) + payload)


def _chosen_slots(bp, be, e_n: int):
    b, ef = bp.shape
    exp = (bp >= 0) & ~be
    rank = exp.cumsum(1) - 1
    chosen = exp & (rank < e_n)
    slot = torch.arange(ef, dtype=torch.int32, device=bp.device).expand(b, -1)
    sel = torch.full((b, e_n + 1), -1, dtype=torch.int32, device=bp.device)
    sel.scatter_(1, torch.where(chosen, rank, e_n), slot)
    sel = sel[:, :e_n]
    cur = torch.where(sel >= 0, bp.gather(1, sel.clamp(min=0).long()), -1)
    return chosen, cur


def _approx_dists(q, codes, scales):
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


def walk_work(queries, beam_d0, beam_p0, ids, codes, scales, *,
              expand: int, ef: int, max_iters: int, rows: int = 1024,
              **_):
    """(rows expanded, valid neighbours scored) of the walk over K4's
    arguments, ``rows`` queries at a time (the walk of each query is
    independent of the others)."""
    expanded = scored = 0
    for s in range(0, queries.shape[0], rows):
        e, v = _walk_block(queries[s:s + rows], beam_d0[s:s + rows],
                           beam_p0[s:s + rows], ids, codes, scales,
                           expand, ef, max_iters)
        expanded += e
        scored += v
    return expanded, scored


def _walk_block(queries, bd, bp, ids, codes, scales, expand, ef, max_iters):
    b = queries.shape[0]
    k = ids.shape[1]
    ek = expand * k
    group = torch.arange(ek, device=queries.device) // k
    earlier = group[None, :] < group[:, None]
    be = torch.zeros_like(bp, dtype=torch.bool)
    expanded = torch.zeros((), dtype=torch.int64, device=queries.device)
    scored = torch.zeros((), dtype=torch.int64, device=queries.device)
    for _ in range(max_iters):
        if not bool(((bp >= 0) & ~be).any()):
            break
        chosen, cur = _chosen_slots(bp, be, expand)
        expanded += chosen.sum()
        be = be | chosen
        safe = cur.clamp(min=0).long()
        nb = ids[safe].view(b, ek)
        nd = _approx_dists(queries, codes[safe].view(b, ek, -1),
                           scales[safe].view(b, ek))
        valid = (nb >= 0) & (cur >= 0).repeat_interleave(k, dim=1)
        scored += valid.sum()
        nb = torch.where(valid, nb, -1)
        nd = torch.where(valid, nd, torch.inf)
        dup = ((nb[:, :, None] == bp[:, None, :])
               & (bp >= 0)[:, None, :]).any(2)
        if expand > 1:
            dup |= ((nb[:, :, None] == nb[:, None, :])
                    & (nb >= 0)[:, None, :] & earlier).any(2)
        nd = torch.where(dup, torch.inf, nd)
        nb = torch.where(dup, -1, nb)
        bd, bp, be = _sort2(torch.cat([bd, nd], 1), torch.cat([bp, nb], 1),
                            torch.cat([be, torch.zeros_like(dup)], 1))
        bd, bp, be = bd[:, :ef], bp[:, :ef], be[:, :ef]
    return int(expanded), int(scored)
