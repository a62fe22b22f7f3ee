"""Batched wavefront beam search (port of
``instant_distance_tpu/ops/beam.py``).

One fixed-shape beam per query, sorted ``(dist f32[B, ef], pid
i32[B, ef], expanded bool[B, ef])``; each step expands the ``expand``
nearest unexpanded entries of every query at once and merges the
neighbours by (distance, pid), the reference's ``Candidate`` order.  The
expanded-flag beam equals the reference's heap search (proof in the JAX
module's docstring).

``lax.while_loop`` becomes a Python loop: its ``jnp.any``/``jnp.all``
condition is one device-to-host read per step.
"""

from __future__ import annotations

import numpy as np
import torch

from .distance import Metric
from .sort import sort2

_I32MAX = np.iinfo(np.int32).max


def greedy_descent(queries, adj, points, metric: Metric, cur_d, cur_p,
                   links: int, max_iters: int):
    """Batched ef=1 greedy search on one layer (lib.rs:365-379): move to
    the smallest (distance, pid) neighbour until a local minimum."""
    done = torch.zeros(queries.shape[0], dtype=torch.bool,
                       device=queries.device)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        nb = adj[cur_p.clamp(min=0)][:, :links]                 # [B, K]
        nvalid = (nb >= 0) & ~done[:, None]
        nd = metric.gathered(queries, points[nb.clamp(min=0)])
        nd = torch.where(nvalid, nd, torch.inf)
        md = nd.amin(dim=1)
        # tie-break equal distances by smallest pid (Candidate ordering)
        mp = torch.where(nd == md[:, None], nb, _I32MAX).amin(dim=1)
        better = (md < cur_d) | ((md == cur_d) & (mp < cur_p))
        step = better & ~done
        cur_d = torch.where(step, md, cur_d)
        cur_p = torch.where(step, mp, cur_p)
        done = done | ~better
    return cur_d, cur_p


def mask_eligible(d, p, eligible):
    """(d, p) with entries whose pid is not ``eligible`` set to (inf, -1)."""
    ok = (p >= 0) & eligible[p.clamp(min=0).long()]
    return torch.where(ok, d, torch.inf), torch.where(ok, p, -1)


def chosen_slots(bp, be, e_n: int):
    """One step's wavefront: ``(chosen [B, ef] bool, cur [B, e_n]
    int32)``, the first ``e_n`` unexpanded valid slots of each sorted
    beam and their pids in beam order, -1 where a beam has fewer."""
    b, ef = bp.shape
    exp = (bp >= 0) & ~be
    rank = exp.cumsum(1) - 1
    chosen = exp & (rank < e_n)
    slot = torch.arange(ef, dtype=torch.int32, device=bp.device).expand(b, -1)
    # column e_n is the drop column of JAX's scatter(mode="drop")
    sel = torch.full((b, e_n + 1), -1, dtype=torch.int32, device=bp.device)
    sel.scatter_(1, torch.where(chosen, rank, e_n), slot)
    sel = sel[:, :e_n]
    cur = torch.where(sel >= 0, bp.gather(1, sel.clamp(min=0).long()), -1)
    return chosen, cur


def beam_search_layer(queries, adj, points, metric: Metric,
                      beam_d, beam_p, beam_e, links: int, max_iters: int,
                      expand: int = 1, eligible=None):
    """One layer of batched best-first search with an ef-wide beam.

    The beam must be sorted by (dist, pid) with (inf, -1, False) pads.
    ``links`` caps the neighbours read per row; ``expand`` entries are
    expanded per step; ``eligible`` (bool [N]) filters the RESULT beam
    while traversal still routes through every node.  Returns the final
    ``(beam_d, beam_p)`` (the result beam when filtered).
    """
    b, ef = beam_p.shape
    dev = beam_p.device
    row_width = adj.shape[1]
    e_n = max(1, min(expand, ef))
    ek = e_n * row_width
    col = torch.arange(row_width, device=dev).view(1, 1, -1)
    tril = torch.ones((ek, ek), dtype=torch.bool, device=dev).tril(-1)
    filtered = eligible is not None
    bd, bp, be = beam_d, beam_p, beam_e
    if filtered:
        rd, rp = sort2(*mask_eligible(bd, bp, eligible))

    for _ in range(max_iters):
        if not bool(((bp >= 0) & ~be).any()):
            break
        chosen, cur = chosen_slots(bp, be, e_n)
        be = be | chosen
        nb = adj[cur.clamp(min=0)]                              # [B, E, K]
        nvalid = (nb >= 0) & (cur >= 0)[:, :, None] & (col < links)
        nb = torch.where(nvalid, nb, -1).reshape(b, ek)
        # dedup against the beam and within this wavefront's union
        dup = ((nb[:, :, None] == bp[:, None, :])
               & (bp >= 0)[:, None, :]).any(2)
        dup |= ((nb[:, :, None] == nb[:, None, :]) & tril).any(2)
        nb = torch.where(dup, -1, nb)
        nd = metric.gathered(queries, points[nb.clamp(min=0)])
        nd = torch.where(nb >= 0, nd, torch.inf)
        if filtered:
            # a node pruned from the traversal beam can be re-proposed
            # later, so the result beam dedups against its own members
            fd, fp = mask_eligible(nd, nb, eligible)
            dup_r = ((fp[:, :, None] == rp[:, None, :])
                     & (rp >= 0)[:, None, :]).any(2)
            fd = torch.where(dup_r, torch.inf, fd)
            fp = torch.where(dup_r, -1, fp)
            rd, rp = sort2(torch.cat([rd, fd], 1), torch.cat([rp, fp], 1))
            rd, rp = rd[:, :ef], rp[:, :ef]
        # merge by (dist, pid), the reference's Candidate order
        fresh = torch.zeros_like(nb, dtype=torch.bool)
        bd, bp, be = sort2(torch.cat([bd, nd], 1), torch.cat([bp, nb], 1),
                           torch.cat([be, fresh], 1))
        bd, bp, be = bd[:, :ef], bp[:, :ef], be[:, :ef]
    return (rd, rp) if filtered else (bd, bp)


def hnsw_search(queries, zero_adj, upper_adjs, points, metric: Metric,
                ef: int, m: int, zero_links: int, max_iter_factor: int = 8,
                greedy_max_iters: int = 512, expand: int = 1,
                eligible=None, entry_seeds: int = 0):
    """Full batched HNSW query (lib.rs:352-383): entry pid 0, greedy
    descent through ``upper_adjs`` (top first), zero-layer beam.

    ``entry_seeds`` S > 0 replaces the descent with one pairwise scan
    over ``points[:S]`` (a uniform sample: pids are a seeded shuffle) and
    starts the beam at the ef nearest seeds.  Returns (dists [B, ef],
    pids [B, ef]) sorted ascending, (inf, -1) padded.
    """
    b = queries.shape[0]
    dev = queries.device
    beam_d = torch.full((b, ef), torch.inf, device=dev)
    beam_p = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    if entry_seeds:
        sd = metric.pairwise(queries, points[:entry_seeds])    # [B, S]
        n_init = min(ef, entry_seeds)
        nd, np_ = torch.topk(sd, n_init, dim=1, largest=False)
        beam_d[:, :n_init] = nd
        beam_p[:, :n_init] = np_.to(torch.int32)
    else:
        cur_p = torch.zeros(b, dtype=torch.int32, device=dev)
        cur_d = metric.gathered(queries, points[cur_p[:, None]])[:, 0]
        for adj in upper_adjs:
            cur_d, cur_p = greedy_descent(
                queries, adj, points, metric, cur_d, cur_p,
                links=min(m, adj.shape[1]), max_iters=greedy_max_iters)
        beam_d[:, 0] = cur_d
        beam_p[:, 0] = cur_p
    beam_e = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    return beam_search_layer(
        queries, zero_adj, points, metric, beam_d, beam_p, beam_e,
        links=zero_links, max_iters=max_iter_factor * ef + 16,
        expand=expand, eligible=eligible)
