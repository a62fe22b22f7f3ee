"""Batched neighbour selection, paper Algorithms 3 and 4 (port of
``instant_distance_tpu/ops/select.py``).

Semantics as in the reference: candidates in ascending (distance, pid)
order; a candidate is kept iff no kept result is closer to it than the
query is (lib.rs:674-679); scanning stops at M*2 kept (lib.rs:668-670);
with ``keep_pruned`` the discarded candidates backfill to M*2 in scan
order (lib.rs:687-695).  ``extend_candidates`` (lib.rs:648-664) widens
the candidate set with the candidates' graph neighbours first.
"""

from __future__ import annotations

import numpy as np
import torch

from .distance import Metric
from .sort import sort2

_I32MAX = np.iinfo(np.int32).max
#: Elements of the [rows, C * K, D] neighbour gather of
#: :func:`extend_candidates` per block of wave rows (2^27 f32 = 512 MiB;
#: a 4096-point wave at pool 300, K 64, D 128 would gather ~40 GB).
EXTEND_ELEMS = 1 << 27


def select_simple(cand_d, cand_p, m0: int):
    """Paper Alg. 3: the M*2 nearest candidates (sorted [W, C] input)."""
    c = cand_p.shape[1]
    if c < m0:
        cand_d = torch.nn.functional.pad(cand_d, (0, m0 - c),
                                         value=torch.inf)
        cand_p = torch.nn.functional.pad(cand_p, (0, m0 - c), value=-1)
    return cand_d[:, :m0], cand_p[:, :m0]


def select_heuristic(q_pts, cand_d, cand_p, cand_pts, metric: Metric,
                     m0: int, keep_pruned: bool, pd_dtype=None):
    """Paper Alg. 4, batched over W queries.

    ``cand_d``/``cand_p`` [W, C] sorted ascending with (inf, -1) pads,
    ``cand_pts`` [W, C, D] their coordinates, ``pd_dtype`` the dtype of
    the [W, C, C] candidate-pairwise matrix.  Returns (sel_d, sel_p)
    [W, m0] in kept-then-pruned order, padded with (inf, -1).

    The scan over candidate rank is a Python loop of C steps on [W, C]
    tensors (``lax.fori_loop`` in the JAX package).  Step j reads
    ``pd[:, :j, j]`` only, since nothing at rank >= j is kept yet; the
    loop reads the transposed matrix so those reads are contiguous.
    """
    w, c = cand_p.shape
    pd_t = metric.self_pairwise(cand_pts, out_dtype=pd_dtype).transpose(
        1, 2).contiguous()                       # pd_t[:, j, i] = pd[:, i, j]
    valid = cand_p >= 0
    kept = torch.zeros((w, c), dtype=torch.bool, device=cand_p.device)
    disc = torch.zeros_like(kept)
    count = torch.zeros(w, dtype=torch.int32, device=cand_p.device)
    for j in range(c):
        # bf16 pd promotes to f32 against the f32 query distance, as in
        # the JAX comparison
        blocked = (kept[:, :j] & (pd_t[:, j, :j] < cand_d[:, j, None])).any(1)
        live = valid[:, j] & (count < m0)
        take = live & ~blocked
        kept[:, j] = take
        disc[:, j] = live & blocked
        count += take

    kept_rank = kept.cumsum(1) - 1
    if keep_pruned:
        disc_rank = count[:, None] + disc.cumsum(1) - 1
        rank = torch.where(kept, kept_rank, torch.where(disc, disc_rank, m0))
    else:
        rank = torch.where(kept, kept_rank, m0)
    rank = torch.clamp(rank, max=m0).long()     # m0 -> the dropped column

    # one-wider buffers stand in for JAX's .at[].set(mode="drop")
    sel_p = torch.full((w, m0 + 1), -1, dtype=torch.int32,
                       device=cand_p.device)
    sel_d = torch.full((w, m0 + 1), torch.inf, device=cand_p.device)
    sel_p.scatter_(1, rank, cand_p)
    sel_d.scatter_(1, rank, cand_d)
    return sel_d[:, :m0], sel_p[:, :m0]


def extend_candidates(q_pts, cand_d, cand_p, adj, points, metric: Metric,
                      links: int, cap: int):
    """Candidate-set extension for Alg. 4's ``extend_candidates`` knob
    (lib.rs:648-664): add the first ``links`` neighbours of every
    candidate (rows of ``adj``), dedup by pid, sort by (distance, pid)
    and keep the ``cap`` nearest.

    As in the JAX package, hops are deduplicated against the candidate
    set and each other, not against the reference's whole search trail.
    The wave rows run in blocks of at most :data:`EXTEND_ELEMS` gathered
    elements; rows are independent, so the blocks never change a value.
    """
    w, c = cand_p.shape
    per_row = max(1, c * adj.shape[1] * points.shape[1])
    step = max(1, EXTEND_ELEMS // per_row)
    parts = [_extend_rows(q_pts[s:s + step], cand_d[s:s + step],
                          cand_p[s:s + step], adj, points, metric, links,
                          cap) for s in range(0, w, step)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _extend_rows(q_pts, cand_d, cand_p, adj, points, metric, links, cap):
    w, c = cand_p.shape
    k = adj.shape[1]
    hops = adj[cand_p.clamp(min=0)]                               # [W, C, K]
    colmask = torch.arange(k, device=adj.device) < links
    hmask = (cand_p >= 0)[:, :, None] & colmask
    hops = torch.where(hmask, hops, -1).reshape(w, c * k)
    hd = metric.gathered(q_pts, points[hops.clamp(min=0)])
    hd = torch.where(hops >= 0, hd, torch.inf)

    all_p = torch.cat([cand_p, hops], 1)
    all_d = torch.cat([cand_d, hd], 1)
    # dedup: sort by (pid, dist), invalidate repeats of the same pid
    key_p = torch.where(all_p >= 0, all_p, _I32MAX)
    sp, sd = sort2(key_p, all_d)
    dup = torch.cat([torch.zeros_like(sp[:, :1], dtype=torch.bool),
                     sp[:, 1:] == sp[:, :-1]], 1)
    sd = torch.where(dup | (sp == _I32MAX), torch.inf, sd)
    sp = torch.where(torch.isfinite(sd), sp, -1)
    # resort by (dist, pid) and truncate
    od, op = sort2(sd, sp)
    return od[:, :cap], op[:, :cap]
