"""Batched neighbour selection, paper Algorithms 3 and 4 (port of
``instant_distance_tpu/ops/select.py``).

Semantics as in the reference: candidates in ascending (distance, pid)
order; a candidate is kept iff no kept result is closer to it than the
query is (lib.rs:674-679); scanning stops at M*2 kept (lib.rs:668-670);
with ``keep_pruned`` the discarded candidates backfill to M*2 in scan
order (lib.rs:687-695).  ``extend_candidates`` waits (ROADMAP.md §1
item 5; ``Heuristic.extend_candidates`` defaults to False).
"""

from __future__ import annotations

import torch

from .distance import Metric


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
