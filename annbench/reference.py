"""The plain reference: exact k-nearest neighbours under squared L2.

Plain torch, in blocks of queries and of points so that it fits beside
whatever is left on the device.  It reads only the benchmark's own
points and queries, and imports nothing of the program.

:func:`exact_knn` finds each query's ``slack`` best candidates by the
f32 matrix form ``|p|^2 - 2 q.p`` with TF32 off, then recomputes those
candidates' distances directly, ``sum((q - p)^2)`` in float64, and keeps
the ``k`` best: ids in the points' order and their distances.

:func:`tf32_knn` is the control: the same search with every product in
TF32 (operands rounded to TF32's 10 mantissa bits, as the tensor cores
round them), answering with the TF32 matrix form's own distances, as a
TF32 brute-force search or a TF32 rerank would.

:func:`distances` gives the float64 distance of any (query, point)
pairs, by which the comparison judges a reported distance.
"""

from __future__ import annotations

import contextlib

import torch

#: Queries and points of one block of the f32 product ([QB, NB] f32 is
#: 1 GiB).
QB, NB = 2048, 1 << 17


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to nearest (ties to even) on TF32's grid: 10
    mantissa bits kept of 23."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _candidates(points, queries, m: int, tf32: bool):
    """(scores [Q, m] f32, ids [Q, m] int64): the m best points of each
    query by ``|q|^2 + |p|^2 - 2 q.p``, computed blockwise."""
    m = min(m, points.shape[0])
    p_all = round_tf32(points) if tf32 else points
    pn = (p_all * p_all).sum(1)
    out_s, out_i = [], []
    with _tf32(tf32):
        for qs in range(0, queries.shape[0], QB):
            q = queries[qs:qs + QB]
            q = round_tf32(q) if tf32 else q
            qn = (q * q).sum(1, keepdim=True)
            best_s = best_i = None
            for ps in range(0, points.shape[0], NB):
                p = p_all[ps:ps + NB]
                s = qn + pn[None, ps:ps + NB] - 2.0 * (q @ p.T)
                ts, ti = torch.topk(s, min(m, s.shape[1]), dim=1,
                                    largest=False)
                ti = ti + ps
                if best_s is not None:
                    ts, j = torch.topk(torch.cat([best_s, ts], 1), m, dim=1,
                                       largest=False)
                    ti = torch.cat([best_i, ti], 1).gather(1, j)
                best_s, best_i = ts, ti
            out_s.append(best_s)
            out_i.append(best_i)
    return torch.cat(out_s), torch.cat(out_i)


def distances(points, queries, ids) -> torch.Tensor:
    """float64 ``sum((q - p)^2)`` [Q, k] of each query to the points
    ``ids`` [Q, k] names (ids must be valid)."""
    rows = points[ids].double()
    diff = queries.double()[:, None, :] - rows
    return (diff * diff).sum(-1)


def exact_knn(points, queries, k: int, slack: int = 64):
    """(dists [Q, k] float64, ids [Q, k] int64), nearest first."""
    _, cand = _candidates(points, queries, max(slack, k), tf32=False)
    out_d, out_i = [], []
    for qs in range(0, queries.shape[0], QB):
        c = cand[qs:qs + QB]
        d = distances(points, queries[qs:qs + QB], c)
        d, j = torch.sort(d, dim=1, stable=True)
        out_d.append(d[:, :k])
        out_i.append(c.gather(1, j[:, :k]))
    return torch.cat(out_d), torch.cat(out_i)


def tf32_knn(points, queries, k: int):
    """The control: (dists [Q, k] f32, ids [Q, k] int64) of the search
    computed in TF32."""
    s, i = _candidates(points, queries, k, tf32=True)
    return torch.clamp(s, min=0.0), i


def recall_at_k(got_ids, true_ids) -> torch.Tensor:
    """[Q] recall of each row of ``got_ids`` against ``true_ids`` [Q, k]:
    the share of the true ids that the row holds (a repeated id counts
    once)."""
    k = true_ids.shape[1]
    hit = (true_ids[:, :, None] == got_ids[:, None, :]).any(2)
    return hit.sum(1).double() / k
