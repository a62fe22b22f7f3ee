"""The comparison that decides ``correct``.

It judges answers, whoever produced them: the program's, from the calls
of the window that the seed picked, or the control's (``readings.py``).
Each answer is a query's ``k`` ids, in the points' order, and their
distances.  Three numbers, each beside its limit:

* ``bad_ids``: ids outside the points, or repeated in one answer;
  exact, limit 0.
* ``dist_gap``: the widest gap between a reported distance and the
  float64 distance from that query to the point its id names, over
  ``d + 1e-6 |q|^2`` (the floor keeps a near-duplicate's tiny distance
  from dividing by nothing).  Its limit is the configuration's
  ``dist_gap_limit``, set from the program's and the control's readings
  (PERF.md).
* ``recall_min``: the lowest mean recall@k over blocks of
  ``recall_block`` queries against the exact reference; its limit is
  the configuration's stated ``recall_floor``.

Routes may add checks of their own (the graph route's ``id_map_bad``).
"""

from __future__ import annotations

import torch

from . import reference


def judge(points, queries, got_d, got_i, true_i, spec: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for answers ``got_d``/``got_i``
    [Q, k] (ids in the points' order) to ``queries`` [Q, D], with the
    reference's ids ``true_i`` [Q, k]; plus ``recall`` (mean, not a
    check) and ``failed`` (queries with a bad id or a gap over the
    limit)."""
    n = points.shape[0]
    got_i = got_i.long()
    valid = (got_i >= 0) & (got_i < n)
    srt = torch.sort(torch.where(valid, got_i, -1), dim=1).values
    repeat = torch.zeros_like(valid)
    repeat[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    bad_row = (~valid).any(1) | repeat.any(1)
    bad_ids = int((~valid).sum()) + int(repeat.sum())

    ref_d = reference.distances(points, queries, got_i.clamp(0, n - 1))
    qn = (queries.double() ** 2).sum(1, keepdim=True)
    gap = (got_d.double() - ref_d).abs() / (ref_d + 1e-6 * qn)
    gap = torch.where(valid, gap.nan_to_num(nan=float("inf")), 0.0)
    row_gap = gap.amax(1)
    limit = float(spec["dist_gap_limit"])
    dist_gap = float(row_gap.max()) if row_gap.numel() else 0.0

    rec = reference.recall_at_k(torch.where(valid, got_i, -1), true_i)
    block = int(spec["recall_block"])
    blocks = [float(rec[s:s + block].mean())
              for s in range(0, rec.shape[0], block)]
    floor = float(spec["recall_floor"])
    return {
        "checks": {
            "bad_ids": _check(bad_ids, 0, bad_ids <= 0),
            "dist_gap": _check(dist_gap, limit, dist_gap <= limit),
            "recall_min": _check(min(blocks), floor, min(blocks) >= floor),
        },
        "recall": float(rec.mean()),
        "failed": int((bad_row | (row_gap > limit)).sum()),
    }


def _check(value, limit, ok: bool) -> dict:
    return {"value": value, "limit": limit, "ok": bool(ok)}
