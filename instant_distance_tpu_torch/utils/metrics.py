"""Recall harness (the port's own copy of ``recall_at_k`` from
``instant_distance_tpu/utils/metrics.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["recall_at_k"]


def recall_at_k(found_ids, true_ids, k: Optional[int] = None) -> float:
    """Mean |found ∩ true| / k over the query batch (ids < 0 ignored)."""
    found = np.asarray(found_ids)
    true = np.asarray(true_ids)
    k = k or true.shape[1]
    hits = []
    for f, t in zip(found, true):
        fs = set(int(x) for x in f[:k] if x >= 0)
        ts = set(int(x) for x in t[:k] if x >= 0)
        hits.append(len(fs & ts) / max(1, len(ts)))
    return float(np.mean(hits))
