"""Recall harness: the JAX package's numpy-only ``recall_at_k``, reused
(``instant_distance_tpu/utils/metrics.py`` imports nothing of JAX)."""

from instant_distance_tpu.utils.metrics import recall_at_k

__all__ = ["recall_at_k"]
