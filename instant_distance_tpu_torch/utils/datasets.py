"""Synthetic datasets: the JAX package's numpy-only generator, reused.

``instant_distance_tpu/utils/datasets.py`` imports numpy and nothing of
JAX, so the port shares it instead of forking it: both packages then
draw the very same points from a seed.
"""

from instant_distance_tpu.utils.datasets import synthetic_clustered

__all__ = ["synthetic_clustered"]
