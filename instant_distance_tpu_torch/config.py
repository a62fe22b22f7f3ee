"""Configuration: the JAX package's jax-free ``config`` module, reused.

``Config``, ``Heuristic``, ``layer_sizes`` and ``resolve_seed`` are the
reference's own objects, so a port build and a reference build with the
same ``Config`` draw the same insertion order and layer assignment.
Only ``Builder`` is subclassed: its ``build``/``build_hnsw`` construct
this package's indices.
"""

from __future__ import annotations

from instant_distance_tpu.config import Builder as _ReferenceBuilder
from instant_distance_tpu.config import (DEFAULT_M, INVALID, Config,
                                         Heuristic, layer_sizes,
                                         resolve_seed)

__all__ = ["Builder", "Config", "Heuristic", "DEFAULT_M", "INVALID",
           "layer_sizes", "resolve_seed"]


class Builder(_ReferenceBuilder):
    """Fluent builder (reference lib.rs:21-113) building torch indices."""

    def build(self, points, values):
        from .models.hnsw import HnswMap

        return HnswMap.build(points, values, self._config,
                             progress=getattr(self, "_progress", None))

    def build_hnsw(self, points):
        from .models.hnsw import Hnsw

        return Hnsw.build(points, self._config,
                          progress=getattr(self, "_progress", None))
