"""Configuration for index construction and search (the port's own copy
of ``instant_distance_tpu/config.py``).

Field names, defaults and the sizing rules are the JAX package's, which
match the reference (instant-distance/src/lib.rs:21-128 and
instant-distance-py/src/lib.rs:216-325): ef_search=100,
ef_construction=100, ml=1/ln(M), heuristic on with keep_pruned=True.  So
a ``Config`` built from the same keywords in either package gives the
same insertion order and layer assignment (tests/test_torch_build.py
holds ``layer_sizes`` and ``resolve_seed`` to the originals).

``dispatch_sync_every``, a throttle of the JAX package's TPU dispatch
queue, is kept for a shared keyword surface and has no effect here.
``construct_split`` runs no separate programs here either, but with
``construct_sample_cols`` it decides where the build repairs the sampled
scan's misses, exactly as in the JAX package (``ops/construct.py``).
"""

from __future__ import annotations

import dataclasses
import math
import secrets
from typing import Optional

#: The parameter ``M`` from the HNSW paper (reference lib.rs:784-787).
#: Upper layers keep M links per node, the zero layer keeps M * 2.
DEFAULT_M = 32

#: Sentinel for "no neighbor" adjacency slots: the reference's
#: PointId(u32::MAX) (types.rs:293), which as int32 is exactly -1.
INVALID = -1

__all__ = ["Builder", "Config", "Heuristic", "DEFAULT_M", "INVALID",
           "layer_sizes", "resolve_seed"]


def resolve_seed(seed: Optional[int]) -> int:
    """An explicit seed passes through; ``None`` draws entropy at build
    time, not ``Config()`` time (as ``Builder::default``, lib.rs:108), so
    ``Config() == Config()`` stays true."""
    return seed if seed is not None else secrets.randbits(64)


@dataclasses.dataclass(frozen=True)
class Heuristic:
    """Algorithm-4 neighbor-selection knobs (reference lib.rs:115-128)."""

    #: Extend the candidate set with candidate neighbors before selecting.
    extend_candidates: bool = False
    #: Keep pruned candidates to pad the neighbor set to a constant size.
    keep_pruned: bool = True


@dataclasses.dataclass
class Config:
    """All hyperparameters for building and searching an index (the
    reference's Python ``Config``, py src/lib.rs:216-256, plus the JAX
    package's extras)."""

    # -- reference-parity fields (same names, same defaults) ---------------
    ef_search: int = 100
    ef_construction: int = 100
    ml: float = 1.0 / math.log(DEFAULT_M)
    seed: Optional[int] = None  # None -> entropy, like Builder::default
    heuristic: Optional[Heuristic] = dataclasses.field(default_factory=Heuristic)

    # -- extras --------------------------------------------------------------
    #: Graph degree parameter M; the zero layer stores 2*M links.
    m: int = DEFAULT_M
    #: Metric name: sqeuclidean (the reference binding's FloatArray,
    #: py src/lib.rs:378-420), euclidean, dot or cosine.
    metric: object = "sqeuclidean"
    #: Max points inserted per construction wave; waves double up to it.
    wave_size: int = 2048
    #: Storage dtype of the index's points ("float32" or "bfloat16").
    dtype: str = "float32"
    #: Dtype of the construction-time neighbor-distance cache.
    dist_cache_dtype: str = "float32"
    #: Safety cap on beam-search iterations, as a multiple of ef.
    max_iter_factor: int = 8
    #: JAX package only (a TPU dispatch-queue throttle); no effect here.
    dispatch_sync_every: int = 16
    #: Beam entries expanded per search step (1 = strict best-first).
    search_expand: int = 4
    #: Beam entries expanded per step of construction searches.
    construct_expand: int = 4
    #: S > 0 starts serving beams at the ef nearest of the first S points
    #: instead of the upper-layer descent; 0 = classic descent.
    entry_seeds: int = 0
    #: Dtype of Alg. 4's candidate-pairwise matrix ("bfloat16" or
    #: "float32"); query-ranking distances are always f32.
    select_pd_dtype: str = "bfloat16"
    #: Wave-search mode: "auto"/"scan"/"scan_fused" scan the inserted
    #: prefix with the int8 kernels (named metrics), "beam" walks the
    #: graph.
    construct_mode: str = "auto"
    #: Pending reverse-edge additions re-selected per round per target
    #: (None -> min(m0, 32)).
    pend_cap: Optional[int] = None
    #: Reverse-commit rounds per wave; None/0 = as many as needed
    #: (lossless), an explicit value caps them and counts the drops.
    rev_rounds: Optional[int] = None
    #: Waves with an inserted prefix below this scan it exactly.
    construct_exact_prefix: Optional[int] = None
    #: Graph neighbours of each wave point's top-H candidates merged in.
    construct_hop_repair: int = 0
    #: Scan-mode candidate pool (None -> 3 * ef_construction).
    construct_pool: Optional[int] = None
    #: Cap on the scanned prefix (None = the whole prefix).
    construct_sample_cols: Optional[int] = None
    #: Hop expansion of sampled builds.
    construct_sample_hops: int = 16
    #: Where a sampled build repairs its misses: True = after the
    #: wave-peer merge (the JAX split programs' order), False = in the
    #: search; None = the JAX package's memory estimate decides.
    construct_split: Optional[bool] = None

    def __post_init__(self) -> None:
        if self.ef_construction < 1 or self.ef_search < 1:
            raise ValueError("ef_search and ef_construction must be >= 1")
        if self.m < 1:
            raise ValueError("m must be >= 1")
        if (self.construct_sample_cols is not None
                and self.construct_sample_cols < 1):
            raise ValueError("construct_sample_cols must be >= 1")

    @property
    def m0(self) -> int:
        """Zero-layer degree (M * 2), reference types.rs:83-85."""
        return 2 * self.m


class Builder:
    """Fluent builder mirroring the reference API (lib.rs:21-113).

    Example::

        hnsw, ids = Builder().seed(42).ef_search(100).build_hnsw(points)
    """

    def __init__(self, config: Optional[Config] = None):
        self._config = config if config is not None else Config()

    def ef_construction(self, ef_construction: int) -> "Builder":
        self._config.ef_construction = ef_construction
        return self

    def ef_search(self, ef: int) -> "Builder":
        self._config.ef_search = ef
        return self

    def select_heuristic(self, params: Optional[Heuristic]) -> "Builder":
        self._config.heuristic = params
        return self

    def ml(self, ml: float) -> "Builder":
        self._config.ml = ml
        return self

    def seed(self, seed: int) -> "Builder":
        self._config.seed = seed
        return self

    def metric(self, metric) -> "Builder":
        self._config.metric = metric
        return self

    def progress(self, callback) -> "Builder":
        """Register a progress callback ``f(done, total, phase)``
        (``Builder::progress``, lib.rs:71-75)."""
        self._progress = callback
        return self

    def into_parts(self):
        """(ef_search, ef_construction, ml, seed), lib.rs:88-98."""
        c = self._config
        return (c.ef_search, c.ef_construction, c.ml, c.seed)

    @property
    def config(self) -> Config:
        return self._config

    def build(self, points, values):
        """Build an ``HnswMap`` (reference lib.rs:78-80) on ``points``'
        device (numpy input: the card)."""
        from .models.hnsw import HnswMap

        return HnswMap.build(points, values, self._config,
                             progress=getattr(self, "_progress", None))

    def build_hnsw(self, points):
        """Build an ``Hnsw``, returning (index, ids) (reference
        lib.rs:83-85), on ``points``' device (numpy input: the card)."""
        from .models.hnsw import Hnsw

        return Hnsw.build(points, self._config,
                          progress=getattr(self, "_progress", None))


def layer_sizes(n: int, ml: float, m: int = DEFAULT_M) -> list[tuple[int, int]]:
    """Geometric layer sizing, top layer first: ``[(size, cumulative),
    ...]`` exactly like the reference's sizing loop (lib.rs:238-250),
    shrinking by ``ml`` until the next level would hold fewer than M
    points.  ``cumulative`` counts the points at that layer or above."""
    sizes = []
    num = n
    while True:
        next_num = int(num * ml)
        if next_num < m:
            break
        sizes.append((num - next_num, num))
        num = next_num
    sizes.append((num, num))
    sizes.reverse()
    return sizes
