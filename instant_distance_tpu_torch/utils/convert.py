"""Tensors in, index objects out.

``as_tensor`` is how every index takes its inputs: a tensor keeps its
device (a CPU tensor is a request for the CPU), anything else (numpy,
lists) goes to the ``device`` named, and without one to the CUDA card.
Where there is no card, such input raises instead of running on the CPU.

``hnsw_from_arrays``, ``sharded_from_arrays`` and ``scan_from_points``
carry state built by the JAX package over to this one, as numpy arrays
(``np.asarray(index.points / .zero / .layers / .gids)``), so both
packages can search the very same graph.
"""

from __future__ import annotations

import numpy as np
import torch


def default_device(device=None) -> torch.device:
    """``device`` if given, else the CUDA card; raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless asked for the "
            "CPU (pass device='cpu' or CPU tensors)")
    return torch.device("cuda")


def as_tensor(x, device=None, dtype=None):
    """``x`` as a tensor on ``device`` (default: where ``x`` already is,
    the CUDA card for non-tensors), cast to ``dtype`` when given."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype)
    a = np.asarray(x)
    if not a.flags.writeable:  # e.g. a view of a jax array: torch shares
        a = a.copy()           # memory with numpy and may write to it
    return torch.as_tensor(a, dtype=dtype, device=default_device(device))


def as_queries(queries, device, dim: int):
    """A query batch as a [B, dim] f32 tensor on ``device`` (one query
    becomes a batch of one); ValueError on any other shape, an empty
    batch included."""
    queries = as_tensor(queries, device, torch.float32)
    if queries.dim() == 1:
        queries = queries[None]
    if queries.dim() != 2:
        raise ValueError(f"queries must be a [B, D] 2-D array, got shape "
                         f"{tuple(queries.shape)}")
    if queries.shape[1] != dim:
        raise ValueError(f"queries dim {queries.shape[1]} != index dim "
                         f"{dim}")
    return queries


def hnsw_from_arrays(points, zero, layers, config, device=None):
    """An :class:`~instant_distance_tpu_torch.models.hnsw.Hnsw` over the
    given graph arrays (pid order; ``layers[l-1]`` is level l), on
    ``device`` (default: as :func:`as_tensor` places ``points``)."""
    from ..models.hnsw import Hnsw

    pts = as_tensor(points, device, torch.float32)
    return Hnsw(pts, as_tensor(zero, pts.device, torch.int32),
                [as_tensor(l, pts.device, torch.int32) for l in layers],
                config)


def scan_from_points(points, device=None, **kw):
    """A :class:`~instant_distance_tpu_torch.models.scan.ScanIndex` over
    ``points`` on ``device`` (default: as :func:`as_tensor` places
    them)."""
    from ..models.scan import ScanIndex

    return ScanIndex(as_tensor(points, device, torch.float32), **kw)


def sharded_from_arrays(points, zero, layers, gids, config, mesh):
    """A :class:`~instant_distance_tpu_torch.parallel.sharded.ShardedHnsw`
    over a JAX ``ShardedHnsw``'s arrays (leading global shard axis:
    points [S, n_s, D], zero [S, n_s, m0], ``layers[l-1]`` [S, end_l, m]
    for level l, gids [S, n_s]) on ``mesh``, whose size must be S."""
    from ..parallel.sharded import ShardedHnsw

    return ShardedHnsw(np.asarray(points, np.float32),
                       np.asarray(zero, np.int32),
                       [np.asarray(l, np.int32) for l in layers],
                       np.asarray(gids, np.int32), config, mesh)
