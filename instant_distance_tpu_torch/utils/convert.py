"""Tensors in, index objects out.

``as_tensor`` is how every index takes its inputs: a tensor keeps its
device, anything else (numpy, lists) goes to the ``device`` named, CPU
by default — the port never guesses a device.

``hnsw_from_arrays`` and ``scan_from_points`` carry state built by the
JAX package over to this one, as numpy arrays
(``np.asarray(index.points / .zero / .layers)``), so both packages can
search the very same graph.
"""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(x, device=None, dtype=None):
    """``x`` as a tensor on ``device`` (default: where ``x`` already is,
    CPU for non-tensors), cast to ``dtype`` when given."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype)
    a = np.asarray(x)
    if not a.flags.writeable:  # e.g. a view of a jax array: torch shares
        a = a.copy()           # memory with numpy and may write to it
    return torch.as_tensor(a, dtype=dtype,
                           device=device if device is not None else "cpu")


def hnsw_from_arrays(points, zero, layers, config, device=None):
    """An :class:`~instant_distance_tpu_torch.models.hnsw.Hnsw` over the
    given graph arrays (pid order; ``layers[l-1]`` is level l)."""
    from ..models.hnsw import Hnsw

    dev = torch.device(device if device is not None else "cpu")
    return Hnsw(as_tensor(points, dev, torch.float32),
                as_tensor(zero, dev, torch.int32),
                [as_tensor(l, dev, torch.int32) for l in layers], config)


def scan_from_points(points, device=None, **kw):
    """A :class:`~instant_distance_tpu_torch.models.scan.ScanIndex` over
    ``points`` on ``device``."""
    from ..models.scan import ScanIndex

    dev = torch.device(device if device is not None else "cpu")
    return ScanIndex(as_tensor(points, dev, torch.float32), **kw)
