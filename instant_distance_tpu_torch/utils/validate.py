"""Graph invariant checker (the port's own copy of
``instant_distance_tpu/utils/validate.py``), the deterministic-build
analogue of the reference's safety structure.

The reference's only structural guards are per-node RwLocks plus one
debug_assert for candidate uniqueness (lib.rs:476-479), and it accepts
algorithm-level data races during parallel construction (SURVEY.md §5).
Wave construction is deterministic, so the corresponding tool here is an
explicit validator: run it after a build (or on a loaded/imported index)
to certify structural invariants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ValidationReport:
    n: int
    errors: list
    degree_histogram: dict
    mean_degree: float
    n_layers: int

    @property
    def ok(self) -> bool:
        return not self.errors


def _host(x) -> np.ndarray:
    """A graph array (a tensor on any device, or array-like) on the
    host."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def validate_graph(index_or_zero, layers=None, n: int = None) -> ValidationReport:
    """Check: pids in range, no self loops, no duplicate neighbors,
    INVALID-terminated row prefixes (the NearestIter iteration contract,
    types.rs:178-191), upper layers truncated to M and row-prefix
    consistent with their level ranges."""
    if layers is None:
        zero = _host(index_or_zero.zero)
        layers = [_host(l) for l in index_or_zero.layers]
    else:
        zero = _host(index_or_zero)
        layers = [_host(l) for l in layers]
    n = n if n is not None else zero.shape[0]
    errors = []

    def check_rows(adj, label, limit):
        if adj.size == 0:
            return
        if adj.max() >= limit:
            errors.append(f"{label}: pid {int(adj.max())} >= {limit}")
        valid = adj >= 0
        # prefix property: no valid entry after an invalid one
        seen_invalid = np.cumsum(~valid, axis=1) > 0
        if np.any(valid & seen_invalid):
            bad = int(np.argmax(np.any(valid & seen_invalid, axis=1)))
            errors.append(f"{label}: hole in row {bad}")
        # self loops
        rows = np.arange(adj.shape[0])[:, None]
        if np.any((adj == rows) & valid):
            bad = int(np.argmax(np.any((adj == rows) & valid, axis=1)))
            errors.append(f"{label}: self loop in row {bad}")
        # duplicates within a row
        s = np.sort(np.where(valid, adj, -np.arange(adj.shape[1])[None, :]
                             - 1), axis=1)
        if np.any((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)):
            bad = int(np.argmax(
                np.any((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0), axis=1)))
            errors.append(f"{label}: duplicate neighbor in row {bad}")

    check_rows(zero, "zero", n)
    for i, layer in enumerate(layers):
        check_rows(layer, f"layer_{i}", layer.shape[0])

    degrees = (zero >= 0).sum(axis=1) if zero.size else np.zeros(0, int)
    hist = {}
    if degrees.size:
        for lo, hi in [(0, 0), (1, 8), (9, 32), (33, 63), (64, 64)]:
            hist[f"{lo}-{hi}"] = int(((degrees >= lo) & (degrees <= hi)).sum())
    return ValidationReport(
        n=n, errors=errors, degree_histogram=hist,
        mean_degree=float(degrees.mean()) if degrees.size else 0.0,
        n_layers=len(layers))
