"""The benchmark's data, made on the device from the run's seed.

A frozen torch copy of the port's ``synthetic_clustered``
(``instant_distance_tpu_torch/utils/datasets.py``): ``n_clusters``
standard normal centres, each point a centre plus ``scale`` * N(0, 1)
noise.  The queries are held-out draws from the same clusters: new
points, never rows of the index.  One ``torch.Generator`` on the
device, seeded with ``--seed``, draws everything in a fixed order, so
one seed gives the same points and queries, and every seed the same
sizes.
"""

from __future__ import annotations

import torch

#: Rows drawn per call of the generator: large calls, and a bounded
#: temporary (the gathered centres) beside the points.
_ROWS = 1 << 18


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _draw(g, centers, n: int, scale: float) -> torch.Tensor:
    dev = centers.device
    out = torch.empty((n, centers.shape[1]), dtype=torch.float32, device=dev)
    for s in range(0, n, _ROWS):
        e = min(s + _ROWS, n)
        assign = torch.randint(0, centers.shape[0], (e - s,), generator=g,
                               device=dev)
        out[s:e].normal_(generator=g).mul_(scale).add_(centers[assign])
    return out


def make(spec: dict, n_queries: int, seed: int, device):
    """(points [n, dim] f32, queries [n_queries, dim] f32) of a
    configuration's ``data`` spec, on ``device``."""
    data = spec["data"]
    if data["generator"] != "clustered":
        raise ValueError(f"unknown generator {data['generator']!r}")
    g = generator(seed, device)
    centers = torch.randn((data["n_clusters"], spec["dim"]), generator=g,
                          device=device)
    points = _draw(g, centers, spec["n"], data["scale"])
    queries = _draw(g, centers, n_queries, data["scale"])
    return points, queries
