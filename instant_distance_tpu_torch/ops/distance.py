"""Batched distances (port of ``instant_distance_tpu/ops/distance.py``).

* ``gathered``      — q [B, D] x p [B, K, D] -> [B, K], elementwise.
* ``pairwise``      — q [B, D] x p [N, D] -> [B, N], one f32 matmul for
                      the matmul-form metrics.
* ``self_pairwise`` — p [B, C, D] -> [B, C, C], optionally rounded to
                      ``out_dtype`` (Alg. 4's bfloat16 pairwise matrix).

Matmuls run in full f32: the package sets TF32 off at import (see
``instant_distance_tpu_torch/__init__.py``).  Only the four named metrics
exist here; callable metrics arrive with beam-mode construction
(ROADMAP.md §1 item 5).
"""

from __future__ import annotations

import torch


def _f32(x):
    """Upcast storage dtypes (bfloat16 point tables) at the metric
    boundary: distances are always evaluated in f32."""
    return x if x.dtype == torch.float32 else x.float()


def torch_dtype(name):
    """``"bfloat16"``/``"float32"`` (the Config spellings) -> torch dtype."""
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def _sqeuclidean(a, b):
    d = a - b
    return (d * d).sum(-1)


def _euclidean(a, b):
    return torch.sqrt(_sqeuclidean(a, b))


def _neg_dot(a, b):
    return -(a * b).sum(-1)


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-30)


def _cosine(a, b):
    return 1.0 - (_normalize(a) * _normalize(b)).sum(-1)


METRICS = {
    "sqeuclidean": _sqeuclidean,
    "euclidean": _euclidean,
    "dot": _neg_dot,
    "cosine": _cosine,
}


class Metric:
    """A named metric with its batched forms."""

    def __init__(self, metric):
        if isinstance(metric, Metric):
            metric = metric.name
        if callable(metric):
            raise NotImplementedError(
                "callable metrics are not ported yet: they need beam-mode "
                "construction (ROADMAP.md §1 item 5)")
        if metric not in METRICS:
            raise ValueError(
                f"unknown metric {metric!r}; known: {sorted(METRICS)}")
        self.name = metric
        self.fn = METRICS[metric]
        self.matmul_form = metric in ("sqeuclidean", "euclidean")

    def gathered(self, q, p):
        return self.fn(_f32(q)[:, None, :], _f32(p))

    def pairwise(self, q, p):
        q, p = _f32(q), _f32(p)
        if self.matmul_form:
            qn = (q * q).sum(-1)
            pn = (p * p).sum(-1)
            d2 = torch.clamp(qn[:, None] - 2.0 * (q @ p.T) + pn[None, :],
                             min=0.0)
            return torch.sqrt(d2) if self.name == "euclidean" else d2
        if self.name == "dot":
            return -(q @ p.T)
        return 1.0 - _normalize(q) @ _normalize(p).T

    def self_pairwise(self, p, out_dtype=None):
        p = _f32(p)
        if self.matmul_form:
            n = (p * p).sum(-1)
            cross = torch.bmm(p, p.transpose(1, 2))
            d2 = torch.clamp(n[:, :, None] - 2.0 * cross + n[:, None, :],
                             min=0.0)
            if self.name == "euclidean":
                d2 = torch.sqrt(d2)
        elif self.name == "dot":
            d2 = -torch.bmm(p, p.transpose(1, 2))
        else:
            # a batched matmul, not the [B, C, C, D] broadcast of the
            # elementwise form (hundreds of GB at a 4096-point wave, 300-d)
            pn = _normalize(p)
            d2 = 1.0 - torch.bmm(pn, pn.transpose(1, 2))
        out_dtype = torch_dtype(out_dtype)
        return d2 if out_dtype is None else d2.to(out_dtype)


def resolve(metric) -> Metric:
    return metric if isinstance(metric, Metric) else Metric(metric)
