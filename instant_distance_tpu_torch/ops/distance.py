"""Batched distances (port of ``instant_distance_tpu/ops/distance.py``).

* ``gathered``      — q [B, D] x p [B, K, D] -> [B, K], elementwise.
* ``pairwise``      — q [B, D] x p [N, D] -> [B, N], one f32 matmul for
                      the matmul-form metrics.
* ``self_pairwise`` — p [B, C, D] -> [B, C, C], optionally rounded to
                      ``out_dtype`` (Alg. 4's bfloat16 pairwise matrix).

Matmuls run in full f32: the package sets TF32 off at import (see
``instant_distance_tpu_torch/__init__.py``).

A metric is one of the four names below or any callable ``f(a[D], b[D])
-> scalar`` on torch tensors (the reference's ``Point`` trait), batched
with ``torch.func.vmap``.  A vmapped callable materialises its
broadcasts ([B, K, D] for ``gathered``, [B, C, C, D] for
``self_pairwise``), so its forms run over blocks of rows holding at most
:data:`CALLABLE_ELEMS` elements each; the rows are independent, so the
blocks change peak memory, never a value.
"""

from __future__ import annotations

import torch

#: Elements of a callable metric's broadcast operand ([rows, K, D] and
#: the like) per block of rows: 2^27 f32 is 512 MiB, so a callable that
#: keeps two or three such temporaries peaks at a few GiB.
CALLABLE_ELEMS = 1 << 27


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
    """A named metric or a callable, with its batched forms.
    ``matmul_form`` is True for (sq)euclidean."""

    def __init__(self, metric):
        if isinstance(metric, Metric):
            metric = metric.name if metric.name in METRICS else metric.fn
        if callable(metric):
            self.name = getattr(metric, "__name__", "custom")
            self.fn = metric
            self._named = False
        else:
            if metric not in METRICS:
                raise ValueError(
                    f"unknown metric {metric!r}; known: {sorted(METRICS)}")
            self.name = metric
            self.fn = METRICS[metric]
            self._named = True
        self.matmul_form = self._named and self.name in ("sqeuclidean",
                                                         "euclidean")

    def one(self, a, b):
        return self.fn(_f32(a), _f32(b))

    def _blocks(self, f, lead, per_row: int, *rest):
        """``f`` over blocks of the rows of the ``lead`` operands (each
        row ``per_row`` broadcast elements), ``rest`` passed whole."""
        step = max(1, CALLABLE_ELEMS // max(1, per_row))
        return torch.cat([f(*(x[s:s + step] for x in lead), *rest)
                          for s in range(0, max(1, lead[0].shape[0]), step)])

    def gathered(self, q, p):
        """q [B, D] vs p [B, K, D] -> [B, K]."""
        q, p = _f32(q), _f32(p)
        if self._named:
            return self.fn(q[:, None, :], p)
        f = torch.func.vmap(torch.func.vmap(self.fn, in_dims=(None, 0)))
        return self._blocks(f, (q, p), p.shape[1] * p.shape[2])

    def pairwise(self, q, p):
        """q [B, D] vs p [N, D] -> [B, N]."""
        q, p = _f32(q), _f32(p)
        if self.matmul_form:
            qn = (q * q).sum(-1)
            pn = (p * p).sum(-1)
            d2 = torch.clamp(qn[:, None] - 2.0 * (q @ p.T) + pn[None, :],
                             min=0.0)
            return torch.sqrt(d2) if self.name == "euclidean" else d2
        if not self._named:
            f = torch.func.vmap(torch.func.vmap(self.fn, in_dims=(None, 0)),
                                in_dims=(0, None))
            return self._blocks(f, (q,), p.numel(), p)
        if self.name == "dot":
            return -(q @ p.T)
        return 1.0 - _normalize(q) @ _normalize(p).T

    def self_pairwise(self, p, out_dtype=None):
        """p [B, C, D] -> [B, C, C], rounded to ``out_dtype`` when given
        (Alg. 4's bfloat16 pairwise matrix)."""
        p = _f32(p)
        if self.matmul_form:
            n = (p * p).sum(-1)
            cross = torch.bmm(p, p.transpose(1, 2))
            d2 = torch.clamp(n[:, :, None] - 2.0 * cross + n[:, None, :],
                             min=0.0)
            if self.name == "euclidean":
                d2 = torch.sqrt(d2)
        elif not self._named:
            f = torch.func.vmap(torch.func.vmap(
                torch.func.vmap(self.fn, in_dims=(None, 0)),
                in_dims=(0, None)))
            d2 = self._blocks(f, (p, p), p.shape[1] ** 2 * p.shape[2])
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
