"""Per-point int8 quantization (port of ``quantize_points`` from
``instant_distance_tpu/ops/packed.py``; the packed graph layout and its
search wait for ``PackedHnsw``, ROADMAP.md §1 item 6)."""

from __future__ import annotations

import torch


def quantize_points(points):
    """Per-point symmetric int8: v ~= scale * code (max-abs scaling)."""
    points = points.float()
    amax = points.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(points / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale
