"""The yardstick of the kernels' roofline shares: published peaks, and
the least time of a call's work, frozen from the bounds of
``chip_smoke.py`` (``_bound``, ``_walk_bound``).

A kernel's least time is the larger of its operations over the peak
rate and its bytes over the HBM rate, each input counted as read once
and each output as written once, at the data's own N and D (not the
padded operands).
"""

from __future__ import annotations

#: NVIDIA H100 SXM (data sheet, dense): int8 tensor-core operations/s,
#: f32 operations/s outside the tensor cores, HBM3 bytes/s.
PEAK_INT8_OPS, PEAK_F32_OPS, PEAK_BYTES = 1979e12, 67e12, 3.35e12


def k1_least_s(b: int, n: int, d: int, lsub: int) -> float:
    """K1, the packed-key scan of ``b`` queries over ``n`` points of
    width ``d``: 2·B·N·D int8 operations; reads the queries' codes (B·D
    int8), the packed weights (N int32) and the points' codes (N·D
    int8), writes one int32 key per ``lsub`` points and query."""
    ops = 2 * b * n * d
    nbytes = b * d + 4 * n + n * d + 4 * b * (n // lsub)
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def k4_least_s(expanded: int, scored: int, k: int, d: int, b: int,
               ef: int) -> float:
    """K4, the packed walk, from one call's work: the ``k`` int32 ids of
    each of the ``expanded`` rows, the ``d`` int8 codes and f32 scale of
    each of the ``scored`` valid neighbours, the f32 queries, and the
    beams (f32 distance and int32 id a slot) read and written; or 3 f32
    operations per scored neighbour and dimension."""
    nbytes = expanded * k * 4 + scored * (d + 4) + b * d * 4 + 2 * b * ef * 8
    return max(nbytes / PEAK_BYTES, 3 * scored * d / PEAK_F32_OPS)


def share_pct(least_s: float, device_s: float):
    """Least time over measured device time, in per cent; None where
    nothing was measured."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * least_s / device_s
