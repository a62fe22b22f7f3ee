"""Tracing and profiling hooks (port of
``instant_distance_tpu/utils/profiling.py``).

``device_trace`` records a ``torch.profiler`` trace of host ops and CUDA
kernels (Chrome trace JSON, for Perfetto or chrome://tracing);
``PhaseTimer`` times named phases on the host clock, syncing the card
at a phase's end when asked; ``annotate`` names a function's span in
such a trace (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block (CPU ops, and CUDA
    kernels where a card is present) into ``logdir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseTimer:
    """Nested wall-clock phase timing with a flat report."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None) -> Iterator[None]:
        """Time the block.  ``sync`` (any value: tensors, or True) makes
        the phase end only when the card's queued work has finished."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and torch.cuda.is_available():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {name: {"total_s": round(t, 4),
                       "calls": self.counts[name],
                       "mean_ms": round(1e3 * t / self.counts[name], 3)}
                for name, t in sorted(self.totals.items(),
                                      key=lambda kv: -kv[1])}


def annotate(name: str):
    """Decorator naming a function's span in a profiler trace."""

    def wrap(fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
