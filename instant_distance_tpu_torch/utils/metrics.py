"""Observability: recall harness, timers, structured build stats (the
port's own copy of ``instant_distance_tpu/utils/metrics.py``).

``force_ready`` waits for the card: torch launches CUDA work
asynchronously, so a timer that stops without a sync measures the
launch, not the work.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["recall_at_k", "Timing", "force_ready", "time_fn", "BuildStats",
           "emit"]


def recall_at_k(found_ids, true_ids, k: Optional[int] = None) -> float:
    """Mean |found ∩ true| / k over the query batch (ids < 0 ignored)."""
    found = np.asarray(found_ids)
    true = np.asarray(true_ids)
    k = k or true.shape[1]
    hits = []
    for f, t in zip(found, true):
        fs = set(int(x) for x in f[:k] if x >= 0)
        ts = set(int(x) for x in t[:k] if x >= 0)
        hits.append(len(fs & ts) / max(1, len(ts)))
    return float(np.mean(hits))


@dataclasses.dataclass
class Timing:
    wall_s: float
    per_call_s: float
    calls: int


def _leaves(out):
    if isinstance(out, (tuple, list)):
        for x in out:
            yield from _leaves(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _leaves(x)
    else:
        yield out


def force_ready(out) -> None:
    """Block until the device work behind ``out`` has finished: one
    ``torch.cuda.synchronize`` for each CUDA device that a tensor leaf of
    ``out`` (tuples, lists and dicts are walked) lives on.  Nothing to
    wait for on the CPU."""
    devices = {x.device for x in _leaves(out)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            sync: Optional[Callable] = force_ready) -> Timing:
    """Steady-state timing; ``sync`` (default :func:`force_ready`)
    drains async device work after warmup and after the timed loop —
    launches overlap execution across the loop, so ``per_call_s`` is
    sustained pipeline throughput, not single-call latency."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if sync is not None and warmup:
        sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    if sync is not None:
        sync(out)
    wall = time.perf_counter() - t0
    return Timing(wall_s=wall, per_call_s=wall / iters, calls=iters)


class BuildStats:
    """Progress callback that records per-phase wall time and insert
    throughput (the indicatif-progress-bar analogue, lib.rs:29-30)."""

    def __init__(self, log_every: int = 0):
        self.t0 = time.perf_counter()
        self.phases: dict[str, float] = {}
        self._last = self.t0
        self.total = 0
        self.log_every = log_every
        self._next_log = log_every

    def __call__(self, done: int, total: int, phase: str):
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + (now - self._last)
        self._last = now
        self.total = total
        if self.log_every and done >= self._next_log:
            rate = done / (now - self.t0)
            print(f"[build] {phase}: {done}/{total} "
                  f"({rate:,.0f} pts/s)", flush=True)
            self._next_log = done + self.log_every

    @property
    def wall_s(self) -> float:
        return time.perf_counter() - self.t0

    def summary(self) -> dict:
        return {"wall_s": round(self.wall_s, 3),
                "phases": {k: round(v, 3) for k, v in self.phases.items()}}


def emit(metric: str, value: float, unit: str,
         vs_baseline: Optional[float] = None, **extra) -> str:
    """One structured JSON metric line."""
    rec = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": vs_baseline}
    rec.update(extra)
    line = json.dumps(rec)
    print(line, flush=True)
    return line
