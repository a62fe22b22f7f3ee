"""Profile one HNSW build of the port on a CUDA card.

Builds the first ``--n`` points of one of ``chip_smoke.py``'s data sets
(``--dim 128``: ``synthetic_clustered(1_000_000 + 8192, 128,
n_clusters=10000, seed=3)``, the packed-key build; ``--dim 300``: the
same at 300-d with seed 5, the K2 build) with the smoke's config (m=32,
wave 4096) under ``torch.profiler``, after a warm-up build of 8192
points, and prints:

* the build's wall time under the profiler and the device-kernel share
  of it;
* one line per ``build.*`` span: calls, host ms, device-kernel ms;
* the device-launching ops called most often: calls, host ms,
  device-kernel ms;
* the device kernels that take the most time: launches, ms.

``--out FILE`` also writes the profiler's full tables.  Run from the
repository root on a machine with a card:

    python -m instant_distance_tpu_torch.profile_build [--n 131072] \
        [--dim 128|300] [--out profile_build.txt]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .config import Config
from .models.hnsw import Hnsw
from .utils.datasets import synthetic_clustered


#: Ops and device kernels listed, the most frequent / longest first.
_TOP = 8
#: chip_smoke.py's data sets: dimension -> seed.
_SEEDS = {128: 3, 300: 5}


def _dev_ms(ev, self_only: bool = False) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    return getattr(ev, name, 0.0) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=131072,
                    help="points to build (default: 131072)")
    ap.add_argument("--dim", type=int, choices=_SEEDS, default=128,
                    help="the smoke's 128-d or 300-d data (default: 128)")
    ap.add_argument("--out", default=None,
                    help="also write the profiler's tables here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_build: no CUDA device", file=sys.stderr)
        return 1

    seed = _SEEDS[args.dim]
    data = synthetic_clustered(1_000_000 + 8192, args.dim, n_clusters=10000,
                               seed=seed)
    pts = torch.from_numpy(data[:args.n]).cuda()
    del data
    cfg = Config(seed=seed, m=32, wave_size=4096)
    Hnsw.build(pts[:8192], cfg)        # warm: kernel build, library handles
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        Hnsw.build(pts, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    # the spans appear twice: as host ranges (the entries kept here) and
    # as device-side annotations, which are not kernels
    spans = [e for e in events
             if e.key.startswith("build.") and e.cpu_time_total > 0]
    kernels = [e for e in events
               if e.device_type != torch.autograd.DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)]
    kernel_ms = sum(_dev_ms(e, self_only=True) for e in kernels)
    print(f"profile_build n={args.n} dim={args.dim} "
          f"({torch.cuda.get_device_name(0)}): "
          f"wall {wall_ms:.1f} ms (under the profiler), device kernels "
          f"{kernel_ms:.1f} ms = {kernel_ms / wall_ms:.1%} of wall")
    for e in sorted(spans, key=lambda e: -e.cpu_time_total):
        print(f"  span {e.key}: {e.count} calls, host "
              f"{e.cpu_time_total / 1e3:.1f} ms, device kernels "
              f"{_dev_ms(e):.1f} ms")
    # ops that launch device work (views and other host-only ops skipped)
    ops = sorted((e for e in events
                  if e.key.startswith("aten::") and _dev_ms(e) > 0),
                 key=lambda e: -e.count)
    for e in ops[:_TOP]:
        print(f"  op {e.key}: {e.count} calls, host "
              f"{e.cpu_time_total / 1e3:.1f} ms, device kernels "
              f"{_dev_ms(e):.1f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :_TOP]:
        print(f"  kernel {e.key[:60]}: {e.count} launches, "
              f"{_dev_ms(e, self_only=True):.1f} ms")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(events.table(sort_by="cuda_time_total", row_limit=45))
            f.write("\n\nby host time\n")
            f.write(events.table(sort_by="cpu_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
