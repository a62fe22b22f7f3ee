"""Run one cell of the port's benchmark once.

    python3 -m annbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  A cell (``BENCHMARK.json``'s
``workloads``) is one configuration (an index deployment: data shape,
metric, index settings) under one traffic mix (a route into the port, a
batch size, a pool of query batches).  The run:

1. makes the points and a pool of query batches on the card from the
   seed (``data.py``), builds the route's index with the port
   (``routes/<route>.py``) and calls it twice on the first batch:
   ``setup_s`` runs from this module's first line to the end of that;
2. closed loop, one client: calls the route on the pool's batches in
   turn, each call timed from issue until the device is synchronised,
   for ``--seconds`` (``--trace 0``); or, under ``torch.profiler``, for
   the mix's ``trace_calls`` calls (``--trace 1``);
3. reads the peak of device memory, frees the index, and judges the
   answers of the calls that the seed picked (the first call of each
   picked pool batch) against the plain reference (``judge.py``);
4. prints the checks on standard error and one JSON line on standard
   output: the cell's end-to-end metrics (``--trace 0``) or its
   per-layer metrics (``--trace 1``), the device, and the checks last.

It exits non-zero, printing no result, without enough CUDA devices, and
when a module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up starts at the harness's first line

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from annbench import data, judge, reference, trace  # noqa: E402
from annbench.spec import Bench  # noqa: E402

#: Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "instant_distance_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name is forbidden, compared
    whole (``instant_distance_tpu_torch`` is not
    ``instant_distance_tpu``)."""
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


@contextlib.contextmanager
def one_cpu():
    """The calling thread held on one CPU, the last it may use, for the
    window.  A client thread free to move between CPUs issues each
    call's launches at a pace that differs from run to run: on one
    card, four runs of the 1M x 128 scan cell spread 1.9% in p95 with
    the thread free and 0.16% with it held (PERF.md section 2)."""
    mask = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(mask)})
    try:
        yield
    finally:
        os.sched_setaffinity(0, mask)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Cell:
    """One cell's set-up: data, pool, the route's served index, and the
    calls whose answers are judged."""

    def __init__(self, bench: Bench, workload: str, seed: int, dev,
                 serve: bool = True):
        self.entry = bench.cell(workload)
        self.spec = bench.config(self.entry["config"])
        self.traffic = bench.traffic(self.entry["traffic"])
        route_name = self.traffic["route"]
        self.params = self.spec["routes"][route_name]
        self.dev = dev
        t = self.traffic
        self.batch, self.pool_n = t["batch"], t["pool"]
        n_check = math.ceil(t["check_queries"] / self.batch)
        if n_check > self.pool_n or t["trace_calls"] < self.pool_n:
            raise ValueError(f"{self.entry['traffic']}: check_queries must "
                             "fit the pool, trace_calls cover it")
        self.picked = sorted(random.Random(seed).sample(range(self.pool_n),
                                                        n_check))
        self.points, q = data.make(self.spec, self.batch * self.pool_n, seed,
                                   dev)
        self.pool = q.view(self.pool_n, self.batch, -1)
        self.counters = {}
        self.kept = {}
        self.served = None
        if serve:
            self.served = bench.route(route_name).setup(
                self.points, self.spec, self.params, seed, self.counters)
            for _ in range(2):
                self.served.search(self.pool[0])
                _sync(dev)

    def call(self, c: int):
        d, i = self.served.search(self.pool[c % self.pool_n])
        if c in self.picked and c not in self.kept:
            self.kept[c] = (d, i)

    def timed(self, seconds: float) -> dict:
        """The measured window: every call's latency."""
        lat = []
        c = 0
        with one_cpu():
            start = now = time.perf_counter()
            while c < self.pool_n or now - start < seconds:
                t0 = time.perf_counter()
                self.call(c)
                _sync(self.dev)
                now = time.perf_counter()
                lat.append(now - t0)
                c += 1
        return {"calls": c, "window_s": now - start, "latency_s": lat}

    def traced(self) -> dict:
        """The traced window: ``trace_calls`` calls under the profiler."""
        n = self.traffic["trace_calls"]
        with one_cpu(), trace.profiler(self.dev.type == "cuda") as prof:
            for c in range(n):
                with torch.profiler.record_function(trace.CALL):
                    self.call(c)
                    with torch.profiler.record_function(trace.SYNC):
                        _sync(self.dev)
        out = trace.reduce(prof.events())
        out["calls"] = n
        return out

    def answers(self):
        """(queries [Q, D], dists [Q, k], ids [Q, k] in the points'
        order) of the picked calls."""
        qs = torch.cat([self.pool[c] for c in self.picked])
        ds = torch.cat([self.kept[c][0] for c in self.picked])
        ids = torch.cat([self.served.input_ids(self.kept[c][1])
                         for c in self.picked])
        return qs, ds, ids

    def close(self) -> None:
        self.served.close()
        self.served = None
        self.kept = {}
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(bench: Bench, workload: str, seed: int, seconds: float, traced: bool,
        dev) -> dict:
    """One run of a cell on ``dev``: the result line's object."""
    cell = Cell(bench, workload, seed, dev)
    setup_s = time.perf_counter() - _T0
    win = cell.traced() if traced else cell.timed(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    layers = cell.served.layers(cell.pool[0]) if traced else {}
    qs, got_d, got_i = cell.answers()
    route_checks = cell.served.checks()
    cell.close()
    _, true_i = reference.exact_knn(cell.points, qs, cell.spec["k"])
    verdict = judge.judge(cell.points, qs, got_d, got_i, true_i, cell.spec)
    checks = {**verdict["checks"], **route_checks}

    if traced:
        ctx = {"calls": win["calls"], "window_s": win["window_s"],
               "busy_s": win["busy_s"], "device": win["device"],
               "layers": layers, "counters": cell.counters}
        entries = bench.metrics("per_layer", workload)
        values = {m["name"]: bench.reader(m["name"]).read(ctx)
                  for m in entries}
    else:
        lat = win["latency_s"]
        values = {
            "qps": win["calls"] * cell.batch / win["window_s"],
            "p95_ms": 1e3 * statistics.quantiles(lat, n=100,
                                                 method="inclusive")[94],
            "recall_at_10": verdict["recall"],
            "peak_gib": peak / 2**30,
            "setup_s": setup_s,
        }
        entries = bench.metrics("end_to_end", workload)
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in entries if values.get(m["name"]) is not None}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type),
              "count": 1, "memory_peak_bytes": peak}
    out = {"correct": all(c["ok"] for c in checks.values()),
           "attempted": win["calls"] * cell.batch,
           "failed": verdict["failed"], "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = win["busy_s"]
        device["window_s"] = win["window_s"]
        out["breakdown"] = {"device_ops": win["device_ops"],
                            "idle_gaps": win["idle_gaps"]}
    out["checks"] = checks
    return out


def report(out: dict) -> None:
    """The checks as the last lines of standard error, then the result
    as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"annbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(bench, args.workload, args.seed, args.seconds,
              bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"annbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
