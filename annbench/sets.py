"""Sets of runs of one cell, the readings that its bounds are set from.

    python3 -m annbench.sets --workload <cell> --seeds <s1> ... <s6> \
        [--traced <s> ...] [--extra <s> ...] [--out <file.jsonl>]

Each run is ``python3 -m annbench.run`` for ``BENCHMARK.json``'s
``run_seconds``, in a process of its own, one after another: each of
two sets runs the same seeds in turn with ``--trace 0``, then each
``--traced`` seed runs once with ``--trace 1`` and each ``--extra`` seed
once with ``--trace 0``.  Every run's result line, with its set, seed,
trace flag, exit code and wall seconds, is printed and appended to
``--out``.  Then, for each end-to-end metric and set: the median, the
spread ((Q3 - Q1) / median, quartiles by ``statistics.quantiles(n=4)``)
and the spread without the set's run farthest from its median.  Exits 1
if any run exited non-zero, printed no result, or was not correct, and
names each such run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from annbench.spec import Bench

#: Sets of runs on the same seeds, as the bounds are set from.
SETS = 2


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed_spread(values) -> float:
    """The spread without the run farthest from the median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda j: abs(values[j] - med))
    return spread([v for j, v in enumerate(values) if j != far])


def one_run(workload: str, seed: int, seconds: int, trace: int) -> dict:
    cmd = [sys.executable, "-m", "annbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                       text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1])
    except (IndexError, ValueError):
        out = {"correct": None, "stderr_tail": p.stderr[-2000:]}
    out.update(seed=seed, trace=trace, rc=p.returncode, wall=round(wall, 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--extra", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seconds = Bench().spec["run_seconds"]
    plan = [(str(s + 1), seed, 0) for s in range(SETS) for seed in args.seeds]
    plan += [("T", seed, 1) for seed in args.traced]
    plan += [("X", seed, 0) for seed in args.extra]
    runs, bad = [], []
    for label, seed, trace in plan:
        out = dict(one_run(args.workload, seed, seconds, trace), set=label)
        runs.append(out)
        if out["rc"] != 0 or out["correct"] is not True:
            bad.append(f"set {label} seed {seed} trace {trace}: rc "
                       f"{out['rc']}, correct {out['correct']}")
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    for s in range(SETS):
        done = [r["metrics"] for r in runs
                if r["set"] == str(s + 1) and r.get("metrics")]
        for name in sorted({m for d in done for m in d}):
            v = [d[name]["value"] for d in done if name in d]
            if len(v) >= 3:
                print(f"summary {args.workload} set {s + 1} {name}: median "
                      f"{statistics.median(v)!r} spread {spread(v)!r} "
                      f"trimmed {trimmed_spread(v)!r} runs {len(v)}",
                      flush=True)
    for b in bad:
        print(f"annbench.sets: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
