"""The control's readings for the limits of ``judge.py``, over many
seeds in one process, at a cell's own size.

    python3 -m annbench.readings --workload <cell> --seeds 1 2 3 ...

The control is the reference put in the program's place and computed in
TF32 (``reference.tf32_knn``), one precision below the f32 that the
configuration states: it answers the queries of the calls that the seed
picks, and the comparison judges its answers as it judges the
program's.  The program's readings are the checks that every run of the
benchmark prints.  One JSON line a seed, naming the card it ran on; the
benchmark's own runs never run this.  Like a run, it exits non-zero
without a CUDA device: a limit is set from readings on the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from annbench import judge, reference
from annbench.run import Cell
from annbench.spec import Bench


def readings(bench: Bench, workload: str, seed: int, dev) -> dict:
    """{check: value, "correct": bool} of the control for one seed."""
    cell = Cell(bench, workload, seed, dev, serve=False)
    qs = torch.cat([cell.pool[c] for c in cell.picked])
    d, i = reference.tf32_knn(cell.points, qs, cell.spec["k"])
    truth = reference.exact_knn(cell.points, qs, cell.spec["k"])[1]
    checks = judge.judge(cell.points, qs, d, i, truth, cell.spec)["checks"]
    out = {k: c["value"] for k, c in checks.items()}
    out["correct"] = all(c["ok"] for c in checks.values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("annbench.readings: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    bench = Bench()
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control", "device": kind,
                          **readings(bench, args.workload, seed, dev)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
