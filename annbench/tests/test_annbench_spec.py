"""The benchmark's parts are found by name, and a new cell or metric is
new files and entries only."""

import json
import os
import re

import torch

from annbench import run as harness
from annbench.spec import ROOT, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_part_is_found_by_name():
    bench = Bench()
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        cfg = bench.config(w["config"])
        traffic = bench.traffic(w["traffic"])
        assert traffic["route"] in cfg["routes"]
        assert hasattr(bench.route(traffic["route"]), "setup")
        assert w["chips"] == 1 and len(w["why"]) <= 200
        e2e = {m["name"] for m in bench.metrics("end_to_end", w["name"])}
        assert {"setup_s", "qps"} <= e2e
        assert bench.metrics("per_layer", w["name"])
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("annbench/")
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]).read)
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "kernels" in layers


def test_a_new_cell_and_metric_are_new_files(tiny_root):
    """A throwaway cell and per-layer metric, added as files and entries
    in a copy of the benchmark, run through the harness unchanged."""
    with open(os.path.join(tiny_root, "annbench", "traffic",
                           "scan.tiny2.json"), "w") as f:
        json.dump({"route": "scan", "batch": 32, "pool": 4,
                   "check_queries": 64, "trace_calls": 4}, f)
    with open(os.path.join(tiny_root, "annbench", "metrics",
                           "calls_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['calls'])\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny.scan2", "config": "tiny_scan",
                              "traffic": "scan.tiny2", "chips": 1,
                              "why": "tests"})
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "qps",
                              "workloads": ["tiny.scan2"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    bench = Bench(tiny_root)
    cpu = torch.device("cpu")
    out = harness.run(bench, "tiny.scan2", 5, 0.2, False, cpu)
    assert out["correct"] and out["attempted"] >= 4 * 32
    assert set(out["metrics"]) == {"qps", "p95_ms", "recall_at_10",
                                   "peak_gib", "setup_s"}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"bad_ids", "dist_gap", "recall_min"}
    out = harness.run(bench, "tiny.scan2", 5, 0.2, True, cpu)
    assert out["correct"]
    assert out["metrics"]["calls_traced"] == {"value": 4.0, "unit": "calls"}
