"""A tiny copy of the benchmark for CPU tests: the repository's
``BENCHMARK.json`` and ``annbench/`` files in a temporary root, plus a
tiny configuration and one tiny traffic mix a route, and a cell for
each (``tiny.scan``, ``tiny.hnsw``).  Run from the repository root:

    python -m pytest annbench/tests -q
"""

import json
import os
import shutil

import pytest

from annbench.spec import ROOT

TINY = {
    "name": "tiny", "n": 8192, "dim": 32, "metric": "sqeuclidean", "k": 10,
    "data": {"generator": "clustered", "n_clusters": 64, "scale": 0.15},
    "recall_floor": 0.95, "recall_block": 64, "dist_gap_limit": 0.0001,
    "routes": {
        "scan": {"search": {"fused": "bucket_pack", "lsub": 16, "cb": 1024,
                            "inner": 2, "ef": 32}},
        "hnsw": {"build": {"m": 8, "wave_size": 256, "ef_search": 50},
                 "search": {"ef": 50, "entry_seeds": 256, "expand": 2}},
    },
}


def make_root(path, hnsw_n: int = 2048) -> str:
    """A benchmark root at ``path`` with the tiny cells added."""
    root = str(path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for part in ("configs", "traffic", "routes", "metrics"):
        shutil.copytree(os.path.join(ROOT, "annbench", part),
                        os.path.join(root, "annbench", part))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for route, n in (("scan", TINY["n"]), ("hnsw", hnsw_n)):
        cfg = dict(TINY, name=f"tiny_{route}", n=n)
        with open(os.path.join(root, "annbench", "configs",
                               f"tiny_{route}.json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(root, "annbench", "traffic",
                               f"{route}.tiny.json"), "w") as f:
            json.dump({"route": route, "batch": 64, "pool": 4,
                       "check_queries": 128, "trace_calls": 4}, f)
        spec["configs"].append({
            "name": f"tiny_{route}", "source": "tests", "reduced": [],
            "file": f"annbench/configs/tiny_{route}.json", "why": "tests"})
        spec["workloads"].append({
            "name": f"tiny.{route}", "config": f"tiny_{route}",
            "traffic": f"{route}.tiny", "chips": 1, "why": "tests"})
    for m in spec["per_layer"]:
        m["workloads"] = m["workloads"] + ["tiny.scan", "tiny.hnsw"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("annbench"))
