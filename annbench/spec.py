"""The benchmark's parts, found by the names ``BENCHMARK.json`` gives.

Under a root (the checkout, or a test's directory laid out alike):
``BENCHMARK.json``; each configuration's ``file``; a traffic mix
``annbench/traffic/<traffic>.json``; the route a mix names,
``annbench/routes/<route>.py``; a per-layer metric's reader,
``annbench/metrics/<name>.py``.  A new cell or metric is new files and
new entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))

    def _path(self, *parts) -> str:
        return os.path.join(self.root, "annbench", *parts)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(self._path("traffic", f"{name}.json"))

    def _module(self, kind: str, name: str):
        path = self._path(kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"annbench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def route(self, name: str):
        return self._module("routes", name)

    def reader(self, metric: str):
        return self._module("metrics", metric)

    def metrics(self, kind: str, cell: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports: those without ``workloads``, and those that list it."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]
