"""No run loads JAX or the JAX package."""

import subprocess
import sys

from annbench.run import forbidden_modules
from annbench.spec import ROOT


def test_names_are_compared_whole():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "instant_distance_tpu",
                              "instant_distance_tpu.ops.scan"]) == [
        "flax.linen", "instant_distance_tpu",
        "instant_distance_tpu.ops.scan", "jax", "jax.numpy",
        "jaxlib.xla_client"]
    assert forbidden_modules(["instant_distance_tpu_torch",
                              "instant_distance_tpu_torch.models.scan",
                              "jaxtyping", "annbench.run", "torch"]) == []


def test_a_run_of_every_route_loads_neither(tiny_root):
    """Both tiny cells, run through the harness in a fresh interpreter:
    the modules loaded at the end hold no forbidden top-level name."""
    code = (
        "import sys, torch\n"
        "from annbench import run\n"
        "from annbench.spec import Bench\n"
        f"b = Bench({tiny_root!r})\n"
        "for cell in ('tiny.scan', 'tiny.hnsw'):\n"
        "    assert run.run(b, cell, 3, 0.1, True, torch.device('cpu'))"
        "['correct']\n"
        "assert 'instant_distance_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
