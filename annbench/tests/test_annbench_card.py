"""On the card: a tiny cell of each route through the whole run, trace
included.  Run there with ``python -m pytest -m gpu annbench/tests``."""

import pytest
import torch

from annbench import run as harness
from annbench.spec import Bench


@pytest.mark.gpu
@pytest.mark.parametrize("cell,kernel_metric", [
    ("tiny.scan", "k1_roofline_pct"), ("tiny.hnsw", "k4_roofline_pct")])
def test_a_tiny_cell_on_the_card(tiny_root, cell, kernel_metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = Bench(tiny_root)
    dev = torch.device("cuda", 0)
    out = harness.run(bench, cell, 2**31 + 5, 0.5, False, dev)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["peak_gib"]["value"] > 0
    out = harness.run(bench, cell, 2**31 + 5, 0.5, True, dev)
    assert out["correct"] and out["device"]["busy_s"] > 0
    m = out["metrics"]
    assert 0 < m[kernel_metric]["value"] <= 105
    assert m["launches_per_call"]["value"] > 0
    assert 0 <= m["device_idle_pct"]["value"] < 100
