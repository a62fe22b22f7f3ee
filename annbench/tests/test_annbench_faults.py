"""``correct`` comes out false for the control and for each fault a
cell can have, with the timed path broken underneath the harness (tiny
sizes, on the CPU, so the harness's look for a card is skipped)."""

import pytest
import torch

import instant_distance_tpu_torch.models.packed as packed_model
import instant_distance_tpu_torch.models.scan as scan_model
import instant_distance_tpu_torch.ops.packed as packed_ops
from annbench import readings, run as harness
from annbench.spec import Bench
from instant_distance_tpu_torch.ops.scan_kernel import PACK_INELIGIBLE

CPU = torch.device("cpu")


def _run(tiny_root, cell, seed=11):
    return harness.run(Bench(tiny_root), cell, seed, 0.1, False, CPU)


@pytest.mark.parametrize("cell", ["tiny.scan", "tiny.hnsw"])
def test_sound_runs_are_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny.scan", "tiny.hnsw"])
def test_the_control_fails(tiny_root, cell):
    for seed in (1, 2, 3):
        v = readings.readings(Bench(tiny_root), cell, seed, CPU)
        assert not v["correct"] and v["dist_gap"] > 1e-4, v


def _state_unchanged(monkeypatch, cell):
    if cell == "tiny.scan":
        def k1(qc, w2, codes_t, *, lsub, cb, groups=0):
            return torch.full((qc.shape[0], codes_t.shape[1] // lsub),
                              PACK_INELIGIBLE, dtype=torch.int32)
        monkeypatch.setattr(scan_model, "fused_scan_bucket_int_packed", k1)
    else:
        def walk(queries, bd0, bp0, *args, **kw):
            return bd0, bp0
        monkeypatch.setattr(packed_model, "walk_search", walk)


def _rerank(monkeypatch, cell, alter):
    mod, name = ((scan_model, "rerank_exact") if cell == "tiny.scan"
                 else (packed_ops, "rerank_beam"))
    sound = getattr(mod, name)

    def broken(queries, points, ids, metric, k):
        d, i = sound(queries, points, ids, metric, k)
        return alter(d, i, points.shape[0])
    monkeypatch.setattr(mod, name, broken)


def _half_batch(d, i, n):
    # half of the batch left out, its answers taken from the other half
    h = d.shape[0] // 2
    return torch.cat([d[:h], d[:d.shape[0] - h]]), \
        torch.cat([i[:h], i[:i.shape[0] - h]])


def _one_answer(d, i, n):
    i = i.clone()
    i[0, 0] = (i[0, 0] + 1) % n
    return d, i


@pytest.mark.parametrize("cell", ["tiny.scan", "tiny.hnsw"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_each_fault_fails(tiny_root, monkeypatch, cell, fault):
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch, cell)
    else:
        _rerank(monkeypatch, cell, _half_batch if fault == "half_batch"
                else _one_answer)
    out = _run(tiny_root, cell)
    assert not out["correct"], out["checks"]
