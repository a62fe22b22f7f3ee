"""The plain reference, the control's rounding, the recall arithmetic
and the frozen walk count, at tiny sizes."""

import numpy as np
import pytest
import torch

from annbench import data, reference, walkcount


def _data(n=3000, d=24, q=300, seed=4):
    spec = {"n": n, "dim": d, "data": {"generator": "clustered",
                                       "n_clusters": 30, "scale": 0.15}}
    return data.make(spec, q, seed, torch.device("cpu"))


def test_data_is_the_seed_s():
    a = _data(seed=2**31 + 77)
    b = _data(seed=2**31 + 77)
    c = _data(seed=2**31 + 78)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3000, 24) and a[1].shape == (300, 24)


def test_exact_knn_matches_numpy_brute_force(monkeypatch):
    monkeypatch.setattr(reference, "QB", 64)     # several blocks each way
    monkeypatch.setattr(reference, "NB", 700)
    pts, qs = _data()
    d, i = reference.exact_knn(pts, qs, 10)
    p64, q64 = pts.numpy().astype(np.float64), qs.numpy().astype(np.float64)
    full = ((q64[:, None, :] - p64[None]) ** 2).sum(-1)
    want_i = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert np.array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, want_i, 1),
                               rtol=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -1.5,
                      1 + 2**-12])
    want = torch.tensor([1.0, 1 + 2**-10, 1.0, 1 + 2**-9, -1.5, 1.0])
    assert torch.equal(reference.round_tf32(x), want)


def test_tf32_control_answers_with_coarse_distances():
    pts, qs = _data()
    d64, i64 = reference.exact_knn(pts, qs, 10)
    d, i = reference.tf32_knn(pts, qs, 10)
    assert reference.recall_at_k(i, i64).mean() > 0.9
    gap = ((d.double() - reference.distances(pts, qs, i)).abs()
           / reference.distances(pts, qs, i))
    assert gap.max() > 1e-3


def test_recall_at_k_counts_a_repeat_once():
    true = torch.tensor([[1, 2, 3, 4]])
    assert reference.recall_at_k(torch.tensor([[4, 3, 9, 9]]), true) == 0.5
    assert reference.recall_at_k(torch.tensor([[1, 1, 1, 1]]), true) == 0.25


def test_walk_count_is_the_port_s_plain_walk():
    from instant_distance_tpu_torch.ops import walk_kernel

    g = torch.Generator().manual_seed(0)
    n, k, b, d, ef = 500, 16, 40, 24, 20
    ids = torch.randint(0, n, (n, k), generator=g, dtype=torch.int32)
    ids[:, -3:] = -1
    codes = torch.randint(-127, 128, (n, k, d), generator=g,
                          dtype=torch.int8)
    scales = torch.rand((n, k), generator=g)
    q = torch.randn((b, d), generator=g)
    bp = torch.full((b, ef), -1, dtype=torch.int32)
    bp[:, :4] = torch.randint(0, n, (b, 4), generator=g, dtype=torch.int32)
    bd = torch.where(bp >= 0, torch.rand((b, ef), generator=g), torch.inf)
    bd, order = torch.sort(bd, dim=1, stable=True)
    bp = bp.gather(1, order)
    kw = dict(expand=2, ef=ef, max_iters=60)
    *_, e, v = walk_kernel.walk_search_plain(q, bd, bp, ids, codes, scales,
                                             **kw, return_work=True)
    assert walkcount.walk_work(q, bd, bp, ids, codes, scales, rows=7,
                               **kw) == (e, v)
    assert e > b and v > e
