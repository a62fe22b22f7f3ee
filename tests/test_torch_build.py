"""HNSW construction and graph search in the PyTorch port vs the JAX
package.

Whole builds: the port's ``Hnsw.build`` (scan_fused route, kernel K1's
plain version here) on the same data and seed as the JAX scan_fused
build (its Pallas kernel in interpret mode) inserts the same points in
the same waves, so ids and layer sizes are identical; the graphs
themselves may differ where f32 sums in another order or top-k ties at
the pool boundary pick another candidate, so they are compared by
validity, recall and zero-layer edge overlap.  Both packages' ``Config``
are built from the same keywords.

The K2 build (300-d, and dot/cosine at any width) for sqeuclidean, dot
and cosine at D=300: a valid graph whose recall@10 against the port's
``BruteForce`` meets the seed's floor of 0.9
(tests/test_construct_scan.py) and comes within 0.02 of the JAX
``construct_mode="scan"`` build on the same data and config.  (The JAX
``scan_fused`` dot/cosine build is not the reference here: that seed
test needs tens of GB.)

Graph search: both packages search the JAX-built graph, carried over
with ``hnsw_from_arrays``.  Tolerances: pids equal on at least 99% of
entries (f32 sums in another order can reorder near-equal candidates and
so the walk), distances within 1e-5 relative where pids agree.

Building blocks, on random inputs: reverse-edge grouping, the pending
window and Alg. 4 selection with an f32 pairwise matrix are bit-exact;
with the default bfloat16 matrix the selections agree on a stated share
of rows; the two-key sort breaks ties as ``lax.sort(num_keys=2)``.

The sequential oracle: the port's ``RefHnsw`` builds the JAX package's
graph bit for bit (Alg. 4, the simple selection, a callable metric), and
the port's batched ``hnsw_search`` returns its pid lists exactly.

The port stands alone: a subprocess builds and searches with ``jax`` and
``instant_distance_tpu`` both blocked (it runs beside the item's last
checks), and the port's own copies of ``layer_sizes``, ``resolve_seed``,
``Config``, the dataset generators and ``recall_at_k`` equal the JAX
package's.  Numpy input with no ``device``
goes to the CUDA card, and raises where there is none (here).

The build modes beyond scan_fused, checkpoints and ``add`` are checked by
``tests/test_torch_construct.py``, and the serving surface (host engine,
``HybridIndex``, ``StreamingHnsw``, validation, the CLI) by
``tests/test_torch_serving.py``, on the same JAX-built graph.

The checks run as one test item that pays for one JAX build here (and
three in tests/test_torch_construct.py): each item the suite collects
shifts how pytest-xdist splits the whole suite into chunks, and one item
keeps that split as it is without the port (the reasoning is in
CHANGES.md).
"""

import dataclasses
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instant_distance_tpu as jpkg
from instant_distance_tpu import config as jconfig
from instant_distance_tpu.models.hnsw import Hnsw as JaxHnsw
from instant_distance_tpu.ops import construct as jc
from instant_distance_tpu.ops import distance as jdist
from instant_distance_tpu.ops import select as jsel
from instant_distance_tpu.utils import datasets as jdatasets
from instant_distance_tpu.utils import metrics as jmetrics
from instant_distance_tpu.utils.refimpl import RefHnsw as JaxRefHnsw
from instant_distance_tpu.utils.validate import validate_graph
import instant_distance_tpu_torch as tpkg
from instant_distance_tpu_torch import Builder, PackedHnsw, ScanIndex
from instant_distance_tpu_torch import config as tconfig
from instant_distance_tpu_torch.models.brute import BruteForce
from instant_distance_tpu_torch.models.hnsw import Hnsw, HnswMap, Search
from instant_distance_tpu_torch.ops import construct as tc
from instant_distance_tpu_torch.ops import distance as tdist
from instant_distance_tpu_torch.ops import select as tsel
from instant_distance_tpu_torch.ops.beam import hnsw_search
from instant_distance_tpu_torch.ops.sort import sort2
from instant_distance_tpu_torch.utils import datasets as tdatasets
from instant_distance_tpu_torch.utils import metrics as tmetrics
from instant_distance_tpu_torch.utils.refimpl import RefHnsw
from instant_distance_tpu_torch.utils.convert import (as_tensor,
                                                       hnsw_from_arrays,
                                                       scan_from_points)
from test_torch_construct import check_cpu as check_construct
from test_torch_packed import check_cpu as check_packed_path
from test_torch_serving import check_cpu as check_serving

# Tiny shapes: more threads only add synchronisation under a parallel run.
torch.set_num_threads(1)

N, D, Q = 1024, 16, 64
CFG_KW = dict(seed=7, m=8, wave_size=16, construct_mode="scan_fused")
CFG = tconfig.Config(**CFG_KW)
JAX_CFG = jconfig.Config(**CFG_KW)
#: Share of zero-layer edges the two builds have in common.  Measured:
#: 1.0 (identical zero layers) for seeds 7 and 8 on this data; the floor
#: leaves room for top-k ties at the pool boundary and last-ulp f32
#: differences, which may pick another candidate.
OVERLAP_FLOOR = 0.99
#: Search settings on the JAX-built graph, one per search variant, as
#: Config keywords for both packages.
SEARCH_KW = dict(CFG_KW, ef_search=32)
SEARCH_CFG = tconfig.Config(**SEARCH_KW)
SEARCH_VARIANTS = {
    "descent": SEARCH_KW,
    "expand1": dict(SEARCH_KW, search_expand=1),
    "entry_seeds": dict(SEARCH_KW, entry_seeds=128),
    "filtered": SEARCH_KW,
}


def _check_builds_agree(pts, ref, ref_ids, idx, ids):
    np.testing.assert_array_equal(ids, ref_ids)
    assert [tuple(l.shape) for l in idx.layers] == \
        [tuple(np.shape(l)) for l in ref.layers]
    np.testing.assert_allclose(idx.points.numpy(), np.asarray(ref.points))
    a, b = idx.zero.numpy(), np.asarray(ref.zero)
    common = sum(len(set(a[i][a[i] >= 0]) & set(b[i][b[i] >= 0]))
                 for i in range(N))
    overlap = common / max(1, int((b >= 0).sum()))
    assert overlap >= OVERLAP_FLOOR, f"zero-layer edge overlap {overlap:.4f}"


def _check_port_build(pts, queries, idx, ids):
    """Recall floor of tests/test_construct_scan.py (0.97 at ef=64)."""
    rep = validate_graph(idx.zero.numpy(), [l.numpy() for l in idx.layers])
    assert rep.ok, rep.errors
    assert idx.reverse_drops == 0
    gt = BruteForce(pts, device="cpu").search_batch(queries, 10)[1].numpy()
    _, p = idx.search_batch(queries, k=10, ef=64)
    pid_gt = ids[gt]
    got = p.numpy()
    rec = np.mean([len(set(got[i]) & set(pid_gt[i])) / 10 for i in range(Q)])
    assert rec >= 0.97, f"recall {rec}"


def _check_search(arrays, queries, variant):
    """One search variant on the JAX-built graph, both packages."""
    points, zero, layers = arrays
    kw = SEARCH_VARIANTS[variant]
    jax_idx = JaxHnsw(points, zero, layers, jconfig.Config(**kw))
    port = hnsw_from_arrays(points, zero, layers, tconfig.Config(**kw),
                            device="cpu")
    mask = None
    if variant == "filtered":
        mask = np.random.default_rng(3).random(N) < 0.3
        jax_idx.delete([5, 17])
        port.delete([5, 17])
    jd, jp = (np.asarray(a) for a in jax_idx.search_batch(
        queries, k=10, filter_mask=mask))
    td, tp = (a.numpy() for a in port.search_batch(
        queries, k=10, filter_mask=mask))
    same = tp == jp
    assert same.mean() >= 0.99, f"{variant}: pids agree on {same.mean():.4f}"
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-6,
                               err_msg=variant)
    if mask is not None:
        ok = mask.copy()
        ok[[5, 17]] = False
        assert np.all(ok[tp[tp >= 0]]), "a filtered or deleted pid came back"


def _check_map_api(arrays, queries):
    points, zero, layers = arrays
    values = [f"v{i}" for i in range(N)]
    port = HnswMap(torch.tensor(points), zero, layers, SEARCH_CFG, values)
    s = Search()
    hits = list(port.search(queries[0], s))
    assert len(hits) == len(s) == SEARCH_CFG.ef_search
    assert hits[0].value == f"v{hits[0].pid}"
    assert [h.distance for h in hits] == sorted(h.distance for h in hits)
    np.testing.assert_array_equal(hits[0].point, points[hits[0].pid])
    assert port.get(0, s).pid == hits[0].pid
    _, p, vals = port.search_batch_values(queries[:2], k=3)
    assert vals[1][2] == f"v{int(p[1, 2])}"
    with pytest.raises(ValueError, match="dim"):
        port.search_batch(np.zeros((2, D + 1), np.float32))


def _random_selection(seed, w=32, m0=16):
    """A wave's forward selections: distinct targets per row, sorted
    distances with ties, -1 padded rows and padded wave lanes."""
    rng = np.random.default_rng(seed)
    n = 200
    sel_p = np.stack([rng.choice(n, m0, replace=False) for _ in range(w)])
    sel_p = sel_p.astype(np.int32)
    sel_d = np.sort(rng.integers(0, 20, (w, m0)).astype(np.float32), 1)
    sel_p[:, -3:] = -1
    sel_d[:, -3:] = np.inf
    wave = np.arange(100, 100 + w, dtype=np.int32)
    wave[-4:] = -1
    sel_p[-4:] = -1
    sel_d[-4:] = np.inf
    return sel_d, sel_p, wave


def _check_reverse_grouping():
    """_group_reverse_edges and _pend_window: bit-exact."""
    sel_d, sel_p, wave = _random_selection(1)
    want = jax.jit(jc._group_reverse_edges, static_argnums=3)(
        jnp.asarray(sel_d), jnp.asarray(sel_p), jnp.asarray(wave), 200)
    got = tc._group_reverse_edges(torch.from_numpy(sel_d),
                                  torch.from_numpy(sel_p),
                                  torch.from_numpy(wave))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for cap, r in ((4, 0), (4, 1), (3, 2)):
        wp = jax.jit(jc._pend_window, static_argnums=(6, 7))(*want, cap, r)
        tp = tc._pend_window(*got, cap, r)
        for g, w in zip(tp, wp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _candidates(seed, w=24, c=40, dim=16):
    rng = np.random.default_rng(seed)
    q = rng.random((w, dim), dtype=np.float32)
    cand = rng.random((w, c, dim), dtype=np.float32)
    cand_d = ((cand - q[:, None]) ** 2).sum(-1).astype(np.float32)
    cand_p = np.tile(np.arange(c, dtype=np.int32), (w, 1))
    cand_p[:, -5:] = -1
    cand_d[:, -5:] = np.inf
    order = np.lexsort((cand_p, cand_d), axis=1)
    return (q, np.take_along_axis(cand_d, order, 1),
            np.take_along_axis(cand_p, order, 1), cand)


def _select_both(seed, pd_dtype, keep_pruned, m0=12):
    q, cd, cp, pts = _candidates(seed)
    want = jsel.select_heuristic(
        jnp.asarray(q), jnp.asarray(cd), jnp.asarray(cp), jnp.asarray(pts),
        jdist.resolve("sqeuclidean"), m0, keep_pruned=keep_pruned,
        pd_dtype=jnp.dtype(pd_dtype))
    got = tsel.select_heuristic(
        torch.from_numpy(q), torch.from_numpy(cd), torch.from_numpy(cp),
        torch.from_numpy(pts), tdist.resolve("sqeuclidean"), m0,
        keep_pruned=keep_pruned, pd_dtype=pd_dtype)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _check_select_heuristic():
    """f32 pairwise: bit-exact, with and without keep_pruned.  bfloat16
    pairwise: both round to nearest even, but last-ulp f32 differences
    upstream can flip a bridging comparison; stated agreement: at least
    95% of rows identical (measured: all rows)."""
    for keep_pruned in (True, False):
        (wd, wp), (gd, gp) = _select_both(2, "float32", keep_pruned)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gd, wd)
    rows = []
    for seed in range(3):
        (_, wp), (_, gp) = _select_both(seed, "bfloat16", True)
        rows.append(np.all(gp == wp, axis=1))
    assert np.mean(np.concatenate(rows)) >= 0.95


def _check_sort2_ties():
    """Many full and partial ties: the permutation must be JAX's."""
    rng = np.random.default_rng(0)
    prim = rng.integers(0, 4, (8, 64)).astype(np.float32)
    prim[0, :5] = np.inf
    sec = rng.integers(-1, 3, (8, 64)).astype(np.int32)
    pay = np.tile(np.arange(64, dtype=np.int32), (8, 1))
    want = jax.lax.sort((jnp.asarray(prim), jnp.asarray(sec),
                         jnp.asarray(pay)), dimension=1, num_keys=2,
                        is_stable=True)
    got = sort2(torch.from_numpy(prim), torch.from_numpy(sec),
                torch.from_numpy(pay))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


_WITHOUT_JAX = (
    "import sys\n"
    "sys.modules['jax'] = sys.modules['instant_distance_tpu'] = None\n"
    "import numpy as np, instant_distance_tpu_torch as t\n"
    "from instant_distance_tpu_torch.utils.datasets import "
    "synthetic_clustered\n"
    "from instant_distance_tpu_torch.utils.metrics import recall_at_k\n"
    "pts = synthetic_clustered(300, 8, n_clusters=10, seed=0)\n"
    "for metric in ('sqeuclidean', 'cosine'):\n"
    "    idx, ids = t.Hnsw.build(pts, t.Config(seed=1, m=4, wave_size=32,\n"
    "        metric=metric), device='cpu')\n"
    "    d, p = idx.search_batch(pts[:4], k=3)\n"
    "    assert recall_at_k(p[:, :1].numpy(), ids[:4, None]) == 1.0\n"
    "beam, _ = t.Hnsw.build(pts, t.Config(seed=1, m=4, wave_size=32,\n"
    "    metric=lambda a, b: ((a - b) ** 2).sum()), device='cpu')\n"
    "assert (beam.add(pts[:5] + 0.5) == np.arange(300, 305)).all()\n"
    "assert beam.search_batch(pts[:5] + 0.5, k=1)[1][0, 0] == 300\n"
    "for fused in ('bucket_pack', 'bucket_int', 'bucket', 'topt'):\n"
    "    d, i = t.ScanIndex(pts, device='cpu').search_batch(\n"
    "        pts[:4], k=3, fused=fused, lsub=8, cb=64)\n"
    "    assert (i[:, 0].numpy() == np.arange(4)).all(), fused\n"
    "import os, tempfile\n"
    "with tempfile.TemporaryDirectory() as tmp:\n"
    "    f = os.path.join(tmp, 'p.npz')\n"
    "    idx.dump(f)\n"
    "    pk = t.PackedHnsw.from_index(t.Hnsw.load(f, device='cpu'))\n"
    "    pk.dump(f)\n"
    "    pk = t.PackedHnsw.load(f, device='cpu')\n"
    "q = idx.points[:4]\n"
    "for p in (pk.search_batch(q, k=3)[1],\n"
    "          pk.search_batch_kernel(q, k=3, entry_seeds=64)[1]):\n"
    "    assert (p[:, 0].numpy() == np.arange(4)).all()\n"
    "from instant_distance_tpu_torch import native\n"
    "from instant_distance_tpu_torch.models.hybrid import HybridIndex\n"
    "from instant_distance_tpu_torch.utils import profiling, validate\n"
    "from instant_distance_tpu_torch.__main__ import main\n"
    "nat, _ = t.Hnsw.build(pts, t.Config(seed=1, m=4), backend='native',\n"
    "    device='cpu')\n"
    "assert validate.validate_graph(nat).ok\n"
    "assert (HybridIndex(nat).search_batch(pts[:2], k=1)[1][:, 0]\n"
    "        == nat.search_batch(pts[:2], k=1)[1][:, 0].numpy()).all()\n"
    "s = t.StreamingHnsw(nat, serving='scan')\n"
    "assert s.search_batch(pts[:3] + 1, k=1)[1][0, 0] != 300\n"
    "s.add(pts[:3] + 1)\n"
    "assert (s.search_batch(pts[:3] + 1, k=1)[1][:, 0].numpy()\n"
    "        == np.arange(300, 303)).all()\n"
    "from instant_distance_tpu_torch.parallel import (mesh, replicated,\n"
    "    scan, sharded)\n"
    "sh = t.ShardedHnsw.build(pts, t.Config(seed=1, m=4, wave_size=32),\n"
    "    mesh=mesh.default_mesh(devices=['cpu'] * 4))\n"
    "assert sh.n_shards == 4 and len(sh) == 300\n"
    "assert (sh.search_batch(pts[:4], k=1)[1][:, 0].numpy()\n"
    "        == np.arange(4)).all()\n"
    "from instant_distance_tpu_torch.utils.refimpl import RefHnsw\n"
    "ref = RefHnsw(pts[:50], t.Config(seed=1, m=4, ef_construction=16))\n"
    "assert ref.search(ref.points[7], ef=8)[0][1] == 7\n"
    "from instant_distance_tpu_torch.utils.datasets import load_config\n"
    "rgb, rgb_q = load_config('rgb', n=32)\n"
    "assert rgb.shape == (32, 3) and rgb_q.shape == (10_000, 3)\n"
    "import contextlib, io\n"
    "from instant_distance_tpu_torch.examples import colors\n"
    "out = io.StringIO()\n"
    "with contextlib.redirect_stdout(out):\n"
    "    colors.main(['--device', 'cpu'])\n"
    "assert out.getvalue() == 'red\\n', out.getvalue()\n"
    "loaded = {m.split('.')[0] for m in sys.modules\n"
    "          if sys.modules[m] is not None}\n"
    "assert not loaded & {'jax', 'instant_distance_tpu'}, loaded\n"
    "print('ok')\n")


def _start_without_jax():
    """Start :func:`_check_runs_without_jax`'s subprocess, which runs
    beside the item's later checks (after ``check_serving`` has built the
    host engine it loads); returns it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", _WITHOUT_JAX],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _check_runs_without_jax(proc):
    """The port imports nothing of JAX or the JAX package: a tiny CPU
    build (K1 and K2 routes), a beam build with a callable metric and an
    add to it, graph search, kernel-path scans, a dump, load, pack and
    packed search (both routes), and a native build served by
    ``HybridIndex`` and ``StreamingHnsw`` (with the CLI, validation and
    profiling modules imported), a 4-shard ``ShardedHnsw`` on the CPU
    with the ``parallel`` modules imported, a 50-point ``RefHnsw``, the
    ladder's ``load_config`` and the colors example (``--device cpu``)
    succeed with ``jax`` and ``instant_distance_tpu`` blocked, and so do
    the dataset and recall helpers that chip_smoke.py imports."""
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and out.strip() == "ok", err


#: The K2 builds: D=300 clustered data, a pool and waves small enough for
#: the CPU (the JAX reference compiles a wave program per shape).
K2_N, K2_D, K2_Q = 512, 300, 32
K2_KW = dict(seed=5, m=8, wave_size=16, ef_construction=24)


def _check_k2_builds():
    data = tdatasets.synthetic_clustered(K2_N + K2_Q, K2_D, n_clusters=32,
                                         seed=4)
    pts, queries = data[:K2_N], data[K2_N:]
    for metric in ("sqeuclidean", "dot", "cosine"):
        kw = dict(K2_KW, metric=metric)
        idx, ids = Hnsw.build(torch.from_numpy(pts), tconfig.Config(**kw))
        rep = validate_graph(idx.zero.numpy(), [l.numpy() for l in idx.layers])
        assert rep.ok, (metric, rep.errors)
        assert idx.reverse_drops == 0
        gt = ids[BruteForce(pts, metric, device="cpu").search_batch(
            queries, 10)[1].numpy()]
        rec = tmetrics.recall_at_k(
            idx.search_batch(queries, k=10, ef=64)[1].numpy(), gt)
        ref, ref_ids = JaxHnsw.build(
            pts, jconfig.Config(construct_mode="scan", **kw))
        ref_gt = ref_ids[BruteForce(pts, metric, device="cpu").search_batch(
            queries, 10)[1].numpy()]
        ref_rec = tmetrics.recall_at_k(
            np.asarray(ref.search_batch(queries, k=10, ef=64)[1]), ref_gt)
        assert rec >= 0.9 and rec >= ref_rec - 0.02, (metric, rec, ref_rec)


#: The oracle checks: test_beam_vs_oracle.py's 700 x 8 sqeuclidean data
#: and seed, with M 4 and ef_construction 16 (a sequential Python build
#: at the default M 32 and 100 takes tens of seconds), which still
#: gives four layers; the callable metric's 200 x 4 at M 2 and 8, since
#: the JAX oracle calls its (jitted) jnp callable once per distance.
ORACLE_KW = dict(seed=1234, metric="sqeuclidean", m=4, ef_construction=16)
CALLABLE_KW = dict(seed=3, m=2, ef_construction=8)


def _same_oracle(got, want, what):
    np.testing.assert_array_equal(got.ids, want.ids, err_msg=what)
    np.testing.assert_array_equal(got.points, want.points, err_msg=what)
    np.testing.assert_array_equal(got.zero, want.zero, err_msg=what)
    assert len(got.layers) == len(want.layers), what
    for g, w in zip(got.layers, want.layers):
        np.testing.assert_array_equal(g, w, err_msg=what)


def _check_refimpl():
    """The port's ``RefHnsw`` builds the JAX package's graph bit for bit
    (ids, points, zero layer, upper layers) with Alg. 4 and with the
    simple selection, and with a callable metric (a jnp lambda there,
    the same torch lambda here); the port's batched ``hnsw_search`` on
    the oracle's graph returns the oracle's pid lists exactly and its
    distances within 1e-5 relative (tests/test_beam_vs_oracle.py:60-76,
    on the CPU)."""
    rng = np.random.default_rng(1234)
    pts = rng.standard_normal((700, 8)).astype(np.float32)
    queries = rng.standard_normal((8, 8)).astype(np.float32)
    for heuristic, jax_heuristic in ((tconfig.Heuristic(),
                                      jconfig.Heuristic()), (None, None)):
        ref = RefHnsw(pts, tconfig.Config(heuristic=heuristic, **ORACLE_KW))
        _same_oracle(ref, JaxRefHnsw(pts, jconfig.Config(
            heuristic=jax_heuristic, **ORACLE_KW)), f"RefHnsw {heuristic}")
        assert len(ref.layers) >= 2
        cfg = ref.config
        d, p = hnsw_search(
            torch.from_numpy(queries), torch.from_numpy(ref.zero),
            tuple(torch.from_numpy(a) for a in reversed(ref.layers)),
            torch.from_numpy(ref.points), tdist.resolve(cfg.metric), ef=64,
            m=cfg.m, zero_links=cfg.m0)
        for i, q in enumerate(queries):
            oracle = ref.search(q, ef=64)
            assert p[i, :len(oracle)].tolist() == [pid for _, pid in oracle]
            np.testing.assert_allclose(
                d[i, :len(oracle)].numpy(),
                np.array([dd for dd, _ in oracle], np.float32), rtol=1e-5)
    pts = rng.standard_normal((200, 4)).astype(np.float32)
    ref = RefHnsw(pts, tconfig.Config(
        metric=lambda a, b: ((a - b) ** 2).sum(), **CALLABLE_KW))
    _same_oracle(ref, JaxRefHnsw(pts, jconfig.Config(
        metric=jax.jit(lambda a, b: jnp.sum((a - b) ** 2)), **CALLABLE_KW)),
        "RefHnsw callable")


def _check_copies():
    """The port's own copies equal the JAX package's originals."""
    for n, ml, m in ((1, 0.3, 4), (1000, 1 / np.log(8), 8),
                     (1_000_000, 1 / np.log(32), 32), (50, 0.9, 2)):
        assert tconfig.layer_sizes(n, ml, m) == jconfig.layer_sizes(n, ml, m)
    assert tconfig.resolve_seed(11) == jconfig.resolve_seed(11) == 11
    assert isinstance(tconfig.resolve_seed(None), int)
    assert ([(f.name, f.default) for f in dataclasses.fields(tconfig.Config)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jconfig.Config)])
    assert tconfig.Config().m0 == jconfig.Config().m0
    assert tconfig.DEFAULT_M == jconfig.DEFAULT_M
    assert tconfig.INVALID == jconfig.INVALID
    np.testing.assert_array_equal(
        tdatasets.synthetic_clustered(300, 7, n_clusters=5, seed=3),
        jdatasets.synthetic_clustered(300, 7, n_clusters=5, seed=3))
    np.testing.assert_array_equal(tdatasets.synthetic_uniform(50, 4, seed=2),
                                  jdatasets.synthetic_uniform(50, 4, seed=2))
    rng = np.random.default_rng(1)
    found = rng.integers(-1, 20, (9, 10))
    true = rng.integers(-1, 20, (9, 10))
    assert (tmetrics.recall_at_k(found, true, 5)
            == jmetrics.recall_at_k(found, true, 5))


def _check_card_default():
    """Numpy input with no device goes to the card; here, with none, every
    entry point (an example among them) raises instead of running on the
    CPU.  CPU tensors keep their device."""
    pts = np.zeros((40, 4), np.float32)
    assert as_tensor(torch.zeros(2)).device.type == "cpu"
    assert as_tensor(pts, "cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert as_tensor(pts).device.type == "cuda"
        return
    from instant_distance_tpu_torch.examples import colors
    from instant_distance_tpu_torch.parallel.mesh import default_mesh

    entry_points = (
        lambda: colors.main([]),
        lambda: default_mesh(),
        lambda: tpkg.ShardedHnsw.build(pts, CFG),
        lambda: tpkg.ShardedScanIndex(pts),
        lambda: as_tensor(pts),
        lambda: Hnsw.build(pts, CFG),
        lambda: HnswMap.build(pts, list(range(40)), CFG),
        lambda: Builder(CFG).build_hnsw(pts),
        lambda: ScanIndex(pts),
        lambda: BruteForce(pts),
        lambda: scan_from_points(pts),
        lambda: hnsw_from_arrays(pts, np.full((40, 16), -1, np.int32), [],
                                 CFG))
    for call in entry_points:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _check_from_index_tombstones(arrays):
    """A delete on an index, or on a ``from_index`` child, is seen by no
    other object: each keeps its own mask (the JAX package makes a new
    array on every delete)."""
    h = hnsw_from_arrays(*arrays, SEARCH_CFG, device="cpu")
    h.delete([1])
    scan = ScanIndex.from_index(h)
    scan.delete([5])
    packed = PackedHnsw.from_index(h)
    packed.delete([7])
    h.delete([9])
    for obj, dead in ((h, [1, 9]), (scan, [1, 5]), (packed, [1, 7])):
        got = (~obj._alive).nonzero().flatten().tolist()
        assert got == dead, (type(obj).__name__, got)
    assert h.is_deleted(9) and not h.is_deleted(5) and h.n_deleted == 2
    assert hnsw_from_arrays(*arrays, SEARCH_CFG, device="cpu").n_deleted == 0


def _check_signatures():
    """Every public method of every class both packages export (the
    ``Sharded*``/``Replicated*`` wrappers among them) and of
    ``ShardedPackedHnsw`` takes the reference's parameter names; the port
    adds ``device`` and nothing else.  The mesh helpers and the sharded
    serializers take the reference's parameters first (``distributed_
    mesh`` adds the ``devices`` a process holds).  No NotImplementedError
    is left in the port."""
    from instant_distance_tpu.parallel import mesh as jmesh
    from instant_distance_tpu.parallel import sharded as jsharded
    from instant_distance_tpu.utils import serialize as jser
    from instant_distance_tpu_torch.parallel import mesh as tmesh
    from instant_distance_tpu_torch.parallel import sharded as tsharded
    from instant_distance_tpu_torch.utils import serialize as tser

    names = sorted(set(jpkg.__all__) & set(tpkg.__all__))
    assert {"ShardedHnsw", "ShardedScanIndex", "ReplicatedHnsw",
            "ReplicatedPackedHnsw", "ReplicatedScanIndex"} <= set(names)
    pairs = [(name, getattr(jpkg, name), getattr(tpkg, name))
             for name in names]
    pairs.append(("ShardedPackedHnsw", jsharded.ShardedPackedHnsw,
                  tsharded.ShardedPackedHnsw))
    for name, ref, port in pairs:
        if not inspect.isclass(ref):
            continue
        for attr, member in vars(ref).items():
            if attr.startswith("_") and attr != "__init__":
                continue
            if isinstance(member, property):
                assert isinstance(inspect.getattr_static(port, attr, None),
                                  property), (name, attr)
                continue
            if not callable(getattr(ref, attr)):
                continue
            want = list(inspect.signature(getattr(ref, attr)).parameters)
            got = list(inspect.signature(getattr(port, attr)).parameters)
            assert [p for p in got if p != "device"] == want, \
                (name, attr, got, want)
    for ref, port in ((jmesh.default_mesh, tmesh.default_mesh),
                      (jmesh.distributed_mesh, tmesh.distributed_mesh),
                      (jser.dump_sharded, tser.dump_sharded),
                      (jser.load_sharded, tser.load_sharded)):
        want = list(inspect.signature(ref).parameters)
        got = list(inspect.signature(port).parameters)
        assert got[:len(want)] == want, (port.__name__, got, want)
    root = os.path.dirname(tpkg.__file__)
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if fname.endswith(".py"):
                with open(os.path.join(dirpath, fname)) as f:
                    assert "NotImplementedError" not in f.read(), fname


def _check_empty_batch_width(arrays):
    """A [0, D + 1] batch raises ValueError at every search entry point
    (the JAX package lets an empty batch of any width through)."""
    h = hnsw_from_arrays(*arrays, SEARCH_CFG, device="cpu")
    hmap = HnswMap(h.points, h.zero, h.layers, SEARCH_CFG, list(range(N)))
    scan = ScanIndex.from_index(hmap)
    packed = PackedHnsw.from_index(hmap)
    bad = torch.zeros((0, D + 1))
    for call in (lambda: h.search_batch(bad, 3, 10),
                 lambda: h.search(bad, Search()),
                 lambda: hmap.search(bad, Search()),
                 lambda: hmap.search_batch_values(bad, 3),
                 lambda: scan.search_batch(bad),
                 lambda: scan.search_batch(bad, fused="bucket_pack", lsub=16,
                                           cb=256),
                 lambda: scan.search_batch_values(bad),
                 lambda: BruteForce(h.points).search_batch(bad, 3),
                 lambda: packed.search_batch(bad),
                 lambda: packed.search_batch_kernel(bad, entry_seeds=64),
                 lambda: packed.search_batch_values(bad)):
        with pytest.raises(ValueError, match="dim"):
            call()


def test_build_and_search_match_jax():
    rng = np.random.default_rng(7)
    pts = rng.random((N, D), dtype=np.float32)
    queries = rng.random((Q, D), dtype=np.float32)
    ref, ref_ids = JaxHnsw.build(pts, JAX_CFG)
    idx, ids = Hnsw.build(pts, CFG, device="cpu")
    _check_builds_agree(pts, ref, ref_ids, idx, ids)
    _check_port_build(pts, queries, idx, ids)

    arrays = (np.asarray(ref.points), np.asarray(ref.zero),
              [np.asarray(l) for l in ref.layers])
    assert validate_graph(arrays[1], arrays[2]).ok
    for variant in SEARCH_VARIANTS:
        _check_search(arrays, queries, variant)
    _check_map_api(arrays, queries)
    _check_from_index_tombstones(arrays)
    _check_empty_batch_width(arrays)
    _check_signatures()
    check_packed_path(arrays, queries)
    check_construct(arrays, queries)
    check_serving(arrays, queries)

    without_jax = _start_without_jax()
    try:
        _check_k2_builds()
        _check_refimpl()
        _check_reverse_grouping()
        _check_select_heuristic()
        _check_sort2_ties()
        _check_copies()
        _check_card_default()
        _check_runs_without_jax(without_jax)
    finally:
        if without_jax.poll() is None:
            without_jax.kill()
            without_jax.wait()
