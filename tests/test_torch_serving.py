"""The single-card serving surface of the PyTorch port vs the JAX package:
the host engine (``native/``), ``Hnsw.build(backend="native")``,
``HybridIndex``, ``StreamingHnsw``, ``validate_graph``, the profiling
hooks, the timing helpers and the CLI.

This file defines no test item of its own (each item the suite collects
shifts how pytest-xdist splits the whole suite, tests/test_torch_build.py
says why): ``tests/test_torch_build.py::test_build_and_search_match_jax``
calls :func:`check_cpu` with its JAX-built 1024 x 16 graph.

What is held, and how tightly:

* Host engine: the port's ``NativeHnsw`` over that graph gives the JAX
  engine's ``search_batch`` results bit for bit (1 thread and all
  cores), and a one-thread ``NativeHnsw.build`` the same ``to_arrays``
  bit for bit (the same C++ under the same flags).  ``Hnsw.build(
  backend="native")`` reaches the recall of the JAX native build less
  NATIVE_SLACK (both builds use every core, so threads insert in a
  run-dependent order).  A changed CPU identity gives another library
  path, and the library is compiled for it, not loaded.
* HybridIndex: host-routed results equal the JAX ``HybridIndex``'s bit
  for bit; device-routed results equal the port index's own
  ``search_batch``; both packages route filter masks, tombstones and a
  graph grown after the lift the same way (a recording device index
  shows the route, so no JAX search is compiled).
* StreamingHnsw: the slab scan and merge against JAX
  ``_slab_search_jit`` on the JAX package's own padded slab and its
  two-key sort: ids bit-exact, distances within SLAB_TOL (the port's f32
  matmul sums in another order), for a slab smaller than k, a filter
  over pending rows and deletes; the port scans the slab unpadded.
  Compaction falls where JAX ``_auto_repack`` puts it, and every
  just-added point comes back at rank 0.
* ``validate_graph`` gives the JAX function's report on a good graph and
  on corrupted ones; the CLI's ``info`` JSON equals the JAX CLI's on the
  same file and ``validate``'s exit codes match (``main`` in-process).
"""

import contextlib
import dataclasses
import io
import json
import os
import tempfile
import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from instant_distance_tpu import config as jconfig
from instant_distance_tpu.__main__ import main as jax_main
from instant_distance_tpu.models.hnsw import Hnsw as JaxHnsw
from instant_distance_tpu.models.hybrid import HybridIndex as JaxHybrid
from instant_distance_tpu.models import streaming as jstream
from instant_distance_tpu.native import NativeHnsw as JaxNative
from instant_distance_tpu.utils import metrics as jmetrics
from instant_distance_tpu.utils.validate import \
    validate_graph as jax_validate
import instant_distance_tpu_torch as tpkg
from instant_distance_tpu_torch import native as tnative
from instant_distance_tpu_torch import config as tconfig
from instant_distance_tpu_torch.__main__ import main as port_main
from instant_distance_tpu_torch.models import streaming as tstream
from instant_distance_tpu_torch.models.brute import BruteForce
from instant_distance_tpu_torch.models.hnsw import Hnsw, HnswMap, Search
from instant_distance_tpu_torch.models.hybrid import HybridIndex
from instant_distance_tpu_torch.models.streaming import StreamingHnsw
from instant_distance_tpu_torch.native import cpu as tcpu
from instant_distance_tpu_torch.utils import metrics as tmetrics
from instant_distance_tpu_torch.utils import profiling
from instant_distance_tpu_torch.utils.convert import hnsw_from_arrays
from instant_distance_tpu_torch.utils.validate import validate_graph

CFG_KW = dict(seed=7, m=8, ef_search=32)
#: Recall@10 the port's native build may lose to the JAX native build on
#: the same data (thread-dependent insertion order in both).
NATIVE_SLACK = 0.01
#: Slab distances: f32 matmul forms summed in another order.
SLAB_TOL = dict(rtol=1e-5, atol=1e-5)
K = 10


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# host engine
# ---------------------------------------------------------------------------

def _check_host_engine(arrays, queries):
    assert tnative.available(), tnative.load_error()
    points, zero, layers = arrays
    port = hnsw_from_arrays(points, zero, layers,
                            tconfig.Config(**CFG_KW), device="cpu")
    # tensors in (the port's own index), numpy in (the JAX package's)
    mine = tnative.NativeHnsw.from_arrays(port.points, port.zero,
                                          port.layers, "sqeuclidean", 8)
    ref = JaxNative.from_arrays(points, zero, layers, "sqeuclidean", 8)
    for threads in (1, 0):
        got = mine.search_batch(torch.from_numpy(queries), ef=32, k=K,
                                n_threads=threads)
        want = ref.search_batch(queries, ef=32, k=K, n_threads=threads)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{threads=}")

    cfg_kw = dict(CFG_KW, ef_construction=40)
    got = tnative.NativeHnsw.build(points, tconfig.Config(**cfg_kw),
                                   n_threads=1).to_arrays(8)
    want = JaxNative.build(points, jconfig.Config(**cfg_kw),
                           n_threads=1).to_arrays(8)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert len(got[3]) == len(want[3])
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)

    # the entry point: the native build's recall vs the JAX one's
    idx, ids = Hnsw.build(points, tconfig.Config(**cfg_kw),
                          backend="native", device="cpu")
    assert idx.device == torch.device("cpu")
    assert validate_graph(idx).ok
    jidx, jids = JaxHnsw.build(points, jconfig.Config(**cfg_kw),
                               backend="native")
    truth = BruteForce(points, device="cpu").search_batch(queries, K)[1]
    truth = _np(truth)

    def recall(arrs, ids_):
        eng = tnative.NativeHnsw.from_arrays(*arrs, "sqeuclidean", 8)
        return tmetrics.recall_at_k(
            eng.search_batch(queries, ef=32, k=K, n_threads=1)[1],
            ids_[truth])

    rec = recall((idx.points, idx.zero, idx.layers), ids)
    ref_rec = recall((np.asarray(jidx.points), np.asarray(jidx.zero),
                      [np.asarray(l) for l in jidx.layers]), jids)
    assert rec >= 0.9 and rec >= ref_rec - NATIVE_SLACK, (rec, ref_rec)
    hmap = HnswMap.build(points, [f"v{i}" for i in range(len(points))],
                         tconfig.Config(**cfg_kw), backend="native",
                         device="cpu")
    assert hmap.values[0] == f"v{int(np.flatnonzero(ids == 0)[0])}"
    with pytest.raises(ValueError, match="named metrics"):
        Hnsw.build(points, tconfig.Config(metric=lambda a, b: 0.0),
                   backend="native", device="cpu")
    # shapes are checked before any pointer reaches the engine
    with pytest.raises(ValueError, match="queries must be"):
        mine.search_batch(queries[:, :5], ef=32)
    with pytest.raises(ValueError, match="do not fit"):
        tnative.NativeHnsw.from_arrays(points, zero[:, :8], layers,
                                       "sqeuclidean", 8)


def _check_host_rebuild():
    """The library's path hashes the CPU identity: another identity finds
    no library and compiles one (into a scratch directory here) instead
    of loading this CPU's."""
    saved = (tcpu._LIB, tcpu._LIB_ERR, tcpu.BUILD_DIR, tcpu.cpu_identity,
             tcpu._compile)
    here = tcpu.lib_path()
    assert os.path.exists(here)  # built by the checks before
    compiled = []

    def record(path):
        compiled.append(path)
        saved[4](path)

    try:
        with tempfile.TemporaryDirectory() as tmp:
            tcpu.BUILD_DIR = tmp
            tcpu._compile = record
            tcpu._LIB = tcpu._LIB_ERR = None
            tcpu.cpu_identity = lambda: saved[3]() + "\nflags : another"
            other = tcpu.lib_path()
            assert os.path.basename(other) != os.path.basename(here)
            assert tcpu.available(), tcpu.load_error()
            assert compiled == [other] and os.path.exists(other)
            tcpu._LIB = None
            assert tcpu.available() and compiled == [other]  # loaded now
    finally:
        (tcpu._LIB, tcpu._LIB_ERR, tcpu.BUILD_DIR, tcpu.cpu_identity,
         tcpu._compile) = saved


# ---------------------------------------------------------------------------
# HybridIndex
# ---------------------------------------------------------------------------

class _Recorder:
    """A device index that records that it was called."""

    def __init__(self):
        self.calls = 0

    def search_batch(self, q, k=10, ef=None, filter_mask=None):
        self.calls += 1
        return "device", "device"


def _routes(hyb, rec, q, **kw):
    before = rec.calls
    hyb.search_batch(q, k=5, **kw)
    return "device" if rec.calls > before else "host"


def _check_hybrid(arrays, queries):
    points, zero, layers = arrays
    port = hnsw_from_arrays(points, zero, layers,
                            tconfig.Config(**CFG_KW), device="cpu")
    jidx = JaxHnsw(points, zero, layers, jconfig.Config(**CFG_KW))
    # host route: bit for bit against the JAX HybridIndex
    hyb, jhyb = HybridIndex(port, threshold=64), JaxHybrid(jidx,
                                                           threshold=64)
    assert hyb.host_available
    got, want = hyb.search_batch(queries[:8], k=K), jhyb.search_batch(
        queries[:8], k=K)
    assert isinstance(got[1], np.ndarray)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a CPU tensor batch takes the same host route
    got_t = hyb.search_batch(torch.from_numpy(queries[:8]), k=K)
    np.testing.assert_array_equal(got_t[1], want[1])
    # device route: the port index's own search_batch
    d, i = hyb.search_batch(queries, k=K)
    wd, wi = port.search_batch(queries, k=K, ef=32)
    assert torch.equal(i, wi) and torch.equal(d, wd)

    # routing: the same decision in both packages
    mask = np.zeros(len(points), bool)
    mask[:100] = True
    rec, jrec = _Recorder(), _Recorder()
    hyb = HybridIndex(port, tpu_index=rec, threshold=16)
    jhyb = JaxHybrid(jidx, tpu_index=jrec, threshold=16)
    cases = (("small", queries[:4], {}), ("threshold", queries[:16], {}),
             ("filter", queries[:2], dict(filter_mask=mask)))
    for what, q, kw in cases:
        assert _routes(hyb, rec, q, **kw) == _routes(jhyb, jrec, q, **kw), \
            what
    assert [_routes(hyb, rec, queries[:2])] == ["host"]
    port_dead = hnsw_from_arrays(points, zero, layers,
                                 tconfig.Config(**CFG_KW), device="cpu")
    jdead = JaxHnsw(points, zero, layers, jconfig.Config(**CFG_KW))
    hyb = HybridIndex(port_dead, tpu_index=rec, threshold=16)
    jhyb = JaxHybrid(jdead, tpu_index=jrec, threshold=16)
    port_dead.delete([3])
    jdead.delete([3])
    assert _routes(hyb, rec, queries[:2]) == _routes(jhyb, jrec,
                                                     queries[:2]) == "device"
    # a graph grown after the lift: the port adds for real; the JAX index
    # is only made longer (its add would compile a wave program), which is
    # all its staleness test reads
    grown = hnsw_from_arrays(points, zero, layers,
                             tconfig.Config(**CFG_KW), device="cpu")
    jgrown = JaxHnsw(points, zero, layers, jconfig.Config(**CFG_KW))
    hyb = HybridIndex(grown, tpu_index=rec, threshold=16)
    jhyb = JaxHybrid(jgrown, tpu_index=jrec, threshold=16)
    assert _routes(hyb, rec, queries[:2]) == "host"
    grown.add(queries[:3])
    jgrown.points = jnp.concatenate([jgrown.points, queries[:3]])
    assert _routes(hyb, rec, queries[:2]) == _routes(jhyb, jrec,
                                                     queries[:2]) == "device"

    # calibrate returns an int and sets the threshold
    hyb = HybridIndex(port)
    thr = hyb.calibrate(queries, k=K, iters=1)
    assert isinstance(thr, int) and thr >= 1 and hyb.threshold == thr
    # search fills a Search, for an Hnsw and an HnswMap
    hyb = HybridIndex(port, threshold=64)
    hits = list(hyb.search(queries[0], Search()))
    assert len(hits) == 32 and hits[0].pid == want[1][0, 0]
    hmap = HnswMap(port.points, port.zero, port.layers,
                   tconfig.Config(**CFG_KW), [f"v{i}" for i in
                                              range(len(points))])
    hits = list(HybridIndex(hmap, threshold=64).search(queries[0], Search()))
    assert hits[0].value == f"v{hits[0].pid}" and hits[0].pid == want[1][0, 0]


# ---------------------------------------------------------------------------
# StreamingHnsw
# ---------------------------------------------------------------------------

class _JaxGraph:
    """What JAX ``StreamingHnsw._slab_arrays`` reads of its graph."""

    def __init__(self, points):
        self.points = points

    def __len__(self):
        return len(self.points)


def _jax_slab_merge(queries, points, eligible, snap_n, sd, si, metric, k):
    """The JAX package's slab search and merge (models/streaming.py:
    _slab_arrays, _slab_search_jit and search_batch's two-key sort) on
    the same inputs."""
    me = types.SimpleNamespace(graph=_JaxGraph(points), _snap_n=snap_n)
    slab, el = jstream.StreamingHnsw._slab_arrays(me, eligible)
    pd, pi = jstream._slab_search_jit(jnp.asarray(queries), slab, el,
                                      metric_name=metric, k=k)
    big = np.iinfo(np.int32).max
    pi = jnp.where(pi >= 0, pi + snap_n, big)
    cd = jnp.concatenate([jnp.asarray(sd), pd], axis=1)
    ci = jnp.concatenate([jnp.where(jnp.asarray(si) >= 0, si, big), pi],
                         axis=1)
    md, mi = lax.sort((cd, ci), dimension=1, num_keys=2)
    mi = jnp.where(jnp.isfinite(md), mi, -1)
    return np.asarray(md[:, :k]), np.asarray(mi[:, :k])


def _check_slab_merge(queries):
    rng = np.random.default_rng(21)
    d = queries.shape[1]
    for metric, snap_n, pend, filtered in (
            ("sqeuclidean", 300, 5, True),       # a slab smaller than k
            ("sqeuclidean", 300, 100, False),
            ("cosine", 200, 77, True)):
        points = rng.standard_normal((snap_n + pend, d)).astype(np.float32)
        eligible = None
        if filtered:  # a filter over pending rows, and deletes
            eligible = rng.random(snap_n + pend) < 0.7
            eligible[snap_n] = False
        # a snapshot result: sorted, with missing tails
        sd = np.sort(rng.random((len(queries), K)).astype(np.float32) * 50,
                     axis=1)
        si = rng.integers(0, snap_n, (len(queries), K)).astype(np.int32)
        sd[::3, -2:], si[::3, -2:] = np.inf, -1
        want_d, want_i = _jax_slab_merge(queries, points, eligible, snap_n,
                                         sd, si, metric, K)
        q, p = torch.from_numpy(queries), torch.from_numpy(points)
        el = None if eligible is None else torch.from_numpy(eligible)
        pd, pi = tstream.slab_search(q, p[snap_n:], None if el is None
                                     else el[snap_n:], metric, K)
        assert pd.shape[1] == min(K, pend)
        got_d, got_i = tstream.merge_slab(torch.from_numpy(sd),
                                          torch.from_numpy(si), pd, pi,
                                          snap_n, K)
        what = f"{metric} slab {pend}"
        np.testing.assert_array_equal(got_i.numpy(), want_i, err_msg=what)
        np.testing.assert_allclose(got_d.numpy(), want_d, **SLAB_TOL,
                                   err_msg=what)
        if eligible is not None:  # no ineligible slab row came back
            ids = got_i.numpy()
            assert eligible[ids[ids >= snap_n]].all(), what


def _check_auto_repack():
    for repack_every, snap_n in ((0, 1024), (0, 20_000), (500, 1024),
                                 (0, 0)):
        me = types.SimpleNamespace(repack_every=repack_every, _snap_n=snap_n)
        assert (tstream.StreamingHnsw._auto_repack(me)
                == jstream.StreamingHnsw._auto_repack(me))


def _check_streaming(arrays, queries):
    points, zero, layers = arrays
    n = len(points)
    rng = np.random.default_rng(22)
    scan_kw = dict(fused="bucket_pack", lsub=16, cb=256, ef=32)
    for serving, kw in (("scan", scan_kw), ("packed", {})):
        graph = hnsw_from_arrays(points, zero, layers,
                                 tconfig.Config(**CFG_KW), device="cpu")
        s = StreamingHnsw(graph, serving=serving, repack_every=300)
        pending = []
        for c in range(3):
            new = rng.random((150, points.shape[1]), dtype=np.float32)
            pids = s.add(new)
            assert np.array_equal(pids, np.arange(n + 150 * c,
                                                  n + 150 * (c + 1)))
            # the slab reaches repack_every at the second add
            assert s.n_pending == (0 if c == 1 else 150), (serving, c)
            pending.append(new)
            d, p = s.search_batch(new, k=K, **kw)
            assert np.array_equal(p[:, 0].numpy(), pids), (serving, c)
            assert (d[:, 0].numpy() < 1e-4).all()
        # after the third add 150 rows are pending: the merged results
        # equal an exact search's top row, filters and deletes included
        last = pids
        s.delete(last[:10])
        fm = np.ones(len(s), bool)
        fm[last[10:20]] = False
        d, p = s.search_batch(pending[-1], k=K, filter_mask=fm, **kw)
        p = p.numpy()
        assert not np.isin(p, last[:20]).any(), serving
        assert np.array_equal(p[20:, 0], last[20:]), serving
        assert len(s) == n + 450 and s.values is None
    # build / dump / load, with values
    vals = [f"v{i}" for i in range(n)]
    s = StreamingHnsw.build(points, vals, tconfig.Config(**CFG_KW, wave_size=64),
                            serving="scan", device="cpu")
    s.add(points[:2] + 0.5, values=["a", "b"])
    d, p, out = s.search_batch_values(points[:2] + 0.5, k=3)
    assert [r[0] for r in out] == ["a", "b"]
    with tempfile.TemporaryDirectory() as tmp:
        f = os.path.join(tmp, "s.npz")
        s.dump(f)
        t = StreamingHnsw.load(f, serving="packed", device="cpu")
        assert len(t) == n + 2 and t.n_pending == 0 and t.values[-1] == "b"
    _check_slab_merge(queries)
    _check_auto_repack()


# ---------------------------------------------------------------------------
# validate, metrics, profiling
# ---------------------------------------------------------------------------

def _same_report(got, want, what):
    assert (got.n, got.errors, got.degree_histogram, got.n_layers) == \
        (want.n, want.errors, want.degree_histogram, want.n_layers), what
    assert got.mean_degree == pytest.approx(want.mean_degree), what


def _check_validate(arrays):
    points, zero, layers = arrays
    _same_report(validate_graph(torch.tensor(zero),
                                [torch.tensor(l) for l in layers]),
                 jax_validate(zero, layers), "good")
    bad_zero = zero.copy()
    bad_zero[5, 0] = 5                        # self loop
    bad_zero[6, 1] = bad_zero[6, 0]           # duplicate
    bad_zero[7, 0] = -1                       # hole
    bad_zero[8, 0] = len(points)              # out of range
    bad_layers = [l.copy() for l in layers]
    bad_layers[0][0, 0] = 0
    rep = validate_graph(bad_zero, bad_layers)
    assert not rep.ok and len(rep.errors) == 5, rep.errors
    _same_report(rep, jax_validate(bad_zero, bad_layers), "bad")
    port = hnsw_from_arrays(points, zero, layers, tconfig.Config(**CFG_KW),
                            device="cpu")
    _same_report(validate_graph(port), jax_validate(zero, layers), "index")


def _check_utils():
    calls = []
    t = tmetrics.time_fn(lambda x: calls.append(x) or torch.ones(2), 3,
                         warmup=1, iters=4)
    assert calls == [3] * 5 and t.calls == 4 and t.wall_s >= 0
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(jmetrics.Timing)]
    tmetrics.force_ready({"a": (torch.ones(1), [torch.zeros(2)]), "b": 3})
    stats = tmetrics.BuildStats()
    stats(5, 10, "wave")
    assert set(stats.summary()) == {"wall_s", "phases"}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tmetrics.emit("qps", 1.5, "q/s", extra=1)
    assert json.loads(out.getvalue()) == {"metric": "qps", "value": 1.5,
                                          "unit": "q/s", "vs_baseline": None,
                                          "extra": 1}
    timer = profiling.PhaseTimer()
    with timer.phase("a", sync=True):
        pass
    assert timer.report()["a"]["calls"] == 1

    @profiling.annotate("span")
    def f(x):
        return x + 1

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            assert f(torch.ones(2)).sum() == 4
        with open(os.path.join(tmp, "trace.json")) as fh:
            assert "span" in fh.read()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run(main, argv):
    """(exit code, stdout) of ``main(argv)`` in-process."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = main(argv)
    return rc, out.getvalue()


def _check_cli(arrays, tmp):
    points, zero, layers = arrays
    port = hnsw_from_arrays(points, zero, layers, tconfig.Config(**CFG_KW),
                            device="cpu")
    good = os.path.join(tmp, "good.npz")
    port.dump(good)
    bad_zero = zero.copy()
    bad_zero[5, 0] = 5
    bad = os.path.join(tmp, "bad.npz")
    hnsw_from_arrays(points, bad_zero, layers, tconfig.Config(**CFG_KW),
                     device="cpu").dump(bad)
    cpu = ["--device", "cpu"]
    for f in (good, bad):
        rc, out = _run(port_main, ["info", f, *cpu])
        jrc, jout = _run(jax_main, ["info", f])
        assert rc == jrc == 0 and json.loads(out) == json.loads(jout), f
        rc, out = _run(port_main, ["validate", f, *cpu])
        jrc, jout = _run(jax_main, ["validate", f])
        assert rc == jrc and json.loads(out) == json.loads(jout), f
    assert _run(port_main, ["validate", bad, *cpu])[0] == 1
    rc, out = _run(port_main, ["selftest", good, "--queries", "64", *cpu])
    assert rc == 0 and json.loads(out)["recall_at_10"] >= 0.9
    # a scan index file
    scan = os.path.join(tmp, "scan.npz")
    tpkg.ScanIndex(points, device="cpu").dump(scan)
    rc, out = _run(port_main, ["info", scan, *cpu])
    assert rc == 0 and json.loads(out) == json.loads(_run(jax_main,
                                                          ["info", scan])[1])
    assert _run(port_main, ["validate", scan, *cpu])[0] == 0
    # build (native npz and bincode), search, convert npz -> bincode -> info
    vecs = os.path.join(tmp, "vecs.npy")
    np.save(vecs, points[:256])
    vals = os.path.join(tmp, "vals.json")
    with open(vals, "w") as fh:
        json.dump([f"w{i}" for i in range(256)], fh)
    built = os.path.join(tmp, "built.npz")
    rc, out = _run(port_main, ["build", vecs, built, "--seed", "73",
                               "--ef-construction", "32", "--values", vals,
                               *cpu])
    assert rc == 0 and json.loads(out)["points"] == 256
    q = os.path.join(tmp, "q.npy")
    np.save(q, points[:3])
    rc, out = _run(port_main, ["search", built, q, "--k", "2", *cpu])
    rows = [json.loads(line) for line in out.strip().splitlines()]
    assert rc == 0 and len(rows) == 3
    assert rows[0]["values"][0] == "w0" and rows[0]["distances"][0] < 1e-5
    binf = os.path.join(tmp, "built.bin")
    assert _run(port_main, ["convert", built, binf, *cpu])[0] == 0
    rc, out = _run(port_main, ["info", binf, "--dims", "16", *cpu])
    jrc, jout = _run(jax_main, ["info", binf, "--dims", "16"])
    assert rc == jrc == 0 and json.loads(out) == json.loads(jout)
    assert json.loads(out)["points"] == 256
    if not torch.cuda.is_available():  # the card is the CLI's default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main(["info", good])


def _check_card_default(arrays, tmp):
    """Numpy input with no device goes to the card: here, with none, the
    new entry points raise."""
    if torch.cuda.is_available():
        return
    points = arrays[0]
    f = os.path.join(tmp, "good.npz")
    for call in (
            lambda: Hnsw.build(points, tconfig.Config(**CFG_KW),
                               backend="native"),
            lambda: StreamingHnsw.build(points,
                                        config=tconfig.Config(**CFG_KW)),
            lambda: StreamingHnsw.load(f)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def check_cpu(arrays, queries):
    """Every CPU check, on the JAX-built graph ``arrays`` = (points, zero,
    layers) and ``queries`` of ``tests/test_torch_build.py``."""
    _check_host_engine(arrays, queries)
    _check_host_rebuild()
    _check_hybrid(arrays, queries)
    _check_streaming(arrays, queries)
    _check_validate(arrays)
    _check_utils()
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # bincode width warnings
        _check_cli(arrays, tmp)
        _check_card_default(arrays, tmp)
