"""Construction in the PyTorch port beyond the default scan_fused route:
callable metrics, beam and streamed-scan wave search, the exact-prefix
hybrid, sampled scans with hop repair, ``extend_candidates``, build
checkpoints and incremental ``add`` (``Hnsw``, ``HnswMap``,
``ScanIndex``), each against the JAX package on the same inputs made
from seeded numpy.

This file defines no test item of its own (each item the suite collects
shifts how pytest-xdist splits the whole suite, tests/test_torch_build.py
says why): ``tests/test_torch_build.py::test_build_and_search_match_jax``
calls :func:`check_cpu` with its JAX-built 1024 x 16 graph.  It pays for
three JAX builds.

Tolerances:

* building blocks on random inputs (``extend_candidates``,
  ``_hop_repair``, ``_merge_dedup_rerank``): pids equal, distances
  within 1e-6 relative; the callable metric's three forms within 1e-5
  relative of the JAX package's, and its row blocks bit-exact with one
  block; ``repair_commit_core`` on the JAX-built graph: adjacency equal
  with an f32 pairwise matrix, and with bfloat16 equal on at least
  BF16_ROWS of the rows;
* whole builds (1024 x 16): ids and layer shapes equal to the JAX
  build's; recall@10 (ef 64) at the seed's floors, 0.97
  (tests/test_construct_scan.py, tests/test_sampled_build.py) and 0.90
  for ``extend_candidates`` (tests/test_extend_candidates.py:59); for
  the three modes with a JAX build, zero-layer edge overlap at least
  OVERLAP_FLOOR;
* checkpoints: a crashed and resumed build equals the uninterrupted one
  bit for bit (f32 and bfloat16 caches);
* ``add``: both packages grow the JAX-built graph by the same points in
  two rounds; zero-layer edge overlap at least ADD_OVERLAP_FLOOR and the
  floors of tests/test_mutations.py:106-140, which an add on the K2
  route (cosine) meets too; a grown ``ScanIndex`` equals a one-shot one
  bit for bit.
"""

import os
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_distance_tpu import config as jconfig
from instant_distance_tpu.models.hnsw import Hnsw as JaxHnsw
from instant_distance_tpu.ops import construct as jc
from instant_distance_tpu.ops import distance as jdist
from instant_distance_tpu.ops import select as jsel
from instant_distance_tpu.utils.validate import validate_graph
from instant_distance_tpu_torch import PackedHnsw, ScanIndex
from instant_distance_tpu_torch import config as tconfig
from instant_distance_tpu_torch.models.brute import BruteForce
from instant_distance_tpu_torch.models.hnsw import Hnsw, HnswMap, Search
from instant_distance_tpu_torch.ops import construct as tc
from instant_distance_tpu_torch.ops import distance as tdist
from instant_distance_tpu_torch.ops import select as tsel
from instant_distance_tpu_torch.utils import serialize as tser
from instant_distance_tpu_torch.utils.convert import hnsw_from_arrays
from instant_distance_tpu_torch.utils.metrics import recall_at_k

#: One callable metric for both packages: it runs on jax arrays and on
#: torch tensors alike.
SQ_L2 = lambda a, b: ((a - b) ** 2).sum()  # noqa: E731

#: Whole builds: the keywords every mode shares.
BASE_KW = dict(seed=7, m=8, wave_size=16, ef_construction=32)
#: Zero-layer edges shared with the JAX build of the same mode.
#: Measured: 1.0 (identical zero layers) for every mode with a JAX build;
#: the floor leaves room for last-ulp f32 differences and top-k ties.
OVERLAP_FLOOR = 0.99
#: Rows of repair_commit_core's adjacency equal to the JAX package's
#: with the bfloat16 pairwise matrix (measured: 0.993; last-ulp f32
#: differences upstream can flip a bridging comparison at bf16).
BF16_ROWS = 0.95
#: Zero-layer edges shared after both packages add the same points to
#: the same graph (measured: 1.0).
ADD_OVERLAP_FLOOR = 0.98
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _overlap(a, b) -> float:
    a, b = _np(a), _np(b)
    common = sum(len(set(a[i][a[i] >= 0]) & set(b[i][b[i] >= 0]))
                 for i in range(len(b)))
    return common / max(1, int((b >= 0).sum()))


def _recall(index, ids, pts, queries) -> float:
    gt = BruteForce(pts, device="cpu").search_batch(queries, 10)[1].numpy()
    got = _np(index.search_batch(queries, k=10, ef=64)[1])
    return recall_at_k(got, np.asarray(ids)[gt])


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _check_callable_metric():
    """gathered, pairwise and self_pairwise of one lambda in both
    packages; the port's row blocks change no value."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((20, 12)).astype(np.float32)
    p = rng.standard_normal((20, 9, 12)).astype(np.float32)
    pn = rng.standard_normal((33, 12)).astype(np.float32)
    jm, tm = jdist.Metric(SQ_L2), tdist.Metric(SQ_L2)
    assert tdist.resolve(tm) is tm and tdist.Metric(tm).fn is SQ_L2
    assert not tm.matmul_form and tm.name == "<lambda>"
    forms = (("gathered", (q, p)), ("pairwise", (q, pn)),
             ("self_pairwise", (p,)))
    saved = tdist.CALLABLE_ELEMS
    try:
        for name, args in forms:
            want = np.asarray(getattr(jm, name)(*map(jnp.asarray, args)))
            tdist.CALLABLE_ELEMS = 1 << 30
            whole = getattr(tm, name)(*map(torch.from_numpy, args))
            tdist.CALLABLE_ELEMS = 100        # a few rows a block
            blocks = getattr(tm, name)(*map(torch.from_numpy, args))
            np.testing.assert_allclose(whole.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            assert torch.equal(whole, blocks), name
    finally:
        tdist.CALLABLE_ELEMS = saved
    assert float(tm.one(torch.ones(3), torch.zeros(3))) == 3.0
    cfg = tconfig.Config(metric=SQ_L2)
    assert '"metric": "custom"' in tser._config_to_json(cfg)


def _graph(rng, n, k):
    adj = np.full((n + 1, k), -1, np.int32)
    for i in range(n):
        deg = rng.integers(1, k + 1)
        adj[i, :deg] = rng.choice(n, deg, replace=False)
    return adj


def _pool(rng, q, pts, c):
    """A (dist, pid)-sorted candidate pool of c pids per row, -1 padded
    at the tail, with exact sq-L2 distances."""
    w = q.shape[0]
    cand_p = np.stack([rng.choice(len(pts), c, replace=False)
                       for _ in range(w)]).astype(np.int32)
    cand_p[:, -3:] = -1
    cand_d = ((pts[cand_p] - q[:, None]) ** 2).sum(-1).astype(np.float32)
    cand_d[cand_p < 0] = np.inf
    order = np.lexsort((cand_p, cand_d), axis=1)
    return (np.take_along_axis(cand_d, order, 1),
            np.take_along_axis(cand_p, order, 1))


def _same(got, want, what):
    (gd, gp), (wd, wp) = [tuple(_np(a) for a in r) for r in (got, want)]
    np.testing.assert_array_equal(gp, wp, err_msg=what)
    np.testing.assert_allclose(gd, wd, err_msg=what, **TOL)


def _check_blocks():
    """extend_candidates (and its row blocks), _hop_repair and
    _merge_dedup_rerank on random inputs."""
    rng = np.random.default_rng(1)
    n, d, k, w, c = 300, 8, 12, 24, 20
    pts = rng.random((n, d), dtype=np.float32)
    adj = _graph(rng, n, k)
    q = rng.random((w, d), dtype=np.float32)
    cand_d, cand_p = _pool(rng, q, pts, c)
    jm, tm = jdist.resolve("sqeuclidean"), tdist.resolve("sqeuclidean")
    jargs = [jnp.asarray(x) for x in (q, cand_d, cand_p, adj, pts)]
    targs = [torch.from_numpy(x) for x in (q, cand_d, cand_p, adj, pts)]
    links = 7                     # a walk's link cap below the row width
    # jitted: one compile each instead of one per op
    want = jax.jit(lambda *a: jsel.extend_candidates(
        *a, jm, links=links, cap=c + 16))(*jargs)
    got = tsel.extend_candidates(*targs, tm, links=links, cap=c + 16)
    _same(got, want, "extend_candidates")
    saved = tsel.EXTEND_ELEMS
    tsel.EXTEND_ELEMS = c * k * d * 5              # blocks of five rows
    try:
        blocks = tsel.extend_candidates(*targs, tm, links=links, cap=c + 16)
    finally:
        tsel.EXTEND_ELEMS = saved
    for g, b in zip(got, blocks):
        assert torch.equal(g, b), "extend_candidates blocks"
    _same(tc._hop_repair(*targs, tm, 4),
          jax.jit(lambda *a: jc._hop_repair(*a, jm, 4))(*jargs),
          "_hop_repair")
    # hop candidates that repeat pool pids and each other
    nb = np.concatenate([cand_p[:, 2:9], cand_p[:, :4], cand_p[:, :2]], 1)
    nd = ((pts[np.maximum(nb, 0)] - q[:, None]) ** 2).sum(-1)
    nd = np.where(nb >= 0, nd, np.inf).astype(np.float32)
    nb[:, -1] = -1
    nd[:, -1] = np.inf
    want = jax.jit(lambda *a: jc._merge_dedup_rerank(*a, 8))(
        *map(jnp.asarray, (cand_d, cand_p, nd, nb)))
    got = tc._merge_dedup_rerank(*map(torch.from_numpy,
                                      (cand_d, cand_p, nd, nb)), 8)
    _same(got, want, "_merge_dedup_rerank")


def _check_cap_scan_ops():
    """The capped K1 operands are the first block-rounded columns, as
    contiguous copies, and their wave search equals the full scan cut at
    the cap."""
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.random((20000, 16), dtype=np.float32))
    cfg = tconfig.Config(construct_sample_cols=5000)
    plan = tc._plan_of(cfg, 20000, 16)
    assert plan.sampling and plan.search_mode == "scan_fused"
    full = tc._quantize_for_scan(pts, "sqeuclidean")
    capped = tc._cap_scan_ops(full, plan, 16)
    assert capped[0].shape == (16, 8192) and capped[0].is_contiguous()
    assert torch.equal(capped[0], full[0][:, :8192])
    assert torch.equal(capped[2], full[2][:, :8192]) and capped[1] is full[1]
    q = pts[15000:15016]
    got = tc._scan_pack(q, 15000, *capped, 40)
    want = tc._scan_pack(q, 8192, *full, 40)
    assert int(got.max()) < 8192
    assert [sorted(r[r >= 0].tolist()) for r in got] == \
        [sorted(r[r >= 0].tolist()) for r in want]
    flat = tc._cap_scan_ops(tc._flat_operands(pts), tc._plan_of(
        tconfig.Config(metric=SQ_L2, construct_mode="scan",
                       construct_sample_cols=300), 20000, 16), 16)
    assert [tuple(x.shape) for x in flat] == [(384, 16), (384,), (384,)]


def _check_repair_commit(arrays):
    """repair_commit_core on the JAX-built graph: a wave of its last 24
    pids (lanes padded to 32), taken out of the graph first, with their
    exact top-40 pools among the rest, committed by both packages."""
    points, zero = np.array(arrays[0]), np.array(arrays[1])
    n, m0 = zero.shape
    wave = np.full(32, -1, np.int32)
    wave[:24] = np.arange(n - 24, n, dtype=np.int32)
    zero = np.where(np.isin(zero, wave[:24]), -1, zero)
    zero[n - 24:] = -1
    q = points[np.maximum(wave, 0)]
    dd = ((q[:, None] - points[None, :n - 24]) ** 2).sum(-1)
    cand_p = np.argsort(dd, 1, kind="stable")[:, :40].astype(np.int32)
    cand_p[24:] = -1
    # each package's own exact distances, so that a hop neighbour that
    # repeats a pool pid repeats its distance too, as in a build
    pools = {}
    for pkg, metric, arr in (("jax", jdist.resolve("sqeuclidean"),
                              jnp.asarray),
                             ("torch", tdist.resolve("sqeuclidean"),
                              torch.from_numpy)):
        cd = _np(metric.gathered(arr(q), arr(points[np.maximum(cand_p, 0)])))
        cd = np.where(cand_p >= 0, cd, np.inf).astype(np.float32)
        order = np.lexsort((cand_p, cd), axis=1)
        pools[pkg] = (np.take_along_axis(cd, order, 1),
                      np.take_along_axis(cand_p, order, 1))
    adj = np.concatenate([zero, np.full((1, m0), -1, np.int32)])
    adjd = np.concatenate([np.asarray(jc._recompute_adjd(
        jnp.asarray(points), jnp.asarray(zero), "sqeuclidean",
        jnp.float32)), np.full((1, m0), np.inf, np.float32)])
    shares = {}
    for pd_dtype in ("float32", "bfloat16"):
        kw = dict(metric_name="sqeuclidean", m0=m0, heuristic=(False, True),
                  pend_cap=16, rev_rounds=0, pd_dtype=pd_dtype, hops=16)
        w_adj, w_adjd, _ = jc._repair_commit_step(
            *(jnp.asarray(x) for x in (adj, adjd, wave, points,
                                       *pools["jax"])),
            rev_chunk=8192, **kw)
        t_adj, t_adjd = torch.from_numpy(adj.copy()), torch.from_numpy(adjd)
        tc.repair_commit_core(t_adj, t_adjd, *map(torch.from_numpy, (
            wave, points, *pools["torch"])), **kw)
        # row n is the padded lanes' write sink, never read
        got, want = t_adj.numpy()[:n], np.asarray(w_adj)[:n]
        shares[pd_dtype] = np.all(got == want, axis=1).mean()
        if pd_dtype == "float32":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(t_adjd.numpy()[:n],
                                       np.asarray(w_adjd)[:n], **TOL)
    assert shares["bfloat16"] >= BF16_ROWS, shares


# ---------------------------------------------------------------------------
# whole builds
# ---------------------------------------------------------------------------

#: mode -> (port keywords, JAX keywords or None).  "scan extend" runs the
#: streamed scan in every wave (a scan_fused build whose exact prefix
#: covers all points; the JAX package's CPU "scan") with
#: ``extend_candidates``.  The sampled builds scan with the callable so
#: that the cap (256 of 1024 columns) really cuts: the fused kernels'
#: blocks round a cap up to 8192 columns.  Three modes get a JAX build.
MODES = {
    "beam callable": (dict(metric=SQ_L2), dict(metric=SQ_L2)),
    "beam": (dict(construct_mode="beam"), None),
    "scan extend": (
        dict(construct_exact_prefix=1024,
             heuristic=tconfig.Heuristic(extend_candidates=True)),
        dict(construct_mode="scan",
             heuristic=jconfig.Heuristic(extend_candidates=True))),
    "exact prefix 256": (dict(construct_exact_prefix=256), None),
    "sampled split": (dict(metric=SQ_L2, construct_mode="scan",
                           construct_sample_cols=256, construct_split=True),
                      dict(construct_mode="scan", construct_sample_cols=256,
                           construct_split=True)),
    "sampled": (dict(metric=SQ_L2, construct_mode="scan",
                     construct_sample_cols=256, construct_split=False),
                None),
    "hop 8": (dict(construct_hop_repair=8), None),
}


def _check_builds(pts, queries):
    pts = np.array(pts)
    built = {}
    ref_ids = ref_shapes = None
    for mode, (tkw, jkw) in MODES.items():
        idx, ids = Hnsw.build(torch.from_numpy(pts),
                              tconfig.Config(**BASE_KW, **tkw))
        rep = validate_graph(idx.zero.numpy(), [l.numpy() for l in idx.layers])
        assert rep.ok and idx.reverse_drops == 0, (mode, rep.errors)
        floor = 0.90 if "extend" in mode else 0.97
        rec = _recall(idx, ids, pts, queries)
        assert rec >= floor, (mode, rec)
        if jkw is not None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")    # JAX buffer donation
                ref, jids = JaxHnsw.build(pts, jconfig.Config(**BASE_KW,
                                                              **jkw))
            ref_ids = jids
            ref_shapes = [tuple(np.shape(l)) for l in ref.layers]
            ov = _overlap(idx.zero, ref.zero)
            assert ov >= OVERLAP_FLOOR, (mode, ov)
        built[mode] = (idx, ids)
    for mode, (idx, ids) in built.items():
        np.testing.assert_array_equal(ids, ref_ids, err_msg=mode)
        assert [tuple(l.shape) for l in idx.layers] == ref_shapes, mode
    # where the sampled build repairs decides the graph
    assert not torch.equal(built["sampled"][0].zero,
                           built["sampled split"][0].zero)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class _Boom(RuntimeError):
    pass


def _crash_then_resume(pts, cfg, ckpt, crash_after):
    """A build stopped by progress at its ``crash_after``-th wave, then a
    rerun that resumes from the checkpoint: (index, ids, stored seed)."""
    def stop(done, total, phase):
        stop.calls += 1
        if stop.calls >= crash_after:
            raise _Boom()

    stop.calls = 0
    with pytest.raises(_Boom):
        Hnsw.build(pts, cfg, progress=stop, checkpoint=ckpt,
                   checkpoint_every=1)
    assert os.path.exists(ckpt)
    with np.load(ckpt) as z:
        seed = int(z["seed"])
        assert set(z.files) >= {"key", "seed", "adj", "adjd", "adjd_dtype",
                                "stacked", "offsets", "write_off", "li",
                                "s", "drops"}
    idx, ids = Hnsw.build(pts, cfg, checkpoint=ckpt)
    assert not os.path.exists(ckpt)
    return idx, ids, seed


def _equal_graphs(a, b, what):
    assert torch.equal(a.zero, b.zero), what
    assert len(a.layers) == len(b.layers), what
    for x, y in zip(a.layers, b.layers):
        assert torch.equal(x, y), what


def _check_checkpoints(tmp):
    """Crash and resume bit-exact (a beam build stopped after two layers,
    so it resumes their snapshots; a bfloat16 cache with the exact-prefix
    switch to K1 inside the run); a stale checkpoint is ignored; an
    entropy seed adopts the stored one; the keys."""
    rng = np.random.default_rng(59)
    pts = torch.from_numpy(rng.random((600, 8), dtype=np.float32))
    kw = dict(seed=59, wave_size=64, ef_construction=32, m=8)
    cases = ((dict(construct_mode="beam"), 9),
             (dict(dist_cache_dtype="bfloat16",
                   construct_exact_prefix=128), 5))
    refs = []
    for i, (extra, crash_after) in enumerate(cases):
        cfg = tconfig.Config(**kw, **extra)
        ref, ref_ids = Hnsw.build(pts, cfg)
        ckpt = os.path.join(tmp, f"ck{i}.npz")
        idx, ids, _ = _crash_then_resume(pts, cfg, ckpt, crash_after)
        np.testing.assert_array_equal(ids, ref_ids)
        _equal_graphs(idx, ref, extra)
        refs.append((cfg, ref))
    # stale: the first case's checkpoint does not resume the second's build
    (cfg0, _), (cfg1, ref1) = refs
    ckpt = os.path.join(tmp, "stale.npz")
    with pytest.raises(_Boom):
        Hnsw.build(pts, cfg0, checkpoint=ckpt, checkpoint_every=1,
                   progress=lambda d, t, p: (_ for _ in ()).throw(_Boom())
                   if d > 100 else None)
    idx, _ = Hnsw.build(pts, cfg1, checkpoint=ckpt)
    _equal_graphs(idx, ref1, "stale checkpoint")
    assert not os.path.exists(ckpt)
    # entropy seed: the resume adopts the stored seed
    cfg = tconfig.Config(**dict(kw, seed=None))
    idx, ids, seed = _crash_then_resume(pts, cfg,
                                        os.path.join(tmp, "ent.npz"), 4)
    ref, ref_ids = Hnsw.build(pts, tconfig.Config(**dict(kw, seed=seed)))
    np.testing.assert_array_equal(ids, ref_ids)
    _equal_graphs(idx, ref, "entropy seed")

    def key(**extra):
        cfg = tconfig.Config(**kw, **extra)
        return tc._ckpt_key(cfg, tc._plan_of(cfg, 1536, 8), 1536, 8)

    k0 = key()
    assert k0.startswith("v8:1536:8:32:8:") and k0.endswith(":1:float32")
    assert key(construct_sample_cols=512) == k0 + ":sc512:sh16:split0"
    assert (key(construct_sample_cols=512, construct_split=True)
            == k0 + ":sc512:sh16:split1")
    assert key(construct_sample_cols=1536) == k0


# ---------------------------------------------------------------------------
# add
# ---------------------------------------------------------------------------

#: The JAX-built graph's configuration (tests/test_torch_build.py's).
ADD_KW = dict(seed=7, m=8, wave_size=16, construct_mode="scan_fused",
              ef_search=32)


def _check_add(arrays, queries):
    """Both packages grow the JAX-built graph by the same points in two
    rounds (the port starts from ``hnsw_from_arrays``); then the floors
    of tests/test_mutations.py:106-140."""
    points, zero, layers = arrays
    n = len(points)
    rng = np.random.default_rng(11)
    new = rng.random((512, points.shape[1]), dtype=np.float32)
    ref = JaxHnsw(points, zero, layers, jconfig.Config(**ADD_KW))
    port = hnsw_from_arrays(points, zero, layers, tconfig.Config(**ADD_KW),
                            device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")            # JAX buffer donation
        for lo, hi in ((0, 192), (192, 512)):
            want = ref.add(new[lo:hi])
            got = port.add(new[lo:hi])
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, np.arange(n + lo, n + hi))
    assert port._adjd.shape == (n + 513, port.config.m0)
    ov = _overlap(port.zero, ref.zero)
    assert ov >= ADD_OVERLAP_FLOOR, ov
    assert port.zero.shape == (n + 512, 16) and len(port) == n + 512
    assert [tuple(l.shape) for l in port.layers] == \
        [tuple(np.shape(l)) for l in ref.layers]
    assert port.reverse_drops == 0
    all_pts = np.concatenate([points, new])
    assert _recall(port, np.arange(n + 512), all_pts, queries) >= 0.9
    p = port.search_batch(new[:16], k=1)[1].numpy()[:, 0]
    assert (p == np.arange(n, n + 16)).mean() >= 0.9
    return port, ref


def _check_add_mask_and_children(port):
    """Tombstones grow with alive rows; a ``from_index`` child and the
    tensors the index held before an add are untouched by it."""
    port.delete([0, 1])
    old = (port.points, port.zero, port._alive)
    kept = [t.clone() for t in old]
    scan = ScanIndex.from_index(port)
    packed = PackedHnsw.from_index(port)
    q = port.points[:4]
    before = [c.search_batch(q, k=5) for c in (scan, packed)]
    rng = np.random.default_rng(13)
    port.add(torch.from_numpy(rng.random((40, 16), dtype=np.float32)))
    assert port._alive.shape == (len(port),) and port.n_deleted == 2
    assert bool(port._alive[-40:].all())
    for t, k in zip(old, kept):
        assert torch.equal(t, k)
    for c, b in zip((scan, packed), before):
        assert len(c) == len(port) - 40
        for x, y in zip(c.search_batch(q, k=5), b):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="dim"):
        port.add(np.zeros((2, 5), np.float32))


def _check_map_add(arrays):
    points, zero, layers = arrays
    n = len(points)
    cfg = tconfig.Config(**ADD_KW)
    h = hnsw_from_arrays(points, zero, layers, cfg, device="cpu")
    hmap = HnswMap(h.points, h.zero, h.layers, cfg,
                   [f"w{i}" for i in range(n)])
    before = hmap.values
    rng = np.random.default_rng(17)
    new = rng.random((48, points.shape[1]), dtype=np.float32)
    pids = hmap.add(new, [f"w{i}" for i in range(n, n + 48)])
    np.testing.assert_array_equal(pids, np.arange(n, n + 48))
    assert len(hmap.values) == n + 48 and len(before) == n
    _, p, vals = hmap.search_batch_values(new[5:9], k=1)
    assert vals[0][0] == f"w{n + 5}" and int(p[0, 0]) == n + 5
    hit = next(iter(hmap.search(new[7], Search())))
    assert hit.pid == n + 7 and hit.value == f"w{n + 7}"
    with pytest.raises(ValueError):
        hmap.add(new[:4], ["too", "few"])
    with pytest.raises(ValueError):
        hmap.add(new[:2])


def _check_add_k2():
    """An add on the K2 route (cosine, like any dot/cosine or >256-d
    index): the grown index finds its new points and meets the floor of
    tests/test_mutations.py against a cosine BruteForce."""
    rng = np.random.default_rng(29)
    pts = rng.standard_normal((640, 16)).astype(np.float32)
    q = rng.standard_normal((32, 16)).astype(np.float32)
    idx, ids = Hnsw.build(torch.from_numpy(pts[:512]), tconfig.Config(
        **dict(BASE_KW, metric="cosine", ef_search=48)))
    new = idx.add(pts[512:])
    gt = BruteForce(pts, "cosine", device="cpu").search_batch(q, 10)[1]
    got = idx.search_batch(q, k=10)[1].numpy()
    rec = recall_at_k(got, np.concatenate([ids, new])[gt.numpy()])
    assert rec >= 0.9 and idx.reverse_drops == 0, rec
    p = idx.search_batch(pts[512:528], k=1)[1].numpy()[:, 0]
    assert (p == new[:16]).mean() >= 0.9


def _check_scan_add():
    """A grown ScanIndex equals a one-shot one on all its rows, bit for
    bit, on the streamed scan and the fused routes; values and
    tombstones follow."""
    rng = np.random.default_rng(19)
    pts = rng.random((1500, 16), dtype=np.float32)
    q = rng.random((24, 16), dtype=np.float32)
    vals = [f"s{i}" for i in range(1500)]
    one = ScanIndex(pts, values=vals, device="cpu")
    grown = ScanIndex(pts[:1000], values=vals[:1000], device="cpu")
    grown.delete([3])
    old_codes = grown.codes
    grown.search_batch(q, fused="bucket_pack", lsub=16, cb=256)
    ids = grown.add(pts[1000:1200], vals[1000:1200])
    np.testing.assert_array_equal(ids, np.arange(1000, 1200))
    grown.add(pts[1200:], vals[1200:])
    assert old_codes.shape[0] == 1000
    for name in ("points", "codes", "scales", "norms"):
        assert torch.equal(getattr(grown, name), getattr(one, name)), name
    assert grown.values == vals and grown._alive.shape == (1500,)
    one.delete([3])
    for kw in (dict(), dict(fused="bucket_pack", lsub=16, cb=256),
               dict(fused="bucket", lsub=8, cb=256),
               dict(fused="bucket_int", lsub=16, cb=256)):
        for x, y in zip(grown.search_batch(q, k=5, **kw),
                        one.search_batch(q, k=5, **kw)):
            assert torch.equal(x, y), kw
    with pytest.raises(ValueError, match="values"):
        grown.add(pts[:2], ["a"])
    with pytest.raises(ValueError, match="no values"):
        ScanIndex(pts[:10], device="cpu").add(pts[:2], ["a", "b"])


def _check_grown_dump(port, ref, queries, tmp):
    """A grown index dumped by the port loads in the JAX package with the
    same arrays and results."""
    f = os.path.join(tmp, "grown.npz")
    port.dump(f)
    back = JaxHnsw.load(f)
    np.testing.assert_array_equal(np.asarray(back.zero), port.zero.numpy())
    np.testing.assert_array_equal(np.asarray(back.points),
                                  port.points.numpy())
    assert back.n_deleted == port.n_deleted
    jd, jp = (np.asarray(a) for a in back.search_batch(queries, k=10))
    td, tp = (a.numpy() for a in port.search_batch(queries, k=10))
    same = jp == tp
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-6)
    # and a loaded index grows like the one it was dumped from
    again = Hnsw.load(f, device="cpu")
    assert again._adjd is None
    rng = np.random.default_rng(23)
    new = rng.random((20, 16), dtype=np.float32)
    np.testing.assert_array_equal(again.add(new), port.add(new))
    assert torch.equal(again.zero, port.zero)


def check_cpu(arrays, queries):
    """Every check, on the JAX-built 1024 x 16 graph ``arrays`` = (points,
    zero, layers) and ``queries`` of tests/test_torch_build.py."""
    _check_callable_metric()
    _check_blocks()
    _check_cap_scan_ops()
    _check_repair_commit(arrays)
    _check_builds(arrays[0], queries)
    port, ref = _check_add(arrays, queries)
    _check_add_mask_and_children(port)
    _check_map_add(arrays)
    _check_add_k2()
    _check_scan_add()
    with tempfile.TemporaryDirectory() as tmp:
        _check_checkpoints(tmp)
        _check_grown_dump(port, ref, queries, tmp)
