"""The packed serving path of the PyTorch port: ``PackedHnsw``, its plain
ops, the walk kernel K4, the probe K6 and the serializers.

This file defines no test item of its own (each item the suite collects
shifts how pytest-xdist splits the whole suite, tests/test_torch_build.py
says why); its named checks run inside the existing items:

* ``tests/test_torch_build.py::test_build_and_search_match_jax`` calls
  :func:`check_cpu` with the JAX-built 1024 x 16 graph: the port against
  the JAX package on the same inputs, made from seeded numpy.
* ``tests/test_torch_gpu.py::test_kernel_matches_plain`` calls
  :func:`check_card`: K4 and K6 against their plain versions on the card.

Tolerances: pids equal on at least 99% of entries and distances within
1e-5 relative where they agree, as in tests/test_torch_build.py (f32
sums in another order reorder near-equal candidates); ``pack_layer`` bit-exact; the
plain K4 against the Pallas kernel (interpret mode) pids equal and
distances within 1e-6 relative (only the order of the D-term sum
differs); on the card K4 and K6 bit-exact with their plain versions.

The card's machine has PyTorch only, so JAX is imported only where it is
installed; :func:`check_card` needs none of it.
"""

import dataclasses
import os
import tempfile
import warnings

import numpy as np
import pytest
import torch

from instant_distance_tpu_torch import PackedHnsw, ScanIndex
from instant_distance_tpu_torch import config as tconfig
from instant_distance_tpu_torch.models.hnsw import Hnsw, HnswMap
from instant_distance_tpu_torch.ops import packed as tpk
from instant_distance_tpu_torch.ops import scan_kernel as tsk
from instant_distance_tpu_torch.ops import walk_kernel as twk
from instant_distance_tpu_torch.utils import serialize as tser
from instant_distance_tpu_torch.parallel.mesh import default_mesh
from instant_distance_tpu_torch.parallel.sharded import ShardedHnsw
from instant_distance_tpu_torch.utils.convert import (hnsw_from_arrays,
                                                       sharded_from_arrays)

try:  # absent on the card's machine; check_card needs none of it
    import jax.numpy as jnp

    from instant_distance_tpu import config as jconfig
    from instant_distance_tpu.models.hnsw import Hnsw as JaxHnsw
    from instant_distance_tpu.models.hnsw import HnswMap as JaxHnswMap
    from instant_distance_tpu.models.packed import PackedHnsw as JaxPacked
    from instant_distance_tpu.models.scan import ScanIndex as JaxScan
    from instant_distance_tpu.ops import packed as jpk
    from instant_distance_tpu.ops import walk_kernel as jwk
except ImportError:
    jnp = None

PID_SHARE = 0.99
TOL = dict(rtol=1e-5, atol=1e-6)


def _mk_graph(rng, n, d, k):
    """Random points and a random valid adjacency (distinct ids per row,
    -1-terminated), the recipe of tests/test_walk_kernel.py."""
    pts = rng.standard_normal((n, d)).astype(np.float32)
    adj = np.full((n, k), -1, np.int32)
    for i in range(n):
        deg = rng.integers(1, k + 1)
        others = np.setdiff1d(rng.permutation(n)[:deg + 1], [i])[:deg]
        adj[i, :len(others)] = np.sort(others)
    return pts, adj


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_mostly(got, want, what):
    """pids on >= 99% of entries, distances within TOL where they agree."""
    (gd, gp), (wd, wp) = [tuple(_np(a) for a in r) for r in (got, want)]
    same = gp == wp
    assert same.mean() >= PID_SHARE, f"{what}: pids agree on {same.mean()}"
    np.testing.assert_allclose(gd[same], wd[same], err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# CPU: the port against the JAX package
# ---------------------------------------------------------------------------

def _check_walk_vs_pallas():
    """Plain K4 vs the Pallas kernel in interpret mode, at the JAX test's
    size, fed the same seed beams."""
    rng = np.random.default_rng(7)
    n, d, k, ef, b = 300, 32, 8, 12, 16
    pts, adj = _mk_graph(rng, n, d, k)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    codes, scales = jpk.quantize_points(jnp.asarray(pts))
    _, pcodes, pscales = jpk.pack_layer(jnp.asarray(adj), codes, scales)
    sd, sp = jpk.seed_entry(jnp.asarray(queries),
                            jnp.asarray(pts[:64], jnp.bfloat16), ef)
    meta, kp = jwk.pack_walk_meta(adj, np.asarray(pscales))
    t_ids, t_codes, t_scales = tpk.pack_layer(
        torch.from_numpy(adj), *tpk.quantize_points(torch.from_numpy(pts)))
    for expand, merge in ((2, "extract"), (1, "count")):
        wd, wp = jwk.walk_search(
            jnp.asarray(queries), sd, sp, pcodes, jnp.asarray(meta), kp=kp,
            expand=expand, ef=ef, max_iters=8 * ef + 16, bq=8,
            interpret=True, merge=merge)
        gd, gp = twk.walk_search(
            torch.from_numpy(queries), torch.from_numpy(np.array(sd)),
            torch.from_numpy(np.array(sp)), t_ids, t_codes, t_scales,
            expand=expand, ef=ef, max_iters=8 * ef + 16, merge=merge)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6,
                                   atol=1e-6)
    # the work count behind K4's bound: every expanded row's valid
    # neighbours, no more (the -1 tail of a row is never read)
    *_, n_exp, n_scored = twk.walk_search_plain(
        torch.from_numpy(queries), torch.from_numpy(np.array(sd)),
        torch.from_numpy(np.array(sp)), t_ids, t_codes, t_scales, expand=2,
        ef=ef, max_iters=8 * ef + 16, return_work=True)
    assert 0 < n_scored < n_exp * k, (n_exp, n_scored)


def _check_walk_empty_start():
    rng = np.random.default_rng(3)
    pts, adj = _mk_graph(rng, 100, 16, 4)
    ids, codes, scales = tpk.pack_layer(
        torch.from_numpy(adj), *tpk.quantize_points(torch.from_numpy(pts)))
    bd0 = torch.full((8, 8), torch.inf)
    bp0 = torch.full((8, 8), -1, dtype=torch.int32)
    bd, bp, n_exp, n_scored = twk.walk_search_plain(
        torch.from_numpy(pts[:8]), bd0, bp0, ids, codes, scales, expand=2,
        ef=8, max_iters=32, return_work=True)
    assert n_exp == 0 and n_scored == 0
    assert bool((bp == -1).all()) and bool(bd.isinf().all())


def _check_pack_layer(jax_packed, port_packed, zero):
    """``from_index`` packs every layer bit-exactly as the JAX package,
    and so does ``links`` truncation."""
    for jp_, tp_ in zip((jax_packed.zero_pack, *jax_packed.upper_packs),
                        (port_packed.zero_pack, *port_packed.upper_packs)):
        for w, g in zip(jp_, tp_):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pts = port_packed.points
    want = jpk.pack_layer(jnp.asarray(zero), *jpk.quantize_points(
        jnp.asarray(pts.numpy())), links=4)
    got = tpk.pack_layer(torch.tensor(zero),
                         *tpk.quantize_points(pts), links=4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _check_seed_entry(pts, queries):
    want = jpk.seed_entry(jnp.asarray(queries),
                          jnp.asarray(pts[:128], jnp.bfloat16), 32)
    got = tpk.seed_entry(torch.from_numpy(queries),
                         torch.tensor(pts[:128]).to(torch.bfloat16), 32)
    _same_mostly(got, want, "seed_entry")


def _check_beam_search_packed(jax_packed, port_packed, queries):
    """``beam_search_packed`` on the same seed beams: expand 1, 2, 4, and
    a filtered search (result filter + tombstones) at expand 2."""
    ef = 32
    sd, sp = jpk.seed_entry(jnp.asarray(queries),
                            jnp.asarray(np.asarray(jax_packed.points)[:128],
                                        jnp.bfloat16), ef)
    beams = (torch.from_numpy(np.array(sd)), torch.from_numpy(np.array(sp)))
    jbe = jnp.zeros((queries.shape[0], ef), bool)
    tbe = torch.zeros((queries.shape[0], ef), dtype=torch.bool)
    eligible = np.random.default_rng(3).random(len(port_packed)) < 0.3
    eligible[[5, 17]] = False
    for expand, elig in ((1, None), (2, None), (4, None), (2, eligible)):
        want = jpk.beam_search_packed(
            jnp.asarray(queries), *jax_packed.zero_pack, sd, sp, jbe,
            max_iters=8 * ef + 16, expand=expand,
            eligible=None if elig is None else jnp.asarray(elig))
        got = tpk.beam_search_packed(
            torch.from_numpy(queries), *port_packed.zero_pack, *beams, tbe,
            max_iters=8 * ef + 16, expand=expand,
            eligible=None if elig is None else torch.from_numpy(elig))
        _same_mostly(got, want, f"beam_search_packed expand={expand} "
                                f"filtered={elig is not None}")
        if elig is not None:
            p = got[1].numpy()
            assert np.all(elig[p[p >= 0]]), "an ineligible pid came back"


def _check_packed_hnsw(jax_packed, port_packed, queries):
    """``PackedHnsw.search_batch`` (descent) and ``search_batch_kernel``
    (plain K4 here; expand 2 and 1, both merges) against the JAX
    ``search_batch``, the port's plain-op route equal to its kernel
    route; then tombstones and a filter."""
    jq = jnp.asarray(queries)
    tq = torch.from_numpy(queries)
    _same_mostly(port_packed.search_batch(tq, k=10),
                 jax_packed.search_batch(jq, k=10), "descent")
    for expand, merge in ((2, "extract"), (1, "count")):
        want = jax_packed.search_batch(jq, k=10, entry_seeds=128,
                                       expand=expand)
        got = port_packed.search_batch_kernel(
            tq, k=10, entry_seeds=128, expand=expand, merge=merge)
        _same_mostly(got, want, f"kernel route expand={expand} merge={merge}")
        # the port's two routes score alike (ops/packed.approx_dists), so
        # on a valid graph they return the very same results
        plain = port_packed.search_batch(tq, k=10, entry_seeds=128,
                                         expand=expand)
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g.numpy(), p.numpy())
    mask = np.random.default_rng(5).random(len(port_packed)) < 0.5
    for index in (jax_packed, port_packed):
        index.delete([5, 17])
    got = port_packed.search_batch(tq, k=10, filter_mask=mask,
                                   entry_seeds=128, expand=2)
    _same_mostly(got, jax_packed.search_batch(
        jq, k=10, filter_mask=mask, entry_seeds=128, expand=2), "filtered")
    mask[[5, 17]] = False
    p = got[1].numpy()
    assert np.all(mask[p[p >= 0]]), "a filtered or deleted pid came back"
    with pytest.raises(ValueError, match="tombstones"):
        port_packed.search_batch_kernel(tq, entry_seeds=128)


def _config(index):
    """An index's Config as a dict (the packages' Config classes differ)."""
    return dataclasses.asdict(index.config)


def _equal_index(got, want, what):
    """Points, graph, config, values and tombstones equal."""
    np.testing.assert_array_equal(_np(got.points), _np(want.points),
                                  err_msg=what)
    np.testing.assert_array_equal(_np(got.zero), _np(want.zero),
                                  err_msg=what)
    assert len(got.layers) == len(want.layers), what
    for g, w in zip(got.layers, want.layers):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=what)
    assert _config(got) == _config(want), what
    assert getattr(got, "values", None) == getattr(want, "values", None)
    ga, wa = got._alive, want._alive
    assert (ga is None) == (wa is None), what
    if ga is not None:
        np.testing.assert_array_equal(_np(ga), _np(wa), err_msg=what)


def _check_serialize(arrays, jax_packed, tmp):
    """Both packages read each other's files: native Hnsw/HnswMap with
    tombstones, bincode at D=300, PackedHnsw and ScanIndex dumps."""
    points, zero, layers = arrays
    cfg_kw = dict(seed=7, m=8, ef_search=32)
    values = [f"v{i}" for i in range(len(points))]
    f = os.path.join(tmp, "x.npz")
    # native, JAX -> port and port -> JAX
    for jidx, tcls in ((JaxHnsw(points, zero, layers,
                                jconfig.Config(**cfg_kw)), Hnsw),
                       (JaxHnswMap(points, zero, layers,
                                   jconfig.Config(**cfg_kw), values),
                        HnswMap)):
        jidx.delete([3, 9])
        jidx.dump(f)
        port = tcls.load(f, device="cpu")
        assert type(port) is tcls
        _equal_index(port, jidx, f"native JAX -> port {tcls.__name__}")
        port.dump(f)
        _equal_index(type(jidx).load(f), port,
                     f"native port -> JAX {tcls.__name__}")
    with pytest.raises(ValueError, match="plain Hnsw"):
        Hnsw.load(f, device="cpu")
    # bincode at the reference binding's width, both ways
    rng = np.random.default_rng(2)
    n, d = 40, tser.REFERENCE_DIMS
    b_pts = rng.standard_normal((n, d)).astype(np.float32)
    b_zero = np.where(rng.random((n, 64)) < 0.5,
                      rng.integers(0, n, (n, 64)), -1).astype(np.int32)
    b_layers = [rng.integers(-1, n, (6, 32)).astype(np.int32)]
    b_vals = [f"w{i}é" for i in range(n)]
    fb, fb2 = os.path.join(tmp, "x.bin"), os.path.join(tmp, "y.bin")
    jmap = JaxHnswMap(b_pts, b_zero, b_layers, jconfig.Config(m=32), b_vals)
    jmap.dump(fb, format="bincode")
    port = HnswMap.load(fb, device="cpu")
    _equal_index(port, jmap, "bincode JAX -> port")
    port.dump(fb2, format="bincode")
    with open(fb, "rb") as f1, open(fb2, "rb") as f2:
        assert f1.read() == f2.read(), "bincode bytes differ"
    _equal_index(JaxHnswMap.load(fb2), port, "bincode port -> JAX")
    # PackedHnsw: JAX -> port (values and tombstones), port -> JAX
    fp = os.path.join(tmp, "p.npz")
    jp_ = JaxPacked(jax_packed.points, jax_packed.zero_pack,
                    jax_packed.upper_packs, jax_packed.config,
                    values=values, alive=np.arange(len(points)) % 7 > 0)
    jp_.dump(fp)
    port = PackedHnsw.load(fp, device="cpu")
    port.dump(f)
    back = JaxPacked.load(f)
    for got, want in ((port, jp_), (back, port)):
        for gp_, wp_ in zip((got.zero_pack, *got.upper_packs),
                            (want.zero_pack, *want.upper_packs)):
            for g, w in zip(gp_, wp_):
                np.testing.assert_array_equal(_np(g), _np(w))
        np.testing.assert_array_equal(_np(got.points), _np(want.points))
        np.testing.assert_array_equal(_np(got._alive), _np(want._alive))
        assert got.values == want.values
        assert _config(got) == _config(want)
    # ScanIndex: JAX -> port through the native front door, port -> JAX
    fs = os.path.join(tmp, "s.npz")
    jscan = JaxScan(points, values=values)
    jscan.delete([1, 2])
    jscan.dump(fs)
    port = tser.load(fs, device="cpu")
    assert isinstance(port, ScanIndex)
    port.dump(f)
    back = JaxScan.load(f)
    for got, want in ((port, jscan), (back, port)):
        for name in ("points", "codes", "scales", "norms", "_alive"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          _np(getattr(want, name)))
        assert got.values == want.values
        assert (got.metric_name, got.chunk) == (want.metric_name,
                                                 want.chunk)
    # a load with no device goes to the card, and raises without one; so
    # does a sharded file with no mesh
    if not torch.cuda.is_available():
        fh = os.path.join(tmp, "h.npz")
        JaxHnsw(points, zero, layers, jconfig.Config(**cfg_kw)).dump(fh)
        fsh = os.path.join(tmp, "sharded.npz")
        sharded_from_arrays(
            points[:64].reshape(2, 32, -1), zero[:64].reshape(2, 32, -1),
            [], np.arange(64, dtype=np.int32).reshape(2, 32),
            tconfig.Config(**cfg_kw),
            default_mesh(devices=["cpu"] * 2)).dump(fsh)
        for load, fname in ((Hnsw.load, fh), (tser.load, fh),
                            (HnswMap.load, fb), (PackedHnsw.load, fp),
                            (ScanIndex.load, fs), (ShardedHnsw.load, fsh)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                load(fname)


def check_cpu(arrays, queries):
    """Every CPU check, on the JAX-built graph ``arrays`` = (points, zero,
    layers) and ``queries`` of ``tests/test_torch_build.py``."""
    points, zero, layers = arrays
    cfg_kw = dict(seed=7, m=8, ef_search=32, search_expand=4)
    jax_packed = JaxPacked.from_index(
        JaxHnsw(points, zero, layers, jconfig.Config(**cfg_kw)))
    port_packed = PackedHnsw.from_index(hnsw_from_arrays(
        points, zero, layers, tconfig.Config(**cfg_kw), device="cpu"))
    _check_walk_vs_pallas()
    _check_walk_empty_start()
    _check_pack_layer(jax_packed, port_packed, zero)
    _check_seed_entry(points, queries)
    _check_beam_search_packed(jax_packed, port_packed, queries)
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's bincode width warning
        _check_serialize(arrays, jax_packed, tmp)
    _check_packed_hnsw(jax_packed, port_packed, queries)


# ---------------------------------------------------------------------------
# the card: K4 and K6 against their plain versions
# ---------------------------------------------------------------------------

#: K4: (B, D, N, K); each case runs ef 12, 50 and 256 and expand 1 and
#: 2.  In every batch the second query's beam is the seeded beam in a
#: shuffled slot order (the kernel ranks the caller's beam once) and the
#: third's is all (inf, -1).  ef 50 runs the "ties" data (every odd point
#: a copy of the even one before it: equal distances between pids); ef
#: 12 stages at most SMALL_STAGE bytes of codes at once, so the rows pass
#: the staging buffer (whole-row chunks, or 32 rows times a slice of D at
#: D = 300).  B = 100 is a ragged batch, D = 300
#: the 300-d path's width, D = 30 not a multiple of 4, D = 960 GIST1M's
#: (a slice of D a stage at every staging size).
WALK_CASES = tuple((b, d, n, k) for b, d, n in ((256, 16, 2048),
                                                (100, 30, 2048),
                                                (256, 128, 4096),
                                                (100, 300, 2048),
                                                (64, 960, 2048))
                   for k in (8, 64))
#: More K4 cases: (B, D, N, K, ef, expand, variant).  Odd row sizes take
#: 4-byte cp.async and plain loads, as do misaligned codes; K = 2048 with
#: expand 2 is the largest pool, 4096 candidates a step.
WALK_EXTRA = ((64, 33, 1024, 5, 16, 2, ""), (64, 18, 1024, 6, 20, 1, ""),
              (64, 64, 1024, 16, 24, 2, "misaligned"),
              (16, 20, 4400, 2048, 40, 2, ""))
SMALL_STAGE = 4096
#: K6: (B, D, N, lsub, cb)
PROBE_CASES = ((1024, 128, 65536, 64, 8192), (100, 20, 4096, 16, 1024))


def _launched(name, fn):
    before = tsk.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert tsk.launches[name] == before + 1, name
    return out


def _walk_operands(b, d, n, k, ef, device, seed=0, variant=""):
    rng = np.random.default_rng(seed)
    pts, adj = _mk_graph(rng, n, d, k)
    if variant == "ties":
        pts[1::2] = pts[0::2]
    pts = torch.from_numpy(pts).to(device)
    ids, codes, scales = tpk.pack_layer(torch.from_numpy(adj).to(device),
                                        *tpk.quantize_points(pts))
    queries = torch.from_numpy(
        rng.standard_normal((b, d)).astype(np.float32)).to(device)
    bd0, bp0 = tpk.seeded_beam(queries, pts[:256].to(torch.bfloat16), ef)
    if b >= 3:
        perm = torch.from_numpy(rng.permutation(ef)).to(device)
        bd0[1], bp0[1] = bd0[1][perm], bp0[1][perm]
        bd0[2], bp0[2] = torch.inf, -1
    if variant == "misaligned":
        codes = torch.empty(codes.numel() + 1, dtype=codes.dtype,
                            device=device)[1:].view(codes.shape).copy_(codes)
    return queries, bd0, bp0, ids, codes, scales


def _card_walk(ops, what, stage=None, **kw):
    """K4 vs its plain version on ``ops``, with the staging buffer set to
    ``stage`` bytes for the call."""
    saved = twk.STAGE_BYTES
    twk.STAGE_BYTES = stage or saved
    try:
        got = _launched("walk_search", lambda: twk.walk_search(*ops, **kw))
    finally:
        twk.STAGE_BYTES = saved
    want = twk.walk_search_plain(*ops, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"K4 {what}")
    return got


def _check_card_walk(cuda):
    for b, d, n, k in WALK_CASES:
        for ef in (12, 50, 256):
            variant = "ties" if ef == 50 else ""
            ops = _walk_operands(b, d, n, k, ef, cuda, seed=b + d + k,
                                 variant=variant)
            for expand in twk.EXPANDS:
                _card_walk(ops, f"B={b} D={d} K={k} ef={ef} expand={expand} "
                           f"{variant}",
                           stage=SMALL_STAGE if ef == 12 else None,
                           expand=expand,
                           ef=ef, max_iters=8 * ef + 16)
    for b, d, n, k, ef, expand, variant in WALK_EXTRA:
        ops = _walk_operands(b, d, n, k, ef, cuda, seed=d + k,
                             variant=variant)
        _card_walk(ops, f"B={b} D={d} K={k} ef={ef} {variant}", stage=8192,
                   expand=expand, ef=ef, max_iters=8 * ef + 16)
    # both merge strategies' names launch the one kernel
    ops = _walk_operands(64, 16, 256, 8, 12, cuda)
    got = [_card_walk(ops, f"merge={m}", ef=12, merge=m) for m in twk.MERGES]
    for g, w in zip(*got):
        assert torch.equal(g, w)
    queries, bd0, bp0, ids, codes, scales = ops
    bd, bp = _launched("walk_search", lambda: twk.walk_search(
        queries, torch.full_like(bd0, torch.inf), torch.full_like(bp0, -1),
        ids, codes, scales, expand=2, ef=12))
    assert bool((bp == -1).all()) and bool(bd.isinf().all())


def _check_card_probe(cuda):
    for b, d, n, lsub, cb in PROBE_CASES:
        g = torch.Generator().manual_seed(n + d)
        qc = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8)
        codes = torch.randint(-127, 128, (d, n), generator=g,
                              dtype=torch.int8)
        norms = torch.rand((1, n), generator=g) * 4
        norms[0, -n // 16:] = torch.inf
        w2 = tsk.pack_w2(norms, torch.tensor(2 * 0.011 * 0.019), None,
                         lsub=lsub, cb=cb, d=d)
        qc, w2, codes = qc.to(cuda), w2.to(cuda), codes.to(cuda)
        for probe in tsk.PROBES:
            got = _launched("fused_scan_probe", lambda: tsk.fused_scan_probe(
                qc, w2, codes, lsub=lsub, cb=cb, probe=probe))
            np.testing.assert_array_equal(
                _np(got), _np(tsk.fused_scan_probe_plain(
                    qc, w2, codes, lsub=lsub, cb=cb, probe=probe)),
                err_msg=f"K6 {probe} B={b} D={d} N={n}")
            if probe == "full":
                np.testing.assert_array_equal(
                    _np(got), _np(tsk.fused_scan_bucket_int_packed(
                        qc, w2, codes, lsub=lsub, cb=cb)))


def _check_card_malformed(cuda):
    """Malformed K4/K6 operands raise instead of reaching a kernel."""
    ops = _walk_operands(8, 16, 256, 8, 12, cuda)
    queries, bd0, bp0, ids, codes, scales = ops
    with pytest.raises(TypeError):
        twk.walk_search(queries.double(), *ops[1:], ef=12)
    with pytest.raises(ValueError, match="contiguous"):
        twk.walk_search(queries, bd0, bp0, ids,
                        codes.transpose(1, 2).contiguous().transpose(1, 2),
                        scales, ef=12)
    with pytest.raises(ValueError, match="device"):
        twk.walk_search(queries.cpu(), *ops[1:], ef=12)
    wide = (torch.full((8, 257), torch.inf, device=cuda),
            torch.full((8, 257), -1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="ef"):
        twk.walk_search(queries, *wide, ids, codes, scales, ef=257)
    with pytest.raises(ValueError, match="expand"):
        twk.walk_search(*ops, ef=12, expand=3)
    qc = torch.zeros((8, 16), dtype=torch.int8, device=cuda)
    w2 = torch.zeros((1, 512), dtype=torch.int32, device=cuda)
    codes_t = torch.zeros((16, 512), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="probe"):
        tsk.fused_scan_probe(qc, w2, codes_t, lsub=8, cb=64, probe="dot")


def check_card(cuda):
    _check_card_walk(cuda)
    _check_card_probe(cuda)
    _check_card_malformed(cuda)
