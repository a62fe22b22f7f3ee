"""The scan path of the PyTorch port vs the JAX package: kernels K1, K2,
K3 and K5, the ScanIndex built on them, and the building blocks they
share.

* K1: the port's plain torch version of ``fused_scan_bucket_int_packed``
  and its ``pack_w2`` agree BIT FOR BIT with the JAX ones (the Pallas
  kernel in interpret mode, both kernel bodies, with and without the
  second-level group min).
* K2 ``fused_scan_bucket``, K3 ``fused_scan_bucket_int`` and K5
  ``fused_scan_topt``: the plain versions against the Pallas kernels in
  interpret mode on one- and two-cell grids (``inner`` 1 and 2, D 16, 300
  and 3, ``is_dot`` both ways, an ineligible tail).  K3 ranks and all ids
  must be bit-exact; K2/K5 distances are held to rtol 1e-6 and measured
  bit-exact (the port keeps the kernels' f32 order of operations).  Their
  operands (``ScanIndex._fused_arrays`` for l2/dot/cosine and the build's
  ``_quantize_for_scan``) match the JAX ones: codes bit-exact, scales
  and norms within rtol 1e-6 (a norm is an f32 sum of D squares, summed
  in another order: measured 3.3e-7 at D=300).  The CUDA kernels are held to the plain
  versions on the card by tests/test_torch_gpu.py.
* ScanIndex on the same points, every search path (``bucket_pack``,
  ``bucket_int``, ``bucket``, ``topt``, ``bucket_pack`` turned
  ``bucket_int`` at D * lsub > 16384, and the default streamed scan),
  with ``rerank=False``, tombstones and a filter mask: ids equal on at
  least 99% of entries (f32 sums in another order can swap near-equal
  candidates), distances within 1e-5 relative where ids agree.  The int32
  conversion of ``bucket_int``'s rank weights saturates as XLA's does; a
  batch of small queries against large points shows it.
* The grouped selections of ``bucket_pack`` (``sel_group``,
  ``sel_kgroup``) against the JAX ``_fused_int_packed_search_jit`` on the
  same operands, rerank on and off, with and without a filter: ids
  bit-exact, distances within 1e-6 relative.
* Building blocks on random inputs: the four named metrics in their
  three batched forms within 1e-5 relative and 1e-5 absolute (the matmul
  forms lose the last bits of ``|q|^2 - 2 q.p + |p|^2`` to cancellation,
  so euclidean is compared squared: a residue of 2e-6 where the exact
  value is 0 has a square root of 1.4e-3); int8 quantization of points
  and queries and Alg. 3 selection bit-exact; exact rerank ids
  bit-exact; brute-force ids on at least 99% of entries.

The parallel wrappers (``ShardedHnsw``, ``ShardedScanIndex``, the
``Replicated*`` forms, the sharded files and a two-process gloo mesh)
are checked by ``tests/test_torch_parallel.py``, whose ``check_cpu``
runs in this item.

The checks run as one test item: each item the suite collects shifts
how pytest-xdist splits the whole suite into chunks, and one item keeps
that split as it is without the port (the reasoning is in CHANGES.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_distance_tpu.models import scan as jscan
from instant_distance_tpu.models.brute import BruteForce as JaxBruteForce
from instant_distance_tpu.models.scan import ScanIndex as JaxScanIndex
from instant_distance_tpu.ops import construct as jconstruct
from instant_distance_tpu.ops import distance as jdist
from instant_distance_tpu.ops import packed as jpacked
from instant_distance_tpu.ops import scan_kernel as jsk
from instant_distance_tpu.ops import select as jsel
from instant_distance_tpu_torch.models import scan as tscan
from instant_distance_tpu_torch.models.brute import BruteForce
from instant_distance_tpu_torch.ops import construct as tconstruct
from instant_distance_tpu_torch.ops import distance as tdist
from instant_distance_tpu_torch.ops import packed as tpacked
from instant_distance_tpu_torch.ops import scan_kernel as tsk
from instant_distance_tpu_torch.ops import select as tsel
from instant_distance_tpu_torch.utils.convert import scan_from_points
from test_torch_parallel import check_cpu as check_parallel

# Tiny shapes: more threads only add synchronisation under a parallel run.
torch.set_num_threads(1)

METRICS = ["sqeuclidean", "euclidean", "dot", "cosine"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _same_mostly(got_d, got_i, want_d, want_i, what):
    """ids equal on >= 99% of entries, distances within 1e-5 relative
    where they are."""
    assert got_i.shape == want_i.shape, what
    same = got_i == want_i
    assert same.mean() >= 0.99, f"{what}: ids agree on {same.mean():.4f}"
    np.testing.assert_allclose(got_d[same], want_d[same], rtol=1e-5,
                               atol=1e-6, err_msg=what)


# ---------------------------------------------------------------------------
# kernel K1 and its operands
# ---------------------------------------------------------------------------

KB, KD, KN = 64, 16, 1024


def _k1_operands(seed=0):
    """int8 codes hitting both ends of the range, norms with +inf
    padding, a few norms large enough to hit pack_w2's clamp, and a
    random eligibility mask."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(-127, 128, (KB, KD), dtype=np.int8)
    qc[0] = 127
    codes = rng.integers(-127, 128, (KD, KN), dtype=np.int8)
    codes[:, 1] = -127
    norms = rng.uniform(0.0, 4.0, (1, KN)).astype(np.float32)
    norms[0, -40:] = np.inf
    norms[0, 5:9] = 1e30
    eligible = rng.random((1, KN)) < 0.8
    denom = np.float32(2.0 * 0.013 * 0.021)
    return qc, codes, norms, eligible, denom


def _check_pack_w2():
    """Bit-exact, padded and ineligible columns included."""
    qc, codes, norms, eligible, denom = _k1_operands()
    for lsub, cb in ((8, 512), (16, 256), (64, 512)):
        for el in (None, eligible):
            want = np.asarray(jsk.pack_w2(
                jnp.asarray(norms), jnp.float32(denom),
                None if el is None else jnp.asarray(el), lsub=lsub, cb=cb,
                d=KD))
            got = tsk.pack_w2(
                torch.from_numpy(norms), torch.tensor(denom),
                None if el is None else torch.from_numpy(el),
                lsub=lsub, cb=cb, d=KD).numpy()
            np.testing.assert_array_equal(got, want)
            # padded and ineligible columns carry the sentinel
            assert np.all(got[0, -40:] == tsk.PACK_INELIGIBLE)


def _check_k1_plain():
    """Plain version vs the Pallas kernel (interpret mode), grid and slab
    bodies, with and without groups.  Tolerance: none — int32 keys (and
    group keys) are bit-exact."""
    for slab, groups, lsub, cb, inner in ((False, 0, 8, 512, 1),
                                          (True, 2, 16, 256, 2),
                                          (False, 4, 16, 256, 1),
                                          (True, 0, 8, 256, 2)):
        qc, codes, norms, eligible, denom = _k1_operands(seed=lsub)
        w2 = np.array(jsk.pack_w2(jnp.asarray(norms), jnp.float32(denom),
                                  jnp.asarray(eligible), lsub=lsub, cb=cb,
                                  d=KD))
        want = jsk.fused_scan_bucket_int_packed(
            jnp.asarray(qc), jnp.asarray(w2), jnp.asarray(codes), lsub=lsub,
            qb=KB, cb=cb, inner=inner, slab=slab, groups=groups,
            interpret=True)
        got = tsk.fused_scan_bucket_int_packed(
            torch.from_numpy(qc), torch.from_numpy(w2),
            torch.from_numpy(codes), lsub=lsub, cb=cb, groups=groups)
        if groups <= 1:
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(w),
                err_msg=f"slab={slab} groups={groups} lsub={lsub} cb={cb}")


def _check_k1_wrapper():
    """CPU tensors take the plain version without counting a launch;
    malformed operands raise instead of reaching a kernel."""
    qc, codes, norms, eligible, denom = _k1_operands()
    w2 = tsk.pack_w2(torch.from_numpy(norms), torch.tensor(denom), None,
                     lsub=8, cb=512, d=KD)
    before = dict(tsk.launches)
    out = tsk.fused_scan_bucket_int_packed(
        torch.from_numpy(qc), w2, torch.from_numpy(codes), lsub=8, cb=512)
    assert tuple(out.shape) == (KB, KN // 8) and out.dtype == torch.int32
    assert tsk.launches == before
    good = (torch.from_numpy(qc), w2, torch.from_numpy(codes))
    with pytest.raises(TypeError):
        tsk.fused_scan_bucket_int_packed(good[0].int(), *good[1:], lsub=8,
                                         cb=512)
    with pytest.raises(ValueError, match="power of two"):
        tsk.fused_scan_bucket_int_packed(*good, lsub=6, cb=516)
    with pytest.raises(ValueError, match="overflow"):
        tsk.fused_scan_bucket_int_packed(*good, lsub=2048, cb=2048 * 2)
    with pytest.raises(ValueError, match="device"):
        tsk.fused_scan_bucket_int_packed(*good[:2], good[2].to("meta"),
                                         lsub=8, cb=512)


# ---------------------------------------------------------------------------
# kernels K2, K3, K5 and their operands
# ---------------------------------------------------------------------------

#: (B, D, N, cb, inner, lsub, is_dot, topt): one- and two-cell grids, the
#: 300-d width, and D=3 with a 64-query block.
BUCKET_CASES = ((32, 16, 4096, 4096, 1, 32, False, 8),
                (32, 300, 8192, 4096, 2, 32, True, 8),
                (64, 3, 1024, 256, 2, 8, False, 5))


def _bucket_operands(b, d, n, is_dot, seed):
    """Random codes and scales, norms (the 0 bias under is_dot) with an
    ineligible tail and random ineligible points, and rank weights
    reaching the int32 range (``w - dot`` wraps) with INT32_MAX // 2
    marking ineligible points."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(-127, 128, (b, d), dtype=np.int8)
    codes = rng.integers(-127, 128, (d, n), dtype=np.int8)
    qs = rng.uniform(1e-3, 2e-2, (b, 1)).astype(np.float32)
    scales = rng.uniform(1e-3, 2e-2, (1, n)).astype(np.float32)
    norms = (np.zeros((1, n)) if is_dot
             else rng.uniform(0, 4, (1, n))).astype(np.float32)
    out = rng.random((1, n)) < 0.2
    out[0, -300:] = True
    norms[out] = np.inf
    w = rng.integers(-2**20, 2**31 - 1, (1, n)).astype(np.int32)
    w[out] = np.iinfo(np.int32).max // 2
    return qc, qs, codes, scales, norms, w


def _check_bucket_kernels_plain():
    """Plain K2/K3/K5 vs the Pallas kernels in interpret mode."""
    for b, d, n, cb, inner, lsub, is_dot, topt in BUCKET_CASES:
        qc, qs, codes, scales, norms, w = _bucket_operands(b, d, n, is_dot,
                                                           seed=d)
        case = f"B={b} D={d} N={n} cb={cb} inner={inner} is_dot={is_dot}"
        f32 = tuple(map(torch.from_numpy, (qc, qs, codes, scales, norms)))
        j32 = tuple(map(jnp.asarray, (qc, qs, codes, scales, norms)))
        for got, want, what in (
                (tsk.fused_scan_bucket(*f32, lsub=lsub, cb=cb,
                                       is_dot=is_dot),
                 jsk.fused_scan_bucket(*j32, lsub=lsub, qb=b, cb=cb,
                                       inner=inner, is_dot=is_dot,
                                       interpret=True), "K2"),
                (tsk.fused_scan_topt(*f32, lsub=lsub, topt=topt, cb=cb,
                                     is_dot=is_dot),
                 jsk.fused_scan_topt(*j32, lsub=lsub, topt=topt, qb=b,
                                     cb=cb, is_dot=is_dot, interpret=True),
                 "K5")):
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                          err_msg=f"{what} ids {case}")
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{what} dists {case}")
        got = tsk.fused_scan_bucket_int(torch.from_numpy(qc),
                                        torch.from_numpy(w),
                                        torch.from_numpy(codes), lsub=lsub,
                                        cb=cb)
        want = jsk.fused_scan_bucket_int(jnp.asarray(qc), jnp.asarray(w),
                                         jnp.asarray(codes), lsub=lsub, qb=b,
                                         cb=cb, inner=inner, interpret=True)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt),
                                          err_msg=f"K3 {case}")


def _check_bucket_wrappers():
    """CPU tensors take the plain versions without counting a launch;
    malformed operands raise."""
    qc, qs, codes, scales, norms, w = map(
        torch.from_numpy, _bucket_operands(8, 16, 512, False, seed=1))
    before = dict(tsk.launches)
    od, oi = tsk.fused_scan_bucket(qc, qs, codes, scales, norms, lsub=8,
                                   cb=64)
    assert od.dtype == torch.float32 and oi.dtype == torch.int32
    assert tuple(od.shape) == tuple(oi.shape) == (8, 64)
    od, oi = tsk.fused_scan_topt(qc, qs, codes, scales, norms, lsub=8,
                                 topt=3, cb=64)
    assert tuple(od.shape) == (8, 8 * 3)
    od, oi = tsk.fused_scan_bucket_int(qc, w, codes, lsub=8, cb=64)
    assert od.dtype == torch.int32 and tuple(oi.shape) == (8, 64)
    assert tsk.launches == before
    with pytest.raises(TypeError):
        tsk.fused_scan_bucket(qc, qs.double(), codes, scales, norms, lsub=8,
                              cb=64)
    with pytest.raises(ValueError, match="qs"):
        tsk.fused_scan_bucket(qc, qs[:4], codes, scales, norms, lsub=8,
                              cb=64)
    with pytest.raises(ValueError, match="lsub"):
        tsk.fused_scan_bucket_int(qc, w, codes, lsub=6, cb=64)
    with pytest.raises(ValueError, match="topt"):
        tsk.fused_scan_topt(qc, qs, codes, scales, norms, lsub=8, topt=0,
                            cb=64)
    with pytest.raises(ValueError, match="device"):
        tsk.fused_scan_bucket_int(qc, w, codes.to("meta"), lsub=8, cb=64)


def _check_fused_operands():
    """``ScanIndex._fused_arrays`` (l2/dot/cosine) and the build's
    ``_quantize_for_scan`` (K2 at D=300 for each metric, K1 at D=16)."""
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((700, 300)).astype(np.float32)
    pts[3] = 0.0                                   # the 1e-30 norm floor
    jidx = JaxScanIndex(pts)
    port = scan_from_points(pts, device="cpu")
    for variant in ("l2", "dot", "cosine"):
        got = port._fused_arrays(256, variant)
        want = jidx._fused_arrays(256, variant)
        _same_operands(got, want, f"_fused_arrays {variant}")
    for metric, d in (("sqeuclidean", 300), ("dot", 300), ("cosine", 300),
                      ("sqeuclidean", 16)):
        want = jconstruct._quantize_for_scan(jnp.asarray(pts[:, :d]),
                                             fused=True, metric_name=metric)
        got = tconstruct._quantize_for_scan(torch.from_numpy(pts[:, :d]),
                                            metric)
        _same_operands(got, want, f"_quantize_for_scan {metric} D={d}")


def _same_operands(got, want, what):
    """(codes_t, scales, norms): codes bit-exact, scales and norms within
    rtol 1e-6."""
    codes_t, scales, norms = got
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(want[0]),
                                  err_msg=what)
    for g, w in ((scales, want[1]), (norms, want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0, err_msg=what)


# ---------------------------------------------------------------------------
# ScanIndex
# ---------------------------------------------------------------------------

SN, SQ = 2048, 64
PACK = dict(fused="bucket_pack", lsub=16, cb=256, inner=2, ef=32)
#: The JAX kernel's query-block size (a TPU grid knob the port lacks).
JAX_KW = dict(qb=SQ)


def _check_scan_index():
    rng = np.random.default_rng(11)
    pts = rng.standard_normal((SN, KD)).astype(np.float32)
    queries = rng.standard_normal((SQ, KD)).astype(np.float32)
    mask = rng.random(SN) < 0.5
    jax_idx = JaxScanIndex(pts, chunk=512)
    port = scan_from_points(pts, device="cpu", chunk=512)
    for name, kw in (("bucket_pack", PACK), ("streamed", dict(ef=32)),
                     ("pack_norerank", dict(PACK, rerank=False)),
                     ("streamed_tile", dict(ef=32, tile=4))):
        jd, ji = jax_idx.search_batch(queries, k=10, **kw, **JAX_KW)
        td, ti = port.search_batch(queries, k=10, **kw)
        _same_mostly(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji),
                     name)

    # the port's own ground truth: bucket_pack recall@10 stays at the
    # level the JAX tests hold its kernel path to
    gt = BruteForce(pts, device="cpu").search_batch(queries, 10)[1].numpy()
    got = port.search_batch(queries, k=10, **PACK)[1].numpy()
    rec = np.mean([len(set(got[i]) & set(gt[i])) / 10 for i in range(SQ)])
    assert rec >= 0.9, rec

    dead = np.arange(0, SN, 7)
    jax_idx.delete(dead)
    port.delete(dead)
    ok = mask & np.isin(np.arange(SN), dead, invert=True)
    for name, kw in (("bucket_pack", PACK), ("streamed", dict(ef=32))):
        jd, ji = jax_idx.search_batch(queries, k=10, filter_mask=mask, **kw,
                                      **JAX_KW)
        td, ti = port.search_batch(queries, k=10, filter_mask=mask, **kw)
        got = ti.numpy()
        _same_mostly(td.numpy(), got, np.asarray(jd), np.asarray(ji),
                     f"{name} filtered")
        assert np.all(ok[got[got >= 0]]), "a filtered or deleted id came back"

    small = scan_from_points(pts[:300], device="cpu",
                             values=[f"v{i}" for i in range(300)])
    d, i, vals = small.search_batch_values(queries[:2], k=3)
    assert vals[0][0] == f"v{int(i[0, 0])}"
    assert small.device == torch.device("cpu")
    with pytest.raises(IndexError):
        small.delete([300])
    with pytest.raises(ValueError, match="filter_mask"):
        small.search_batch(queries, filter_mask=np.ones(5, bool))
    with pytest.raises(ValueError, match="fused"):
        small.search_batch(queries, fused="tile", cb=256)
    # the grouped selections reach the selection that _check_scan_grouped
    # holds to the JAX function, and honour filters and tombstones
    fresh = scan_from_points(pts, device="cpu")
    codes_t, norms_r, sg = fresh._fused_int_arrays(PACK["cb"] * PACK["inner"])
    for sel in (dict(sel_group=4), dict(sel_kgroup=2)):
        got = port.search_batch(queries, k=10, filter_mask=mask, **PACK,
                                **sel)[1].numpy()
        assert np.all(ok[got[got >= 0]]), f"{sel}: a filtered id came back"
        d, i = fresh.search_batch(queries, k=10, **PACK, **sel)
        wd, wi = tscan._fused_int_packed_search(
            torch.from_numpy(queries), codes_t, norms_r, sg, fresh.points,
            None, ef=32, k=10, lsub=PACK["lsub"], cb=PACK["cb"], rerank=True,
            **sel)
        assert torch.equal(i, wi) and torch.equal(d, wd), sel


#: Grouped selections of bucket_pack: (sel_group, sel_kgroup, filtered).
#: At lsub 16, cb 256 and inner 2 the 2048 points give 128 key columns:
#: 32 groups of 4 for sel_group, 64 og columns for sel_kgroup 2 (ef 32).
GROUPED = ((4, 0, False), (0, 2, False), (0, 2, True), (4, 0, True))


def _check_scan_grouped():
    """``sel_group`` and ``sel_kgroup`` against JAX
    ``_fused_int_packed_search_jit`` (its K1 in interpret mode) on the
    same operands, with rerank on and off.  ``approx_min_k`` is exact on
    XLA's CPU backend and the port selects with ``torch.topk``, so ids
    must be bit-exact; distances within 1e-6 relative (the rerank's and
    ``|q|^2``'s f32 sums run in another order)."""
    rng = np.random.default_rng(13)
    pts = rng.standard_normal((SN, KD)).astype(np.float32)
    queries = rng.standard_normal((SQ, KD)).astype(np.float32)
    mask = rng.random(SN) < 0.6
    port = scan_from_points(pts, device="cpu")
    lsub, cb, inner = PACK["lsub"], PACK["cb"], PACK["inner"]
    codes_t, norms_r, sg = port._fused_int_arrays(cb * inner)
    for sel_group, sel_kgroup, filtered in GROUPED:
        for rerank in (True, False):
            el = mask if filtered else None
            kw = dict(ef=32, k=10, lsub=lsub, cb=cb, rerank=rerank,
                      sel_group=sel_group, sel_kgroup=sel_kgroup)
            want = jscan._fused_int_packed_search_jit(
                jnp.asarray(queries), jnp.asarray(codes_t.numpy()),
                jnp.asarray(norms_r.numpy()), jnp.asarray(sg.numpy()),
                jnp.asarray(pts), None if el is None else jnp.asarray(el),
                metric_name="sqeuclidean", qb=SQ, inner=inner,
                interpret=True, **kw)
            got = tscan._fused_int_packed_search(
                torch.from_numpy(queries), codes_t, norms_r, sg,
                port.points, None if el is None else torch.from_numpy(el),
                **kw)
            what = f"{sel_group=} {sel_kgroup=} {filtered=} {rerank=}"
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]), err_msg=what)
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       rtol=1e-6, atol=1e-6, err_msg=what)
            if filtered:
                ids = got[1].numpy()
                assert mask[ids[ids >= 0]].all(), what


#: ScanIndex fused modes at D=300 (cb small enough that 1024 points fill
#: whole kernel blocks): (label, metric, search_batch arguments).
MODES = (
    ("bucket", "sqeuclidean", dict(fused="bucket", cb=256, inner=2)),
    ("bucket_int", "sqeuclidean", dict(fused="bucket_int", lsub=16, cb=256)),
    ("bucket_pack->bucket_int", "sqeuclidean",
     dict(fused="bucket_pack", lsub=64, cb=512, inner=2)),
    ("topt", "sqeuclidean", dict(fused="topt", cb=256, inner=2, topt=4)),
    ("bucket_int norerank", "sqeuclidean",
     dict(fused="bucket_int", lsub=16, cb=256, rerank=False)),
    ("bucket cosine", "cosine", dict(fused=True, cb=256)),
    ("topt cosine norerank", "cosine",
     dict(fused="topt", cb=256, rerank=False)),
    ("bucket_int->bucket dot", "dot", dict(fused="bucket_int", cb=256)),
)
#: The modes also run with tombstones and a filter mask.
FILTERED = ("bucket_int", "topt", "bucket cosine")


def _check_scan_index_modes():
    """Every fused mode against the JAX ScanIndex (Pallas kernels in
    interpret mode), then one of each kernel with tombstones and a
    filter mask."""
    rng = np.random.default_rng(12)
    pts = rng.standard_normal((1024, 300)).astype(np.float32)
    queries = rng.standard_normal((SQ, 300)).astype(np.float32)
    mask = rng.random(1024) < 0.5
    dead = np.arange(0, 1024, 7)
    ok = mask & np.isin(np.arange(1024), dead, invert=True)
    for filtered in (False, True):
        pairs = {}
        for label, metric, kw in MODES:
            if filtered and label not in FILTERED:
                continue
            if metric not in pairs:
                pairs[metric] = (JaxScanIndex(pts, metric=metric),
                                 scan_from_points(pts, device="cpu",
                                                  metric=metric))
                if filtered:
                    for index in pairs[metric]:
                        index.delete(dead)
            jidx, port = pairs[metric]
            fm = dict(filter_mask=mask) if filtered else {}
            jd, ji = jidx.search_batch(queries, k=10, ef=32, **kw, **fm,
                                       **JAX_KW)
            td, ti = port.search_batch(queries, k=10, ef=32, **kw, **fm)
            got = ti.numpy()
            _same_mostly(td.numpy(), got, np.asarray(jd), np.asarray(ji),
                         f"{label} filtered={filtered}")
            if filtered:
                assert np.all(ok[got[got >= 0]]), f"{label}: a filtered " \
                    "or deleted id came back"


def _check_int32_saturation():
    """``bucket_int``'s rank weights round(|p_hat|^2 / (2 qs sg)) pass
    2^31 for a batch of small queries against large points; XLA's convert
    saturates them at INT32_MAX, and so must the port (a plain
    ``.to(torch.int32)`` gives INT32_MIN here).  ef covers every stride
    group, so the candidate set does not hang on top-k tie order."""
    rng = np.random.default_rng(13)
    pts = rng.standard_normal((512, KD)).astype(np.float32)
    pts[::9] *= 3000.0
    queries = 0.01 * rng.standard_normal((SQ, KD)).astype(np.float32)
    port = scan_from_points(pts, device="cpu")
    codes_t, norms_r, sg = port._fused_int_arrays(256)
    qs = torch.clamp(torch.from_numpy(queries).abs().max(), min=1e-30) / 127
    ratio = torch.round(norms_r / (2.0 * qs * sg))
    assert float(ratio[torch.isfinite(ratio)].max()) >= 2**31
    want = np.asarray(jnp.asarray(ratio.numpy()).astype(jnp.int32))
    np.testing.assert_array_equal(tscan._int32_saturating(ratio).numpy(),
                                  want)
    jidx = JaxScanIndex(pts)
    for rerank in (True, False):
        kw = dict(k=10, ef=32, fused="bucket_int", lsub=16, cb=256,
                  rerank=rerank)
        jd, ji = jidx.search_batch(queries, **kw, **JAX_KW)
        td, ti = port.search_batch(queries, **kw)
        _same_mostly(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji),
                     f"saturated bucket_int rerank={rerank}")


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

B, K, N = 8, 12, 256


def _check_metrics():
    rng = np.random.default_rng(0)
    operands = {
        "gathered": (rng.standard_normal((B, KD), dtype=np.float32),
                     rng.standard_normal((B, K, KD), dtype=np.float32)),
        "pairwise": (rng.standard_normal((B, KD), dtype=np.float32),
                     rng.standard_normal((N, KD), dtype=np.float32)),
        "self_pairwise": (rng.standard_normal((B, K, KD), dtype=np.float32),),
    }
    for metric in METRICS:
        for form, args in operands.items():
            want = getattr(jdist.resolve(metric), form)(
                *map(jnp.asarray, args))
            got = getattr(tdist.resolve(metric), form)(
                *map(torch.from_numpy, args))
            assert tuple(got.shape) == want.shape, (metric, form)
            assert got.dtype == torch.float32, (metric, form)
            got, want = got.numpy(), np.asarray(want)
            if metric == "euclidean":
                got, want = got * got, want * want
            np.testing.assert_allclose(got, want, **TOL,
                                       err_msg=f"{metric} {form}")


def _check_quantize():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, KD), dtype=np.float32)
    edge = x.copy()
    edge[0] = 0.0                      # the 1e-30 scale floor
    edge[1] *= 1e6
    edge[2, :] = 0.5                   # every code at a .5 rounding tie
    edge[2, 0] = 127.0 * 0.5
    cases = ((jnp.asarray(x), torch.from_numpy(x)),
             (jnp.asarray(edge), torch.from_numpy(edge)),
             (jnp.asarray(x, jnp.bfloat16),
              torch.from_numpy(x).to(torch.bfloat16)))
    for jx, tx in cases:
        wc, ws = jpacked.quantize_points(jx)
        gc, gs = tpacked.quantize_points(tx)
        assert gc.dtype == torch.int8 and gs.dtype == torch.float32
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    wc, ws = jscan._quantize_queries(jnp.asarray(edge))
    gc, gs = tscan._quantize_queries(torch.from_numpy(edge))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def _check_rerank():
    """Candidate lists with -1 pads and repeated ids (ties broken by id)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, KD), dtype=np.float32)
    pts = rng.standard_normal((N, KD), dtype=np.float32)
    bi = rng.integers(0, N, (B, 32)).astype(np.int32)
    bi[:, -5:] = -1
    bi[0, :4] = 9
    for metric in ("sqeuclidean", "cosine"):
        wd, wi = jscan.rerank_exact(jnp.asarray(q), jnp.asarray(pts),
                                    jnp.asarray(bi), jdist.resolve(metric),
                                    10)
        gd, gi = tscan.rerank_exact(torch.from_numpy(q),
                                    torch.from_numpy(pts),
                                    torch.from_numpy(bi),
                                    tdist.resolve(metric), 10)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)


def _check_select_simple():
    """Sorted candidates, wider than M*2 or padded up to it."""
    rng = np.random.default_rng(3)
    for c in (24, 10):
        d = np.sort(rng.integers(0, 9, (B, c)).astype(np.float32), axis=1)
        p = rng.integers(0, N, (B, c)).astype(np.int32)
        d[:, -2:], p[:, -2:] = np.inf, -1
        want = jsel.select_simple(jnp.asarray(d), jnp.asarray(p), 16)
        got = tsel.select_simple(torch.from_numpy(d), torch.from_numpy(p),
                                 16)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _check_bruteforce():
    """Four chunks of 64 points, so the per-chunk top-k merge runs."""
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((N, KD), dtype=np.float32)
    q = rng.standard_normal((2 * B, KD), dtype=np.float32)
    for metric in METRICS:
        jd, ji = JaxBruteForce(pts, metric, chunk=64).search_batch(q, 10)
        td, ti = BruteForce(pts, metric, chunk=64,
                            device="cpu").search_batch(q, 10)
        _same_mostly(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji),
                     f"BruteForce {metric}")


def test_scan_path_matches_jax():
    _check_pack_w2()
    _check_k1_plain()
    _check_k1_wrapper()
    _check_bucket_kernels_plain()
    _check_bucket_wrappers()
    _check_fused_operands()
    _check_scan_index()
    _check_scan_grouped()
    _check_scan_index_modes()
    _check_int32_saturation()
    _check_metrics()
    _check_quantize()
    _check_rerank()
    _check_select_simple()
    _check_bruteforce()
    check_parallel()
