"""The scan path of the PyTorch port vs the JAX package: kernel K1, the
ScanIndex built on it, and the building blocks they share.

* K1: the port's plain torch version of ``fused_scan_bucket_int_packed``
  and its ``pack_w2`` agree BIT FOR BIT with the JAX ones (the Pallas
  kernel in interpret mode, both kernel bodies, with and without the
  second-level group min).  The CUDA kernel is held to the plain version
  on the card by tests/test_torch_gpu.py.
* ScanIndex on the same points, both search paths (the packed-key kernel
  path ``fused="bucket_pack"`` and the default streamed scan), with and
  without tombstones and a filter mask: ids equal on at least 99% of
  entries (f32 sums in another order can swap near-equal candidates),
  distances within 1e-5 relative where ids agree.
* Building blocks on random inputs: the four named metrics in their
  three batched forms within 1e-5 relative and 1e-5 absolute (the matmul
  forms lose the last bits of ``|q|^2 - 2 q.p + |p|^2`` to cancellation,
  so euclidean is compared squared: a residue of 2e-6 where the exact
  value is 0 has a square root of 1.4e-3); int8 quantization of points
  and queries and Alg. 3 selection bit-exact; exact rerank ids
  bit-exact; brute-force ids on at least 99% of entries.

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
from instant_distance_tpu.ops import distance as jdist
from instant_distance_tpu.ops import packed as jpacked
from instant_distance_tpu.ops import scan_kernel as jsk
from instant_distance_tpu.ops import select as jsel
from instant_distance_tpu_torch.models import scan as tscan
from instant_distance_tpu_torch.models.brute import BruteForce
from instant_distance_tpu_torch.ops import distance as tdist
from instant_distance_tpu_torch.ops import packed as tpacked
from instant_distance_tpu_torch.ops import scan_kernel as tsk
from instant_distance_tpu_torch.ops import select as tsel
from instant_distance_tpu_torch.utils.convert import scan_from_points

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
    before = tsk.launches
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
    port = scan_from_points(pts, chunk=512)
    for name, kw in (("bucket_pack", PACK), ("streamed", dict(ef=32)),
                     ("pack_norerank", dict(PACK, rerank=False)),
                     ("streamed_tile", dict(ef=32, tile=4))):
        jd, ji = jax_idx.search_batch(queries, k=10, **kw, **JAX_KW)
        td, ti = port.search_batch(queries, k=10, **kw)
        _same_mostly(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji),
                     name)

    # the port's own ground truth: bucket_pack recall@10 stays at the
    # level the JAX tests hold its kernel path to
    gt = BruteForce(pts).search_batch(queries, 10)[1].numpy()
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

    small = scan_from_points(pts[:300], values=[f"v{i}" for i in range(300)])
    d, i, vals = small.search_batch_values(queries[:2], k=3)
    assert vals[0][0] == f"v{int(i[0, 0])}"
    assert small.device == torch.device("cpu")
    with pytest.raises(IndexError):
        small.delete([300])
    with pytest.raises(ValueError, match="filter_mask"):
        small.search_batch(queries, filter_mask=np.ones(5, bool))
    with pytest.raises(NotImplementedError, match="K2"):
        small.search_batch(queries, fused="bucket", cb=256)


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
        td, ti = BruteForce(pts, metric, chunk=64).search_batch(q, 10)
        _same_mostly(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji),
                     f"BruteForce {metric}")


def test_scan_path_matches_jax():
    _check_pack_w2()
    _check_k1_plain()
    _check_k1_wrapper()
    _check_scan_index()
    _check_metrics()
    _check_quantize()
    _check_rerank()
    _check_select_simple()
    _check_bruteforce()
