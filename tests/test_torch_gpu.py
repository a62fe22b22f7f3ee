"""The CUDA kernels against their plain torch versions.

Needs a CUDA card (marker ``gpu``; skipped elsewhere).  Imports no JAX,
so it runs on a machine that has only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

Tolerance: none.  K1, K3 and K6 are integer kernels; K2, K4 and K5
round every f32 operation in the plain version's order, so distances
and ids are bit-exact too (NaN where the plain version has NaN).  Each case also checks that the wrapper
counted one launch.  A callable metric's row blocks agree with one block
within 1e-6 relative.  The parallel wrappers run on two shards of the
card against two CPU shards (ids on >= 99% of entries).  One test item,
for the reason given in
tests/test_torch_scan.py; the K4 and K6 checks live in
tests/test_torch_packed.py (``check_card``).
"""

import numpy as np
import pytest
import torch

from instant_distance_tpu_torch.ops import scan_kernel as tsk
from test_torch_packed import check_card as check_packed_kernels

pytestmark = pytest.mark.gpu

#: K1: (B, D, N, lsub, cb, groups, variant).  The Hopper tile's edges
#: (csrc/wgmma_tile.cuh: 128 queries in two consumers of 64, 128 columns,
#: 128-byte d chunks): a batch of 1 and batches one past a consumer's and
#: a block's queries, D tails (Dpad = D rounded up to 32, zero-padded),
#: nine chunks of d at D 960 and 1024 against a ring of five stages, the
#: query tile streamed with the codes (D 1536), cb/lsub = 144 (a second,
#: partial column tile) and cb/lsub < 128 (one partial tile a cb block),
#: misaligned codes_t (the point-major copy is the kernel's) and a column
#: count that is a multiple of 8192 but not of 16384 (the capped operands
#: of a sampled build, ``construct_sample_cols``).
#: Variants: "extreme" puts every code at +-127 (D * lsub = 16384, the
#: guard's edge of |dot| * lsub < 2^28); "misaligned" shifts codes_t's
#: data off 16-byte alignment.
PACKED_CASES = (
    (1024, 128, 65536, 64, 8192, 0, ""),     # the main path's shapes
    (1024, 128, 65536, 64, 8192, 2, ""),
    (100, 20, 4096, 16, 1024, 4, ""),        # ragged batch, D % 32 != 0
    (7, 3, 512, 8, 64, 0, ""),
    (1, 128, 16384, 64, 8192, 0, ""),
    (129, 100, 2304, 16, 768, 0, ""),        # N/lsub = 144
    (4097, 16, 8192, 16, 1024, 0, ""),
    (300, 256, 65536, 64, 8192, 0, "extreme"),
    (130, 300, 8192, 32, 4096, 0, ""),
    (64, 1024, 16384, 16, 4096, 0, ""),      # two chunks of d
    (40, 128, 8192, 32, 2048, 0, "misaligned"),
    (4096, 96, 3 * 8192, 64, 8192, 0, ""),   # a sampled build's capped scan
    # GIST1M's width at lsub 16: the ladder's ScanIndex slice, and every
    # code +-127 (|dot| * lsub = 2.48e8) with N/lsub = 144
    (1024, 960, 65536, 16, 8192, 0, ""),
    (129, 960, 2304, 16, 768, 0, "extreme"),
    (65, 128, 16384, 64, 8192, 0, ""),       # one past a consumer's 64
    (129, 128, 4608, 16, 2304, 2, ""),       # cb/lsub = 144: a partial tile
    (65, 1536, 8192, 8, 1024, 0, ""),        # the query tile streamed
)
#: K2 / K3 / K5: (B, D, N, lsub, cb, variant); each runs K2 and K5 both
#: ways of is_dot.  300 is the fastText width of the 300-d path.  K5's
#: edges on the Hopper tile (128 groups a column tile): cb/lsub = 8, 48
#: and 4 (fewer groups than TOPT; one partial tile), 144 (a second,
#: partial tile), 256 (two tiles, merged) and 320 (three, the last
#: partial), two chunks of d.  Variants: "ties" adds NaN norms to the
#: first cb block (the other blocks keep K5's results finite), repeats
#: slab 0 of every block in slabs 1 and 3 (codes, scales, norms and w),
#: so the argmin must keep the first slab, and makes every odd group a
#: copy of the even one before it, so K5 must order equal minima by id;
#: "crosstile" makes group j + 128 of every block a copy of group j, so
#: that equal minima lie in two column tiles and K5's merge must order
#: them by id; "edges" makes the first cb block wholly ineligible and
#: puts -inf norms in the second and NaN norms in the third;
#: "sentinels" puts them in one column tile of a block only: a NaN norm
#: in the last tile of the first block, a -inf norm in the first tile of
#: the second, both (in two tiles) in the third; "misaligned" as for K1.
BUCKET_CASES = (
    (1024, 300, 65536, 32, 4096, ""),        # the build's and bucket's shapes
    (1024, 300, 65536, 64, 8192, ""),        # ScanIndex bucket_int at 300-d
    (100, 20, 8192, 16, 4096, ""),           # ragged batch, D % 32 != 0
    (7, 3, 512, 8, 64, ""),
    (1, 300, 8192, 32, 4096, ""),
    (129, 16, 2304, 16, 768, ""),            # N/lsub = 144
    (4097, 100, 4096, 32, 4096, ""),
    (256, 256, 16384, 32, 4096, "ties"),
    (64, 600, 8192, 16, 4096, ""),           # two chunks of d
    (40, 128, 8192, 32, 2048, "misaligned"),
    (33, 40, 1024, 16, 64, ""),              # cb/lsub = 4 < TOPT
    (200, 300, 12288, 16, 4096, "edges"),    # the topt path's lsub and cb
    # GIST1M's width: the build wave's K2 and the ladder's K3 (lsub 32,
    # cb 8192), and a ragged tile (cb/lsub = 24)
    (1024, 960, 65536, 32, 4096, ""),
    (1024, 960, 65536, 32, 8192, ""),
    (130, 960, 2304, 32, 768, "ties"),
    # the Hopper tile: one past a consumer's 64 queries with cb/lsub =
    # 144, more d chunks than the ring's stages, the query tile streamed
    (65, 300, 4608, 16, 2304, ""),
    (1, 1024, 8192, 32, 4096, "ties"),
    (65, 1536, 4096, 16, 2048, ""),
    # K5 across column tiles: equal minima in two tiles, a NaN or a -inf
    # in one tile of a cb block, and three tiles with a partial last one
    (129, 300, 8192, 16, 4096, "crosstile"),
    (200, 300, 12288, 16, 4096, "sentinels"),
    (65, 96, 15360, 16, 5120, "crosstile"),
)
TOPT = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _misaligned(t):
    """A contiguous copy of ``t`` whose data is one element off the
    allocation's alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _packed_operands(b, d, n, lsub, cb, seed, device, variant=""):
    g = torch.Generator().manual_seed(seed)
    qc = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8)
    codes = torch.randint(-127, 128, (d, n), generator=g, dtype=torch.int8)
    if variant == "extreme":
        qc = torch.where(qc >= 0, 127, -127).to(torch.int8)
        codes = torch.where(codes >= 0, 127, -127).to(torch.int8)
    norms = torch.rand((1, n), generator=g) * 4
    norms[0, -3 * n // 64:] = torch.inf
    eligible = torch.rand((1, n), generator=g) < 0.9
    w2 = tsk.pack_w2(norms, torch.tensor(2 * 0.011 * 0.019), eligible,
                     lsub=lsub, cb=cb, d=d)
    codes = codes.to(device)
    if variant == "misaligned":
        codes = _misaligned(codes)
    return qc.to(device), w2.to(device), codes


def _bucket_operands(b, d, n, seed, device, lsub=1, cb=None, variant=""):
    """Random K2/K3/K5 operands: ineligible (+inf, and the int kernel's
    INT32_MAX // 2) points, a padded tail, rank weights reaching the
    int32 range so that ``w - dot`` wraps; ``variant`` as in
    BUCKET_CASES."""
    g = torch.Generator().manual_seed(seed)
    qc = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8)
    codes = torch.randint(-127, 128, (d, n), generator=g, dtype=torch.int8)
    qs = torch.rand((b, 1), generator=g) * 0.02 + 1e-3
    scales = torch.rand((1, n), generator=g) * 0.02 + 1e-3
    norms = torch.rand((1, n), generator=g) * 4
    out = torch.rand((1, n), generator=g) < 0.1
    out[0, -n // 16:] = True
    norms[out] = torch.inf
    w = torch.randint(-2**20, 2**31 - 1, (1, n), generator=g,
                      dtype=torch.int32)
    w[out] = (2**31 - 1) // 2
    if variant == "edges":
        norms[0, :cb] = torch.inf
        w[0, :cb] = (2**31 - 1) // 2
        norms[0, cb:2 * cb][torch.rand(cb, generator=g) < 0.05] = -torch.inf
        norms[0, 2 * cb:3 * cb][torch.rand(cb, generator=g) < 0.05] = \
            torch.nan
    if variant == "sentinels":
        ct = cb // lsub
        for blk, col, val in ((0, ct - 1, torch.nan), (1, 0, -torch.inf),
                              (2, 0, torch.nan), (2, ct - 1, -torch.inf)):
            norms[0, blk * cb + 5 * ct + col] = val     # slab 5's point
    if variant == "crosstile":
        for t in (codes, scales, norms, w):
            v = t.view(t.shape[0], n // cb, lsub, cb // lsub)
            v[..., 128:] = v[..., :cb // lsub - 128].clone()
    if variant == "ties":
        norms[0, :cb][torch.rand(cb, generator=g) < 0.02] = torch.nan
        for t in (codes, scales, norms, w):
            v = t.view(t.shape[0], n // cb, lsub, cb // lsub)
            v[:, :, 1] = v[:, :, 0]
            v[:, :, 3] = v[:, :, 0]
            v[..., 1::2] = v[..., 0::2]
    ops = [t.to(device) for t in (qc, qs, codes, scales, norms, w)]
    if variant == "misaligned":
        ops[2] = _misaligned(ops[2])
    return ops


def _same(got, want, what):
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.cpu().numpy(), w_.cpu().numpy(),
                                      err_msg=what)


def _launched(name, fn):
    before = tsk.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert tsk.launches[name] == before + 1, name
    return out


def _check_packed(cuda):
    for b, d, n, lsub, cb, groups, variant in PACKED_CASES:
        qc, w2, codes = _packed_operands(b, d, n, lsub, cb, seed=n + d,
                                         device=cuda, variant=variant)
        got = _launched("fused_scan_bucket_int_packed",
                        lambda: tsk.fused_scan_bucket_int_packed(
                            qc, w2, codes, lsub=lsub, cb=cb, groups=groups))
        want = tsk.fused_scan_bucket_int_packed_plain(
            qc, w2, codes, lsub=lsub, cb=cb, groups=groups)
        if groups <= 1:
            got, want = (got,), (want,)
        _same(got, want, f"K1 B={b} D={d} N={n} lsub={lsub} cb={cb} "
                         f"groups={groups} {variant}")


def _check_bucket(cuda):
    for b, d, n, lsub, cb, variant in BUCKET_CASES:
        qc, qs, codes, scales, norms, w = _bucket_operands(
            b, d, n, n + d, cuda, lsub=lsub, cb=cb, variant=variant)
        case = f"B={b} D={d} N={n} lsub={lsub} cb={cb} {variant}"
        for is_dot in (False, True):
            nm = torch.where(torch.isfinite(norms), 0.0, norms) \
                if is_dot else norms
            args = (qc, qs, codes, scales, nm)
            got = _launched("fused_scan_bucket", lambda: tsk.fused_scan_bucket(
                *args, lsub=lsub, cb=cb, is_dot=is_dot))
            _same(got, tsk.fused_scan_bucket_plain(
                *args, lsub=lsub, cb=cb, is_dot=is_dot),
                f"K2 {case} is_dot={is_dot}")
            got = _launched("fused_scan_topt", lambda: tsk.fused_scan_topt(
                *args, lsub=lsub, topt=TOPT, cb=cb, is_dot=is_dot))
            _same(got, tsk.fused_scan_topt_plain(
                *args, lsub=lsub, topt=TOPT, cb=cb, is_dot=is_dot),
                f"K5 {case} is_dot={is_dot}")
        got = _launched("fused_scan_bucket_int",
                        lambda: tsk.fused_scan_bucket_int(qc, w, codes,
                                                          lsub=lsub, cb=cb))
        _same(got, tsk.fused_scan_bucket_int_plain(qc, w, codes, lsub=lsub,
                                                   cb=cb), f"K3 {case}")


def _check_malformed(cuda):
    """Malformed operands raise instead of reaching a kernel."""
    qc, w2, codes = _packed_operands(8, 16, 512, 8, 64, seed=0, device=cuda)
    with pytest.raises(ValueError, match="device"):
        tsk.fused_scan_bucket_int_packed(qc.cpu(), w2, codes, lsub=8, cb=64)
    with pytest.raises(ValueError, match="contiguous"):
        tsk.fused_scan_bucket_int_packed(qc, w2, codes.T.contiguous().T,
                                         lsub=8, cb=64)
    qc, qs, codes, scales, norms, w = _bucket_operands(8, 16, 512, 0, cuda)
    with pytest.raises(ValueError, match="device"):
        tsk.fused_scan_bucket(qc, qs.cpu(), codes, scales, norms, lsub=8,
                              cb=64)
    with pytest.raises(TypeError):
        tsk.fused_scan_bucket(qc, qs.double(), codes, scales, norms, lsub=8,
                              cb=64)
    with pytest.raises(ValueError, match="lsub"):
        tsk.fused_scan_bucket_int(qc, w, codes, lsub=6, cb=64)
    with pytest.raises(ValueError, match="contiguous"):
        tsk.fused_scan_topt(qc, qs, codes.T.contiguous().T, scales, norms,
                            lsub=8, cb=64)


def _check_topt_large(cuda):
    """K5 takes any topt: T = 1000 over cb blocks of 8 groups (one tile)
    and of 256 (two tiles, merged), more rounds than groups, bit-exact."""
    qc, qs, codes, scales, norms, _ = _bucket_operands(8, 16, 4096, 0, cuda)
    for lsub, cb in ((8, 64), (8, 2048)):
        args = (qc, qs, codes, scales, norms)
        got = _launched("fused_scan_topt", lambda: tsk.fused_scan_topt(
            *args, lsub=lsub, topt=1000, cb=cb))
        _same(got, tsk.fused_scan_topt_plain(*args, lsub=lsub, topt=1000,
                                             cb=cb),
              f"K5 topt=1000 lsub={lsub} cb={cb}")


def _check_callable_blocks(cuda):
    """A callable metric's ``self_pairwise`` on the card, in row blocks
    and in one block: equal within 1e-6 relative (a CUDA reduction's
    order may depend on the tensor's size), and equal to sq-L2."""
    from instant_distance_tpu_torch.ops import distance as tdist

    g = torch.Generator().manual_seed(5)
    p = torch.rand((64, 40, 96), generator=g).to(cuda)
    metric = tdist.Metric(lambda a, b: ((a - b) ** 2).sum())
    saved = tdist.CALLABLE_ELEMS
    try:
        tdist.CALLABLE_ELEMS = 1 << 30
        whole = metric.self_pairwise(p)
        tdist.CALLABLE_ELEMS = 40 * 40 * 96 * 3       # three rows a block
        blocks = metric.self_pairwise(p)
    finally:
        tdist.CALLABLE_ELEMS = saved
    np.testing.assert_allclose(blocks.cpu().numpy(), whole.cpu().numpy(),
                               rtol=1e-6, atol=0)
    named = tdist.Metric("sqeuclidean").self_pairwise(p)
    np.testing.assert_allclose(whole.cpu().numpy(), named.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def _check_parallel_card(cuda):
    """The parallel wrappers on two shards of the card against the same
    calls on two CPU shards: ``ShardedScanIndex(fused=True)`` (K2 on the
    card) and a small ``ShardedHnsw`` build and search (K1 in its waves);
    ids equal on >= 99% of entries."""
    from instant_distance_tpu_torch import Config
    from instant_distance_tpu_torch.parallel.mesh import default_mesh
    from instant_distance_tpu_torch.parallel.scan import ShardedScanIndex
    from instant_distance_tpu_torch.parallel.sharded import ShardedHnsw

    rng = np.random.default_rng(3)
    pts = rng.random((10_237, 32), dtype=np.float32)
    queries = rng.random((300, 32), dtype=np.float32)
    card, cpu = default_mesh(devices=[cuda] * 2), \
        default_mesh(devices=["cpu"] * 2)
    before = tsk.launches["fused_scan_bucket"]
    got = ShardedScanIndex(pts, mesh=card).search_batch(queries, fused=True)
    assert tsk.launches["fused_scan_bucket"] == before + 2
    want = ShardedScanIndex(pts, mesh=cpu).search_batch(queries, fused=True)
    same = (got[1].cpu() == want[1]).float().mean().item()
    assert got[1].device.type == "cuda" and same >= 0.99, same
    cfg = Config(seed=3, m=8, wave_size=256, ef_search=32)
    before = tsk.launches["fused_scan_bucket_int_packed"]
    built = ShardedHnsw.build(pts[:4093], cfg, mesh=card)
    assert tsk.launches["fused_scan_bucket_int_packed"] > before
    got = built.search_batch(queries, k=10)[1]
    want = ShardedHnsw.build(pts[:4093], cfg, mesh=cpu).search_batch(
        queries, k=10)[1]
    same = (got.cpu() == want).float().mean().item()
    assert same >= 0.99, same


def test_kernel_matches_plain(cuda):
    _check_packed(cuda)
    _check_bucket(cuda)
    _check_malformed(cuda)
    _check_topt_large(cuda)
    _check_callable_blocks(cuda)
    _check_parallel_card(cuda)
    check_packed_kernels(cuda)
