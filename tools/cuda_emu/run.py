"""Run the CUDA kernels of the mma.sync tile on the CPU: the top-T scan
K5 (``csrc/bucket_kernel.cu``'s ``topt_kernel`` on ``csrc/mma_tile.cuh``)
and the packed walk K4.

A check of the kernels' index math for a machine without ``nvcc``:
copies ``instant_distance_tpu_torch/csrc`` into ``build/cuda_emu/``,
replaces the inline PTX of ``csrc/mma_tile.cuh`` (cp.async, ldmatrix,
mma.sync) by C++ that implements the PTX ISA's fragment layouts, and
K4's cp.async copies by plain copies, compiles each source with g++
against ``tools/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread,
barriers for ``__syncthreads`` and the warp collectives: shuffles,
ballots, ldmatrix, mma.sync), and holds every result bit for bit against
the plain torch versions of ``ops/scan_kernel.py`` and
``ops/walk_kernel.py`` at small shapes that reach the kernels' edges.
It says nothing about what ``nvcc`` accepts or how fast the card runs.

It emulates only ``mma_tile.cuh``: it cannot run wgmma, TMA, mbarriers
or setmaxnreg, so K1 (with its probe K6), K2 and K3, which run on the
Hopper tile of ``csrc/wgmma_tile.cuh``, are left out (``scan_kernel.cu``
is not built, and ``bucket_kernel.cu``'s K2/K3 sections are cut).  They
are held against their plain versions only on the card, by
``tests/test_torch_gpu.py``: run that before any timing of them.

    python tools/cuda_emu/run.py [k4|k5 ...]

Each block runs 256 OS threads, so keep the shapes small (a few blocks).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from instant_distance_tpu_torch.ops import packed as tpk  # noqa: E402
from instant_distance_tpu_torch.ops import scan_kernel as tsk  # noqa: E402
from instant_distance_tpu_torch.ops import walk_kernel as twk  # noqa: E402

CSRC = os.path.join(ROOT, "instant_distance_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "cuda_emu")
HERE = os.path.dirname(os.path.abspath(__file__))

#: C++ for the PTX helpers of csrc/mma_tile.cuh (between smem_addr and
#: the swizzle), in the PTX ISA's layouts: ldmatrix gives lane l word
#: l % 4 of row l / 4 of matrix m (row addresses from lanes 8 m .. 8 m +
#: 7); m16n8k32 A regs a0..a3 = (row g, k 4q..), (g + 8, k 4q..), (g,
#: 16 + 4q..), (g + 8, 16 + 4q..), B regs b0, b1 = (col g, k 4q..), (g,
#: 16 + 4q..), C c0..c3 = (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8,
#: 2q + 1); g = lane / 4, q = lane % 4.
PTX_HELPERS = r'''
inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
inline void cp_async16(void* dst, const void* src, int n) {
  memcpy(dst, src, n);
  memset((uint8_t*)dst + n, 0, 16 - n);
}
inline void cp_async_commit() {}
template <int k> inline void cp_async_wait() {}
inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if (addr % 16) { fprintf(stderr, "ldmatrix: misaligned row\n"); abort(); }
  g_emu->addr[w][lane] = addr;
  warp_sync();
  for (int m = 0; m < 4; ++m)
    memcpy(&r[m], g_emu->smem + g_emu->addr[w][m * 8 + lane / 4] + 4 * (lane % 4), 4);
  warp_sync();
}
inline void mma_s8(int32_t (&acc)[4], const uint32_t (&a)[4],
                   const uint32_t (&b)[2]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  uint32_t* f = g_emu->frag[w][lane];
  for (int i = 0; i < 4; ++i) f[i] = a[i];
  f[4] = b[0];
  f[5] = b[1];
  warp_sync();
  auto A = [&](int r, int k) {
    const uint32_t v = g_emu->frag[w][(r % 8) * 4 + (k % 16) / 4][r / 8 + 2 * (k / 16)];
    return (int)(int8_t)(v >> (8 * (k % 4)));
  };
  auto B = [&](int k, int c) {
    const uint32_t v = g_emu->frag[w][c * 4 + (k % 16) / 4][4 + k / 16];
    return (int)(int8_t)(v >> (8 * (k % 4)));
  };
  const int g = lane / 4, q = lane % 4;
  for (int e = 0; e < 4; ++e) {
    int s = 0;
    for (int k = 0; k < 32; ++k) s += A(g + 8 * (e >> 1), k) * B(k, 2 * q + (e & 1));
    acc[e] += s;
  }
  warp_sync();
}
'''

#: C++ for K4's copies into shared memory (csrc/walk_kernel.cu, between
#: the two "copies" comments): synchronous, so staged bytes are there at
#: once.
WALK_COPIES = r'''
inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async4(void* dst, const void* src) { memcpy(dst, src, 4); }
inline void cp_async_commit() {}
template <int n> inline void cp_async_wait() {}
'''


def build() -> dict:
    """Emulation libraries {source stem: ctypes library}."""
    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(CSRC):
        if name in ("wgmma_tile.cuh", "scan_kernel.cu"):
            continue                     # the Hopper tile: not emulated
        with open(os.path.join(CSRC, name)) as f:
            s = f.read()
        if name == "bucket_kernel.cu":
            s = s.replace('#include "wgmma_tile.cuh"\n', "")
            s = s.replace("namespace wg = idt::wg;\n", "")
            for first, last in (("// -- K2 and K3: the Hopper tile",
                                 "// -- end of K2 and K3\n"),
                                ("// -- K2 and K3: entry points",
                                 "// -- end of K2 and K3 entry points\n")):
                s = s[:s.index(first)] + s[s.index(last) + len(last):]
        if name == "mma_tile.cuh":
            a = s.index("__device__ __forceinline__ uint32_t smem_addr")
            b = s.index("// Swizzle of the 16-byte chunks")
            s = s[:a] + PTX_HELPERS + s[b:]
        if name == "walk_kernel.cu":
            a = s.index("// -- copies into shared memory")
            b = s.index("// -- end of the copies")
            s = s[:a] + WALK_COPIES + s[b:]
        if name.endswith(".cu"):
            s = s.replace("extern __shared__ __align__(16) uint8_t smem[];",
                          "uint8_t* smem = g_emu->smem;")
            s = re.sub(r"(\S+?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(",
                       r"emu_launch_f(\2, \3, \4, \1, ", s)
        with open(os.path.join(OUT, name), "w") as f:
            f.write(s)
    libs = {}
    for stem in ("bucket_kernel", "walk_kernel"):
        so = os.path.join(OUT, f"{stem}.so")
        subprocess.run(["g++", "-x", "c++", "-std=c++20", "-O1",
                        "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                        f"-I{HERE}", os.path.join(OUT, f"{stem}.cu"), "-o",
                        so], check=True)
        libs[stem] = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    bk = libs["bucket_kernel"]
    bk.idt_topt_scan.argtypes = [P] * 7 + [I] * 7 + [P]
    bk.idt_topt_max_topt.argtypes = [I, I]
    libs["walk_kernel"].idt_walk_search.argtypes = [P] * 8 + [I] * 7 + [P]
    libs["walk_kernel"].idt_walk_smem.argtypes = [I] * 5
    return libs


def _ptr(t):
    return None if t is None else t.data_ptr()


def _misaligned(t):
    """A contiguous copy of ``t`` one element off its allocation's
    alignment (the kernels' plain staging path)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    out.copy_(t)
    return out


def _same(got, want, what: str) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=what)
    print("ok", what, flush=True)


#: K5: (B, D, N, lsub, cb, topt, variant); each runs both ways of is_dot.
#: "edges": one whole cb block ineligible (+inf norms), -inf norms in
#: another, NaN norms in a third; "ties" as for K2.
K5_CASES = (
    (7, 3, 512, 8, 64, 8, ""),               # cb / lsub = 8 = T
    (129, 40, 3072, 16, 768, 8, "edges"),    # cb / lsub = 48: one ragged tile
    (33, 40, 1024, 16, 64, 8, ""),           # cb / lsub = 4 < T
    (20, 16, 8192, 16, 4096, 5, "ties"),     # cb / lsub = 256: four tiles
    (9, 600, 1024, 8, 1024, 3, "misaligned"),  # two chunks of d, 128 cols
)


def _bucket_operands(b, d, n, lsub, cb, variant):
    """Random K2/K3/K5 operands (qc, qs, codes, scales, norms, w):
    ineligible points (+inf norms, INT32_MAX // 2 ranks), a padded tail;
    ``variant`` as in K5_CASES: "ties" repeats slab 0 of every block in
    slabs 1 and 3 (codes, scales, norms and w), makes every odd group a
    copy of the even one before it (equal minima, K5's id order among
    them) and puts NaN and -inf norms in the first cb block; "edges"
    makes one whole cb block ineligible.  w reaches the int32 range."""
    g = torch.Generator().manual_seed(n + d + b)
    qc = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8)
    codes = torch.randint(-127, 128, (d, n), generator=g, dtype=torch.int8)
    qs = torch.rand((b, 1), generator=g) * 0.02 + 1e-3
    scales = torch.rand((1, n), generator=g) * 0.02 + 1e-3
    norms = torch.rand((1, n), generator=g) * 4
    out = torch.rand((1, n), generator=g) < 0.1
    out[0, -n // 16:] = True
    w = torch.randint(-2**20, 2**31 - 1, (1, n), generator=g,
                      dtype=torch.int32)
    if variant == "edges":
        out[0, :cb] = True
        norms[0, cb:2 * cb][torch.rand(cb, generator=g) < 0.05] = -torch.inf
        norms[0, 2 * cb:3 * cb][torch.rand(cb, generator=g) < 0.05] = \
            torch.nan
    norms[out] = torch.inf
    w[out] = (2**31 - 1) // 2
    if variant == "ties":
        first = norms[0, :cb]
        first[torch.rand(cb, generator=g) < 0.02] = torch.nan
        first[torch.rand(cb, generator=g) < 0.02] = -torch.inf
        for t in (codes, scales, norms, w):
            v = t.view(t.shape[0], n // cb, lsub, cb // lsub)
            v[:, :, 1] = v[:, :, 0]
            v[:, :, 3] = v[:, :, 0]
            v[..., 1::2] = v[..., 0::2]
    if variant == "misaligned":
        codes = _misaligned(codes)
    return qc, qs, codes, scales, norms, w


def check_k5(lib) -> None:
    for b, d, n, lsub, cb, topt, variant in K5_CASES:
        qc, qs, codes, scales, norms, _ = _bucket_operands(b, d, n, lsub, cb,
                                                           variant)
        assert topt <= lib.idt_topt_max_topt(d, lsub)
        for is_dot in (False, True):
            nm = torch.where(torch.isfinite(norms), 0.0, norms) \
                if is_dot else norms
            t0 = time.perf_counter()
            od = torch.zeros((b, n // cb * topt))
            oi = torch.zeros((b, n // cb * topt), dtype=torch.int32)
            assert lib.idt_topt_scan(_ptr(qc), _ptr(qs), _ptr(codes),
                                     _ptr(scales), _ptr(nm), _ptr(od),
                                     _ptr(oi), b, d, n, lsub, cb, topt,
                                     int(is_dot), None) == 0
            _same((od, oi), tsk.fused_scan_topt_plain(
                qc, qs, codes, scales, nm, lsub=lsub, topt=topt, cb=cb,
                is_dot=is_dot),
                f"K5 B={b} D={d} N={n} lsub={lsub} cb={cb} topt={topt} "
                f"is_dot={is_dot} {variant} "
                f"({time.perf_counter() - t0:.1f} s)")


#: K4: every (D, K, ef, expand) of these on a random valid graph of
#: K4_N nodes, a batch of three queries: a seeded beam, the same beam in
#: a shuffled slot order (the kernel ranks the caller's beam once) and an
#: all-(inf, -1) beam.  ef 50 runs the "ties" data (every odd point a
#: copy of the even one before it: equal distances between pids); ef 12
#: stages at most K4_SMALL_STAGE bytes of codes at once, so that rows
#: pass the staging buffer (whole-row chunks, or 32 rows times a slice of
#: D at D = 300).
K4_DIMS, K4_KS, K4_EFS = (16, 30, 128, 300), (8, 64), (12, 50, 256)
K4_N, K4_SEEDS, K4_SMALL_STAGE = 400, 64, 4096
#: More K4 cases: (D, K, ef, expand, stage bytes, variant).  Odd row
#: sizes take 4-byte cp.async (ids) and plain loads (codes), as do
#: misaligned codes; the largest pool, 4096, takes the block-wide sort.
K4_EXTRA = ((33, 5, 16, 2, 40960, ""), (18, 6, 20, 1, 40960, ""),
            (64, 16, 24, 2, 40960, "misaligned"),
            (20, 2048, 40, 2, 8192, ""),
            # GIST1M's width: rows staged a slice of D at a time
            (960, 64, 50, 2, 20480, "ties"), (960, 64, 12, 1, 4096, ""))


def _walk_operands(d, k, ef, variant):
    rng = np.random.default_rng(d * 1000 + k * 10 + ef)
    n = max(K4_N, 2 * k + 2)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    if variant == "ties":
        pts[1::2] = pts[0::2]
    adj = np.full((n, k), -1, np.int32)
    for i in range(n):
        deg = rng.integers(1, k + 1)
        others = np.setdiff1d(rng.permutation(n)[:deg + 1], [i])[:deg]
        adj[i, :len(others)] = rng.permutation(others)
    ids, codes, scales = tpk.pack_layer(
        torch.from_numpy(adj), *tpk.quantize_points(torch.from_numpy(pts)))
    queries = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
    if variant == "ties":
        queries[1] = torch.from_numpy(pts[8])
    bd0, bp0 = tpk.seeded_beam(queries, torch.from_numpy(
        pts[:K4_SEEDS]).to(torch.bfloat16), ef)
    perm = torch.from_numpy(rng.permutation(ef))
    bd0[1], bp0[1] = bd0[1][perm], bp0[1][perm]
    bd0[2], bp0[2] = torch.inf, -1
    if variant == "misaligned":
        codes = _misaligned(codes)
    return queries, bd0, bp0, ids, codes, scales


def check_k4(lib) -> None:
    cases = [(d, k, ef, expand,
              K4_SMALL_STAGE if ef == 12 else twk.STAGE_BYTES,
              "ties" if ef == 50 else "")
             for d in K4_DIMS for k in K4_KS for ef in K4_EFS
             for expand in twk.EXPANDS] + list(K4_EXTRA)
    for d, k, ef, expand, stage, variant in cases:
        ops = _walk_operands(d, k, ef, variant)
        t0 = time.perf_counter()
        b = ops[0].shape[0]
        bd = torch.zeros((b, ef))
        bp = torch.zeros((b, ef), dtype=torch.int32)
        max_iters = 8 * ef + 16
        assert lib.idt_walk_search(*(_ptr(t) for t in ops), _ptr(bd),
                                   _ptr(bp), b, d, k, ef, expand, max_iters,
                                   stage, None) == 0
        want = twk.walk_search_plain(*ops, expand=expand, ef=ef,
                                     max_iters=max_iters)
        _same((bd, bp), want,
              f"K4 D={d} K={k} ef={ef} expand={expand} stage={stage} "
              f"{variant} ({time.perf_counter() - t0:.1f} s, "
              f"{lib.idt_walk_smem(d, k, ef, expand, stage)} B)")


def main(argv=None) -> int:
    which = argv or sys.argv[1:] or ["k4", "k5"]
    libs = build()
    checks = {"k4": (check_k4, "walk_kernel"),
              "k5": (check_k5, "bucket_kernel")}
    for name in which:
        check, stem = checks[name]
        check(libs[stem])
    return 0


if __name__ == "__main__":
    sys.exit(main())
