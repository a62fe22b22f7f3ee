"""Run the packed walk K4 (``csrc/walk_kernel.cu``) on the CPU.

A check of the kernel's index math for a machine without ``nvcc``:
copies ``csrc/walk_kernel.cu`` into ``build/cuda_emu/``, replaces its
cp.async copies by plain copies, compiles it with g++ against
``tools/cuda_emu/cuda_runtime.h`` (one thread per CUDA thread, barriers
for ``__syncthreads`` and the warp collectives: shuffles and ballots),
and holds every result bit for bit against the plain torch version of
``ops/walk_kernel.py`` at small shapes that reach the kernel's edges.
It says nothing about what ``nvcc`` accepts or how fast the card runs.

The scan kernels (K1 with its probe K6, K2, K3 and K5) run on the Hopper
tile of ``csrc/wgmma_tile.cuh``, whose wgmma, TMA and mbarriers it cannot
run: they are held against their plain versions only on the card, by
``tests/test_torch_gpu.py``, so after touching them make the first chip
call a short one that builds them and runs that test.

    python tools/cuda_emu/run.py

Each block runs 64 OS threads, so keep the shapes small.
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
from instant_distance_tpu_torch.ops import walk_kernel as twk  # noqa: E402

CSRC = os.path.join(ROOT, "instant_distance_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "cuda_emu")
HERE = os.path.dirname(os.path.abspath(__file__))

#: C++ for K4's copies into shared memory (csrc/walk_kernel.cu, between
#: the two "copies" comments): synchronous, so staged bytes are there at
#: once.
WALK_COPIES = r'''
inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async4(void* dst, const void* src) { memcpy(dst, src, 4); }
inline void cp_async_commit() {}
template <int n> inline void cp_async_wait() {}
'''


def build():
    """The emulated K4 as a ctypes library."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(CSRC, "walk_kernel.cu")) as f:
        s = f.read()
    a = s.index("// -- copies into shared memory")
    b = s.index("// -- end of the copies")
    s = s[:a] + WALK_COPIES + s[b:]
    s = s.replace("extern __shared__ __align__(16) uint8_t smem[];",
                  "uint8_t* smem = g_emu->smem;")
    s = re.sub(r"(\S+?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(",
               r"emu_launch_f(\2, \3, \4, \1, ", s)
    src = os.path.join(OUT, "walk_kernel.cu")
    with open(src, "w") as f:
        f.write(s)
    so = os.path.join(OUT, "walk_kernel.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++20", "-O1",
                    "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                    f"-I{HERE}", src, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.idt_walk_search.argtypes = [P] * 8 + [I] * 7 + [P]
    lib.idt_walk_smem.argtypes = [I] * 5
    return lib


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


def main() -> int:
    check_k4(build())
    return 0


if __name__ == "__main__":
    sys.exit(main())
