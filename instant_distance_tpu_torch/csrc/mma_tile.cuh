// The mma.sync int8 tensor-core scan tile (sm_90a) of K5
// (csrc/bucket_kernel.cu's topt_kernel).  K1 (with its probe K6), K2 and
// K3 ran on it until they moved to the Hopper tile of wgmma_tile.cuh;
// K5 is next, after which this tile goes.
//
// The TPU kernel it serves (instant_distance_tpu/ops/scan_kernel.py:
// _fused_scan_kernel) hands the whole [QB, D] x [D, CB] product to the
// matrix unit; here it goes to the int8 tensor cores.
//
// What bounds the product on an H100: at the paths' shapes the int8
// multiply-adds (2 * B * N * D operations, ~1 ms of the 1,979 TOP/s peak)
// and, for a tile this small, the shared-memory traffic and the latency
// of each slab's chain (stage, barrier, fragments, products, epilogue)
// that feed the tensor cores.  What the tile does about it:
//
//   * mma.sync m16n8k32 s8 x s8 -> s32 (IMMA), fragments loaded with
//     ldmatrix.  A block of 8 warps owns kBQ = 128 queries x kBO = 64
//     output columns; warp (wm, wn) = (warp % 4, warp / 4) owns queries
//     32 wm .. +32 and columns 32 wn .. +32: 2 x 4 tiles of 16 x 8, four
//     int32 accumulators each.  A thread's accumulators stand for the same
//     (query, column) pairs in every slab, so the caller's epilogue keeps
//     its running minimum beside them in registers.
//   * The query tile [kBQ, D] is staged once per run() (D <= kKC: once
//     per block, once per column tile for K5) and stays in shared memory
//     across all lsub slabs.  Wider D runs in chunks of kKC d, the query
//     chunk restaged each step.
//   * The codes stay codes_t [D, N] (d-major).  A step's code tiles (64
//     points x one chunk of d, for one slab, or for several narrow ones
//     so that they share a pair of barriers) are copied with 16-byte cp.async
//     along N into a raw [d][64 points] stage, double-buffered so that the
//     next step's copy (and its per-point rows: K1's w2, K2's scales and
//     norms) is in flight during this step's products; then transposed
//     4 x 4 bytes at a time with __byte_perm into the K-major [point][d]
//     layout the tensor cores take, with the 16-byte chunks of a row
//     XOR-swizzled and rows padded so that neither the stores nor the
//     ldmatrix reads conflict on shared-memory banks.  Groups whose
//     points are not 16-aligned runs (cb / lsub % 16 != 0) or misaligned
//     operands are staged by plain loads into the same raw layout.
//   * Grid order: query blocks fastest, so all query blocks of a column
//     tile run together and its codes come from HBM once, then from L2.
//
// Point p(o, t) of output column o at slab t: (o / ct) * cb + t * ct +
// o % ct, ct = cb / lsub.  A block's tile is queries q0 .. q0 + kBQ - 1 x
// columns o0 .. o0 + kBO - 1; K5 walks the tiles of one cb block itself.
// Query rows past B, columns past o_end (the end of K5's cb block) and d
// past D load as zero; the caller skips their outputs.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace idt {
namespace mma {

constexpr int kThreads = 256;            // 8 warps
constexpr int kBQ = 128;                 // queries a block
constexpr int kBO = 64;                  // output columns a block
constexpr int kKC = 512;                 // most d bytes a slab's stage holds
constexpr int kStepBytes = 256;          // d bytes a step aims to stage
constexpr int kRawRow = kBO + 16;        // raw stage row (bytes), padded
constexpr int kMaxRows = 2;              // per-point rows a kernel reads
constexpr int kRowBytes = kMaxRows * kBO * 4;
constexpr int kSmemLimit = 232448;       // bytes a block may use (sm_90)

static_assert(kThreads == 8 * 32 && kBQ == 4 * 32 && kBO == 2 * 32,
              "warp grid 4 x 2 of 32 x 32 tiles");

__host__ __device__ constexpr int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}

// Shared-memory plan for width d and lsub slabs: chunk dk (a multiple of
// 32, at most kKC), chunks nkc, slabs a step spp (several narrow slabs
// share one stage and one pair of barriers; always 1 when nkc > 1), row
// strides, and the offsets of the query tile, the two raw stages (spp
// code tiles, then spp rows blocks), the spp transposed code tiles and
// the spp transposed rows blocks.
struct Plan {
  int dk, nkc, spp, q_row, c_row, raw_bytes;
  int off_raw, off_c, off_rows, bytes;

  __host__ __device__ Plan(int d, int lsub) {
    dk = round_up(d, 32) < kKC ? round_up(d, 32) : kKC;
    nkc = (d + dk - 1) / dk;
    spp = 1;
    while (nkc == 1 && 2 * spp * dk <= kStepBytes && lsub % (2 * spp) == 0)
      spp *= 2;
    q_row = dk + 16;                     // odd number of 16-byte chunks
    c_row = round_up(dk, 128) + 16;      // whole swizzle groups, + 16
    raw_bytes = spp * (dk * kRawRow + kRowBytes);
    off_raw = kBQ * q_row;
    off_c = off_raw + 2 * raw_bytes;
    off_rows = off_c + spp * kBO * c_row;
    bytes = off_rows + spp * kRowBytes;
  }
};

inline bool vector_ok(int ct, const void* codes_t, const void* row0,
                      const void* row1) {
  auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return ct % 16 == 0 && aligned(codes_t) && aligned(row0) && aligned(row1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// acc += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 out.
__device__ __forceinline__ void mma_s8(int32_t (&acc)[4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Swizzle of the 16-byte chunks of transposed code row n: rows 16 apart
// land on different banks when one warp stores 4 x 16 points.
__device__ __forceinline__ int swizzle(int n) { return ((n >> 4) & 3) << 1; }

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Accumulators of one thread: [m16 tile i][n8 tile j][fragment element e].
using Acc = int32_t[2][4][4];

// One block's scan: kBQ queries from q0 x kBO output columns from o0.
struct Tile {
  const int b, d, n, lsub, cb, ct;
  const bool vec;
  const Plan plan;
  const int q0, o0, o_end;
  uint8_t* const smem;
  // this thread's staging pieces at slab 0: code columns o0 + 16 (tid % 4)
  // .. +16, and (tid < kMaxRows * 16) rows columns o0 + 4 (tid % 16) .. +4
  bool c_ok, r_ok;
  long long c_base, r_base;

  // The tile of queries from q0 x columns from o0; nothing at or past
  // column o_end is staged.
  __device__ Tile(uint8_t* smem_, int b_, int d_, int n_, int lsub_, int cb_,
                  bool vec_, int q0_, int o0_, int o_end_)
      : b(b_), d(d_), n(n_), lsub(lsub_), cb(cb_), ct(cb_ / lsub_),
        vec(vec_), plan(d_, lsub_), q0(q0_), o0(o0_),
        o_end(o_end_), smem(smem_) {
    const int oc = o0 + 16 * (threadIdx.x & 3);
    const int orow = o0 + 4 * (threadIdx.x & 15);
    c_ok = oc < o_end;
    r_ok = orow < o_end;
    c_base = c_ok ? point(oc, 0) : 0;
    r_base = r_ok ? point(orow, 0) : 0;
  }

  __device__ __forceinline__ long long point(int o, int t) const {
    return static_cast<long long>(o / ct) * cb +
           static_cast<long long>(t) * ct + o % ct;
  }

  // This thread's fragment coordinates inside the block's tile.
  __device__ __forceinline__ int row(int i, int e) const {
    const int lane = threadIdx.x & 31;
    return ((threadIdx.x >> 5) & 3) * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
  }
  __device__ __forceinline__ int col(int j, int e) const {
    const int lane = threadIdx.x & 31;
    return (threadIdx.x >> 7) * 32 + j * 8 + (lane & 3) * 2 + (e & 1);
  }

  // Query chunk kc -> [kBQ][dk] at stride q_row, zero past B and D.
  __device__ void stage_query(const int8_t* __restrict__ qc, int kc) const {
    const int words = plan.dk / 4;
    const int d0 = kc * plan.dk;
    const bool wide = (d & 3) == 0 && reinterpret_cast<uintptr_t>(qc) % 4 == 0;
    for (int e = threadIdx.x; e < kBQ * words; e += kThreads) {
      const int r = e / words;
      const int dd = d0 + 4 * (e - r * words);
      const int q = q0 + r;
      uint32_t w = 0;
      if (q < b) {
        const int8_t* src = qc + static_cast<long long>(q) * d + dd;
        if (wide && dd + 4 <= d) {
          w = *reinterpret_cast<const uint32_t*>(src);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (dd + i < d) w |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * i);
        }
      }
      *reinterpret_cast<uint32_t*>(smem + r * plan.q_row + 4 * (e - r * words)) = w;
    }
  }

  // Start copying the step of slabs t0 .. t0 + spp - 1 at chunk kc into
  // raw stage buf: per slab the codes as [dk][kBO] bytes at stride
  // kRawRow, then per slab nrows rows [nrows][kBO] of 32-bit values.  One
  // cp.async group per call (plain loads and stores when !vec).
  __device__ void issue(const int8_t* __restrict__ codes_t,
                        const uint32_t* const (&rows)[kMaxRows], int nrows,
                        int t0, int kc, int buf) const {
    uint8_t* raw = smem + plan.off_raw + buf * plan.raw_bytes;
    const int d0 = kc * plan.dk;
    const int c = threadIdx.x & 3;
    for (int u = 0; u < plan.spp; ++u) {
      const int t = t0 + u;
      uint8_t* stage = raw + u * plan.dk * kRawRow + 16 * c;
      for (int r = threadIdx.x >> 2; r < plan.dk; r += kThreads / 4) {
        const int dd = d0 + r;
        uint8_t* dst = stage + r * kRawRow;
        if (vec) {
          const bool ok = c_ok && dd < d;
          cp_async16(dst,
                     ok ? codes_t + static_cast<long long>(dd) * n + c_base +
                              static_cast<long long>(t) * ct
                        : codes_t,
                     ok ? 16 : 0);
        } else {
          const int o = o0 + 16 * c;
          uint32_t w[4] = {0, 0, 0, 0};
          if (dd < d) {
            const int8_t* src = codes_t + static_cast<long long>(dd) * n;
#pragma unroll
            for (int i = 0; i < 16; ++i)
              if (o + i < o_end)
                w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[point(o + i, t)]))
                             << (8 * (i & 3));
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    if (static_cast<int>(threadIdx.x) < nrows * (kBO / 4)) {
      const int k = threadIdx.x / (kBO / 4);
      const int c4 = 4 * (threadIdx.x % (kBO / 4));
      const uint32_t* row = rows[k];
      for (int u = 0; u < plan.spp; ++u) {
        const int t = t0 + u;
        uint8_t* dst = raw + plan.spp * plan.dk * kRawRow + u * kRowBytes +
                       (k * kBO + c4) * 4;
        if (vec) {
          cp_async16(dst, r_ok ? row + r_base + static_cast<long long>(t) * ct : row,
                     r_ok ? 16 : 0);
        } else {
          const int o = o0 + c4;
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = o + i < o_end ? row[point(o + i, t)] : 0u;
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    cp_async_commit();
  }

  // Raw stage buf -> the spp K-major code tiles [kBO][dk] (stride c_row,
  // swizzled 16-byte chunks) and the rows blocks.
  __device__ void transpose(int buf) const {
    const uint8_t* raw = smem + plan.off_raw + buf * plan.raw_bytes;
    // item it of slab u = it / dk: d quad k4 (4 rows) x the 16 points of
    // column chunk c = it % 4 = tid % 4; lane / 4 walks 8 consecutive
    // quads, so each store instruction of a warp hits 32 banks (the
    // swizzle of rows 16 c .. 16 c + 15 is 2 c)
    const int c = threadIdx.x & 3;
    for (int it = threadIdx.x; it < plan.spp * plan.dk; it += kThreads) {
      const int u = it / plan.dk;
      const int k4 = (it - u * plan.dk) >> 2;
      const uint8_t* src = raw + u * plan.dk * kRawRow + 16 * c;
      uint4 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = *reinterpret_cast<const uint4*>(src + (4 * k4 + r) * kRawRow);
      uint8_t* dst = smem + plan.off_c + (u * kBO + 16 * c) * plan.c_row +
                     (((k4 >> 2) ^ (c << 1)) << 4) + ((k4 & 3) << 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // w_r: points 4j .. 4j+3 at d row r -> out_i: point 4j+i at rows 0..3
        const uint32_t t0 = __byte_perm(word(v[0], j), word(v[1], j), 0x5140);
        const uint32_t t1 = __byte_perm(word(v[0], j), word(v[1], j), 0x7362);
        const uint32_t t2 = __byte_perm(word(v[2], j), word(v[3], j), 0x5140);
        const uint32_t t3 = __byte_perm(word(v[2], j), word(v[3], j), 0x7362);
        const uint32_t out[4] = {__byte_perm(t0, t2, 0x5410),
                                 __byte_perm(t0, t2, 0x7632),
                                 __byte_perm(t1, t3, 0x5410),
                                 __byte_perm(t1, t3, 0x7632)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint32_t*>(dst + (4 * j + i) * plan.c_row) = out[i];
      }
    }
    const uint4* rsrc = reinterpret_cast<const uint4*>(raw + plan.spp * plan.dk * kRawRow);
    uint4* rdst = reinterpret_cast<uint4*>(smem + plan.off_rows);
    for (int it = threadIdx.x; it < plan.spp * kRowBytes / 16; it += kThreads)
      rdst[it] = rsrc[it];
  }

  // acc += this warp's products over staged code tile u.
  __device__ __forceinline__ void product(Acc& acc, int u) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    // ldmatrix row addresses: A matrices (rows +0/+8, k +0/+16) in lane
    // order 0-7, 8-15, 16-23, 24-31 give a0..a3; B matrices (k +0/+16,
    // n tile +0/+1) give b0, b1 of tile 2 jp and of tile 2 jp + 1
    uint32_t a_addr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a_addr[i] = smem_addr(smem) +
                  ((warp & 3) * 32 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                      plan.q_row + (lane >> 4) * 16;
    uint32_t b_addr[2];
    int b_swz[2];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const int bn = (warp >> 2) * 32 + jp * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
      b_addr[jp] = smem_addr(smem + plan.off_c) + (u * kBO + bn) * plan.c_row;
      b_swz[jp] = swizzle(bn);
    }
    const int b_half = (lane >> 3) & 1;
    for (int ks = 0; ks < plan.dk / 32; ++ks) {
      uint32_t a[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], a_addr[i] + ks * 32);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, b_addr[jp] + (((2 * ks + b_half) ^ b_swz[jp]) << 4));
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], bf[j]);
    }
  }

  // The whole scan: every slab t < lsub (each in plan.nkc chunks of d),
  // with epi(t, acc, rows) after slab t's last chunk, rows its transposed
  // per-point rows [kMaxRows][kBO].  Every thread of the block calls it.
  template <class Epilogue>
  __device__ __forceinline__ void run(const int8_t* __restrict__ qc,
                                      const int8_t* __restrict__ codes_t,
                                      const uint32_t* const (&rows)[kMaxRows],
                                      int nrows, Epilogue&& epi) const {
    const int nkc = plan.nkc;
    const int steps = lsub / plan.spp * nkc;
    if (nkc == 1) stage_query(qc, 0);
    issue(codes_t, rows, nrows, 0, 0, 0);
    Acc acc;
    for (int s = 0; s < steps; ++s) {
      const int t0 = s / nkc * plan.spp;
      const int kc = s % nkc;
      if (s + 1 < steps) {
        issue(codes_t, rows, nrows, (s + 1) / nkc * plan.spp, (s + 1) % nkc,
              (s + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // step s staged; the last step's readers are done
      transpose(s & 1);
      if (nkc > 1) stage_query(qc, kc);
      __syncthreads();
      for (int u = 0; u < plan.spp; ++u) {
        if (kc == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
        }
        product(acc, u);
        if (kc == nkc - 1)
          epi(t0 + u, acc,
              reinterpret_cast<const uint32_t*>(smem + plan.off_rows + u * kRowBytes));
      }
    }
  }
};

}  // namespace mma
}  // namespace idt
