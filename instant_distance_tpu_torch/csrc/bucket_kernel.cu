// Bucket-min int8 scans for Hopper (sm_90a): kernels K2, K3 and K5.
//
// Replace the TPU Pallas kernels of instant_distance_tpu/ops/scan_kernel.py:
//   K2 fused_scan_bucket      (_bucket_scan_kernel)      idt_bucket_scan
//   K3 fused_scan_bucket_int  (_bucket_scan_int_kernel)  idt_bucket_scan_int
//   K5 fused_scan_topt        (_fused_scan_kernel)       idt_topt_scan
// K2 is the HNSW build's wave search for dot/cosine and D > 256 and
// ScanIndex's "bucket" path; K3 is ScanIndex's "bucket_int" path (and
// "bucket_pack" where packed keys would overflow); K5 is ScanIndex's
// "topt" path.
//
// What they compute, bit-exact with the plain torch versions in
// instant_distance_tpu_torch/ops/scan_kernel.py, for each query q and
// stride group o (points p(o, t) = (o / ct) * cb + t * ct + o % ct,
// t < lsub, ct = cb / lsub):
//
//   K2  v = norms[p] - 2 * prod   (L2)   or   norms[p] - prod   (is_dot),
//       prod = (qs[q] * scales[p]) * float(dot(q, p)),  in f32, rounded
//       after every operation in exactly that order (no FMA contraction:
//       __fmul_rn / __fsub_rn);
//   K3  v = w[p] - dot(q, p), int32 with two's-complement wrap as XLA's;
//   both: od[q, o] = min_t v, oi[q, o] = p(o, t*) for the first slab t*
//       reaching it (a later slab wins only on a strict <; a NaN sticks,
//       as jnp.minimum's does), or -1 where od is not finite (K2) or
//       >= (INT32_MAX / 2) / 2 (K3);
//   K5  K2's od/oi for one cb block, then topt rounds per query: the
//       minimum value, the smallest id among the entries equal to it,
//       that entry removed; od/oi [B, (N / cb) * topt], -1 ids where the
//       minimum is not finite.
//
// What bounds them on an H100: the int8 multiply-adds (2 * B * N * D
// operations, ~1.2 ms of the tensor cores' peak at K2's build wave) at
// the path's shapes; K2/K3 also write [B, N/lsub] f32/i32 pairs (1-2 GB
// at the smoke's shapes, ~0.3-0.6 ms at HBM rate).  Once K2's product
// runs on tensor cores, its epilogue (about nine CUDA-core operations an
// element, one of them the int-to-float conversion) is of the same order.
//
// What the design does about it.  K2 runs on the int8 tensor-core tile
// of mma_tile.cuh (mma.sync m16n8k32, the query tile staged once per
// block, code tiles with their scales and norms rows double-buffered with
// cp.async and transposed in shared memory, query blocks fastest in the
// grid); its blocks own 128 queries x 64 stride groups and keep the
// running min and argmin beside the accumulators in registers across the
// lsub slabs, so the [B, N] distance tile never reaches memory.  K3 and
// K5 still run on the dot tile of dp4a_tile.cuh (__dp4a on four int8 at
// a time), min and argmin in registers likewise; K3's blocks own 64
// queries x 64 stride groups.  K5's top-T needs all cb / lsub group
// minima of a cb block for a query, so its blocks own 32 queries x one
// whole cb block: the minima go to shared memory and 8 threads a query
// run the topt extraction rounds there.  Tensor cores and TMA staging
// for K3 and K5 are later work.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "dp4a_tile.cuh"
#include "mma_tile.cuh"

namespace {

using idt::DotTiles;
using idt::kBL;
using idt::kThreads;
using idt::kTL;
namespace mma = idt::mma;

enum Epilogue { kL2 = 0, kDot = 1 };

constexpr int kTQ = 4;                   // K3: 64 queries per block
constexpr int kBQ = 16 * kTQ;
constexpr int kTQTopt = 2;               // K5: 32 queries per block
constexpr int kBQTopt = 16 * kTQTopt;
constexpr int kTopLanes = 8;             // K5: threads per query in top-T
constexpr int32_t kIntLimit = (INT_MAX / 2) / 2;

static_assert(kThreads == kBQTopt * kTopLanes, "one top-T row per 8 lanes");

// One slab's f32 value, in the JAX kernel's order of operations.
template <Epilogue E>
__device__ __forceinline__ float f32_value(float qsv, float s, float nm,
                                           int32_t dot) {
  const float prod = __fmul_rn(__fmul_rn(qsv, s), __int2float_rn(dot));
  return E == kDot ? __fsub_rn(nm, prod) : __fsub_rn(nm, __fmul_rn(2.0f, prod));
}

// Running strided min and argmin: the first slab wins ties; once a NaN
// arrives the min stays NaN (jnp.minimum), the argmin stays put.
__device__ __forceinline__ void min_update(float v, int t, float& best,
                                           int& am) {
  if (v < best) {
    best = v;
    am = t;
  } else if (isnan(v)) {
    best = v;
  }
}

__device__ __forceinline__ void min_update(int32_t v, int t, int32_t& best,
                                           int& am) {
  if (v < best) {
    best = v;
    am = t;
  }
}

// K3: one block owns kBQ queries x kBL stride groups.
__global__ void __launch_bounds__(kThreads)
bucket_int_kernel(const int8_t* __restrict__ qc,
                  const int8_t* __restrict__ codes_t,
                  const int32_t* __restrict__ w, int32_t* __restrict__ od,
                  int32_t* __restrict__ oi, int b, int d, int n, int lsub,
                  int cb) {
  __shared__ DotTiles<kTQ> sm;

  const int ct = cb / lsub;
  const int ncol = n / lsub;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.y * kBQ;
  const int o0 = blockIdx.x * kBL;

  const int lo = o0 + tid % kBL;
  const bool l_ok = lo < ncol;
  const long long l_base = l_ok ? idt::slab0_point(lo, ct, cb) : 0;

  long long e_base[kTL];
  bool e_ok[kTL];
#pragma unroll
  for (int j = 0; j < kTL; ++j) {
    const int o = o0 + tx + 16 * j;
    e_ok[j] = o < ncol;
    e_base[j] = e_ok[j] ? idt::slab0_point(o, ct, cb) : 0;
  }

  int32_t best[kTQ][kTL];
  int am[kTQ][kTL];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      best[i][j] = INT_MAX;
      am[i][j] = 0;
    }

  for (int t = 0; t < lsub; ++t) {
    const long long slab = static_cast<long long>(t) * ct;
    int32_t acc[kTQ][kTL];
    idt::dot_tile<kTQ>(qc, codes_t, b, d, n, q0, l_ok, l_base + slab, sm,
                       acc);
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      if (!e_ok[j]) continue;
      const uint32_t wv = static_cast<uint32_t>(w[e_base[j] + slab]);
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
        min_update(static_cast<int32_t>(wv - static_cast<uint32_t>(acc[i][j])),
                   t, best[i][j], am[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= b) continue;
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      if (!e_ok[j]) continue;
      const long long idx = static_cast<long long>(q) * ncol + o0 + tx + 16 * j;
      od[idx] = best[i][j];
      oi[idx] = best[i][j] < kIntLimit
                    ? static_cast<int32_t>(e_base[j] + static_cast<long long>(am[i][j]) * ct)
                    : -1;
    }
  }
}

// K2 (E = kL2 / kDot) on the int8 tensor-core tile of mma_tile.cuh: one
// block owns 128 queries x 64 stride groups; each thread keeps the
// running min and argmin slab of its accumulator fragment's (query,
// group) pairs in registers.
template <Epilogue E>
__global__ void __launch_bounds__(mma::kThreads)
bucket_kernel(const int8_t* __restrict__ qc, const float* __restrict__ qs,
              const int8_t* __restrict__ codes_t,
              const float* __restrict__ scales,
              const float* __restrict__ norms, float* __restrict__ od,
              int32_t* __restrict__ oi, int b, int d, int n, int lsub, int cb,
              int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const mma::Tile tile(smem, b, d, n, lsub, cb, vec != 0);

  float qsv[2][2];                       // [m16 tile][row half]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tile.q0 + tile.row(i, 2 * h);
      qsv[i][h] = q < b ? qs[q] : 0.0f;
    }
  float best[2][4][4];
  int am[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        best[i][j][e] = INFINITY;
        am[i][j][e] = 0;
      }

  const uint32_t* const rows[mma::kMaxRows] = {
      reinterpret_cast<const uint32_t*>(scales),
      reinterpret_cast<const uint32_t*>(norms)};
  tile.run(qc, codes_t, rows, 2, [&](int t, const mma::Acc& acc,
                                     const uint32_t* rows_t) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tile.col(j, e);
        const float s = __uint_as_float(rows_t[c]);
        const float nm = __uint_as_float(rows_t[mma::kBO + c]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          min_update(f32_value<E>(qsv[i][e >> 1], s, nm, acc[i][j][e]), t,
                     best[i][j][e], am[i][j][e]);
      }
  });

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = tile.q0 + tile.row(i, e);
      if (q >= b) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = tile.o0 + tile.col(j, e);
        if (o >= tile.ncol) continue;
        const long long idx = static_cast<long long>(q) * tile.ncol + o;
        od[idx] = best[i][j][e];
        oi[idx] = isfinite(best[i][j][e])
                      ? static_cast<int32_t>(tile.point(o, am[i][j][e]))
                      : -1;
      }
    }
}

// (value, id) order of the top-T rounds: smaller value, then smaller id.
__device__ __forceinline__ bool before(float v, int32_t id, float bv,
                                       int32_t bid) {
  return v < bv || (v == bv && id < bid);
}

// K5: one block owns kBQTopt queries x the cb block blockIdx.x.  Phase 1
// writes the block's ct group minima (values and point ids) per query to
// shared memory; phase 2 runs topt extraction rounds per query, 8 lanes
// a query, each lane owning the columns c = lane (mod 8).
template <Epilogue E>
__global__ void __launch_bounds__(kThreads)
topt_kernel(const int8_t* __restrict__ qc, const float* __restrict__ qs,
            const int8_t* __restrict__ codes_t,
            const float* __restrict__ scales,
            const float* __restrict__ norms, float* __restrict__ od,
            int32_t* __restrict__ oi, int b, int d, int n, int lsub, int cb,
            int topt) {
  extern __shared__ float minima[];      // [kBQTopt][ct] values, then ids
  __shared__ DotTiles<kTQTopt> sm;

  const int ct = cb / lsub;
  int32_t* min_ids = reinterpret_cast<int32_t*>(minima + kBQTopt * ct);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int ic = blockIdx.x;
  const int q0 = blockIdx.y * kBQTopt;
  const long long base = static_cast<long long>(ic) * cb;

  float qsv[kTQTopt];
#pragma unroll
  for (int i = 0; i < kTQTopt; ++i) {
    const int q = q0 + ty + 16 * i;
    qsv[i] = q < b ? qs[q] : 0.0f;
  }

  // phase 1: the strided min over this cb block, kBL groups at a time
  for (int c0 = 0; c0 < ct; c0 += kBL) {
    const int lc = c0 + tid % kBL;
    const bool l_ok = lc < ct;
    float best[kTQTopt][kTL];
    int am[kTQTopt][kTL];
#pragma unroll
    for (int i = 0; i < kTQTopt; ++i)
#pragma unroll
      for (int j = 0; j < kTL; ++j) {
        best[i][j] = INFINITY;
        am[i][j] = 0;
      }
    for (int t = 0; t < lsub; ++t) {
      const long long slab = base + static_cast<long long>(t) * ct;
      int32_t acc[kTQTopt][kTL];
      idt::dot_tile<kTQTopt>(qc, codes_t, b, d, n, q0, l_ok,
                             l_ok ? slab + lc : 0, sm, acc);
#pragma unroll
      for (int j = 0; j < kTL; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c >= ct) continue;
        const float s = scales[slab + c];
        const float nm = norms[slab + c];
#pragma unroll
        for (int i = 0; i < kTQTopt; ++i)
          min_update(f32_value<E>(qsv[i], s, nm, acc[i][j]), t, best[i][j],
                     am[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kTQTopt; ++i)
#pragma unroll
      for (int j = 0; j < kTL; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c >= ct) continue;
        const int r = ty + 16 * i;
        minima[r * ct + c] = best[i][j];
        min_ids[r * ct + c] =
            static_cast<int32_t>(base + static_cast<long long>(am[i][j]) * ct + c);
      }
  }
  __syncthreads();

  // phase 2: topt rounds per query row
  const int r = tid / kTopLanes;
  const int lane = tid % kTopLanes;
  const int q = q0 + r;
  float* row = minima + r * ct;
  const int32_t* rid = min_ids + r * ct;
  int has_nan = 0;
  for (int c = lane; c < ct; c += kTopLanes) has_nan |= isnan(row[c]) ? 1 : 0;
#pragma unroll
  for (int off = kTopLanes / 2; off > 0; off /= 2)
    has_nan |= __shfl_xor_sync(0xffffffffu, has_nan, off);
  const int nc = n / cb;
  const long long out0 = static_cast<long long>(q) * nc * topt +
                         static_cast<long long>(ic) * topt;
  for (int k = 0; k < topt; ++k) {
    float lv = INFINITY;
    int32_t lid = INT_MAX;
    int lc = -1;
    for (int c = lane; c < ct; c += kTopLanes) {
      if (before(row[c], rid[c], lv, lid)) {
        lv = row[c];
        lid = rid[c];
        lc = c;
      }
    }
    float mv = lv;
    int32_t mi = lid;
#pragma unroll
    for (int off = kTopLanes / 2; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, mv, off);
      const int32_t oid = __shfl_xor_sync(0xffffffffu, mi, off);
      if (before(ov, oid, mv, mi)) {
        mv = ov;
        mi = oid;
      }
    }
    // a NaN minimum (jnp.min propagates it) or a non-finite one selects
    // nothing: id -1, and no entry is removed
    const bool found = !has_nan && isfinite(mv);
    if (lane == 0 && q < b) {
      od[out0 + k] = has_nan ? NAN : mv;
      oi[out0 + k] = found ? mi : -1;
    }
    // ids are distinct within a row: only the winner's owner matches
    if (found && lc >= 0 && lid == mi) row[lc] = INFINITY;
  }
}

constexpr int kSmemLimit = 232448;       // bytes a block may use (sm_90)

int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// The launchers below run on `stream` and return cudaGetLastError() as an
// int (0 = launched).  Pointer arguments a variant does not read may be
// null.

extern "C" int idt_bucket_scan(const void* qc, const void* qs,
                               const void* codes_t, const void* scales,
                               const void* norms, void* od, void* oi, int b,
                               int d, int n, int lsub, int cb, int is_dot,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = is_dot ? bucket_kernel<kDot> : bucket_kernel<kL2>;
  unsigned blocks;
  int smem;
  cudaError_t err = mma::prepare(kernel, b, d, n, lsub, &blocks, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = mma::vector_ok(cb / lsub, codes_t, scales, norms);
  kernel<<<blocks, mma::kThreads, smem, s>>>(
      static_cast<const int8_t*>(qc), static_cast<const float*>(qs),
      static_cast<const int8_t*>(codes_t), static_cast<const float*>(scales),
      static_cast<const float*>(norms), static_cast<float*>(od),
      static_cast<int32_t*>(oi), b, d, n, lsub, cb, vec);
  return launch_status();
}

extern "C" int idt_bucket_scan_int(const void* qc, const void* w,
                                   const void* codes_t, void* od, void* oi,
                                   int b, int d, int n, int lsub, int cb,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncol = n / lsub;
  const dim3 grid((ncol + kBL - 1) / kBL, (b + kBQ - 1) / kBQ);
  bucket_int_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(qc), static_cast<const int8_t*>(codes_t),
      static_cast<const int32_t*>(w), static_cast<int32_t*>(od),
      static_cast<int32_t*>(oi), b, d, n, lsub, cb);
  return launch_status();
}

// Largest cb / lsub whose minima fit one block's shared memory.
extern "C" int idt_topt_max_ct() {
  return (kSmemLimit - static_cast<int>(sizeof(DotTiles<kTQTopt>))) /
         (kBQTopt * 8);
}

extern "C" int idt_topt_scan(const void* qc, const void* qs,
                             const void* codes_t, const void* scales,
                             const void* norms, void* od, void* oi, int b,
                             int d, int n, int lsub, int cb, int topt,
                             int is_dot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ct = cb / lsub;
  if (ct > idt_topt_max_ct()) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kBQTopt) * ct * 8;
  const dim3 grid(n / cb, (b + kBQTopt - 1) / kBQTopt);
  auto kernel = is_dot ? topt_kernel<kDot> : topt_kernel<kL2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int8_t*>(qc), static_cast<const float*>(qs),
      static_cast<const int8_t*>(codes_t), static_cast<const float*>(scales),
      static_cast<const float*>(norms), static_cast<float*>(od),
      static_cast<int32_t*>(oi), b, d, n, lsub, cb, topt);
  return launch_status();
}
