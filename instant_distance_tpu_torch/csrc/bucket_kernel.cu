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
// operations, ~2.5 ms of the tensor cores' peak at the 300-d ScanIndex
// batches) at the paths' shapes; K2/K3 also write [B, N/lsub] f32/i32
// pairs (1-2 GB at those batches, ~0.3-0.6 ms at HBM rate), K5 only its
// T results per query and cb block.  Once the product runs on tensor
// cores, K2/K5's epilogue (about nine CUDA-core operations an element,
// one of them the int-to-float conversion) is of the same order.
//
// What the design does about it.  All three run on the int8 tensor-core
// tile of mma_tile.cuh (mma.sync m16n8k32, the query tile staged in
// shared memory, code tiles with their per-point rows double-buffered
// with cp.async and transposed in shared memory, query blocks fastest in
// the grid), and keep the running min and argmin of each accumulator
// fragment's (query, group) pairs beside the accumulators in registers
// across the lsub slabs, so the [B, N] distance tile never reaches
// memory.  K2 and K3 are one kernel, bucket_kernel<E>: a block owns 128
// queries x 64 stride groups and writes their minima; K3's epilogue
// (E = kInt) is one int32 subtract on the rank row w.  K5's top-T needs
// every group minimum of a cb block for a query, so its block owns 128
// queries x one whole cb block and walks the block's 64-column tiles with
// the tile: after each, K2's epilogue has the tile's 128 x 64 minima,
// they go to shared memory, and one thread a query merges them into the
// query's running top-T list there, sorted by (value, id).  The top T of
// a union is the top T of the union of each part's top T, so the merge
// is exact; only the T results reach memory, as in the JAX kernel.

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

namespace mma = idt::mma;

enum Epilogue { kL2 = 0, kDot = 1, kInt = 2 };

// The running minimum's type: K3's int32 ranks, else f32 distances.
template <Epilogue E>
using Value = std::conditional_t<E == kInt, int32_t, float>;

constexpr int32_t kIntLimit = (INT_MAX / 2) / 2;

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

// One thread's running minima over its accumulator fragments'
// (query, group) pairs: [m16 tile i][n8 tile j][fragment element e].
template <Epilogue E>
struct SlabMin {
  float qsv[2][2];                       // [m16 tile][row half]; f32 only
  Value<E> best[2][4][4];
  int am[2][4][4];

  __device__ __forceinline__ SlabMin(const mma::Tile& tile,
                                     const float* __restrict__ qs) {
    if constexpr (E != kInt) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = tile.q0 + tile.row(i, 2 * h);
          qsv[i][h] = q < tile.b ? qs[q] : 0.0f;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (E == kInt) best[i][j][e] = INT_MAX;
          else best[i][j][e] = INFINITY;
          am[i][j][e] = 0;
        }
  }

  // Slab t's values from its accumulators and its transposed per-point
  // rows (K2/K5: scales, norms; K3: w).
  __device__ __forceinline__ void update(const mma::Tile& tile, int t,
                                         const mma::Acc& acc,
                                         const uint32_t* rows_t) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tile.col(j, e);
        if constexpr (E == kInt) {
          const uint32_t wv = rows_t[c];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            min_update(static_cast<int32_t>(wv - static_cast<uint32_t>(acc[i][j][e])),
                       t, best[i][j][e], am[i][j][e]);
        } else {
          const float s = __uint_as_float(rows_t[c]);
          const float nm = __uint_as_float(rows_t[mma::kBO + c]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            min_update(f32_value<E>(qsv[i][e >> 1], s, nm, acc[i][j][e]), t,
                       best[i][j][e], am[i][j][e]);
        }
      }
  }

  // Whether fragment (i, j, e)'s minimum names a point: finite (K2/K5),
  // under the rank limit (K3).
  __device__ __forceinline__ bool found(int i, int j, int e) const {
    if constexpr (E == kInt) return best[i][j][e] < kIntLimit;
    else return isfinite(best[i][j][e]);
  }
};

// K2 (E = kL2 / kDot) and K3 (E = kInt): one block owns 128 queries x 64
// stride groups and writes each group's minimum and the point reaching
// it.  K2's per-point rows are scales and norms, K3's the rank row w
// (qs unused).
template <Epilogue E>
__global__ void __launch_bounds__(mma::kThreads)
bucket_kernel(const int8_t* __restrict__ qc, const float* __restrict__ qs,
              const int8_t* __restrict__ codes_t,
              const uint32_t* __restrict__ row0,
              const uint32_t* __restrict__ row1, Value<E>* __restrict__ od,
              int32_t* __restrict__ oi, int b, int d, int n, int lsub, int cb,
              int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const mma::Tile tile(smem, b, d, n, lsub, cb, vec != 0);
  SlabMin<E> m(tile, qs);

  const uint32_t* const rows[mma::kMaxRows] = {row0, row1};
  tile.run(qc, codes_t, rows, E == kInt ? 1 : 2,
           [&](int t, const mma::Acc& acc, const uint32_t* rows_t) {
             m.update(tile, t, acc, rows_t);
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
        od[idx] = m.best[i][j][e];
        oi[idx] = m.found(i, j, e)
                      ? static_cast<int32_t>(tile.point(o, m.am[i][j][e]))
                      : -1;
      }
    }
}

// (value, id) order of the top-T rounds: smaller value, then smaller id.
__device__ __forceinline__ bool before(float v, int32_t id, float bv,
                                       int32_t bid) {
  return v < bv || (v == bv && id < bid);
}

constexpr int kMinRow = mma::kBO + 1;    // K5's tile-minima row (words),
                                         // odd: a row a lane, no conflicts

// K5's shared memory: the tile's plan, whose stages (raw, transposed and
// rows, everything past the query tile) the tile's minima and their point
// ids [kBQ][kMinRow] each share once run() is done, then the top-T lists,
// values and ids [kBQ][topt] each.  Returns the offset of the lists with
// topt = 0, else the bytes.
__host__ __device__ inline int topt_smem(int d, int lsub, int topt) {
  const mma::Plan plan(d, lsub);
  const int minima = 2 * mma::kBQ * kMinRow * 4;
  const int stages = plan.bytes - plan.off_raw;
  return plan.off_raw + (stages > minima ? stages : minima) +
         2 * mma::kBQ * topt * 4;
}

// K5: one block owns 128 queries x the cb block ic, its tiles of 64
// stride groups in turn.  After each tile its minima go to shared memory
// and thread r < 128 merges row r's into query q0 + r's top-T list: only
// finite minima enter, a NaN or -inf among them sets the query's sticky
// flag (the JAX rounds then give T x (NaN, -1), else T x (-inf, -1)), and
// slots no finite minimum filled stay (+inf, -1).  The merge first marks,
// in one pass without divergence, the minima that beat the list's worst
// entry (the threshold) at the tile's start, then takes the marked ones
// in turn; the list stays unsorted, an entry replacing the worst one and
// the threshold found again, so an insertion costs one pass over T
// entries and no shifting.  The list is sorted once, at the end.
template <Epilogue E>
__global__ void __launch_bounds__(mma::kThreads)
topt_kernel(const int8_t* __restrict__ qc, const float* __restrict__ qs,
            const int8_t* __restrict__ codes_t,
            const uint32_t* __restrict__ scales,
            const uint32_t* __restrict__ norms, float* __restrict__ od,
            int32_t* __restrict__ oi, int b, int d, int n, int lsub, int cb,
            int topt, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nqb = (b + mma::kBQ - 1) / mma::kBQ;
  const int q0 = (blockIdx.x % nqb) * mma::kBQ;
  const int ic = blockIdx.x / nqb;
  const int ct = cb / lsub;
  const int c_end = (ic + 1) * ct;
  float* const min_v = reinterpret_cast<float*>(smem + mma::Plan(d, lsub).off_raw);
  int32_t* const min_i = reinterpret_cast<int32_t*>(min_v + mma::kBQ * kMinRow);
  float* const top_v = reinterpret_cast<float*>(smem + topt_smem(d, lsub, 0));
  int32_t* const top_i = reinterpret_cast<int32_t*>(top_v + mma::kBQ * topt);

  // the merging thread's query row r: its list's length, its worst entry
  // once full (the threshold) and its sticky flags
  const int r = threadIdx.x;
  float* const tv = top_v + r * topt;
  int32_t* const ti = top_i + r * topt;
  int cnt = 0, worst = 0;
  float thr_v = INFINITY;
  int32_t thr_i = INT_MAX;
  bool has_nan = false, has_ninf = false;

  const uint32_t* const rows[mma::kMaxRows] = {scales, norms};
  for (int o0 = ic * ct; o0 < c_end; o0 += mma::kBO) {
    const mma::Tile tile(smem, b, d, n, lsub, cb, vec != 0, q0, o0, c_end);
    SlabMin<E> m(tile, qs);
    tile.run(qc, codes_t, rows, 2,
             [&](int t, const mma::Acc& acc, const uint32_t* rows_t) {
               m.update(tile, t, acc, rows_t);
             });
    __syncthreads();  // every warp is past its last product: stages free
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tile.col(j, e);
          if (o0 + c >= c_end) continue;
          const int k = tile.row(i, e) * kMinRow + c;
          min_v[k] = m.best[i][j][e];
          min_i[k] = static_cast<int32_t>(tile.point(o0 + c, m.am[i][j][e]));
        }
    __syncthreads();  // the tile's minima are in
    if (r < mma::kBQ) {
      const float* const mv = min_v + r * kMinRow;
      const int32_t* const mi = min_i + r * kMinRow;
      const int nc = c_end - o0 < mma::kBO ? c_end - o0 : mma::kBO;
      uint64_t marked = 0;
#pragma unroll 4
      for (int c = 0; c < nc; ++c) {
        const float v = mv[c];
        const int32_t id = mi[c];
        has_nan |= isnan(v);
        has_ninf |= v == -INFINITY;
        // before(v, id, thr), both loads issued whatever v is
        if (isfinite(v) & ((v < thr_v) | ((v == thr_v) & (id < thr_i))))
          marked |= 1ull << c;
      }
      for (; marked; marked &= marked - 1) {
        const int c = __ffsll(static_cast<long long>(marked)) - 1;
        const float v = mv[c];
        const int32_t id = mi[c];
        if (!before(v, id, thr_v, thr_i)) continue;  // the threshold rose
        const int slot = cnt < topt ? cnt++ : worst;
        if (cnt < topt) {
          tv[slot] = v;
          ti[slot] = id;
          continue;
        }
        // the full list's largest entry with (v, id) in `slot`, read
        // before the slot is written so that the loads need not wait
        float nv = v;
        int32_t ni = id;
        int nw = slot;
#pragma unroll 4
        for (int k = 0; k < topt; ++k) {
          const float lv = tv[k];
          const int32_t li = ti[k];
          if (k != slot && before(nv, ni, lv, li)) {
            nv = lv;
            ni = li;
            nw = k;
          }
        }
        tv[slot] = v;
        ti[slot] = id;
        worst = nw;
        thr_v = nv;
        thr_i = ni;
      }
    }
    __syncthreads();  // merged: the next tile may stage over the minima
  }

  const int q = q0 + r;
  if (r >= mma::kBQ || q >= b) return;
  const long long out0 = (static_cast<long long>(q) * (n / cb) + ic) * topt;
  for (int k = 0; k < topt; ++k) {
    // selection sort of the list: entry k is the (value, id)-smallest of
    // entries k .. cnt - 1
    if (k < cnt) {
      int s = k;
      float sv = tv[k];
      int32_t si = ti[k];
      for (int j = k + 1; j < cnt; ++j) {
        const float lv = tv[j];
        const int32_t li = ti[j];
        if (before(lv, li, sv, si)) {
          s = j;
          sv = lv;
          si = li;
        }
      }
      tv[s] = tv[k];
      ti[s] = ti[k];
      tv[k] = sv;
      ti[k] = si;
    }
    const bool real = !has_nan && !has_ninf && k < cnt;
    od[out0 + k] = has_nan ? NAN : has_ninf ? -INFINITY : real ? tv[k] : INFINITY;
    oi[out0 + k] = real ? ti[k] : -1;
  }
}

int launch_status() { return static_cast<int>(cudaGetLastError()); }

template <Epilogue E>
int launch_bucket(const void* qc, const void* qs, const void* codes_t,
                  const void* row0, const void* row1, void* od, void* oi,
                  int b, int d, int n, int lsub, int cb, cudaStream_t s) {
  unsigned blocks;
  int smem;
  cudaError_t err = mma::prepare(bucket_kernel<E>, b, d, n, lsub, &blocks,
                                 &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = mma::vector_ok(cb / lsub, codes_t, row0, row1);
  bucket_kernel<E><<<blocks, mma::kThreads, smem, s>>>(
      static_cast<const int8_t*>(qc), static_cast<const float*>(qs),
      static_cast<const int8_t*>(codes_t), static_cast<const uint32_t*>(row0),
      static_cast<const uint32_t*>(row1), static_cast<Value<E>*>(od),
      static_cast<int32_t*>(oi), b, d, n, lsub, cb, vec);
  return launch_status();
}

}  // namespace

// The launchers below run on `stream` and return cudaGetLastError() as an
// int (0 = launched), or cudaErrorInvalidConfiguration where the grid or
// the shared memory would not fit.

extern "C" int idt_bucket_scan(const void* qc, const void* qs,
                               const void* codes_t, const void* scales,
                               const void* norms, void* od, void* oi, int b,
                               int d, int n, int lsub, int cb, int is_dot,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_dot ? launch_bucket<kDot>(qc, qs, codes_t, scales, norms, od, oi,
                                      b, d, n, lsub, cb, s)
                : launch_bucket<kL2>(qc, qs, codes_t, scales, norms, od, oi,
                                     b, d, n, lsub, cb, s);
}

extern "C" int idt_bucket_scan_int(const void* qc, const void* w,
                                   const void* codes_t, void* od, void* oi,
                                   int b, int d, int n, int lsub, int cb,
                                   void* stream) {
  return launch_bucket<kInt>(qc, nullptr, codes_t, w, nullptr, od, oi, b, d,
                             n, lsub, cb, static_cast<cudaStream_t>(stream));
}

// Largest topt whose lists fit one K5 block's shared memory at width d and
// lsub slabs (0 when none does).
extern "C" int idt_topt_max_topt(int d, int lsub) {
  const int spare = mma::kSmemLimit - topt_smem(d, lsub, 0);
  return spare > 0 ? spare / (2 * mma::kBQ * 4) : 0;
}

extern "C" int idt_topt_scan(const void* qc, const void* qs,
                             const void* codes_t, const void* scales,
                             const void* norms, void* od, void* oi, int b,
                             int d, int n, int lsub, int cb, int topt,
                             int is_dot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks =
      static_cast<long long>((b + mma::kBQ - 1) / mma::kBQ) * (n / cb);
  if (blocks > 0x7fffffffLL || topt < 1 || topt > idt_topt_max_topt(d, lsub))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = topt_smem(d, lsub, topt);
  auto kernel = is_dot ? topt_kernel<kDot> : topt_kernel<kL2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = mma::vector_ok(cb / lsub, codes_t, scales, norms);
  kernel<<<static_cast<unsigned>(blocks), mma::kThreads, smem, s>>>(
      static_cast<const int8_t*>(qc), static_cast<const float*>(qs),
      static_cast<const int8_t*>(codes_t),
      static_cast<const uint32_t*>(scales),
      static_cast<const uint32_t*>(norms), static_cast<float*>(od),
      static_cast<int32_t*>(oi), b, d, n, lsub, cb, topt, vec);
  return launch_status();
}
