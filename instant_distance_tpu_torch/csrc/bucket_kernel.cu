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
//       minimum is not finite, and all topt results (NaN, -1) where the
//       block holds a NaN minimum, else (-inf, -1) where it holds a -inf.
//
// What bounds them on an H100: the int8 multiply-adds (2 * B * N * D
// operations, ~2.5 ms of the tensor cores' peak at the 300-d ScanIndex
// batches) at the paths' shapes; K2/K3 also write [B, N/lsub] f32/i32
// pairs (1-4 GB at those batches, ~0.3-1.2 ms at HBM rate), K5 only its
// T results per query and cb block.  Once the product runs on tensor
// cores, K2/K5's epilogue (about nine CUDA-core operations an element,
// one of them the int-to-float conversion) is of the same order.
//
// What the design does about it.  K2, K3 and K5 are one kernel,
// bucket_kernel<E, O>, on the Hopper tile of wgmma_tile.cuh (wgmma fed by
// TMA: the query tile resident in shared memory, point-major code chunks
// and each slab's per-point rows through mbarrier rings filled by a
// producer warp, two consumer warpgroups whose epilogues overlap each
// other's products): a block owns 128 queries x 128 stride groups and
// keeps the running min and argmin of each accumulator's (query, group)
// pair beside the accumulators in registers across the lsub slabs, so
// the [B, N] distance tile never reaches memory.  K3's epilogue (E =
// kInt) is one int32 subtract on the rank row w.  The output policy O
// differs: K2 and K3 write every group's minimum; K5 (O = kTopT) ranks
// the tile's 128 groups of each query in registers (topt rounds, each a
// quad of lanes' minimum by two shuffles) and writes only their top T.
// Where a cb block spans several column tiles (cb / lsub > 128), each
// tile writes its top T to a scratch [B, N/cb, tiles, T] and a second,
// small kernel merges each (query, cb block)'s tiles x T candidates: the
// top T of a union is the top T of the union of each part's top T, so
// the merge is exact.

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "wgmma_tile.cuh"

namespace {

namespace wg = idt::wg;

enum Epilogue { kL2 = 0, kDot = 1, kInt = 2 };
// What a block writes: every group's minimum (K2, K3) or the top T of
// its groups per query (K5).
enum Output { kGroups = 0, kTopT = 1 };

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

// Running strided min and argmin, the argmin in 16-bit half h of am2
// (slab t < 2^16): two running argmins a register, so that the state fits
// the Hopper tile's registers beside the accumulators.  The first slab
// wins ties; once a NaN arrives the min stays NaN (jnp.minimum), the
// argmin stays put.  Written as selects: as branches the compiler gives
// every element its own divergent block, and the elements no longer
// overlap.
__device__ __forceinline__ uint32_t set_half(uint32_t am2, int t, int h) {
  return __byte_perm(am2, static_cast<uint32_t>(t), h ? 0x5410 : 0x3254);
}

__device__ __forceinline__ void min_update(float v, int t, float& best,
                                           uint32_t& am2, int h) {
  const bool lt = v < best;
  best = lt | isnan(v) ? v : best;
  am2 = lt ? set_half(am2, t, h) : am2;
}

__device__ __forceinline__ void min_update(int32_t v, int t, int32_t& best,
                                           uint32_t& am2, int h) {
  const bool lt = v < best;
  best = lt ? v : best;
  am2 = lt ? set_half(am2, t, h) : am2;
}

int launch_status() { return static_cast<int>(cudaGetLastError()); }

// (value, id) order of the top-T rounds: smaller value, then smaller id.
__device__ __forceinline__ bool before(float v, int32_t id, float bv,
                                       int32_t bid) {
  return v < bv || (v == bv && id < bid);
}

// K5's fin(): the top T of the tile's groups for each of the thread's two
// query rows, written to od/oi [B, N/cb, tiles, T] (tiles = the cb
// block's column tiles; 1 makes it K5's output).  A row's 128 groups lie
// in the four lanes of a quad, 32 in each (wg::Tile::row / col).  Each
// round takes the quad's minimum value (fminf over the thread's entries,
// then two shuffles) and the smallest id among the entries equal to it
// (the same way); the entry with that id drops out in the next round.
// Only finite minima take part: a NaN among a row's minima turns its T
// results into (NaN, -1), else a -inf into (-inf, -1), as the JAX rounds
// do; a round with no finite minimum left gives (+inf, -1).
__device__ __forceinline__ void top_t(const wg::Tile& tile, int b, int topt,
                                      float (&best)[wg::kAcc],
                                      const uint32_t (&am2)[wg::kAcc / 2],
                                      float* __restrict__ od,
                                      int32_t* __restrict__ oi) {
  int32_t ids[wg::kAcc];
  uint32_t flags = 0;                  // bit h: a NaN in row h, 4 << h: a -inf
#pragma unroll
  for (int r = 0; r < wg::kAcc; ++r) {
    const int h = (r >> 1) & 1;
    const int c = wg::Tile::col(r);
    const float v = c < tile.width ? best[r] : INFINITY;
    flags |= (isnan(v) ? 1u << h : 0u) | (v == -INFINITY ? 4u << h : 0u);
    best[r] = isfinite(v) ? v : INFINITY;
    const int am = (am2[r / 2] >> (16 * (r & 1))) & 0xFFFF;
    ids[r] = tile.p0 + am * tile.ct + c;
  }
  flags |= __shfl_xor_sync(0xFFFFFFFFu, flags, 1);
  flags |= __shfl_xor_sync(0xFFFFFFFFu, flags, 2);

  // lane h of a quad stores row h's results
  const int h_out = threadIdx.x & 3;
  const int q = tile.q0 + wg::Tile::row(2 * (h_out & 1));
  const bool store = h_out < 2 && q < b;
  const int tiles = (tile.ct + wg::kBN - 1) / wg::kBN;
  const long long out0 =
      ((static_cast<long long>(q) * (tile.ncol / tile.ct) + tile.o0 / tile.ct) *
           tiles +
       (tile.o0 % tile.ct) / wg::kBN) *
      topt;
  const uint32_t f = flags >> (h_out & 1);

  int32_t wid[2] = {-1, -1};           // the last round's winners
  for (int k = 0; k < topt; ++k) {
    float m[2] = {INFINITY, INFINITY};
#pragma unroll
    for (int r = 0; r < wg::kAcc; ++r) {
      const int h = (r >> 1) & 1;
      best[r] = ids[r] == wid[h] ? INFINITY : best[r];
      m[h] = fminf(m[h], best[r]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fminf(m[h], __shfl_xor_sync(0xFFFFFFFFu, m[h], 1));
      m[h] = fminf(m[h], __shfl_xor_sync(0xFFFFFFFFu, m[h], 2));
    }
    int32_t w[2] = {INT_MAX, INT_MAX};
#pragma unroll
    for (int r = 0; r < wg::kAcc; ++r) {
      const int h = (r >> 1) & 1;
      w[h] = min(w[h], best[r] == m[h] ? ids[r] : INT_MAX);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      w[h] = min(w[h], __shfl_xor_sync(0xFFFFFFFFu, w[h], 1));
      w[h] = min(w[h], __shfl_xor_sync(0xFFFFFFFFu, w[h], 2));
      wid[h] = w[h];
    }
    if (store) {
      const float mv = h_out ? m[1] : m[0];
      od[out0 + k] = (f & 1) ? NAN : (f & 4) ? -INFINITY : mv;
      oi[out0 + k] = (f & 5) || mv == INFINITY ? -1 : (h_out ? w[1] : w[0]);
    }
  }
}

// K2 (E = kL2 / kDot), K3 (E = kInt) and K5 (E = kL2 / kDot, O = kTopT):
// one block owns 128 queries x 128 stride groups.  K2's and K5's
// per-point rows are scales and norms, K3's the rank row w (qs unused).
// A consumer thread's accumulator r stands for the (query, group) pair
// (row(r), col(r)) in every slab; its argmin slab is half r % 2 of
// am2[r / 2] (the wrapper refuses lsub > 2^16).  K2 and K3 write each
// group's minimum and the point reaching it to od/oi [B, N/lsub]; K5 the
// top topt of them per query, see top_t.
template <Epilogue E, Output O>
__global__ void __launch_bounds__(wg::kThreads, 1)
bucket_kernel(const __grid_constant__ wg::Maps maps,
              const float* __restrict__ qs, Value<E>* __restrict__ od,
              int32_t* __restrict__ oi, int b, int dpad, int n, int lsub,
              int cb, int topt) {
  extern __shared__ __align__(16) uint8_t smem[];
  const wg::Tile tile(smem, b, dpad, n, lsub, cb);

  Value<E> best[wg::kAcc];
  uint32_t am2[wg::kAcc / 2];          // argmin slabs, two a register
  float qsv[2];                        // the thread's two query rows
  tile.run(
      maps, E == kInt ? 1 : 2,
      [&] {
#pragma unroll
        for (int r = 0; r < wg::kAcc; ++r) {
          if constexpr (E == kInt) best[r] = INT_MAX;
          else best[r] = INFINITY;
          am2[r / 2] = 0;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = tile.q0 + wg::Tile::row(2 * h);
          qsv[h] = E != kInt && q < b ? qs[q] : 0.0f;
        }
      },
      [&](int t, const uint32_t (&acc)[wg::kAcc], const uint32_t* rows) {
#pragma unroll
        for (int j = 0; j < wg::kAcc / 4; ++j) {
          const int c = wg::Tile::col(4 * j);
          const uint2 r0 = *reinterpret_cast<const uint2*>(rows + c);
          const uint2 r1 = *reinterpret_cast<const uint2*>(rows + wg::kBN + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 4 * j + e;
            const uint32_t w0 = (e & 1) ? r0.y : r0.x;
            if constexpr (E == kInt) {
              min_update(static_cast<int32_t>(w0 - acc[r]), t, best[r],
                         am2[r / 2], e & 1);
            } else {
              const uint32_t w1 = (e & 1) ? r1.y : r1.x;
              min_update(f32_value<E>(qsv[e >> 1], __uint_as_float(w0),
                                      __uint_as_float(w1),
                                      static_cast<int32_t>(acc[r])),
                         t, best[r], am2[r / 2], e & 1);
            }
          }
        }
      },
      [&] {
        if constexpr (O == kTopT) {
          top_t(tile, b, topt, best, am2, od, oi);
        } else {
#pragma unroll
          for (int r = 0; r < wg::kAcc; ++r) {
            const int q = tile.q0 + wg::Tile::row(r);
            const int c = wg::Tile::col(r);
            if (q >= b || c >= tile.width) continue;
            const long long idx =
                static_cast<long long>(q) * tile.ncol + tile.o0 + c;
            bool found;
            if constexpr (E == kInt) found = best[r] < kIntLimit;
            else found = isfinite(best[r]);
            const int am = (am2[r / 2] >> (16 * (r & 1))) & 0xFFFF;
            od[idx] = best[r];
            oi[idx] = found ? tile.p0 + am * tile.ct + c : -1;
          }
        }
      });
}

template <Epilogue E, Output O>
int launch_bucket(const void* qc, const void* qs, const void* codes,
                  const void* row0, const void* row1, void* od, void* oi,
                  int b, int dpad, int n, int lsub, int cb, int topt,
                  cudaStream_t s) {
  wg::Maps maps;
  unsigned blocks;
  int smem;
  cudaError_t err = wg::prepare(bucket_kernel<E, O>, &maps, qc, codes, row0,
                                row1, b, dpad, n, lsub, cb, &blocks, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_kernel<E, O><<<blocks, wg::kThreads, smem, s>>>(
      maps, static_cast<const float*>(qs), static_cast<Value<E>*>(od),
      static_cast<int32_t*>(oi), b, dpad, n, lsub, cb, topt);
  return launch_status();
}

// K5's merge where a cb block spans several column tiles: a group of
// kMergeLanes lanes a (query, cb block) row takes the top topt of its
// tiles x topt candidates sv/si [rows, tiles, topt] (rows = B * N/cb)
// into od/oi [rows, topt], under top_t's order and rule (a NaN among
// them, else a -inf, fills all topt results).  Lane l of a group reads
// candidates l, l + kMergeLanes, ..., so a warp's loads cover whole
// rows; each round every lane takes its best candidate after the last
// round's winner in (value, id) order (ids are unique, so none is taken
// twice), and two shuffles pick the group's.
constexpr int kMergeLanes = 4;

__global__ void __launch_bounds__(256)
topt_merge_kernel(const float* __restrict__ sv, const int32_t* __restrict__ si,
                  float* __restrict__ od, int32_t* __restrict__ oi,
                  long long rows, int tiles, int topt) {
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kMergeLanes;
  const int lane = threadIdx.x % kMergeLanes;
  // rows past the end take part in the shuffles with no candidates
  const int nc = g < rows ? tiles * topt : 0;
  const float* const v = sv + g * tiles * topt;
  const int32_t* const id = si + g * tiles * topt;
  uint32_t flags = 0;                  // 1: a NaN, 2: a -inf
  for (int i = lane; i < nc; i += kMergeLanes)
    flags |= (isnan(v[i]) ? 1u : 0u) | (v[i] == -INFINITY ? 2u : 0u);
#pragma unroll
  for (int off = 1; off < kMergeLanes; off *= 2)
    flags |= __shfl_xor_sync(0xFFFFFFFFu, flags, off);
  float pv = -INFINITY;
  int32_t pid = -1;
  for (int k = 0; k < topt; ++k) {
    float bv = INFINITY;
    int32_t bid = INT_MAX;
    for (int i = lane; i < nc; i += kMergeLanes) {
      const float x = v[i];
      const int32_t xi = id[i];
      if (isfinite(x) && before(pv, pid, x, xi) && before(x, xi, bv, bid)) {
        bv = x;
        bid = xi;
      }
    }
#pragma unroll
    for (int off = 1; off < kMergeLanes; off *= 2) {
      const float ov = __shfl_xor_sync(0xFFFFFFFFu, bv, off);
      const int32_t oid = __shfl_xor_sync(0xFFFFFFFFu, bid, off);
      if (before(ov, oid, bv, bid)) {
        bv = ov;
        bid = oid;
      }
    }
    if (lane == 0 && nc > 0) {
      od[g * topt + k] = (flags & 1) ? NAN : (flags & 2) ? -INFINITY : bv;
      oi[g * topt + k] = flags || bv == INFINITY ? -1 : bid;
    }
    pv = bv;
    pid = bid;
  }
}

}  // namespace

// The launchers below run on `stream` and return cudaGetLastError() as an
// int (0 = launched), or cudaErrorInvalidConfiguration where the grid or
// the shared memory would not fit.  They take qc [B, dpad] and codes
// [N, dpad] (int8, zero past D) and refuse operands TMA cannot describe
// (wgmma_tile.cuh's prepare).

extern "C" int idt_bucket_scan(const void* qc, const void* qs,
                               const void* codes, const void* scales,
                               const void* norms, void* od, void* oi, int b,
                               int dpad, int n, int lsub, int cb, int is_dot,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_dot ? launch_bucket<kDot, kGroups>(qc, qs, codes, scales, norms,
                                               od, oi, b, dpad, n, lsub, cb,
                                               0, s)
                : launch_bucket<kL2, kGroups>(qc, qs, codes, scales, norms,
                                              od, oi, b, dpad, n, lsub, cb,
                                              0, s);
}

extern "C" int idt_bucket_scan_int(const void* qc, const void* w,
                                   const void* codes, void* od, void* oi,
                                   int b, int dpad, int n, int lsub, int cb,
                                   void* stream) {
  return launch_bucket<kInt, kGroups>(qc, nullptr, codes, w, nullptr, od, oi,
                                      b, dpad, n, lsub, cb, 0,
                                      static_cast<cudaStream_t>(stream));
}

// K5's merge alone: sv/si [B, N/cb, tiles, topt] -> od/oi [B, (N/cb) *
// topt] (idt_topt_scan runs it; exposed to time it apart).
extern "C" int idt_topt_merge(const void* sv, const void* si, void* od,
                              void* oi, int b, int nblocks, int tiles,
                              int topt, void* stream) {
  const long long rows = static_cast<long long>(b) * nblocks;
  const long long grid = (rows * kMergeLanes + 255) / 256;
  if (grid > 0x7fffffffLL || tiles < 1 || topt < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (rows == 0) return 0;
  topt_merge_kernel<<<static_cast<unsigned>(grid), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sv), static_cast<const int32_t*>(si),
      static_cast<float*>(od), static_cast<int32_t*>(oi), rows, tiles, topt);
  return launch_status();
}

// K5: the tile with its top-T epilogue, then the merge where a cb block
// spans several column tiles (cb / lsub > 128): then the tiles write to
// the scratch sv/si [B, N/cb, tiles, topt], else straight to od/oi and
// sv/si may be null.
extern "C" int idt_topt_scan(const void* qc, const void* qs,
                             const void* codes, const void* scales,
                             const void* norms, void* od, void* oi, void* sv,
                             void* si, int b, int dpad, int n, int lsub,
                             int cb, int topt, int is_dot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (topt < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (cb / lsub + wg::kBN - 1) / wg::kBN;
  void* const tv = tiles > 1 ? sv : od;
  void* const ti = tiles > 1 ? si : oi;
  const int err =
      is_dot ? launch_bucket<kDot, kTopT>(qc, qs, codes, scales, norms, tv,
                                          ti, b, dpad, n, lsub, cb, topt, s)
             : launch_bucket<kL2, kTopT>(qc, qs, codes, scales, norms, tv,
                                         ti, b, dpad, n, lsub, cb, topt, s);
  if (err != 0 || tiles == 1) return err;
  return idt_topt_merge(sv, si, od, oi, b, n / cb, tiles, topt, stream);
}
