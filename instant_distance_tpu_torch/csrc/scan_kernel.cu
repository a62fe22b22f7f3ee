// Packed-key int8 scan for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// instant_distance_tpu/ops/scan_kernel.py:_bucket_scan_int_packed_kernel
// (with its slab form _bucket_scan_int_packed_slab_kernel and the
// second-level min _emit_group_min), called through
// fused_scan_bucket_int_packed.  It serves both the HNSW build's wave
// search and ScanIndex's "bucket_pack" path.
//
// What it computes, bit-exact with the plain torch version in
// instant_distance_tpu_torch/ops/scan_kernel.py:
//
//   od[q, o] = min_{t < lsub} ( w2[p(o, t)] - dot(qc[q, :], codes_t[:, p(o, t)]) * lsub )
//   p(o, t)  = (o / ct) * cb + t * ct + (o % ct),        ct  = cb / lsub
//   og[q, i] = min_{g < groups} od[q, (i / ctg) * ct + g * ctg + (i % ctg)],
//                                                        ctg = ct / groups
//
// All arithmetic is int32.  The wrapper's guards (lsub a power of two,
// D * lsub <= 16384) keep |dot| * lsub < 2^28 and every key inside int32.
//
// What bounds it on an H100: at build-wave sizes (4096 queries against
// up to 1M points of D = 128) the int8 multiply-adds, ~5e11 per wave; at
// small query batches, writing the [B, N/lsub] key array and streaming
// the codes once per 64-query block.
//
// What the design does about it: one block owns 64 queries x 64 output
// columns and keeps their running minimum in registers across the lsub
// slabs (the slab form of the TPU kernel), so the [B, N] dot tile never
// reaches memory and each query writes N/lsub keys.  The dot itself is
// the __dp4a tile of dp4a_tile.cuh, 4 x 4 registers a thread.
// Tensor-core int8 (mma.sync / wgmma) and TMA staging are later work.
//
// The same kernel, cut short, is the timing probe K6 (replaces
// instant_distance_tpu/ops/scan_kernel.py:_probe_kernel, called through
// fused_scan_probe), the template parameter kProbe:
//   kFull: K1's keys without groups (the production epilogue: a multiply,
//          a subtract and a min per element, w2 read once per slab);
//   kMin:  the same min chain over the raw dot (one min per element, no
//          w2);
//   kMm:   the product alone: od holds each cb block's slab-0 dot.  Every
//          other slab's product stays live (the compiler would drop it
//          otherwise and the probe would time 1/lsub of the products):
//          each is an operand of an empty volatile asm, which costs no
//          instruction.
// Timing the three splits K1's time into product, min chain and key
// epilogue.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "dp4a_tile.cuh"

namespace {

using idt::DotTiles;
using idt::kBL;
using idt::kThreads;
using idt::kTL;

constexpr int kTQ = 4;                   // queries per thread: 64 per block
constexpr int kBQ = 16 * kTQ;

enum Probe { kFull = 0, kMin = 1, kMm = 2 };

template <int kProbe>
__global__ void __launch_bounds__(kThreads)
packed_scan_kernel(const int8_t* __restrict__ qc,
                   const int32_t* __restrict__ w2,
                   const int8_t* __restrict__ codes_t,
                   int32_t* __restrict__ od,
                   int b, int d, int n, int lsub, int cb) {
  __shared__ DotTiles<kTQ> sm;

  const int ct = cb / lsub;
  const int ncol = n / lsub;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.y * kBQ;
  const int o0 = blockIdx.x * kBL;

  // code-tile loader: this thread's column of the tile, slab 0
  const int lo = o0 + tid % kBL;
  const bool l_ok = lo < ncol;
  const long long l_base = l_ok ? idt::slab0_point(lo, ct, cb) : 0;

  // epilogue: this thread's output columns, slab 0
  long long e_base[kTL];
  bool e_ok[kTL];
#pragma unroll
  for (int j = 0; j < kTL; ++j) {
    const int o = o0 + tx + 16 * j;
    e_ok[j] = o < ncol;
    e_base[j] = e_ok[j] ? idt::slab0_point(o, ct, cb) : 0;
  }

  int32_t best[kTQ][kTL];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTL; ++j) best[i][j] = INT_MAX;

  for (int t = 0; t < lsub; ++t) {
    const long long slab = static_cast<long long>(t) * ct;
    int32_t acc[kTQ][kTL];
    idt::dot_tile<kTQ>(qc, codes_t, b, d, n, q0, l_ok, l_base + slab, sm,
                       acc);
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      if (kProbe == kMm) {
#pragma unroll
        for (int i = 0; i < kTQ; ++i) {
          if (t == 0) best[i][j] = acc[i][j];
          else asm volatile("" ::"r"(acc[i][j]));
        }
        continue;
      }
      if (kProbe == kMin) {
#pragma unroll
        for (int i = 0; i < kTQ; ++i) best[i][j] = min(best[i][j], acc[i][j]);
        continue;
      }
      if (!e_ok[j]) continue;
      const int32_t wv = w2[e_base[j] + slab];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) best[i][j] = min(best[i][j], wv - acc[i][j] * lsub);
    }
  }
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= b) continue;
#pragma unroll
    for (int j = 0; j < kTL; ++j) {
      if (e_ok[j]) od[static_cast<long long>(q) * ncol + o0 + tx + 16 * j] = best[i][j];
    }
  }
}

// Second-level min over groups-wide strided column groups of od.
__global__ void group_min_kernel(const int32_t* __restrict__ od,
                                 int32_t* __restrict__ og, int b, int ncol,
                                 int ct, int groups) {
  const int ctg = ct / groups;
  const int ngc = ncol / groups;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(b) * ngc) return;
  const long long q = idx / ngc;
  const int i = static_cast<int>(idx % ngc);
  const int32_t* row = od + q * ncol + static_cast<long long>(i / ctg) * ct + i % ctg;
  int32_t v = row[0];
  for (int g = 1; g < groups; ++g) v = min(v, row[g * ctg]);
  og[idx] = v;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() as an int (0 = launched).
// `og` may be null when groups <= 1.
extern "C" int idt_packed_scan(const void* qc, const void* w2,
                               const void* codes_t, void* od, void* og,
                               int b, int d, int n, int lsub, int cb,
                               int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncol = n / lsub;
  const dim3 grid((ncol + kBL - 1) / kBL, (b + kBQ - 1) / kBQ);
  packed_scan_kernel<kFull><<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(qc), static_cast<const int32_t*>(w2),
      static_cast<const int8_t*>(codes_t), static_cast<int32_t*>(od), b, d,
      n, lsub, cb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups <= 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(b) * (ncol / groups);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  group_min_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const int32_t*>(od), static_cast<int32_t*>(og), b, ncol,
      cb / lsub, groups);
  return static_cast<int>(cudaGetLastError());
}

// K6: probe 0 = full, 1 = min, 2 = mm (see the top of this file).
extern "C" int idt_probe_scan(const void* qc, const void* w2,
                              const void* codes_t, void* od, int b, int d,
                              int n, int lsub, int cb, int probe,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n / lsub + kBL - 1) / kBL, (b + kBQ - 1) / kBQ);
  const auto* q = static_cast<const int8_t*>(qc);
  const auto* w = static_cast<const int32_t*>(w2);
  const auto* c = static_cast<const int8_t*>(codes_t);
  auto* o = static_cast<int32_t*>(od);
  if (probe == kFull)
    packed_scan_kernel<kFull><<<grid, kThreads, 0, s>>>(q, w, c, o, b, d, n, lsub, cb);
  else if (probe == kMin)
    packed_scan_kernel<kMin><<<grid, kThreads, 0, s>>>(q, w, c, o, b, d, n, lsub, cb);
  else if (probe == kMm)
    packed_scan_kernel<kMm><<<grid, kThreads, 0, s>>>(q, w, c, o, b, d, n, lsub, cb);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* idt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
