// Packed-key int8 scan for Hopper (sm_90a): kernel K1, and its timing
// probe K6.
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
// What bounds it on an H100: at build-wave and ScanIndex sizes (4096-8192
// queries against ~1M points of D = 128) the int8 multiply-adds, ~1 ms of
// the tensor cores' peak a call; the codes (~130 MB) and the [B, N/lsub]
// keys it writes (~0.5 GB) are a fraction of that at HBM rate.
//
// What the design does about it: the product runs on the int8 tensor
// cores through the tile of mma_tile.cuh (mma.sync m16n8k32, the query
// tile staged once per block, code tiles double-buffered with cp.async
// and transposed in shared memory, query blocks fastest in the grid).
// One block owns 128 queries x 64 output columns and keeps their running
// minimum in registers beside the accumulators across the lsub slabs (the
// slab form of the TPU kernel), so the [B, N] dot tile never reaches
// memory and each query writes N/lsub keys; the slab's w2 row arrives
// with its code tile.
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

#include "mma_tile.cuh"

namespace {

namespace mma = idt::mma;

enum Probe { kFull = 0, kMin = 1, kMm = 2 };

template <int kProbe>
__global__ void __launch_bounds__(mma::kThreads)
packed_scan_kernel(const int8_t* __restrict__ qc,
                   const int32_t* __restrict__ w2,
                   const int8_t* __restrict__ codes_t,
                   int32_t* __restrict__ od, int b, int d, int n, int lsub,
                   int cb, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const mma::Tile tile(smem, b, d, n, lsub, cb, vec != 0);

  int32_t best[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) best[i][j][e] = INT_MAX;

  const uint32_t* const rows[mma::kMaxRows] = {
      reinterpret_cast<const uint32_t*>(w2), nullptr};
  tile.run(qc, codes_t, rows, kProbe == kFull ? 1 : 0,
           [&](int t, const mma::Acc& acc, const uint32_t* rows_t) {
#pragma unroll
             for (int j = 0; j < 4; ++j)
#pragma unroll
               for (int e = 0; e < 4; ++e) {
                 if (kProbe == kFull) {
                   const int32_t wv = static_cast<int32_t>(rows_t[tile.col(j, e)]);
#pragma unroll
                   for (int i = 0; i < 2; ++i)
                     best[i][j][e] = min(best[i][j][e], wv - acc[i][j][e] * lsub);
                 } else if (kProbe == kMin) {
#pragma unroll
                   for (int i = 0; i < 2; ++i)
                     best[i][j][e] = min(best[i][j][e], acc[i][j][e]);
                 } else {
#pragma unroll
                   for (int i = 0; i < 2; ++i) {
                     if (t == 0) best[i][j][e] = acc[i][j][e];
                     else asm volatile("" ::"r"(acc[i][j][e]));
                   }
                 }
               }
           });

  const int ncol = n / lsub;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = tile.q0 + tile.row(i, e);
      if (q >= b) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = tile.o0 + tile.col(j, e);
        if (o < ncol) od[static_cast<long long>(q) * ncol + o] = best[i][j][e];
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

template <int kProbe>
cudaError_t launch(const void* qc, const void* w2, const void* codes_t,
                   void* od, int b, int d, int n, int lsub, int cb,
                   cudaStream_t s) {
  unsigned blocks;
  int smem;
  cudaError_t err = mma::prepare(packed_scan_kernel<kProbe>, b, d, n, lsub,
                                 &blocks, &smem);
  if (err != cudaSuccess) return err;
  const int vec = mma::vector_ok(cb / lsub, codes_t, w2, nullptr);
  packed_scan_kernel<kProbe><<<blocks, mma::kThreads, smem, s>>>(
      static_cast<const int8_t*>(qc), static_cast<const int32_t*>(w2),
      static_cast<const int8_t*>(codes_t), static_cast<int32_t*>(od), b, d,
      n, lsub, cb, vec);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() as an int (0 = launched).
// `og` may be null when groups <= 1.
extern "C" int idt_packed_scan(const void* qc, const void* w2,
                               const void* codes_t, void* od, void* og,
                               int b, int d, int n, int lsub, int cb,
                               int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch<kFull>(qc, w2, codes_t, od, b, d, n, lsub, cb, s);
  if (err != cudaSuccess || groups <= 1) return static_cast<int>(err);
  const int ncol = n / lsub;
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
  cudaError_t err;
  if (probe == kFull)
    err = launch<kFull>(qc, w2, codes_t, od, b, d, n, lsub, cb, s);
  else if (probe == kMin)
    err = launch<kMin>(qc, w2, codes_t, od, b, d, n, lsub, cb, s);
  else if (probe == kMm)
    err = launch<kMm>(qc, w2, codes_t, od, b, d, n, lsub, cb, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* idt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
