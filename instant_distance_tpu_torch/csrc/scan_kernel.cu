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
//   od[q, o] = min_{t < lsub} ( w2[p(o, t)] - dot(qc[q, :], codes[p(o, t), :]) * lsub )
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
// cores through the Hopper tile of wgmma_tile.cuh (wgmma fed by TMA: the
// query tile resident in shared memory, point-major code chunks and the
// slab's w2 row through mbarrier rings filled by a producer warp, two
// consumer warpgroups).  One block owns 128 queries x 128 output columns
// and keeps their running minimum in registers beside the accumulators
// across the lsub slabs (the slab form of the TPU kernel), so the [B, N]
// dot tile never reaches memory and each query writes N/lsub keys.  The
// epilogue is one multiply-add and one min an element.
//
// The same kernel, cut short, is the timing probe K6 (replaces
// instant_distance_tpu/ops/scan_kernel.py:_probe_kernel, called through
// fused_scan_probe), the template parameter kProbe:
//   kFull: K1's keys without groups (the production epilogue);
//   kMin:  the same min chain over the raw dot (one min per element, no
//          w2);
//   kMm:   the product alone: od holds each cb block's slab-0 dot.  Every
//          slab's product still runs (wgmma is issued whatever its
//          accumulators' fate).
// Timing the three splits K1's time into product, min chain and key
// epilogue.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "wgmma_tile.cuh"

namespace {

namespace wg = idt::wg;

enum Probe { kFull = 0, kMin = 1, kMm = 2 };

template <int kProbe>
__global__ void __launch_bounds__(wg::kThreads, 1)
packed_scan_kernel(const __grid_constant__ wg::Maps maps,
                   int32_t* __restrict__ od, int b, int dpad, int n,
                   int lsub, int cb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const wg::Tile tile(smem, b, dpad, n, lsub, cb);

  int32_t best[wg::kAcc];
  // a key is w2 + dot * -lsub, one IMAD; through the empty asm the
  // compiler cannot fold the negation into the product, which costs a
  // negation of every dot
  int32_t neg_lsub;
  asm("mov.b32 %0, %1;" : "=r"(neg_lsub) : "r"(-lsub));
  tile.run(
      maps, kProbe == kFull ? 1 : 0,
      [&] {
#pragma unroll
        for (int r = 0; r < wg::kAcc; ++r) best[r] = INT_MAX;
      },
      [&](int t, const uint32_t (&acc)[wg::kAcc], const uint32_t* rows) {
#pragma unroll
        for (int j = 0; j < wg::kAcc / 4; ++j) {
          const int2 wv = *reinterpret_cast<const int2*>(rows + wg::Tile::col(4 * j));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 4 * j + e;
            const int32_t dot = static_cast<int32_t>(acc[r]);
            if (kProbe == kFull)
              best[r] = min(best[r], ((e & 1) ? wv.y : wv.x) + dot * neg_lsub);
            else if (kProbe == kMin)
              best[r] = min(best[r], dot);
            else if (t == 0)
              best[r] = dot;
          }
        }
      },
      [&] {
#pragma unroll
        for (int r = 0; r < wg::kAcc; ++r) {
          const int q = tile.q0 + wg::Tile::row(r);
          const int c = wg::Tile::col(r);
          if (q < b && c < tile.width)
            od[static_cast<long long>(q) * tile.ncol + tile.o0 + c] = best[r];
        }
      });
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
cudaError_t launch(const void* qc, const void* w2, const void* codes,
                   void* od, int b, int dpad, int n, int lsub, int cb,
                   cudaStream_t s) {
  wg::Maps maps;
  unsigned blocks;
  int smem;
  cudaError_t err = wg::prepare(packed_scan_kernel<kProbe>, &maps, qc, codes,
                                kProbe == kFull ? w2 : nullptr, nullptr, b,
                                dpad, n, lsub, cb, &blocks, &smem);
  if (err != cudaSuccess) return err;
  packed_scan_kernel<kProbe><<<blocks, wg::kThreads, smem, s>>>(
      maps, static_cast<int32_t*>(od), b, dpad, n, lsub, cb);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() as an int (0 = launched),
// or the error of an operand TMA cannot describe (see wg::prepare).  qc is
// [B, dpad] and codes [N, dpad], both int8, zero past D; `og` may be null
// when groups <= 1.
extern "C" int idt_packed_scan(const void* qc, const void* w2,
                               const void* codes, void* od, void* og,
                               int b, int dpad, int n, int lsub, int cb,
                               int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch<kFull>(qc, w2, codes, od, b, dpad, n, lsub, cb, s);
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
                              const void* codes, void* od, int b, int dpad,
                              int n, int lsub, int cb, int probe,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (probe == kFull)
    err = launch<kFull>(qc, w2, codes, od, b, dpad, n, lsub, cb, s);
  else if (probe == kMin)
    err = launch<kMin>(qc, w2, codes, od, b, dpad, n, lsub, cb, s);
  else if (probe == kMm)
    err = launch<kMm>(qc, w2, codes, od, b, dpad, n, lsub, cb, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The Hopper tile's plan at dpad d bytes: out = {shared bytes a block,
// stages, query tile resident (1) or streamed (0), d chunks, threads a
// block}.
extern "C" int idt_wg_plan(int dpad, int* out) {
  const wg::Plan plan(dpad);
  out[0] = plan.bytes;
  out[1] = plan.stages;
  out[2] = plan.resident ? 1 : 0;
  out[3] = plan.nkc;
  out[4] = wg::kThreads;
  return 0;
}

extern "C" const char* idt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
