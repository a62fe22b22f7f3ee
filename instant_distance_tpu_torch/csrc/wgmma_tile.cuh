// The Hopper scan tile (sm_90a) of K1 (csrc/scan_kernel.cu, with its
// probe K6), K2, K3 and K5 (csrc/bucket_kernel.cu): warpgroup MMA (wgmma)
// fed by the Tensor Memory Accelerator (TMA).
//
// The TPU kernels it serves (instant_distance_tpu/ops/scan_kernel.py:
// _bucket_scan_int_packed_kernel, _probe_kernel, _bucket_scan_kernel,
// _bucket_scan_int_kernel, _fused_scan_kernel) hand the whole [QB, D] x
// [D, CB] product to the matrix unit; here it goes to the int8 tensor
// cores through wgmma.
//
// What bounds the product on an H100: the int8 multiply-adds (2 * B * N * D
// operations, 1,979 TOP/s) and, at D <= 300, the CUDA-core epilogue that
// reduces each slab's products (K2's f32 distances take ~9 operations an
// element).  What the tile does about it:
//
//   * Warp specialisation.  A block is two consumer warpgroups (64
//     queries each, kBQ = 128 queries a block) x kBN = 128 output
//     columns, and one producer warp whose first lane issues every copy:
//     288 threads, one block an SM.  Nine warps put three on one of the
//     SM's four register files, so a thread holds at most 168 registers:
//     the 64 accumulators, the caller's 64 running minima and K2's 32
//     words of packed argmins (a producer warpgroup with setmaxnreg gives
//     no more: ptxas still allocates the consumers' code at 168,
//     measured).  The two consumers share each stage; one's epilogue
//     overlaps the other's products as far as their turns at the tensor
//     cores fall apart.
//   * The product: wgmma.mma_async m64n128k32 s8 x s8 -> s32, both
//     operands K-major from shared memory, laid out by TMA's 128-byte
//     swizzle (rows of 128 d bytes, 1 KiB per 8 rows, the k-step's 32
//     bytes reached by moving the descriptor's start address).  The
//     accumulators (64 int32 a thread) are each slab's dot products; the
//     caller's epilogue keeps its running min beside them in registers.
//   * The operands by TMA.  The query tile [kBQ, Dpad] comes in once per
//     block as nkc boxes of 128 rows x 128 d bytes and stays in shared
//     memory across all lsub slabs (up to ~1,150 d bytes; wider queries
//     stream through the ring beside the codes, chunk by chunk).  The
//     codes are point-major, [Npad, Dpad] with Dpad a multiple of 32: a
//     tile's 128 columns are 128 consecutive points at every slab, so a
//     slab's chunk is one TMA box of 128 points x 128 d bytes.  Chunks run
//     through a ring of stages guarded by full/empty mbarriers; a slab's
//     per-point rows (K1's w2, K2's scales and norms, K3's w) ride in the
//     stage of its last chunk, which the consumers free after their
//     epilogue.  No thread stages or transposes a byte.
//   * The grid: query blocks fastest, then the column tiles of one cb
//     block, so a column tile's codes come from HBM once, then from L2.
//     Tile j of cb block k holds the points k * cb + t * ct + j * kBN + c
//     at slab t (ct = cb / lsub, c < kBN); a partial last tile (ct %
//     kBN != 0) loads points of the next slab or past N (zeros, by TMA)
//     into its spare columns, and the caller skips their outputs.
//
// Point p(o, t) of output column o at slab t: (o / ct) * cb + t * ct +
// o % ct.  Query rows past B and d past Dpad load as zero (TMA's
// out-of-bounds fill).

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace idt {
namespace wg {

constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;   // + the producer warp
constexpr int kBQ = 64 * kConsumers;     // queries a block
constexpr int kBN = 128;                 // output columns a block
constexpr int kAcc = kBN / 2;            // accumulators a consumer thread
constexpr int kKC = 128;                 // d bytes a chunk (one swizzle row)
constexpr int kQBytes = kBQ * kKC;       // a query chunk
constexpr int kCBytes = kBN * kKC;       // a code chunk
constexpr int kMaxRows = 2;              // per-point rows a kernel reads
constexpr int kRowBytes = kMaxRows * kBN * 4;
constexpr int kMinStages = 4, kMaxStages = 8;
constexpr int kBarBytes = 256;
constexpr int kAlign = 1024;             // the 128-byte swizzle's period
constexpr int kSmemLimit = 232448;       // bytes a block may use (sm_90)
// A wait on an mbarrier longer than this many SM clocks (~17 s) traps
// instead of hanging the card.
constexpr long long kWatchdog = 1ll << 35;

static_assert((2 * kMaxStages + 1) * 8 <= kBarBytes, "barriers");

// Shared-memory plan at Dpad d bytes: nkc chunks; the query tile resident
// when at least kMinStages stages fit beside it, else streamed with the
// codes; a stage is a code chunk, a query chunk when they stream, and a
// slab's rows (at off_rows in the stage); offsets from the 1 KiB-aligned
// base: query tile, stages, barriers.
struct Plan {
  int nkc, stages, stage_bytes, off_stage, off_rows, off_bar, bytes;
  bool resident;

  __host__ __device__ explicit Plan(int dpad) {
    nkc = (dpad + kKC - 1) / kKC;
    const int fixed = kAlign + kBarBytes;
    const int q = nkc * kQBytes;
    resident = kSmemLimit - fixed - q >= kMinStages * (kCBytes + kRowBytes);
    off_rows = resident ? kCBytes : kCBytes + kQBytes;
    stage_bytes = off_rows + kRowBytes;
    const int room = (kSmemLimit - fixed - (resident ? q : 0)) / stage_bytes;
    stages = room < kMaxStages ? room : kMaxStages;
    off_stage = resident ? q : 0;
    off_bar = off_stage + stages * stage_bytes;
    bytes = off_bar + kBarBytes + kAlign;
  }
};

// The TMA descriptors of one launch: queries [B, Dpad] and codes [Npad,
// Dpad] (int8, boxes of 128 rows x 128 bytes, 128-byte swizzle), and up
// to two per-point rows [Npad] of 32-bit words (boxes of kBN).
struct Maps {
  CUtensorMap q, c, r0, r1;
};

// -- PTX ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` more of TMA traffic in the current phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > kWatchdog) __trap();
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_1d(void* dst, const CUtensorMap* map,
                                       int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in TMA's 128-byte
// swizzle: start address >> 4, leading offset 1 (unused by swizzled
// K-major tiles), stride 1024 bytes (8 rows of 128 bytes) >> 4, layout 1.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above the
// wgmma_wait that completes them.
__device__ __forceinline__ void fence_acc(uint32_t (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, int32) = a (64 x 32) . b (128 x 32)^T (+ d when scale_d).
__device__ __forceinline__ void wgmma_m64n128k32(uint32_t (&d)[kAcc],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// -- the tile ----------------------------------------------------------

// One block's scan: kBQ queries from q0 x kBN output columns from o0 (the
// points p0 + t * ct + c at slab t), of which the first width are real.
struct Tile {
  const int lsub, ct, ncol;
  const Plan plan;
  int q0, o0, p0, width;
  uint8_t* smem;

  __device__ Tile(uint8_t* raw, int b, int dpad, int n, int lsub_, int cb)
      : lsub(lsub_), ct(cb / lsub_), ncol(n / lsub_), plan(dpad) {
    smem = raw + ((kAlign - (smem_u32(raw) & (kAlign - 1))) & (kAlign - 1));
    const int nqb = (b + kBQ - 1) / kBQ;
    const int per_block = (ct + kBN - 1) / kBN;
    const int tile = static_cast<int>(blockIdx.x / nqb);
    const int j0 = (tile % per_block) * kBN;
    q0 = static_cast<int>(blockIdx.x % nqb) * kBQ;
    o0 = (tile / per_block) * ct + j0;
    p0 = (tile / per_block) * cb + j0;
    width = ct - j0 < kBN ? ct - j0 : kBN;
  }

  // Blocks of a launch (0 when they would not fit a 1-D grid).
  static long long blocks(int b, int n, int lsub, int cb) {
    const int ct = cb / lsub;
    const long long nb = static_cast<long long>((b + kBQ - 1) / kBQ) *
                         (n / cb) * ((ct + kBN - 1) / kBN);
    return nb > 0x7fffffffLL ? 0 : nb;
  }

  // A consumer thread's accumulator r: its query row and column in the
  // block's tile (wgmma's D fragment: warp w of warpgroup g holds rows
  // 64 g + 16 w .. +16; r / 4 is the 8-column group).
  static __device__ __forceinline__ int row(int r) {
    const int lane = threadIdx.x & 31;
    return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
           (lane >> 2) + ((r >> 1) & 1) * 8;
  }
  static __device__ __forceinline__ int col(int r) {
    return (r >> 2) * 8 + (threadIdx.x & 3) * 2 + (r & 1);
  }

  __device__ __forceinline__ uint64_t* bars() const {
    return reinterpret_cast<uint64_t*>(smem + plan.off_bar);
  }
  __device__ __forceinline__ uint8_t* stage(int s) const {
    return smem + plan.off_stage + s * plan.stage_bytes;
  }

  // The producer: the query tile, then per slab its nkc code chunks (with
  // the query chunks when they stream), the slab's rows with the last.
  __device__ void produce(const Maps& maps, int nrows) const {
    uint64_t* const full = bars();
    uint64_t* const empty = full + kMaxStages;
    uint64_t* const qfull = empty + kMaxStages;
    if (plan.resident) {
      bar_expect(qfull, plan.nkc * kQBytes);
      for (int kc = 0; kc < plan.nkc; ++kc)
        tma_2d(smem + kc * kQBytes, &maps.q, kc * kKC, q0, qfull);
    }
    int s = 0;
    uint32_t ph = 0;
    for (int t = 0; t < lsub; ++t) {
      const int p = p0 + t * ct;
      for (int kc = 0; kc < plan.nkc; ++kc) {
        const bool last = kc == plan.nkc - 1;
        uint8_t* const st = stage(s);
        bar_wait(empty + s, ph ^ 1);
        bar_expect(full + s, plan.off_rows + (last ? nrows * kBN * 4 : 0));
        tma_2d(st, &maps.c, kc * kKC, p, full + s);
        if (!plan.resident) tma_2d(st + kCBytes, &maps.q, kc * kKC, q0, full + s);
        if (last && nrows > 0) tma_1d(st + plan.off_rows, &maps.r0, p, full + s);
        if (last && nrows > 1)
          tma_1d(st + plan.off_rows + kBN * 4, &maps.r1, p, full + s);
        if (++s == plan.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  }

  // A consumer warpgroup: per slab, the products over its nkc chunks into
  // acc, then epi(t, acc, rows) with rows the slab's [kMaxRows][kBN]
  // per-point words.  Each warp releases a stage once its products are
  // done, the slab's last (which holds the rows) once its epilogue is.
  template <class Epilogue>
  __device__ __forceinline__ void consume(Epilogue& epi) const {
    uint64_t* const full = bars();
    uint64_t* const empty = full + kMaxStages;
    uint64_t* const qfull = empty + kMaxStages;
    const bool lead = (threadIdx.x & 31) == 0;
    const int a_off = (threadIdx.x >> 7) * 64 * kKC;
    if (plan.resident) bar_wait(qfull, 0);
    uint32_t acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    int s = 0;
    uint32_t ph = 0;
    for (int t = 0; t < lsub; ++t) {
      int prev = 0;
      for (int kc = 0; kc < plan.nkc; ++kc) {
        bar_wait(full + s, ph);
        __syncwarp();  // wgmma wants the warp converged
        const uint8_t* b_tile = stage(s);
        const uint8_t* a_tile =
            (plan.resident ? smem + kc * kQBytes : b_tile + kCBytes) + a_off;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kKC / 32; ++k)
          wgmma_m64n128k32(acc, desc(a_tile + 32 * k), desc(b_tile + 32 * k),
                           (kc | k) != 0);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
          __syncwarp();
          if (lead) bar_arrive(empty + prev);
        }
        prev = s;
        if (++s == plan.stages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      epi(t, acc,
          reinterpret_cast<const uint32_t*>(stage(prev) + plan.off_rows));
      __syncwarp();
      if (lead) bar_arrive(empty + prev);
    }
  }

  // The whole scan.  Every thread of the block calls it; each consumer
  // thread calls start() (its running state), the slabs' epi(), then
  // fin() (its stores); the producer warp only returns.
  template <class Start, class Epilogue, class Finish>
  __device__ __forceinline__ void run(const Maps& maps, int nrows,
                                      Start&& start, Epilogue&& epi,
                                      Finish&& fin) const {
    uint64_t* const full = bars();
    if (threadIdx.x == 0) {
      for (int s = 0; s < plan.stages; ++s) {
        bar_init(full + s, 1);
        bar_init(full + kMaxStages + s, kConsumers * 4);
      }
      bar_init(full + 2 * kMaxStages, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= kConsumers * 128) {
      if (threadIdx.x == kConsumers * 128) produce(maps, nrows);
    } else {
      start();
      consume(epi);
      fin();
    }
  }
};

// -- host --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda.so.1 the process
// already holds (no link against the driver); null where there is none.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr
               ? nullptr
               : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// int8 [rows, dpad] at `base`, boxes of box_rows x kKC with the 128-byte
// swizzle.
inline bool encode_codes(CUtensorMap* map, const void* base, int rows,
                         int dpad, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dpad),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dpad)};
  const cuuint32_t box[2] = {kKC, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t one[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                   const_cast<void*>(base), dims, strides, box, one,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 32-bit words [n] at `base`, boxes of kBN.
inline bool encode_row(CUtensorMap* map, const void* base, int n) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};
  const cuuint32_t box[1] = {kBN};
  const cuuint32_t one[1] = {1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 1,
                   const_cast<void*>(base), dims, strides, box, one,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch's descriptors and geometry: queries qc [b, dpad] and codes
// [n, dpad] (int8, 16-byte aligned, dpad a multiple of 16), rows row0 /
// row1 [n] (16-byte aligned, null when unused); sets the kernel's shared
// memory limit.  Returns cudaErrorInvalidValue for operands TMA cannot
// describe, cudaErrorInvalidConfiguration for a grid that does not fit.
template <class Kernel>
cudaError_t prepare(Kernel kernel, Maps* maps, const void* qc,
                    const void* codes, const void* row0, const void* row1,
                    int b, int dpad, int n, int lsub, int cb,
                    unsigned* blocks, int* smem_bytes) {
  const Plan plan(dpad);
  const long long nb = Tile::blocks(b, n, lsub, cb);
  if (nb == 0 || plan.stages < 2 || plan.bytes > kSmemLimit)
    return cudaErrorInvalidConfiguration;
  if (encoder() == nullptr) return cudaErrorInitializationError;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (dpad % 16 != 0 || !aligned(qc) || !aligned(codes) ||
      (row0 != nullptr && !aligned(row0)) || (row1 != nullptr && !aligned(row1)))
    return cudaErrorInvalidValue;
  *maps = Maps{};
  if (!encode_codes(&maps->q, qc, b, dpad, kBQ) ||
      !encode_codes(&maps->c, codes, n, dpad, kBN) ||
      (row0 != nullptr && !encode_row(&maps->r0, row0, n)) ||
      (row1 != nullptr && !encode_row(&maps->r1, row1, n)))
    return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(nb);
  *smem_bytes = plan.bytes;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              plan.bytes);
}

}  // namespace wg
}  // namespace idt
