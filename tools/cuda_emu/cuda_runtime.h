// A CPU stand-in for the parts of the CUDA runtime and device library that
// instant_distance_tpu_torch/csrc/walk_kernel.cu uses, so that g++ can
// build and run it (see run.py).  One block runs at a time, one
// std::thread per CUDA thread; __syncthreads is a block barrier, and the
// warp collectives (shuffles, ballots) meet at a warp barrier.
#pragma once
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };

inline thread_local dim3 threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
constexpr int cudaErrorInvalidConfiguration = 9;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class T> int cudaFuncSetAttribute(T, int, int) { return 0; }
template <class T>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int, size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }

using std::isfinite;
using std::isnan;
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint8_t in[8];
  memcpy(in, &x, 4);
  memcpy(in + 4, &y, 4);
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= uint32_t(in[(s >> (4 * i)) & 7]) << (8 * i);
  return r;
}
// volatile: one rounding per operation, never contracted
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
// Shared-memory atomics: the block's threads are OS threads.
inline int atomicCAS(int* p, int expect, int value) {
  __atomic_compare_exchange_n(p, &expect, value, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return expect;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

// The block being run: its shared memory, barriers and the warps'
// exchange slots for the collective operations.
struct Emu {
  uint8_t* smem = nullptr;
  std::barrier<>* block = nullptr;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  uint64_t xchg[32][32];
};
inline Emu* g_emu = nullptr;

inline void __syncthreads() { g_emu->block->arrive_and_wait(); }
inline uint64_t __cvta_generic_to_shared(const void* p) {
  return uint64_t(static_cast<const uint8_t*>(p) - g_emu->smem);
}
inline void warp_sync() { g_emu->warps[threadIdx.x / 32]->arrive_and_wait(); }

// The warp collectives, for full warps: every lane posts its value, then
// reads its source lane's.
template <class T> T warp_exchange(T v, int src) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  g_emu->xchg[w][lane] = bits;
  warp_sync();
  bits = g_emu->xchg[w][src];
  warp_sync();
  memcpy(&v, &bits, sizeof(T));
  return v;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int off) {
  return warp_exchange(v, (threadIdx.x % 32) ^ off);
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return warp_exchange(v, src);
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int w = threadIdx.x / 32;
  g_emu->xchg[w][threadIdx.x % 32] = pred;
  warp_sync();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= unsigned(g_emu->xchg[w][l] != 0) << l;
  warp_sync();
  return m;
}

// Runs fn (the kernel with its arguments bound) on every block in turn,
// shared memory filled with garbage first, as on the card.
inline void emu_launch(unsigned blocks, unsigned threads, int smem_bytes,
                       const std::function<void()>& fn) {
  std::vector<uint8_t> smem(smem_bytes + 16);
  for (unsigned bid = 0; bid < blocks; ++bid) {
    Emu emu;
    emu.smem = smem.data();
    memset(emu.smem, 0xA5, smem_bytes);
    std::barrier<> block(threads);
    emu.block = &block;
    for (unsigned w = 0; w < threads / 32; ++w)
      emu.warps.emplace_back(std::make_unique<std::barrier<>>(32));
    g_emu = &emu;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(bid);
        blockDim = dim3(threads);
        fn();
      });
    for (auto& t : ts) t.join();
  }
}

template <class F, class... Args>
void emu_launch_f(dim3 grid, dim3 block, int smem, F f, Args... args) {
  emu_launch(grid.x * grid.y, block.x, smem, [&] { f(args...); });
}
