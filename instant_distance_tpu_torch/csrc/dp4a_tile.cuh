// The int8 dot-product tile shared by the scan kernels (csrc/*.cu).
//
// A block of kThreads threads computes, for 16 * TQ queries and kBL point
// columns, the int32 dot over all D of the query codes qc [B, D] with the
// point codes codes_t [D, N].  Query and code tiles are staged in shared
// memory with four consecutive d packed into one 32-bit word, and thread
// (tx, ty) = (tid % 16, tid / 16) runs a TQ x kTL register tile of __dp4a
// (four int8 multiply-adds per instruction): queries ty + 16 i, tile
// columns tx + 16 j.  Rows past B and d past D load as zero.
//
// The loader gives each thread one column of the code tile: the caller
// passes the point index of the column that thread tid % kBL loads (and
// whether it lies inside N), which is how a kernel maps its output
// columns onto strided point slabs.

#pragma once

#include <cstdint>

namespace idt {

constexpr int kBL = 64;                  // point columns per tile
constexpr int kDK = 32;                  // d values per shared-memory stage
constexpr int kThreads = 256;
constexpr int kTL = 4;                   // tile columns per thread
constexpr int kQWords = kDK / 4 + 1;     // padded query-tile row, in words

static_assert(kBL == 16 * kTL, "16 x 16 thread grid");
static_assert(kThreads % kBL == 0, "loader owns one column per thread");

template <int TQ>
struct DotTiles {
  int32_t q[16 * TQ * kQWords];          // [16 TQ queries][kDK d], padded
  int32_t c[(kDK / 4) * kBL];            // [kDK / 4 words][kBL columns]
};

// Point index of output column o at slab 0: groups are the points
// {(o / ct) * cb + t * ct + o % ct : t < lsub}, ct = cb / lsub.
__device__ __forceinline__ long long slab0_point(int o, int ct, int cb) {
  return static_cast<long long>(o / ct) * cb + o % ct;
}

// acc[i][j] = dot(qc[q0 + ty + 16 i, :], codes_t[:, column tx + 16 j]),
// where this thread loads the tile column at point index l_point (l_ok
// false: past N, loads zero).
template <int TQ>
__device__ __forceinline__ void dot_tile(const int8_t* __restrict__ qc,
                                         const int8_t* __restrict__ codes_t,
                                         int b, int d, int n, int q0,
                                         bool l_ok, long long l_point,
                                         DotTiles<TQ>& sm,
                                         int32_t (&acc)[TQ][kTL]) {
  constexpr int kBQ = 16 * TQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lj = tid % kBL;
  int8_t* q_bytes = reinterpret_cast<int8_t*>(sm.q);
  int8_t* c_bytes = reinterpret_cast<int8_t*>(sm.c);
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < kTL; ++j) acc[i][j] = 0;

  for (int d0 = 0; d0 < d; d0 += kDK) {
    // query tile [kBQ, kDK], zero past the batch and past D
    for (int e = tid; e < kBQ * kDK; e += kThreads) {
      const int r = e / kDK;
      const int dd = e % kDK;
      const int q = q0 + r;
      const int dg = d0 + dd;
      q_bytes[r * kQWords * 4 + dd] =
          (q < b && dg < d) ? qc[static_cast<long long>(q) * d + dg] : 0;
    }
    // code tile [kDK, kBL], stored as [kDK/4][kBL] words of 4 d each
    for (int dd = tid / kBL; dd < kDK; dd += kThreads / kBL) {
      const int dg = d0 + dd;
      c_bytes[((dd / 4) * kBL + lj) * 4 + dd % 4] =
          (l_ok && dg < d) ? codes_t[static_cast<long long>(dg) * n + l_point]
                           : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kDK / 4; ++kw) {
      int32_t a[TQ];
      int32_t c[kTL];
#pragma unroll
      for (int i = 0; i < TQ; ++i) a[i] = sm.q[(ty + 16 * i) * kQWords + kw];
#pragma unroll
      for (int j = 0; j < kTL; ++j) c[j] = sm.c[kw * kBL + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < kTL; ++j) acc[i][j] = __dp4a(a[i], c[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace idt
