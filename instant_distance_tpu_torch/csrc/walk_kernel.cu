// Fused packed-graph walk for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU Pallas kernel
// instant_distance_tpu/ops/walk_kernel.py:_walk_kernel (called through
// walk_search), which serves PackedHnsw.search_batch_kernel.
//
// What it computes, bit-exact with walk_search_plain in
// instant_distance_tpu_torch/ops/walk_kernel.py: for each query, the
// zero-layer beam search over the packed rows ids [N, K] i32, codes
// [N, K, D] i8, scales [N, K] f32 (ops/packed.py:pack_layer).  Each step
//   1. picks the first `expand` (1 or 2) unexpanded valid beam slots in
//      beam order and marks them expanded;
//   2. scores every neighbour j of each picked row by
//      sum_d (q_d - code_jd * scale_j)^2, each step rounded in that
//      order (__fmul_rn / __fsub_rn / __fadd_rn: nvcc would contract
//      them into FMAs), summed in a fixed order: lane l of a warp sums
//      d = 128 i + 4 l + c for (i, c) in order, then a butterfly folds
//      the 32 partial sums (16, 8, 4, 2, 1);
//   3. nulls (+inf, -1) neighbours that are invalid, already in the beam
//      or repeated from an earlier row of the same step (rows of a valid
//      graph hold distinct pids, so there is no in-row dedup, as in the
//      TPU kernel);
//   4. merges beam and candidates into the new top-ef by the strict
//      order (dist, pid, position): "count" gives each pool entry its
//      rank, "extract" takes ef block-wide minima.  Both give one beam.
// A query stops when no unexpanded slot is left or at max_iters.  The
// TPU kernel stops per block of bq queries; a converged query's step
// changes nothing, so the beams are the same.
//
// What bounds it on an H100: the bytes it reads, at the HBM rate, if the
// walk kept enough rows in flight: K ids of each expanded row, then D
// codes and a scale of each valid neighbour (the -1 tail of a row is
// never read), expansions x K x 4 + valid x (D + 4); the walk is a
// chain of dependent steps per query, so in practice each step's latency
// (one row read, then two block-wide phases) bounds it.
//
// What the design does about it: one block of 128 threads per query
// (CAGRA's layout), the beam, its expanded flags and the step's
// candidates in shared memory for the whole walk, so no search state
// reaches device memory.  Each warp scores one neighbour at a time and
// reads its D bytes in 4-byte words, coalesced; a converged query's
// block exits and frees its SM slot at once.  Overlapping the next row
// read with the merge (two beams per block, or a warp per query) is
// later work.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEf = 256;
constexpr int kMaxExpand = 2;
constexpr unsigned kFull = 0xffffffffu;

// Pool entry (d, p, i) before (d2, p2, i2) in the strict merge order.
__device__ __forceinline__ bool before(float d, int p, int i, float d2,
                                       int p2, int i2) {
  return d < d2 || (d == d2 && (p < p2 || (p == p2 && i < i2)));
}

// Shared-memory layout of one block, in 4-byte words.
struct Layout {
  int dq, ef, ek, t_all;
  __host__ __device__ Layout(int d, int ef_, int ek_)
      : dq((d + 3) / 4 * 4), ef(ef_), ek(ek_), t_all(ef_ + ek_) {}
  // q [dq], beam (d, p, e) x 2 buffers [6 ef], candidates (d, p) [2 ek],
  // taken [t_all]
  __host__ __device__ int words() const { return dq + 6 * ef + 2 * ek + t_all; }
};

// Squared L2 from the block's query q (shared, zero past d) to one packed
// neighbour row; every lane of the warp returns the same sum.
__device__ __forceinline__ float row_dist(const float* __restrict__ q,
                                          const int8_t* __restrict__ row,
                                          float s, int d, int lane) {
  float acc = 0.f;
  if ((d & 3) == 0) {
    for (int base = 4 * lane; base < d; base += 128) {
      const char4 c4 = *reinterpret_cast<const char4*>(row + base);
      const float4 q4 = *reinterpret_cast<const float4*>(q + base);
      const float cv[4] = {__int2float_rn(c4.x), __int2float_rn(c4.y),
                           __int2float_rn(c4.z), __int2float_rn(c4.w)};
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float diff = __fsub_rn(qv[c], __fmul_rn(cv[c], s));
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
    }
  } else {
    for (int base = 4 * lane; base < d; base += 128) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dd = base + c;
        if (dd < d) {
          const float diff =
              __fsub_rn(q[dd], __fmul_rn(__int2float_rn(row[dd]), s));
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  return acc;
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ queries,
            const float* __restrict__ bd0, const int32_t* __restrict__ bp0,
            const int32_t* __restrict__ ids,
            const int8_t* __restrict__ codes,
            const float* __restrict__ scales, float* __restrict__ bd_out,
            int32_t* __restrict__ bp_out, int d, int k, int ef, int expand,
            int max_iters) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int cur[kMaxExpand];
  __shared__ float red_d[2][kWarps];
  __shared__ int red_p[2][kWarps];
  __shared__ int red_i[2][kWarps];

  const Layout lay(d, ef, expand * k);
  const int ek = lay.ek;
  const int t_all = lay.t_all;
  float* q = reinterpret_cast<float*>(smem);
  float* bd = q + lay.dq;
  int* bp = reinterpret_cast<int*>(bd + ef);
  int* be = bp + ef;
  float* bd2 = reinterpret_cast<float*>(be + ef);
  int* bp2 = reinterpret_cast<int*>(bd2 + ef);
  int* be2 = bp2 + ef;
  float* nd = reinterpret_cast<float*>(be2 + ef);
  int* nb = reinterpret_cast<int*>(nd + ek);
  int* taken = nb + ek;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < lay.dq; i += kThreads)
    q[i] = i < d ? queries[row * d + i] : 0.f;
  for (int s = tid; s < ef; s += kThreads) {
    bd[s] = bd0[row * ef + s];
    bp[s] = bp0[row * ef + s];
    be[s] = 0;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // 1. the first `expand` unexpanded valid slots, in beam order
    if (warp == 0) {
      if (lane < kMaxExpand) cur[lane] = -1;
      __syncwarp();
      int cnt = 0;
      for (int base = 0; base < ef && cnt < expand; base += 32) {
        const int s = base + lane;
        const bool open = s < ef && bp[s] >= 0 && !be[s];
        const unsigned m = __ballot_sync(kFull, open);
        const int r = cnt + __popc(m & ((1u << lane) - 1u));
        if (open && r < expand) {
          cur[r] = bp[s];
          be[s] = 1;
        }
        cnt += __popc(m);
      }
    }
    __syncthreads();
    const int pid0 = cur[0];
    const int pid1 = expand > 1 ? cur[1] : -1;
    if (pid0 < 0) break;  // converged (block-uniform: read from shared)

    // 2. score the picked rows' neighbours, a warp per neighbour
    for (int c = warp; c < ek; c += kWarps) {
      const int e = c / k;
      const int pid = e == 0 ? pid0 : pid1;
      float dist = __int_as_float(0x7f800000);
      int id = -1;
      if (pid >= 0) {
        const long long r = static_cast<long long>(pid) * k + (c - e * k);
        const int nid = ids[r];
        if (nid >= 0) {
          dist = row_dist(q, codes + r * d, scales[r], d, lane);
          id = nid;
        }
      }
      if (lane == 0) {
        nd[c] = id >= 0 ? dist : __int_as_float(0x7f800000);
        nb[c] = id;
      }
    }
    __syncthreads();

    // 3. dedup against the beam and the step's earlier rows
    unsigned dup = 0;
    for (int c = tid, bit = 0; c < ek; c += kThreads, ++bit) {
      const int id = nb[c];
      bool hit = false;
      if (id >= 0) {
        for (int s = 0; s < ef && !hit; ++s) hit = bp[s] == id;
        const int lo = (c / k) * k;
        for (int c2 = 0; c2 < lo && !hit; ++c2) hit = nb[c2] == id;
      }
      dup |= static_cast<unsigned>(hit) << bit;
    }
    __syncthreads();
    for (int c = tid, bit = 0; c < ek; c += kThreads, ++bit) {
      if ((dup >> bit) & 1u) {
        nd[c] = __int_as_float(0x7f800000);
        nb[c] = -1;
      }
    }
    __syncthreads();

    // 4. merge: pool entry l < ef is beam slot l, else candidate l - ef
    if (kCount) {
      for (int l = tid; l < t_all; l += kThreads) {
        const bool in_beam = l < ef;
        const float dl = in_beam ? bd[l] : nd[l - ef];
        const int pl = in_beam ? bp[l] : nb[l - ef];
        int rank = 0;
        for (int j = 0; j < ef; ++j) rank += before(bd[j], bp[j], j, dl, pl, l);
        for (int j = 0; j < ek; ++j)
          rank += before(nd[j], nb[j], ef + j, dl, pl, l);
        if (rank < ef) {
          bd2[rank] = dl;
          bp2[rank] = pl;
          be2[rank] = in_beam ? be[l] : 0;
        }
      }
    } else {
      for (int l = tid; l < t_all; l += kThreads) taken[l] = 0;
      __syncthreads();
      for (int r = 0; r < ef; ++r) {
        float md = 0.f;
        int mp = 0, mi = -1;
        for (int l = tid; l < t_all; l += kThreads) {
          if (taken[l]) continue;
          const float dl = l < ef ? bd[l] : nd[l - ef];
          const int pl = l < ef ? bp[l] : nb[l - ef];
          if (mi < 0 || before(dl, pl, l, md, mp, mi)) {
            md = dl;
            mp = pl;
            mi = l;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float od = __shfl_xor_sync(kFull, md, off);
          const int op = __shfl_xor_sync(kFull, mp, off);
          const int oi = __shfl_xor_sync(kFull, mi, off);
          if (oi >= 0 && (mi < 0 || before(od, op, oi, md, mp, mi))) {
            md = od;
            mp = op;
            mi = oi;
          }
        }
        const int buf = r & 1;
        if (lane == 0) {
          red_d[buf][warp] = md;
          red_p[buf][warp] = mp;
          red_i[buf][warp] = mi;
        }
        __syncthreads();
        md = red_d[buf][0];
        mp = red_p[buf][0];
        mi = red_i[buf][0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const int oi = red_i[buf][w];
          if (oi >= 0 &&
              (mi < 0 || before(red_d[buf][w], red_p[buf][w], oi, md, mp, mi))) {
            md = red_d[buf][w];
            mp = red_p[buf][w];
            mi = oi;
          }
        }
        // every thread holds the winner; its owner marks it taken
        if (mi % kThreads == tid) taken[mi] = 1;
        if (tid == 0) {
          bd2[r] = md;
          bp2[r] = mp;
          be2[r] = mi < ef ? be[mi] : 0;
        }
      }
    }
    __syncthreads();
    float* tf = bd; bd = bd2; bd2 = tf;
    int* ti = bp; bp = bp2; bp2 = ti;
    ti = be; be = be2; be2 = ti;
  }

  for (int s = tid; s < ef; s += kThreads) {
    bd_out[row * ef + s] = bd[s];
    bp_out[row * ef + s] = bp[s];
  }
}

template <bool kCount>
int launch(const void* queries, const void* bd0, const void* bp0,
           const void* ids, const void* codes, const void* scales,
           void* bd_out, void* bp_out, int b, int d, int k, int ef,
           int expand, int max_iters, cudaStream_t s) {
  const size_t bytes = sizeof(int32_t) * Layout(d, ef, expand * k).words();
  auto kernel = walk_kernel<kCount>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kThreads, bytes, s>>>(
      static_cast<const float*>(queries), static_cast<const float*>(bd0),
      static_cast<const int32_t*>(bp0), static_cast<const int32_t*>(ids),
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<float*>(bd_out), static_cast<int32_t*>(bp_out), d, k, ef,
      expand, max_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns a CUDA error code as an int (0 =
// launched).  The wrapper has checked shapes, ef <= 256 and expand <= 2;
// a candidate pool past 32 x 128 entries is refused here (the dedup
// keeps one bit per candidate a thread owns).
extern "C" int idt_walk_search(const void* queries, const void* bd0,
                               const void* bp0, const void* ids,
                               const void* codes, const void* scales,
                               void* bd_out, void* bp_out, int b, int d,
                               int k, int ef, int expand, int max_iters,
                               int count, void* stream) {
  if (ef < 1 || ef > kMaxEf || expand < 1 || expand > kMaxExpand ||
      expand * k > 32 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return count ? launch<true>(queries, bd0, bp0, ids, codes, scales, bd_out,
                              bp_out, b, d, k, ef, expand, max_iters, s)
               : launch<false>(queries, bd0, bp0, ids, codes, scales, bd_out,
                               bp_out, b, d, k, ef, expand, max_iters, s);
}
