// Fused packed-graph walk for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU Pallas kernel _walk_kernel behind walk_search
// (instant_distance_tpu/ops/walk_kernel.py:358), which serves
// PackedHnsw.search_batch_kernel.
//
// What it computes, bit-exact with walk_search_plain in
// instant_distance_tpu_torch/ops/walk_kernel.py: for each query, the
// zero-layer beam search over the packed rows ids [N, K] i32, codes
// [N, K, D] i8, scales [N, K] f32 (ops/packed.py:pack_layer).  Each step
//   1. picks the first `expand` (1 or 2) unexpanded valid beam slots in
//      beam order and marks them expanded;
//   2. scores every neighbour j of each picked row by
//      sum_d (q_d - code_jd * scale_j)^2, each operation rounded on its
//      own (__fmul_rn / __fsub_rn / __fadd_rn: nvcc would contract them
//      into FMAs), summed in a fixed order: lane l of a warp sums
//      d = 128 i + 4 l + c for (i, c) in order, then a butterfly folds
//      the 32 partial sums (16, 8, 4, 2, 1);
//   3. nulls (+inf, -1) neighbours that are invalid, already in the beam
//      or repeated from an earlier row of the same step (rows of a valid
//      graph hold distinct pids, so there is no in-row dedup, as in the
//      TPU kernel); a pid that left the beam may come back;
//   4. merges beam and candidates into the new top-ef by the strict
//      order (dist, pid, position).
// A query stops when no unexpanded slot is left or at max_iters.  The
// TPU kernel stops per block of bq queries; a converged query's step
// changes nothing, so the beams are the same.  The JAX package's two
// merge strategies ("count", "extract") define one beam, so there is one
// merge here.
//
// What bounds it on an H100: bytes, at the HBM rate (chip_smoke.py,
// _walk_bound): each step reads the K ids of every expanded row and the
// D codes and the scale of its neighbours.  A step depends on the one
// before, so a query has one step's reads in flight at a time; the card
// reaches the byte rate only with enough queries resident per SM.
//
// What the design does about it:
//   - one block of two warps per query, the beam, the step's
//     candidates and a hash of the beam's pids in shared memory for the
//     whole walk; a converged query's block exits and frees its slot;
//     registers are capped so that as many blocks fit an SM as shared
//     memory allows at D = 128;
//   - one memory latency per step: once the picks are known, every
//     thread issues 16-byte cp.async copies of the picked rows' ids,
//     scales and codes (contiguous at pid * K * D) into shared memory;
//     the first row's dedup runs while the codes land; rows past the
//     staging buffer (stage_cap bytes) are staged in chunks of whole
//     rows, or of 32 rows times a slice of D, in a loop; shapes that
//     break 16-byte alignment take 4-byte cp.async or plain loads;
//   - scoring from shared memory: a warp takes 16 candidates, lane l
//     reads word l + 32 i of each row (no bank conflicts) and keeps the
//     16 partial sums in registers; a reduce-scatter butterfly (16
//     shuffles, the same tree as the butterfly of the sum order) leaves
//     each candidate's sum in two lanes; codes turn into floats by a
//     byte permute and one subtract (exact, and at the FP32 rate, where
//     I2F runs at an eighth of it);
//   - dedup by the hash: beam pids, then the first row's pids, each
//     candidate one probe chain;
//   - the pick needs no barrier (every warp finds the same slots), and
//     neither does a merge of up to 32 candidates;
//   - a merge in O(T log T): only candidates that beat the beam's last
//     entry enter (few after the first steps); they are sorted by a
//     64-bit (dist, pid) key (in registers by every warp up to 32, else
//     a bitonic sort in shared memory), and each beam entry and
//     candidate finds its rank by a binary search in the other list
//     (merge path).  The caller's beam need not be sorted: the first
//     step ranks it once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxEf = 256;
constexpr int kMaxExpand = 2;
constexpr int kMaxPool = 4096;
constexpr int kMinStage = 32 * 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kMaxKey = ~0ull;
// Warps a query (four were slower: fewer blocks fit an SM), candidates a
// warp scores at once, and lanes that end up with each sum.
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 16;
constexpr int kLanes = 32 / kBatch;

// -- copies into shared memory (cp.async) ---------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
// -- end of the copies -----------------------------------------------------

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int pow2_at_least(int x) {
  int p = 32;
  while (p < x) p <<= 1;
  return p;
}

// Shared-memory layout of one block (byte offsets, each 16-aligned) and
// the staging plan: chunks of cc candidates times dc dims.
struct Layout {
  int ek, ekp, efp, pool, hash, cc, dc;
  int q, bd, bp, be, nd, nb, keys, hkey, htag, stage, bytes;
  __host__ __device__ Layout(int d, int k, int ef, int expand, int cap) {
    ek = expand * k;
    ekp = round_up(ek, 32);
    efp = round_up(ef, 4);
    pool = pow2_at_least(ekp);
    hash = pow2_at_least(2 * (ef + (expand - 1) * k));
    if (ekp * d <= cap) {
      cc = ekp;
      dc = d;
    } else if (32 * d <= cap) {
      cc = cap / (32 * d) * 32;
      dc = d;
    } else {
      cc = 32;
      dc = cap / (32 * 128) * 128;
    }
    int o = 0;
    q = take(o, 4 * round_up(d, 128));
    bd = take(o, 4 * 2 * efp);  // two buffers each
    bp = take(o, 4 * 2 * efp);
    be = take(o, 4 * 2 * efp);
    nd = take(o, 4 * ekp);
    nb = take(o, 4 * ekp);
    keys = take(o, 8 * pool);
    hkey = take(o, 4 * hash);
    htag = take(o, 4 * hash);
    stage = take(o, cc * dc);
    bytes = o;
  }
  __host__ __device__ static int take(int& o, int n) {
    const int at = o;
    o += round_up(n, 16);
    return at;
  }
};

// The strict merge order (dist, pid) as one unsigned key: -0 counts as
// +0 (they compare equal), then the float's order-preserving bits, then
// the pid's.
__device__ __forceinline__ unsigned long long key_of(float d, int p) {
  unsigned u = __float_as_uint(__fadd_rn(d, 0.f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         (static_cast<unsigned>(p) ^ 0x80000000u);
}
__device__ __forceinline__ float key_dist(unsigned long long key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ int key_pid(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key) ^ 0x80000000u);
}

// Open-addressing set of pids (-1 = empty), at most half full.
__device__ __forceinline__ unsigned hash_of(int p, unsigned mask) {
  unsigned h = static_cast<unsigned>(p) * 2654435761u;
  return (h ^ (h >> 15)) & mask;
}
// Slot holding p, inserting it if absent.
__device__ __forceinline__ unsigned hash_insert(int* tab, unsigned mask,
                                                int p) {
  for (unsigned h = hash_of(p, mask);; h = (h + 1) & mask) {
    const int old = atomicCAS(&tab[h], -1, p);
    if (old == -1 || old == p) return h;
  }
}
__device__ __forceinline__ bool hash_find(const int* tab, unsigned mask,
                                          int p) {
  for (unsigned h = hash_of(p, mask);; h = (h + 1) & mask) {
    const int v = tab[h];
    if (v == p) return true;
    if (v == -1) return false;
  }
}

// Copies len bytes to shared memory with every thread of the block:
// 16-byte cp.async where both ends and len allow, else 4-byte, else
// plain loads.
__device__ __forceinline__ void stage_bytes(void* dst, const void* src,
                                            int len, int tid, int nt) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const uintptr_t a = reinterpret_cast<uintptr_t>(d) |
                      reinterpret_cast<uintptr_t>(s) |
                      static_cast<uintptr_t>(len);
  if ((a & 15) == 0) {
    for (int o = 16 * tid; o < len; o += 16 * nt) cp_async16(d + o, s + o);
  } else if ((a & 3) == 0) {
    for (int o = 4 * tid; o < len; o += 4 * nt) cp_async4(d + o, s + o);
  } else {
    for (int o = tid; o < len; o += nt) d[o] = s[o];
  }
}

// Stages the codes of one chunk: with whole rows (dc == d) candidates
// [c0, c0 + cc) at stride d, else dims [d0, d0 + dc) of the 32
// candidates from c0 at stride dc.  Rows of pid -1 are skipped.
__device__ __forceinline__ void stage_codes(uint8_t* stage,
                                            const int8_t* codes, int d,
                                            int k, int ek, int cc, int dc,
                                            int pid0, int pid1, int c0,
                                            int d0, int tid, int nt) {
  if (dc == d) {
    const int c1 = min(c0 + cc, ek);
    for (int e = 0; e * k < c1; ++e) {
      const int pid = e ? pid1 : pid0;
      const int j0 = max(c0 - e * k, 0), j1 = min(c1 - e * k, k);
      if (pid < 0 || j0 >= j1) continue;
      stage_bytes(stage + (e * k + j0 - c0) * d,
                  codes + (static_cast<size_t>(pid) * k + j0) * d,
                  (j1 - j0) * d, tid, nt);
    }
  } else {
    const int len = min(dc, d - d0);
    for (int x = 0; x < 32 && c0 + x < ek; ++x) {
      const int c = c0 + x, e = c / k, pid = e ? pid1 : pid0;
      if (pid < 0) continue;
      stage_bytes(stage + x * dc,
                  codes + (static_cast<size_t>(pid) * k + c - e * k) * d + d0,
                  len, tid, nt);
    }
  }
}

// int8 code (given as its byte, biased by 128) as an exact float: the
// bits of 2^23 + (b + 128), less 2^23 + 128.
__device__ __forceinline__ float code_float(unsigned biased, unsigned sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, sel)),
                   8388736.f);
}
__device__ __forceinline__ float term(float acc, float q, float c, float s) {
  const float diff = __fsub_rn(q, __fmul_rn(c, s));
  return __fadd_rn(acc, __fmul_rn(diff, diff));
}

// Adds lane `lane`'s terms of dims [0, dlen) (relative to q and to each
// staged row) of kBatch staged rows (row x at rows + x * stride, scale
// sc[x]) to p[x], in the (i, c) order of the sum.  kWords: dlen, stride
// and the rows are 4-byte aligned.
template <bool kWords>
__device__ __forceinline__ void score_rows(float (&p)[kBatch],
                                           const uint8_t* rows, int stride,
                                           const float* q, int dlen,
                                           const float* sc, int lane) {
  for (int base = 0; base < dlen; base += 128) {
    const int dd = base + 4 * lane;
    if (kWords) {
      if (dd >= dlen) continue;
      const float4 q4 = *reinterpret_cast<const float4*>(q + dd);
#pragma unroll
      for (int x = 0; x < kBatch; ++x) {
        const unsigned w =
            *reinterpret_cast<const unsigned*>(rows + x * stride + dd) ^
            0x80808080u;
        const float s = sc[x];
        float a = p[x];
        a = term(a, q4.x, code_float(w, 0x7540), s);
        a = term(a, q4.y, code_float(w, 0x7541), s);
        a = term(a, q4.z, code_float(w, 0x7542), s);
        p[x] = term(a, q4.w, code_float(w, 0x7543), s);
      }
    } else {
#pragma unroll
      for (int x = 0; x < kBatch; ++x) {
        const float s = sc[x];
        for (int c = 0; c < 4 && dd + c < dlen; ++c)
          p[x] = term(p[x], q[dd + c],
                      code_float(rows[x * stride + dd + c] ^ 0x80u, 0x7540),
                      s);
      }
    }
  }
}

// One round of the fold that splits the set: lanes with bit kOff keep
// the upper kHalf sums, the others the lower, and each adds its
// partner's.  Bitwise selects: a select of two array elements can become
// a load from a computed index, which would put p in local memory.
template <int kHalf, int kOff>
__device__ __forceinline__ void split_round(float (&p)[kBatch], int lane) {
  const unsigned hi = (lane & kOff) ? ~0u : 0u;
#pragma unroll
  for (int x = 0; x < kHalf; ++x) {
    const unsigned a = __float_as_uint(p[x]);
    const unsigned b = __float_as_uint(p[x + kHalf]);
    const float keep = __uint_as_float((a & ~hi) | (b & hi));
    const float send = __uint_as_float((b & ~hi) | (a & hi));
    p[x] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kOff));
  }
}

// The kBatch sums of p folded across the warp by the butterfly's tree
// (16, 8, 4, 2, 1): the first four rounds split the set between the
// halves of the warp, so that candidate x ends in lanes 2 x and 2 x + 1,
// the last folds the one sum left.
__device__ __forceinline__ float reduce_scatter(float (&p)[kBatch],
                                                int lane) {
  static_assert(kBatch == 16, "the rounds below fold 16 sums");
  split_round<8, 16>(p, lane);
  split_round<4, 8>(p, lane);
  split_round<2, 4>(p, lane);
  split_round<1, 2>(p, lane);
  return __fadd_rn(p[0], __shfl_xor_sync(kFull, p[0], 1));
}

// Writes candidate kBatch g + x from lane kLanes x's folded sum: (+inf,
// -1) where its row or its id is invalid.
__device__ __forceinline__ void finish_group(float (&p)[kBatch], int g,
                                             int ek, int k, int pid0,
                                             int pid1, float* nd, int* nb,
                                             int lane) {
  const float dist = reduce_scatter(p, lane);
  const int c = kBatch * g + lane / kLanes;
  if (c < ek && lane % kLanes == 0) {
    const int id = nb[c];
    const bool ok = (c < k ? pid0 : pid1) >= 0 && id >= 0;
    nd[c] = ok ? dist : __uint_as_float(0x7f800000u);
    nb[c] = ok ? id : -1;
  }
}

// Places the j-th smallest passing candidate (key kc) at its rank: j
// plus the beam entries at or below it.
__device__ __forceinline__ void merge_candidate(unsigned long long kc, int j,
                                                const float* bd,
                                                const int* bp, float* bd2,
                                                int* bp2, int* be2, int ef) {
  int lo = 0, hi = ef;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_of(bd[mid], bp[mid]) <= kc) lo = mid + 1; else hi = mid;
  }
  const int r = j + lo;
  if (r < ef) {
    bd2[r] = key_dist(kc);
    bp2[r] = key_pid(kc);
    be2[r] = 0;
  }
}

// At most 102 registers, so that 10 blocks fit an SM, as many as shared
// memory holds at D = 128.
__global__ void __launch_bounds__(kThreads, 10)
walk_kernel(const float* __restrict__ queries,
            const float* __restrict__ bd0, const int32_t* __restrict__ bp0,
            const int32_t* __restrict__ ids,
            const int8_t* __restrict__ codes,
            const float* __restrict__ scales, float* __restrict__ bd_out,
            int32_t* __restrict__ bp_out, int d, int k, int ef, int expand,
            int max_iters, int stage_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int npass;

  const Layout lay(d, k, ef, expand, stage_cap);
  const int ek = lay.ek, ekp = lay.ekp;
  float* q = reinterpret_cast<float*>(smem + lay.q);
  float* bd = reinterpret_cast<float*>(smem + lay.bd);
  int* bp = reinterpret_cast<int*>(smem + lay.bp);
  int* be = reinterpret_cast<int*>(smem + lay.be);
  float* bd2 = bd + lay.efp;
  int* bp2 = bp + lay.efp;
  int* be2 = be + lay.efp;
  float* nd = reinterpret_cast<float*>(smem + lay.nd);
  int* nb = reinterpret_cast<int*>(smem + lay.nb);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + lay.keys);
  int* hkey = reinterpret_cast<int*>(smem + lay.hkey);
  int* htag = reinterpret_cast<int*>(smem + lay.htag);
  uint8_t* stage = smem + lay.stage;
  const unsigned hmask = static_cast<unsigned>(lay.hash - 1);
  const float inf = __uint_as_float(0x7f800000u);

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < round_up(d, 128); i += kThreads)
    q[i] = i < d ? queries[row * d + i] : 0.f;
  for (int s = tid; s < ef; s += kThreads) {
    bd[s] = bd0[row * ef + s];
    bp[s] = bp0[row * ef + s];
    be[s] = 0;
  }
  for (int h = tid; h < lay.hash; h += kThreads) {
    hkey[h] = -1;
    htag[h] = 1;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // 1. the first `expand` unexpanded valid slots, in beam order: every
    //    warp finds the same ones (no barrier); warp 0 marks them
    //    expanded once all have read the beam
    int slot0 = -1, slot1 = -1;
    for (int base = 0, cnt = 0; base < ef && cnt < expand; base += 32) {
      const int s = base + lane;
      unsigned m = __ballot_sync(kFull, s < ef && bp[s] >= 0 && !be[s]);
      for (; m && cnt < expand; m &= m - 1, ++cnt) {
        const int s1 = base + __ffs(static_cast<int>(m)) - 1;
        if (cnt) slot1 = s1; else slot0 = s1;
      }
    }
    const int pid0 = slot0 >= 0 ? bp[slot0] : -1;
    const int pid1 = slot1 >= 0 ? bp[slot1] : -1;
    if (pid0 < 0) break;  // converged (block-uniform)
    if (tid == 0) npass = 0;

    // 2. stage the picked rows: ids and scales, then the first chunk of
    //    codes; meanwhile hash the beam's pids and, on the first step,
    //    rank the caller's beam by (dist, pid, slot)
    for (int e = 0; e < expand; ++e) {
      const int pid = e ? pid1 : pid0;
      if (pid < 0) continue;
      const size_t r = static_cast<size_t>(pid) * k;
      stage_bytes(nb + e * k, ids + r, 4 * k, tid, kThreads);
      stage_bytes(nd + e * k, scales + r, 4 * k, tid, kThreads);
    }
    cp_async_commit();
    stage_codes(stage, codes, d, k, ek, lay.cc, lay.dc, pid0, pid1, 0, 0,
                tid, kThreads);
    cp_async_commit();
    for (int s = tid; s < ef; s += kThreads)
      if (bp[s] >= 0) htag[hash_insert(hkey, hmask, bp[s])] = 0;
    if (it == 0) {
      for (int s = tid; s < ef; s += kThreads) {
        const unsigned long long ks = key_of(bd[s], bp[s]);
        int r = 0;
        for (int j = 0; j < ef; ++j) {
          const unsigned long long kj = key_of(bd[j], bp[j]);
          r += kj < ks || (kj == ks && j < s);
        }
        bd2[r] = bd[s];
        bp2[r] = bp[s];
        be2[r] = s == slot0 || s == slot1;
      }
    }
    cp_async_wait<1>();  // this thread's ids and scales
    __syncthreads();
    if (it == 0) {
      float* tf = bd; bd = bd2; bd2 = tf;
      int* ti = bp; bp = bp2; bp2 = ti;
      ti = be; be = be2; be2 = ti;
    } else if (tid == 0) {
      be[slot0] = 1;
      if (slot1 >= 0) be[slot1] = 1;
    }
    // the first row's dedup while the codes land: against the beam (with
    // two rows, inserting the row's pids for the second row)
    for (int c = tid; c < k; c += kThreads) {
      const int id = nb[c];
      if (id >= 0 && (expand > 1 ? htag[hash_insert(hkey, hmask, id)] == 0
                                 : hash_find(hkey, hmask, id)))
        nb[c] = -1;
    }
    cp_async_wait<0>();
    __syncthreads();

    // 3. score: a warp per kBatch candidates, chunk by chunk
    const bool words = (d & 3) == 0;
    if (lay.dc == d) {
      for (int c0 = 0; c0 < ekp; c0 += lay.cc) {
        if (c0) {
          __syncthreads();
          stage_codes(stage, codes, d, k, ek, lay.cc, lay.dc, pid0, pid1, c0,
                      0, tid, kThreads);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        const int g1 = min(c0 + lay.cc, ekp) / kBatch;
        for (int g = c0 / kBatch + warp; g < g1; g += kWarps) {
          float p[kBatch];
#pragma unroll
          for (int x = 0; x < kBatch; ++x) p[x] = 0.f;
          const uint8_t* rows = stage + (kBatch * g - c0) * d;
          if (words)
            score_rows<true>(p, rows, d, q, d, nd + kBatch * g, lane);
          else
            score_rows<false>(p, rows, d, q, d, nd + kBatch * g, lane);
          finish_group(p, g, ek, k, pid0, pid1, nd, nb, lane);
        }
      }
    } else {  // 32 rows times a slice of D at a time, 16 a warp
      const bool mine = warp < 32 / kBatch;
      for (int c0 = 0; c0 < ekp; c0 += 32) {
        const int g = c0 / kBatch + warp;
        float p[kBatch];
#pragma unroll
        for (int x = 0; x < kBatch; ++x) p[x] = 0.f;
        for (int d0 = 0; d0 < d; d0 += lay.dc) {
          if (c0 || d0) {
            __syncthreads();
            stage_codes(stage, codes, d, k, ek, lay.cc, lay.dc, pid0, pid1,
                        c0, d0, tid, kThreads);
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
          }
          if (!mine) continue;
          const uint8_t* rows = stage + kBatch * warp * lay.dc;
          const int dlen = min(lay.dc, d - d0);
          if (words)
            score_rows<true>(p, rows, lay.dc, q + d0, dlen, nd + kBatch * g,
                             lane);
          else
            score_rows<false>(p, rows, lay.dc, q + d0, dlen,
                              nd + kBatch * g, lane);
        }
        if (mine) finish_group(p, g, ek, k, pid0, pid1, nd, nb, lane);
      }
    }
    __syncthreads();

    // 4. the second row's dedup against the beam and the first row; the
    //    candidates that beat the beam's last entry, compacted per warp
    const unsigned long long last = key_of(bd[ef - 1], bp[ef - 1]);
    for (int base = 32 * warp; base < ekp; base += kThreads) {
      const int c = base + lane;
      bool pass = false;
      unsigned long long key = 0;
      if (c < ek) {
        int id = nb[c];
        if (id >= 0 && c >= k && hash_find(hkey, hmask, id)) {
          nd[c] = inf;
          nb[c] = id = -1;
        }
        key = key_of(nd[c], id);
        pass = key < last;
      }
      const unsigned m = __ballot_sync(kFull, pass);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&npass, __popc(m));
      at = __shfl_sync(kFull, at, 0);
      if (pass) keys[at + __popc(m & ((1u << lane) - 1u))] = key;
    }
    __syncthreads();
    const int npool = npass;

    // 5. sort the passing candidates, then give every beam entry and
    //    candidate its rank (merge path); up to 32 candidates each warp
    //    sorts them in registers, so no barrier
    if (npool > 0 && npool <= 32) {
      unsigned long long v = lane < npool ? keys[lane] : kMaxKey;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
          const bool low = ((lane & size) == 0) == ((lane & stride) == 0);
          v = low ? (o < v ? o : v) : (o > v ? o : v);
        }
      }
      for (int base = 32 * warp; base < ef; base += kThreads) {
        const int i = base + lane;  // beam slot i: before equal candidates
        const unsigned long long kb = i < ef ? key_of(bd[i], bp[i]) : 0;
        int lo = 0;  // candidates below kb, by binary lifting over lanes
#pragma unroll
        for (int step = 32; step > 0; step >>= 1) {
          const unsigned long long at =
              __shfl_sync(kFull, v, min(lo + step, 32) - 1);
          if (lo + step <= npool && at < kb) lo += step;
        }
        const int r = i + lo;
        if (i < ef && r < ef) {
          bd2[r] = bd[i];
          bp2[r] = bp[i];
          be2[r] = be[i];
        }
      }
      if (warp == 0 && lane < min(npool, ef))
        merge_candidate(v, lane, bd, bp, bd2, bp2, be2, ef);
    } else if (npool > 32) {
      const int pn = pow2_at_least(npool);
      for (int i = npool + tid; i < pn; i += kThreads) keys[i] = kMaxKey;
      __syncthreads();
      for (int size = 2; size <= pn; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int i = tid; i < pn / 2; i += kThreads) {
            const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
            const unsigned long long a = keys[lo], b = keys[lo + stride];
            if ((a > b) == ((lo & size) == 0)) {
              keys[lo] = b;
              keys[lo + stride] = a;
            }
          }
          __syncthreads();
        }
      }
      for (int i = tid; i < ef; i += kThreads) {
        const unsigned long long kb = key_of(bd[i], bp[i]);
        int lo = 0, hi = npool;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (keys[mid] < kb) lo = mid + 1; else hi = mid;
        }
        const int r = i + lo;
        if (r < ef) {
          bd2[r] = bd[i];
          bp2[r] = bp[i];
          be2[r] = be[i];
        }
      }
      for (int j = tid; j < min(npool, ef); j += kThreads)
        merge_candidate(keys[j], j, bd, bp, bd2, bp2, be2, ef);
    }
    for (int h = tid; h < lay.hash; h += kThreads) {
      hkey[h] = -1;
      htag[h] = 1;
    }
    __syncthreads();
    if (npool > 0) {
      float* tf = bd; bd = bd2; bd2 = tf;
      int* ti = bp; bp = bp2; bp2 = ti;
      ti = be; be = be2; be2 = ti;
    }
  }

  for (int s = tid; s < ef; s += kThreads) {
    bd_out[row * ef + s] = bd[s];
    bp_out[row * ef + s] = bp[s];
  }
}

bool valid(int d, int k, int ef, int expand, int stage_cap) {
  return d >= 1 && k >= 1 && ef >= 1 && ef <= kMaxEf && expand >= 1 &&
         expand <= kMaxExpand && expand * k <= kMaxPool &&
         stage_cap >= kMinStage;
}

}  // namespace

// Dynamic shared memory of one block, in bytes (-1 for a shape the
// kernel refuses).
extern "C" int idt_walk_smem(int d, int k, int ef, int expand,
                             int stage_cap) {
  return valid(d, k, ef, expand, stage_cap)
             ? Layout(d, k, ef, expand, stage_cap).bytes
             : -1;
}

// Blocks that one SM holds at once at this shape (0 on an error).
extern "C" int idt_walk_occupancy(int d, int k, int ef, int expand,
                                  int stage_cap) {
  if (!valid(d, k, ef, expand, stage_cap)) return 0;
  const int bytes = Layout(d, k, ef, expand, stage_cap).bytes;
  int n = 0;
  if (cudaFuncSetAttribute(walk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, walk_kernel,
                                                    kThreads, bytes) !=
          cudaSuccess)
    return 0;
  return n;
}

// Launches on `stream` with at most `stage_cap` bytes of staged codes a
// block; returns a CUDA error code as an int (0 = launched).  The
// wrapper has checked shapes, ef <= 256, expand <= 2 and expand * K <=
// 4096.
extern "C" int idt_walk_search(const void* queries, const void* bd0,
                               const void* bp0, const void* ids,
                               const void* codes, const void* scales,
                               void* bd_out, void* bp_out, int b, int d,
                               int k, int ef, int expand, int max_iters,
                               int stage_cap, void* stream) {
  if (!valid(d, k, ef, expand, stage_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(d, k, ef, expand, stage_cap);
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  walk_kernel<<<b, kThreads, lay.bytes, s>>>(
      static_cast<const float*>(queries), static_cast<const float*>(bd0),
      static_cast<const int32_t*>(bp0), static_cast<const int32_t*>(ids),
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<float*>(bd_out), static_cast<int32_t*>(bp_out), d, k, ef,
      expand, max_iters, stage_cap);
  return static_cast<int>(cudaGetLastError());
}
