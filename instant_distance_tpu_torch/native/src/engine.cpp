// Native host engine: multithreaded HNSW build + single/batch query.
//
// The PyTorch port's own copy of the host engine of
// instant_distance_tpu/native/src/engine.cpp, with the same C ABI: a
// from-scratch C++ implementation of the published HNSW algorithm
// (Malkov & Yashunin, Algs. 1-4) with the reference's construction
// recipe — fixed entry point 0, shuffle-sort layer assignment, geometric
// layer sizing, per-layer parallel insertion with per-node locks, and
// bridge-preserving neighbor selection.  It provides:
//   * fast host-side index builds (the card's wave builder is the
//     device-side path; this is the host path),
//   * host queries, one sequential beam search per query (the
//     reference's execution model), for small batches,
//   * graph export so host-built indices can be lifted to the card's
//     batched search engine, and graph import for host queries over a
//     graph built on the card.
//
// Exposed as a C ABI for ctypes (no pybind11 needed).  One change from
// the JAX package's copy: a thread count of 0 means every core on every
// call (team_size below), where that copy's omp_set_num_threads left a
// later 0 on the count of the call before.
//
// Build (instant_distance_tpu_torch/native/cpu.py does it at first use):
//   g++ -O3 -march=native -funroll-loops -fopenmp -shared -fPIC
//       -std=c++17 engine.cpp

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int32_t kInvalid = -1;

enum Metric : int32_t {
  kSqEuclidean = 0,
  kEuclidean = 1,
  kDot = 2,
  kCosine = 3,
};

struct Candidate {
  float d;
  uint32_t pid;
  bool operator<(const Candidate& o) const {
    return d != o.d ? d < o.d : pid < o.pid;
  }
  bool operator>(const Candidate& o) const { return o < *this; }
};

float distance(const float* a, const float* b, int64_t d, Metric metric) {
  switch (metric) {
    case kSqEuclidean:
    case kEuclidean: {
      float acc = 0.f;
      for (int64_t i = 0; i < d; i++) {
        float t = a[i] - b[i];
        acc += t * t;
      }
      return metric == kEuclidean ? std::sqrt(acc) : acc;
    }
    case kDot: {
      float acc = 0.f;
      for (int64_t i = 0; i < d; i++) acc += a[i] * b[i];
      return -acc;
    }
    case kCosine: {
      float ab = 0.f, aa = 0.f, bb = 0.f;
      for (int64_t i = 0; i < d; i++) {
        ab += a[i] * b[i];
        aa += a[i] * a[i];
        bb += b[i] * b[i];
      }
      float den = std::sqrt(aa) * std::sqrt(bb);
      return den > 0.f ? 1.f - ab / den : 1.f;
    }
  }
  return 0.f;
}

// Epoch-cleared visited set (the reference's Visited, types.rs:13-59).
struct Visited {
  std::vector<uint32_t> gen;
  uint32_t cur = 0;
  void reset(size_t n) {
    if (gen.size() < n) gen.assign(n, 0);
    cur++;
  }
  bool insert(uint32_t pid) {
    if (gen[pid] == cur) return false;
    gen[pid] = cur;
    return true;
  }
};

// Per-thread search scratch (the reference's Search, lib.rs:556-574).
struct SearchState {
  Visited visited;
  std::priority_queue<Candidate, std::vector<Candidate>,
                      std::greater<Candidate>>
      candidates;
  std::vector<Candidate> nearest;  // sorted ascending
  size_t ef = 1;

  void reset(size_t n) {
    visited.reset(n);
    candidates = {};
    nearest.clear();
  }

  void push(uint32_t pid, const float* q, const float* pts, int64_t dim,
            Metric metric) {
    if (!visited.insert(pid)) return;
    Candidate c{distance(q, pts + int64_t(pid) * dim, dim, metric), pid};
    auto it = std::lower_bound(nearest.begin(), nearest.end(), c);
    size_t idx = size_t(it - nearest.begin());
    if (idx >= ef) return;
    nearest.insert(it, c);
    candidates.push(c);
  }

  // Paper Alg. 2 expansion loop over one layer.
  void search(const float* q, const int32_t* adj, int row_w, int links,
              const float* pts, int64_t dim, size_t n, Metric metric) {
    while (!candidates.empty()) {
      Candidate c = candidates.top();
      candidates.pop();
      if (!nearest.empty() && c.d > nearest.back().d) break;
      const int32_t* row = adj + int64_t(c.pid) * row_w;
      // links may exceed row_w (the reference passes M*2 even to M-wide
      // upper layers, lib.rs:445; its iterator stops at the slice end)
      if (links > row_w) links = row_w;
      for (int i = 0; i < links; i++) {
        if (row[i] < 0) break;
        push(uint32_t(row[i]), q, pts, dim, metric);
      }
      if (nearest.size() > ef) nearest.resize(ef);
    }
  }

  void cull() {
    candidates = {};
    for (const Candidate& c : nearest) candidates.push(c);
    // visited generation restart: re-mark only the beam
    visited.cur++;
    for (const Candidate& c : nearest) visited.gen[c.pid] = visited.cur;
  }
};

struct Engine {
  int64_t n = 0, dim = 0;
  int m = 32, m0 = 64;
  int ef_construction = 100;
  Metric metric = kSqEuclidean;
  bool use_heuristic = true, extend_candidates = false, keep_pruned = true;

  std::vector<float> points;                  // [n, dim], pid order
  std::vector<uint32_t> ids;                  // original index -> pid
  std::vector<int32_t> zero;                  // [n, m0]
  std::vector<std::vector<int32_t>> layers;   // layers[l-1]: [end_l, m]
  std::vector<int64_t> layer_rows;
  std::vector<std::mutex> locks;

  const float* pt(uint32_t pid) const {
    return points.data() + int64_t(pid) * dim;
  }
};

// Paper Alg. 4 (lib.rs:636-698): keep a candidate iff no kept result is
// closer to it than the query; optionally backfill pruned ones.
void select_heuristic(const Engine& e, const float* q,
                      std::vector<Candidate>& cand,
                      std::vector<Candidate>& out) {
  out.clear();
  std::vector<Candidate> discarded;
  for (const Candidate& c : cand) {
    if (out.size() >= size_t(e.m0)) break;
    const float* cp = e.pt(c.pid);
    bool nearest = true;
    for (const Candidate& r : out) {
      if (distance(cp, e.pt(r.pid), e.dim, e.metric) < c.d) {
        nearest = false;
        break;
      }
    }
    (nearest ? out : discarded).push_back(c);
  }
  if (e.keep_pruned) {
    for (const Candidate& c : discarded) {
      if (out.size() >= size_t(e.m0)) break;
      out.push_back(c);
    }
  }
}

// Candidate-set extension (lib.rs:648-664) for extend_candidates.
void extend_cands(const Engine& e, const float* q, SearchState& s,
                  std::vector<Candidate>& cand) {
  size_t base = cand.size();
  for (size_t i = 0; i < base; i++) {
    const int32_t* row = e.zero.data() + int64_t(cand[i].pid) * e.m0;
    for (int j = 0; j < e.m0; j++) {
      if (row[j] < 0) break;
      uint32_t hop = uint32_t(row[j]);
      if (!s.visited.insert(hop)) continue;
      cand.push_back({distance(q, e.pt(hop), e.dim, e.metric), hop});
    }
  }
  std::sort(cand.begin(), cand.end());
}

// Insert one point (paper Alg. 1; the reference's Construction::insert,
// lib.rs:437-528) under per-node locks.
void insert_point(Engine& e, uint32_t new_pid, int layer, int top,
                  SearchState& search, SearchState& insertion) {
  const float* q = e.pt(new_pid);
  search.reset(size_t(e.n));
  search.ef = 1;
  search.push(0, q, e.points.data(), e.dim, e.metric);
  int links = layer == 0 ? e.m0 : e.m;

  for (int cur = top; cur >= 0; cur--) {
    search.ef = cur <= layer ? size_t(e.ef_construction) : 1;
    if (cur > layer) {
      search.search(q, e.layers[cur - 1].data(), e.m, links,
                    e.points.data(), e.dim, size_t(e.n), e.metric);
      search.cull();
    } else {
      // under-construction zero structure; rows are lock-guarded but we
      // read racily like the reference's RwLock read path does at the
      // algorithm level (stale rows only cost recall, never safety,
      // because rows are only ever valid pids or kInvalid).
      search.search(q, e.zero.data(), e.m0, links, e.points.data(), e.dim,
                    size_t(e.n), e.metric);
      break;
    }
  }

  std::vector<Candidate> found;
  if (e.use_heuristic) {
    std::vector<Candidate> cand = search.nearest;
    if (e.extend_candidates) extend_cands(e, q, search, cand);
    select_heuristic(e, q, cand, found);
  } else {
    found = search.nearest;
    if (found.size() > size_t(e.m0)) found.resize(size_t(e.m0));
  }

  {
    std::lock_guard<std::mutex> g(e.locks[new_pid]);
    int32_t* row = e.zero.data() + int64_t(new_pid) * e.m0;
    for (size_t i = 0; i < found.size(); i++) row[i] = int32_t(found[i].pid);
    for (size_t i = found.size(); i < size_t(e.m0); i++) row[i] = kInvalid;
  }

  // reverse edges (lib.rs:481-517)
  for (const Candidate& c : found) {
    uint32_t t = c.pid;
    const float* tp = e.pt(t);
    if (e.use_heuristic) {
      // re-select t's neighbors over {new} + current row
      std::vector<Candidate> cand;
      cand.push_back({c.d, new_pid});
      {
        std::lock_guard<std::mutex> g(e.locks[t]);
        const int32_t* row = e.zero.data() + int64_t(t) * e.m0;
        for (int i = 0; i < e.m0; i++) {
          if (row[i] < 0) break;
          uint32_t nb = uint32_t(row[i]);
          cand.push_back({distance(tp, e.pt(nb), e.dim, e.metric), nb});
        }
      }
      std::sort(cand.begin(), cand.end());
      if (cand.size() > size_t(e.ef_construction))
        cand.resize(size_t(e.ef_construction));
      std::vector<Candidate>& sel = insertion.nearest;  // reuse scratch
      select_heuristic(e, tp, cand, sel);
      std::lock_guard<std::mutex> g(e.locks[t]);
      int32_t* row = e.zero.data() + int64_t(t) * e.m0;
      for (size_t i = 0; i < sel.size(); i++) row[i] = int32_t(sel[i].pid);
      for (size_t i = sel.size(); i < size_t(e.m0); i++) row[i] = kInvalid;
    } else {
      // distance-sorted shift insert, keep nearest (see
      // utils/refimpl.py on the deviation from lib.rs:502-511)
      std::lock_guard<std::mutex> g(e.locks[t]);
      int32_t* row = e.zero.data() + int64_t(t) * e.m0;
      int idx = e.m0;
      for (int i = 0; i < e.m0; i++) {
        if (row[i] < 0 ||
            c.d < distance(tp, e.pt(uint32_t(row[i])), e.dim, e.metric)) {
          idx = i;
          break;
        }
      }
      if (idx >= e.m0) continue;
      if (row[idx] >= 0)
        std::memmove(row + idx + 1, row + idx,
                     sizeof(int32_t) * size_t(e.m0 - idx - 1));
      row[idx] = int32_t(new_pid);
    }
  }
}

// Threads of a parallel region: n_threads, or every core for 0.  Given as
// a num_threads clause, not with omp_set_num_threads: that setter
// persists, so one single-thread query would leave every later
// "all cores" build and query on one thread.
int team_size(int n_threads) {
#ifdef _OPENMP
  return n_threads > 0 ? n_threads : omp_get_num_procs();
#else
  (void)n_threads;
  return 1;
#endif
}

void build(Engine& e, const float* pts_in, int64_t n, int64_t dim,
           uint64_t seed, float ml, int n_threads) {
  e.n = n;
  e.dim = dim;
  e.ids.resize(size_t(n));
  if (n == 0) return;

  // layer sizing (lib.rs:238-250)
  std::vector<std::pair<int64_t, int64_t>> sizes;  // (size, cumulative)
  int64_t num = n;
  for (;;) {
    int64_t next = int64_t(float(num) * ml);
    if (next < e.m) break;
    sizes.push_back({num - next, num});
    num = next;
  }
  sizes.push_back({num, num});
  std::reverse(sizes.begin(), sizes.end());
  int top = int(sizes.size()) - 1;

  // shuffle-sort layer assignment (lib.rs:256-270)
  std::mt19937_64 rng(seed);
  std::vector<std::pair<uint32_t, uint32_t>> shuffled{size_t(n)};
  for (int64_t i = 0; i < n; i++)
    shuffled[size_t(i)] = {uint32_t(rng() % uint64_t(n)), uint32_t(i)};
  std::sort(shuffled.begin(), shuffled.end());
  e.points.resize(size_t(n * dim));
  for (int64_t i = 0; i < n; i++) {
    uint32_t src = shuffled[size_t(i)].second;
    e.ids[src] = uint32_t(i);
    std::memcpy(e.points.data() + i * dim, pts_in + int64_t(src) * dim,
                sizeof(float) * size_t(dim));
  }

  e.zero.assign(size_t(n) * size_t(e.m0), kInvalid);
  e.layers.assign(size_t(top), {});
  e.layer_rows.assign(size_t(top), 0);
  e.locks = std::vector<std::mutex>(size_t(n));

  const int nt = team_size(n_threads);
  for (int li = 0; li <= top; li++) {
    int layer = top - li;
    int64_t start = std::max<int64_t>(sizes[size_t(li)].second -
                                          sizes[size_t(li)].first,
                                      1);
    int64_t end = sizes[size_t(li)].second;
    if (layer == top) {
      SearchState s, ins;
      for (int64_t i = start; i < end; i++)
        insert_point(e, uint32_t(i), layer, top, s, ins);
    } else {
#pragma omp parallel num_threads(nt)
      {
        SearchState s, ins;
#pragma omp for schedule(dynamic, 16)
        for (int64_t i = start; i < end; i++)
          insert_point(e, uint32_t(i), layer, top, s, ins);
      }
    }
    if (layer > 0) {
      // truncated snapshot (UpperNode::from_zero, lib.rs:321-328)
      auto& snap = e.layers[size_t(layer - 1)];
      snap.resize(size_t(end) * size_t(e.m));
      e.layer_rows[size_t(layer - 1)] = end;
#pragma omp parallel for schedule(static) num_threads(nt)
      for (int64_t i = 0; i < end; i++)
        std::memcpy(snap.data() + i * e.m, e.zero.data() + i * e.m0,
                    sizeof(int32_t) * size_t(e.m));
    }
  }
}

void query(const Engine& e, const float* q, int ef, int k, SearchState& s,
           int32_t* out_ids, float* out_d) {
  for (int i = 0; i < k; i++) {
    out_ids[i] = -1;
    out_d[i] = INFINITY;
  }
  if (e.n == 0) return;
  s.reset(size_t(e.n));
  s.ef = 1;
  s.push(0, q, e.points.data(), e.dim, e.metric);
  int top = int(e.layers.size());
  for (int cur = top; cur >= 0; cur--) {
    if (cur == 0) {
      s.ef = size_t(ef);
      s.search(q, e.zero.data(), e.m0, e.m0, e.points.data(), e.dim,
               size_t(e.n), e.metric);
    } else {
      s.ef = 1;
      s.search(q, e.layers[size_t(cur - 1)].data(), e.m, e.m,
               e.points.data(), e.dim, size_t(e.n), e.metric);
      s.cull();
    }
  }
  int cnt = int(std::min(size_t(k), s.nearest.size()));
  for (int i = 0; i < cnt; i++) {
    out_ids[i] = int32_t(s.nearest[size_t(i)].pid);
    out_d[i] = s.nearest[size_t(i)].d;
  }
}

}  // namespace

extern "C" {

void* idtpu_build(const float* points, int64_t n, int64_t dim, int m,
                  int ef_construction, float ml, uint64_t seed,
                  int32_t metric, int use_heuristic, int extend_candidates,
                  int keep_pruned, int n_threads) {
  Engine* e = new Engine();
  e->m = m;
  e->m0 = 2 * m;
  e->ef_construction = ef_construction;
  e->metric = Metric(metric);
  e->use_heuristic = use_heuristic != 0;
  e->extend_candidates = extend_candidates != 0;
  e->keep_pruned = keep_pruned != 0;
  build(*e, points, n, dim, seed, ml, n_threads);
  return e;
}

void idtpu_free(void* h) { delete static_cast<Engine*>(h); }

int64_t idtpu_n(void* h) { return static_cast<Engine*>(h)->n; }
int64_t idtpu_dim(void* h) { return static_cast<Engine*>(h)->dim; }
int32_t idtpu_n_layers(void* h) {
  return int32_t(static_cast<Engine*>(h)->layers.size());
}
int64_t idtpu_layer_rows(void* h, int32_t l) {
  return static_cast<Engine*>(h)->layer_rows[size_t(l)];
}

void idtpu_export(void* h, float* points_out, uint32_t* ids_out,
                  int32_t* zero_out) {
  Engine* e = static_cast<Engine*>(h);
  if (points_out)
    std::memcpy(points_out, e->points.data(),
                sizeof(float) * e->points.size());
  if (ids_out)
    std::memcpy(ids_out, e->ids.data(), sizeof(uint32_t) * e->ids.size());
  if (zero_out)
    std::memcpy(zero_out, e->zero.data(), sizeof(int32_t) * e->zero.size());
}

void idtpu_export_layer(void* h, int32_t l, int32_t* out) {
  Engine* e = static_cast<Engine*>(h);
  std::memcpy(out, e->layers[size_t(l)].data(),
              sizeof(int32_t) * e->layers[size_t(l)].size());
}

// Batch query; n_threads == 1 measures the single-thread baseline, 0
// uses every core.
void idtpu_search(void* h, const float* queries, int64_t nq, int ef, int k,
                  int n_threads, int32_t* out_ids, float* out_d) {
  Engine* e = static_cast<Engine*>(h);
  const int nt = team_size(n_threads);
#pragma omp parallel num_threads(nt)
  {
    SearchState s;
#pragma omp for schedule(dynamic, 8)
    for (int64_t i = 0; i < nq; i++)
      query(*e, queries + i * e->dim, ef, k, s, out_ids + i * k,
            out_d + i * k);
  }
}

// Load an external graph (e.g. built on the card) for host-side queries.
void* idtpu_from_graph(const float* points, int64_t n, int64_t dim, int m,
                       int32_t metric, const int32_t* zero,
                       int32_t n_layers, const int64_t* layer_rows,
                       const int32_t* const* layer_ptrs) {
  Engine* e = new Engine();
  e->n = n;
  e->dim = dim;
  e->m = m;
  e->m0 = 2 * m;
  e->metric = Metric(metric);
  e->points.assign(points, points + n * dim);
  e->zero.assign(zero, zero + n * int64_t(e->m0));
  e->ids.resize(size_t(n));
  for (int64_t i = 0; i < n; i++) e->ids[size_t(i)] = uint32_t(i);
  e->layers.resize(size_t(n_layers));
  e->layer_rows.resize(size_t(n_layers));
  for (int32_t l = 0; l < n_layers; l++) {
    e->layer_rows[size_t(l)] = layer_rows[l];
    e->layers[size_t(l)].assign(layer_ptrs[l],
                                layer_ptrs[l] + layer_rows[l] * m);
  }
  return e;
}

}  // extern "C"
