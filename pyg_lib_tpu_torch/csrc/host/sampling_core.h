// Copied from pyg_lib_tpu/csrc/sampling_core.h (logic unchanged), so the port's
// engine draws the same samples as the JAX package's for the same seed.

// Shared host-sampling primitives (RNG, Mapper, IndexTracker, samplers).
//
// TPU-native re-design of the reference's sampling engine internals
// (reference pyg_lib/csrc/sampler/cpu/{mapper.h,index_tracker.h,
// neighbor_kernel.cpp}, csrc/random/cpu/rand_engine.h): same semantics,
// but with counter-based SplitMix64 streams derived from a user seed so
// results are reproducible independent of thread count and call order
// (SURVEY.md §7 hard part 3).
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <map>
#include <unordered_map>
#include <utility>
#include <vector>

namespace pygt {

// ---------------------------------------------------------------- RNG ----
// SplitMix64: tiny, fast, statistically solid for sampling. One stream per
// (seed, frontier position) so parallel workers draw independent streams.
struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t s) : state(s) {}
  inline uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // Uniform in [0, n) without modulo bias (Lemire reduction).
  inline uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * (__uint128_t)n;
    return (uint64_t)(m >> 64);
  }
  inline double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
};

// ----------------------------------------------------- FlatHashMap ----
// Minimal open-addressing (linear probing, power-of-2 capacity) uint64 ->
// int64 map. Replaces std::unordered_map in the per-neighbor dedup hot
// loop (the reference vendors parallel-hashmap for the same reason,
// csrc/sampler/cpu/mapper.h): ~3x fewer cache misses than the node-based
// std::unordered_map. EMPTY sentinel key = ~0ull (never produced by
// Mapper::key for valid ids).
struct FlatHashMap {
  static constexpr uint64_t EMPTY = ~0ULL;
  std::vector<uint64_t> keys_;
  std::vector<int64_t> vals_;
  size_t mask_ = 0, size_ = 0;

  void reserve_pow2(size_t cap) {
    size_t c = 16;
    while (c < cap * 2) c <<= 1;  // keep load factor <= 0.5
    keys_.assign(c, EMPTY);
    vals_.assign(c, 0);
    mask_ = c - 1;
  }

  inline void grow() {
    std::vector<uint64_t> ok = std::move(keys_);
    std::vector<int64_t> ov = std::move(vals_);
    keys_.assign(ok.size() * 2, EMPTY);
    vals_.assign(ov.size() * 2, 0);
    mask_ = keys_.size() - 1;
    for (size_t i = 0; i < ok.size(); ++i) {
      if (ok[i] == EMPTY) continue;
      size_t j = hash(ok[i]) & mask_;
      while (keys_[j] != EMPTY) j = (j + 1) & mask_;
      keys_[j] = ok[i];
      vals_[j] = ov[i];
    }
  }

  static inline size_t hash(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    return (size_t)x;
  }

  // Returns (value, inserted); inserts `fresh` when absent.
  inline std::pair<int64_t, bool> emplace(uint64_t k, int64_t fresh) {
    if (keys_.empty()) reserve_pow2(16);
    if (size_ * 2 >= keys_.size()) grow();
    size_t j = hash(k) & mask_;
    while (true) {
      if (keys_[j] == EMPTY) {
        keys_[j] = k;
        vals_[j] = fresh;
        size_++;
        return {fresh, true};
      }
      if (keys_[j] == k) return {vals_[j], false};
      j = (j + 1) & mask_;
    }
  }

  // Read-only probe: value for `k`, or -1 when absent.
  inline int64_t find(uint64_t k) const {
    if (keys_.empty()) return -1;
    size_t j = hash(k) & mask_;
    while (true) {
      if (keys_[j] == EMPTY) return -1;
      if (keys_[j] == k) return vals_[j];
      j = (j + 1) & mask_;
    }
  }
};

// ------------------------------------------------------------- Mapper ----
// Global->local id map; dense vector under a 4M heuristic (the reference
// uses 1e6, csrc/sampler/cpu/mapper.h:22-23 — 4M int64 = 32 MB, cheap on a
// sampling host), flat open-addressing map above or in disjoint mode.
// Disjoint keys pack (batch, node) into a single 64-bit word.
struct Mapper {
  int64_t num_nodes;
  bool use_vec;
  std::vector<int64_t> vec;  // -1 = absent
  FlatHashMap map;
  // Exact-keyed cold path for nodes outside [0, num_nodes).
  std::map<std::pair<int64_t, int64_t>, int64_t> rare;
  int64_t count = 0;

  explicit Mapper(int64_t n, bool disjoint) : num_nodes(n) {
    use_vec = !disjoint && n >= 0 && n <= 4000000;
    if (use_vec) vec.assign((size_t)n, -1);
  }

  // Injective (batch, node) packing for in-range nodes: batch * N + node.
  // (The previous shifted-XOR packing aliased batches above 2^24 and
  // node ids above 2^40.)
  inline uint64_t key(int64_t batch, int64_t node) const {
    return (uint64_t)batch * (uint64_t)num_nodes + (uint64_t)node;
  }

  // Returns (local_id, inserted). Nodes outside [0, num_nodes) — possible
  // when the caller's node-count estimate undershoots (e.g. hetero seed
  // ids beyond every edge endpoint) — go through an exact-keyed rare-path
  // map (cold; collision-free for any (batch, node), unlike any 64-bit
  // packing) instead of indexing past the dense vector.
  inline std::pair<int64_t, bool> insert(int64_t batch, int64_t node) {
    if (node < 0 || node >= num_nodes) {
      auto res = rare.emplace(std::make_pair(batch, node), count);
      if (res.second) count++;
      return {res.first->second, res.second};
    }
    if (use_vec) {
      int64_t& slot = vec[(size_t)node];
      if (slot >= 0) return {slot, false};
      slot = count++;
      return {slot, true};
    }
    auto res = map.emplace(key(batch, node), count);
    if (res.second) count++;
    return res;
  }

  // Read-only lookup: local id, or -1 when the node was never inserted
  // (the undirected induced-subgraph pass probes every neighbor of every
  // sampled node without mutating the map).
  inline int64_t lookup(int64_t batch, int64_t node) const {
    if (node < 0 || node >= num_nodes) {
      auto it = rare.find(std::make_pair(batch, node));
      return it == rare.end() ? -1 : it->second;
    }
    if (use_vec) return vec[(size_t)node];
    return map.find(key(batch, node));
  }
};

// ------------------------------------------------------- IndexTracker ----
// Seen-set for sampling w/o replacement (reference index_tracker.h:10-48):
// epoch-stamped bitvector; population per neighborhood is bounded by the
// degree so one resizable buffer serves every call without clearing.
struct IndexTracker {
  std::vector<int64_t> stamp;
  int64_t epoch = 0;
  void begin(size_t population) {
    if (stamp.size() < population) stamp.resize(population, -1);
    epoch++;
  }
  inline bool try_insert(int64_t i) {
    if (stamp[(size_t)i] == epoch) return false;
    stamp[(size_t)i] = epoch;
    return true;
  }
};

// ------------------------------------------------------- Alias table ----
// Walker alias method (reference csrc/random/cpu/biased_sampling.h:53-130):
// O(population) build, O(1) per draw — wins over CDF binary search when
// many draws hit one neighborhood (large fanout with replacement).
struct AliasTable {
  std::vector<double> prob;
  std::vector<int64_t> alias;

  void build(const double* w, int64_t n) {
    prob.assign((size_t)n, 0.0);
    alias.assign((size_t)n, 0);
    double total = 0;
    for (int64_t i = 0; i < n; ++i) total += w[i];
    if (total <= 0) {
      for (int64_t i = 0; i < n; ++i) {
        prob[(size_t)i] = 1.0;
        alias[(size_t)i] = i;
      }
      return;
    }
    std::vector<double> scaled((size_t)n);
    std::vector<int64_t> small, large;
    for (int64_t i = 0; i < n; ++i) {
      scaled[(size_t)i] = w[i] * n / total;
      (scaled[(size_t)i] < 1.0 ? small : large).push_back(i);
    }
    while (!small.empty() && !large.empty()) {
      int64_t s = small.back(), l = large.back();
      small.pop_back();
      large.pop_back();
      prob[(size_t)s] = scaled[(size_t)s];
      alias[(size_t)s] = l;
      scaled[(size_t)l] = scaled[(size_t)l] + scaled[(size_t)s] - 1.0;
      (scaled[(size_t)l] < 1.0 ? small : large).push_back(l);
    }
    for (int64_t s : small) prob[(size_t)s] = 1.0;
    for (int64_t l : large) prob[(size_t)l] = 1.0;
  }

  inline int64_t draw(SplitMix64& rng) {
    int64_t i = (int64_t)rng.bounded((uint64_t)prob.size());
    return rng.uniform() < prob[(size_t)i] ? i : alias[(size_t)i];
  }
};

// Sample `count` offsets within [0, population) into `out`. Mirrors the
// reference _sample cases (neighbor_kernel.cpp:185-243): full neighborhood
// when count < 0 or count >= population (w/o replacement), bounded draws
// with replacement, else partial Fisher-Yates over the seen-set.
inline void sample_offsets(SplitMix64& rng, IndexTracker& tracker,
                           int64_t population, int64_t count, bool replace,
                           std::vector<int64_t>& out) {
  out.clear();
  if (count < 0 || (!replace && count >= population)) {
    out.resize((size_t)population);
    for (int64_t i = 0; i < population; ++i) out[(size_t)i] = i;
  } else if (replace) {
    out.resize((size_t)count);
    for (int64_t i = 0; i < count; ++i)
      out[(size_t)i] = (int64_t)rng.bounded((uint64_t)population);
  } else {
    tracker.begin((size_t)population);
    out.reserve((size_t)count);
    for (int64_t i = population - count; i < population; ++i) {
      int64_t rnd = (int64_t)rng.bounded((uint64_t)(i + 1));
      if (!tracker.try_insert(rnd)) {
        rnd = i;
        tracker.try_insert(i);
      }
      out.push_back(rnd);
    }
  }
}

// Biased variant (reference _biased_sample, neighbor_kernel.cpp:245-285):
// CDF inversion with replacement, Efraimidis-Spirakis top-k without.
inline void biased_sample_offsets(SplitMix64& rng, const double* w,
                                  int64_t population, int64_t count,
                                  bool replace, std::vector<int64_t>& out,
                                  std::vector<double>& scratch) {
  out.clear();
  if (count < 0 || (!replace && count >= population)) {
    out.resize((size_t)population);
    for (int64_t i = 0; i < population; ++i) out[(size_t)i] = i;
    return;
  }
  if (replace) {
    if (count >= 4 * population && population >= 8) {
      // Many draws per neighborhood: amortise an O(population) alias
      // table for O(1) draws (reference biased_sampling.h:53-130).
      AliasTable table;
      table.build(w, population);
      for (int64_t i = 0; i < count; ++i) out.push_back(table.draw(rng));
      return;
    }
    scratch.resize((size_t)population);
    double acc = 0;
    for (int64_t i = 0; i < population; ++i) {
      acc += w[i];
      scratch[(size_t)i] = acc;
    }
    if (acc <= 0) {  // all-zero window: uniform fallback (matches alias)
      for (int64_t i = 0; i < count; ++i)
        out.push_back((int64_t)rng.bounded((uint64_t)population));
      return;
    }
    for (int64_t i = 0; i < count; ++i) {
      double u = rng.uniform() * acc;
      auto it = std::upper_bound(scratch.begin(), scratch.end(), u);
      // u == acc (or fp round-up) would land one past the last element.
      int64_t off = it - scratch.begin();
      out.push_back(off < population ? off : population - 1);
    }
  } else {
    scratch.resize((size_t)population);
    std::vector<int64_t> idx((size_t)population);
    for (int64_t i = 0; i < population; ++i) {
      double wi = w[i];
      scratch[(size_t)i] =
          wi > 0 ? std::log(rng.uniform()) / wi
                 : -std::numeric_limits<double>::infinity();
      idx[(size_t)i] = i;
    }
    std::partial_sort(idx.begin(), idx.begin() + count, idx.end(),
                      [&](int64_t a, int64_t b) {
                        return scratch[(size_t)a] > scratch[(size_t)b];
                      });
    out.assign(idx.begin(), idx.begin() + count);
  }
}

// Narrow [row_start, row_end) to edges no later than seed time `st`
// (reference node_temporal_sample :74-108 / edge_temporal_sample :110-144;
// binary search assumes time-sorted neighborhoods). `temporal_last` keeps
// only the most recent `count` (temporal_strategy == "last").
inline void temporal_window(const int64_t* node_time, const int64_t* edge_time,
                            const int64_t* col, int64_t st, bool temporal_last,
                            int64_t count, int64_t& row_start,
                            int64_t& row_end) {
  if (edge_time) {
    const int64_t* t = edge_time;
    row_end = std::upper_bound(t + row_start, t + row_end, st) - t;
  } else {
    const int64_t* t = node_time;
    int64_t lo = row_start, hi = row_end;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (t[col[mid]] <= st) lo = mid + 1; else hi = mid;
    }
    row_end = lo;
  }
  if (temporal_last && count >= 0)
    row_start = std::max(row_start, row_end - count);
}

// Deterministic per-site RNG stream: invariant to thread schedule.
inline SplitMix64 site_rng(uint64_t seed, uint64_t k, uint64_t ell,
                           uint64_t i, uint64_t v) {
  return SplitMix64(seed * 0x9e3779b97f4a7c15ULL + k * 0xff51afd7ed558ccdULL +
                    i * 0x100000001b3ULL + ell * 0x1000193ULL + v);
}

}  // namespace pygt
