// Port of pyg_lib_tpu/csrc/sampler.cpp. The draws are the JAX package's
// (the same streams, offsets and insertion order), so the port's engine
// draws the same samples for the same seed; the loop that starts the
// loads, the state kept between calls and the padded hand-over are the
// port's own.

// Host-side homogeneous neighbor sampling engine (C++ fast path).
//
// TPU-native re-design of the reference sampling engine
// (reference pyg_lib/csrc/sampler/cpu/neighbor_kernel.cpp): same sampling
// semantics — uniform full/replacement/without-replacement (partial
// Fisher-Yates over a seen-set), biased (Efraimidis-Spirakis for
// without-replacement, CDF inversion for replacement), node-/edge-temporal
// via binary search over time-sorted neighborhoods, disjoint (batch, node)
// keys — but with a counter-based RNG (SplitMix64 streams derived from a
// user seed) so results are reproducible independent of thread count and
// call order (SURVEY.md §7 hard part 3; the reference depends on ATen's
// global RNG sequence).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). A call
// samples into a workspace taken from a pool (its map, seen-set and
// output arenas keep their memory from call to call); the caller reads
// the sizes, copies the arrays out or writes the padded batch, and frees
// the handle, which returns the workspace to the pool.

#include <cstring>
#include <mutex>

#include "sampling_core.h"

using namespace pygt;

namespace {

// A sample's arrays. Directed sampling (not distributed) keeps the
// edges' destinations, the frontier index i of each, as `dst_end`: the
// edge count once node i was expanded, so edges [dst_end[i - 1],
// dst_end[i]) go to i, and `rows` stays empty. The induced pass of
// undirected sampling writes `rows`; distributed sampling writes there
// the nodes counted after each frontier node. `batches` is written for
// disjoint sampling only (else every batch is 0).
struct Outputs {
  std::vector<int64_t> rows, cols, eids, nodes, batches, dst_end;
  std::vector<int64_t> nodes_per_hop, edges_per_hop;

  void clear() {
    for (auto* v : {&rows, &cols, &eids, &nodes, &batches, &dst_end,
                    &nodes_per_hop, &edges_per_hop})
      v->clear();
  }

  // The edge count (distributed: the nodes counted a frontier node).
  size_t num_rows() const {
    return dst_end.empty() ? rows.size() : cols.size();
  }

  // The edges' destinations into `out`, from dst_end (T int32 or int64).
  template <typename T>
  void expand_rows(T* out) const {
    size_t k = 0;
    for (size_t i = 0; i < dst_end.size(); ++i)
      for (const size_t stop = (size_t)dst_end[i]; k < stop; ++k)
        out[k] = (T)i;
  }
};

// Global->local id map kept between calls: Mapper's ids (insertion order)
// and its split (a dense slot array for up to 4M nodes without disjoint
// batches, open addressing on (batch, node) keys otherwise, an exact map
// for nodes outside [0, num_nodes)), but emptied in O(1) or in what the
// call set: a dense slot holds (call << 32 | local id) and counts only
// for the call that wrote it; the hash slots a call filled are listed.
struct LocalMap {
  static constexpr int64_t kDenseNodes = 4000000;
  static constexpr uint64_t kEmpty = FlatHashMap::EMPTY;
  int64_t num_nodes = 0, count = 0;
  bool dense = false;
  uint64_t call = 0;  // the dense slots' current call (never 0)
  std::vector<uint64_t> slot;
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  std::vector<size_t> used;  // the hash slots this call filled
  size_t mask = 0;
  std::map<std::pair<int64_t, int64_t>, int64_t> rare;

  void begin(int64_t n, bool disjoint) {
    num_nodes = n;
    count = 0;
    dense = !disjoint && n >= 0 && n <= kDenseNodes;
    if (dense) {
      if (++call >> 32) {  // 2^32 calls: clear every slot once
        std::fill(slot.begin(), slot.end(), 0);
        call = 1;
      }
      if (slot.size() < (size_t)n) slot.resize((size_t)n, 0);
    } else if (keys.empty()) {
      keys.assign(16, kEmpty);
      vals.assign(16, 0);
      mask = 15;
    }
  }

  inline uint64_t key(int64_t batch, int64_t node) const {
    return (uint64_t)batch * (uint64_t)num_nodes + (uint64_t)node;
  }

  inline void prefetch(int64_t batch, int64_t node) const {
    if (node < 0 || node >= num_nodes) return;
    if (dense) {
      __builtin_prefetch(slot.data() + node, 1);
      return;
    }
    const size_t j = FlatHashMap::hash(key(batch, node)) & mask;
    __builtin_prefetch(keys.data() + j, 1);
    __builtin_prefetch(vals.data() + j, 1);
  }

  // Returns (local_id, inserted), as Mapper::insert. A dense slot keeps
  // 32 bits of id: a sample holds fewer than 2^32 nodes.
  inline std::pair<int64_t, bool> insert(int64_t batch, int64_t node) {
    if (node < 0 || node >= num_nodes) {
      auto res = rare.emplace(std::make_pair(batch, node), count);
      if (res.second) count++;
      return {res.first->second, res.second};
    }
    if (dense) {
      uint64_t& s = slot[(size_t)node];
      if (s >> 32 == call) return {(int64_t)(uint32_t)s, false};
      s = call << 32 | (uint64_t)count;
      return {count++, true};
    }
    if (used.size() * 2 >= keys.size()) grow();
    const uint64_t k = key(batch, node);
    for (size_t j = FlatHashMap::hash(k) & mask;; j = (j + 1) & mask) {
      if (keys[j] == kEmpty) {
        keys[j] = k;
        vals[j] = count;
        used.push_back(j);
        return {count++, true};
      }
      if (keys[j] == k) return {vals[j], false};
    }
  }

  // Local id, or -1 when the node was never inserted.
  inline int64_t lookup(int64_t batch, int64_t node) const {
    if (node < 0 || node >= num_nodes) {
      auto it = rare.find(std::make_pair(batch, node));
      return it == rare.end() ? -1 : it->second;
    }
    if (dense) {
      const uint64_t s = slot[(size_t)node];
      return s >> 32 == call ? (int64_t)(uint32_t)s : -1;
    }
    const uint64_t k = key(batch, node);
    for (size_t j = FlatHashMap::hash(k) & mask;; j = (j + 1) & mask) {
      if (keys[j] == kEmpty) return -1;
      if (keys[j] == k) return vals[j];
    }
  }

  void grow() {
    std::vector<uint64_t> ok(keys.size() * 2, kEmpty);
    std::vector<int64_t> ov(keys.size() * 2, 0);
    ok.swap(keys);
    ov.swap(vals);
    mask = keys.size() - 1;
    for (size_t& u : used) {
      size_t j = FlatHashMap::hash(ok[u]) & mask;
      while (keys[j] != kEmpty) j = (j + 1) & mask;
      keys[j] = ok[u];
      vals[j] = ov[u];
      u = j;
    }
  }

  // Empty again, for the next call.
  void end() {
    for (size_t j : used) keys[j] = kEmpty;
    used.clear();
    rare.clear();
  }
};

struct SampleArgs {
  const int64_t* rowptr;
  const int64_t* col;
  int64_t num_nodes;
  const int64_t* seed;
  int64_t num_seed;
  const int64_t* fanouts;
  int64_t num_hops;
  const double* edge_weight;    // nullable
  const int64_t* node_time;     // nullable
  const int64_t* edge_time;     // nullable
  const int64_t* seed_time;     // nullable
  bool replace;
  bool directed;  // false: discard hop edges, emit the induced subgraph
  bool disjoint;
  bool temporal_last;  // temporal_strategy == "last"
  bool return_edge_id;
  bool distributed;  // one-hop, no relabel, keep duplicates
  uint64_t rng_seed;
};

// A hop's frontier goes in chunks of about kStageEdges draws, through a
// pipeline of three steps: chunk t draws its offsets (prefetching each
// col[e]) while chunk t-1 loads its neighbours (prefetching each map
// slot) and chunk t-2 inserts and emits, in draw order. Each load thus has
// a chunk's time to arrive, and a chunk's misses overlap instead of
// waiting one after another. The order of the draws, the inserts and so
// the local ids is the plain loop's.
constexpr int64_t kStageEdges = 128;
constexpr size_t kFullChunk = 8;  // frontier nodes a chunk, fanout -1

inline size_t chunk_width(int64_t count) {
  if (count <= 0) return kFullChunk;
  return (size_t)std::max<int64_t>(1, kStageEdges / count);
}

// One chunk's draws: the frontier range, the edge ids in draw order, the
// neighbour each reads, and where each frontier node's draws end.
struct Stage {
  size_t c = 0, c_end = 0;
  std::vector<int64_t> edge, nbr;
  std::vector<size_t> end;
};

}  // namespace

extern "C" {

// The engine's state for one call, kept in a pool between calls: the
// outputs' arenas, the map, the seen-set and the staging buffers.
struct SampleResult {
  Outputs o;
  LocalMap map;
  IndexTracker tracker;
  std::vector<int64_t> offs, seed_times;
  std::vector<double> scratch;
  Stage stage[3];  // the pipeline's chunks
  bool dst_order = false;  // directed, not distributed: o.dst_end
};

}  // extern "C"

namespace {

std::mutex g_pool_mu;
std::vector<SampleResult*> g_pool;
constexpr size_t kPoolMax = 64;

SampleResult* acquire() {
  {
    std::lock_guard<std::mutex> lock(g_pool_mu);
    if (!g_pool.empty()) {
      SampleResult* r = g_pool.back();
      g_pool.pop_back();
      return r;
    }
  }
  return new SampleResult();
}

void release(SampleResult* r) {
  {
    std::lock_guard<std::mutex> lock(g_pool_mu);
    if (g_pool.size() < kPoolMax) {
      g_pool.push_back(r);
      return;
    }
  }
  delete r;
}

// Layer-by-layer frontier expansion (reference sample<> routine,
// neighbor_kernel.cpp:332-514) with a begin/end sliding window over the
// flat sampled-nodes vector, a hop's frontier taken in chunks of
// chunk_width nodes.
// Returns false on invalid input (out-of-range seed id, or temporal mode
// without disjoint — which would read an empty seed_times vector). The
// Python layer rejects both before calling, but the C ABI must not be one
// caller away from UB.
bool run_sample(const SampleArgs& a, SampleResult& ws) {
  const bool temporal = a.node_time || a.edge_time;
  if (temporal && !a.disjoint) return false;
  // Undirected (induced-subgraph) mode composes with neither disjoint
  // batching nor the distributed one-hop contract (reference intent:
  // neighbor_kernel.cpp:501-506 TORCH_CHECKs). Python rejects first.
  if (!a.directed && (a.disjoint || a.distributed)) return false;
  for (int64_t i = 0; i < a.num_seed; ++i)
    if (a.seed[i] < 0 || a.seed[i] >= a.num_nodes) return false;
  Outputs& o = ws.o;
  o.clear();
  ws.dst_order = a.directed && !a.distributed;
  LocalMap& mapper = ws.map;
  mapper.begin(a.num_nodes, a.disjoint);
  std::vector<int64_t>& seed_times = ws.seed_times;
  seed_times.clear();

  for (int64_t i = 0; i < a.num_seed; ++i) {
    int64_t b = a.disjoint ? i : 0;
    auto res = mapper.insert(b, a.seed[i]);
    if (res.second || a.distributed) {
      o.nodes.push_back(a.seed[i]);
      if (a.disjoint) o.batches.push_back(b);
    }
  }
  if (a.disjoint && temporal) {
    for (int64_t i = 0; i < a.num_seed; ++i)
      seed_times.push_back(a.seed_time ? a.seed_time[i]
                                       : a.node_time[a.seed[i]]);
  }
  o.nodes_per_hop.push_back((int64_t)o.nodes.size());

  size_t begin = 0, end = o.nodes.size();
  for (int64_t ell = 0; ell < a.num_hops; ++ell) {
    const int64_t count = a.fanouts[ell];
    const size_t width = chunk_width(count);
    const size_t chunks = (end - begin + width - 1) / width;
    int64_t hop_edges = 0;

    // Draw: each node's offsets from its own stream, in frontier order.
    auto draw = [&](Stage& st, size_t c) {
      st.c = c;
      st.c_end = std::min(c + width, end);
      st.edge.clear();
      st.end.clear();
      for (size_t i = c; i < st.c_end; ++i) {
        if (i + width < end) __builtin_prefetch(a.rowptr + o.nodes[i + width]);
        const int64_t v = o.nodes[i];
        const int64_t b = a.disjoint ? o.batches[i] : 0;
        int64_t row_start = a.rowptr[v], row_end = a.rowptr[v + 1];
        bool skip = (row_end == row_start || count == 0);
        if (!skip && temporal) {
          const int64_t st_time = seed_times[(size_t)b];
          temporal_window(a.node_time, a.edge_time, a.col, st_time,
                          a.temporal_last, count, row_start, row_end);
          skip = row_end <= row_start;
        }
        if (!skip) {
          const int64_t population = row_end - row_start;
          SplitMix64 rng = site_rng(a.rng_seed, 0, (uint64_t)ell,
                                    (uint64_t)i, (uint64_t)v);
          if (a.edge_weight) {
            biased_sample_offsets(rng, a.edge_weight + row_start, population,
                                  count, a.replace, ws.offs, ws.scratch);
          } else {
            sample_offsets(rng, ws.tracker, population, count, a.replace,
                           ws.offs);
          }
          for (int64_t off : ws.offs) {
            const int64_t e = row_start + off;
            __builtin_prefetch(a.col + e);
            st.edge.push_back(e);
          }
        }
        st.end.push_back(st.edge.size());
      }
    };
    // Load: the neighbours, prefetching their map slots.
    auto load = [&](Stage& st) {
      st.nbr.resize(st.edge.size());
      size_t k = 0;
      for (size_t i = st.c; i < st.c_end; ++i) {
        const int64_t b = a.disjoint ? o.batches[i] : 0;
        for (const size_t stop = st.end[i - st.c]; k < stop; ++k) {
          st.nbr[k] = a.col[st.edge[k]];
          if (!a.distributed) mapper.prefetch(b, st.nbr[k]);
        }
      }
    };
    // Insert and emit, in draw order.
    auto emit = [&](const Stage& st) {
      size_t k = 0;
      for (size_t i = st.c; i < st.c_end; ++i) {
        const int64_t b = a.disjoint ? o.batches[i] : 0;
        for (const size_t stop = st.end[i - st.c]; k < stop; ++k) {
          const int64_t e = st.edge[k], w = st.nbr[k];
          if (a.distributed) {
            o.nodes.push_back(w);
            if (a.return_edge_id) o.eids.push_back(e);
            hop_edges++;
            continue;
          }
          auto res = mapper.insert(b, w);
          if (res.second) {
            o.nodes.push_back(w);
            if (a.disjoint) o.batches.push_back(b);
          }
          if (!a.directed) continue;  // induced pass emits edges later
          hop_edges++;
          o.cols.push_back(res.first);
          if (a.return_edge_id) o.eids.push_back(e);
        }
        if (ws.dst_order) o.dst_end.push_back((int64_t)o.cols.size());
        // Distributed contract: per-frontier-node cumulative node count
        // (reference cumsum_neighbors_per_node, neighbor.cpp:99-127). The
        // rows vector is unused in distributed mode and carries it out.
        if (a.distributed) o.rows.push_back((int64_t)o.nodes.size());
      }
    };
    for (size_t t = 0; t < chunks + 2; ++t) {
      if (t < chunks) draw(ws.stage[t % 3], begin + t * width);
      if (t >= 1 && t - 1 < chunks) load(ws.stage[(t - 1) % 3]);
      if (t >= 2) emit(ws.stage[(t - 2) % 3]);
    }
    begin = end;
    end = o.nodes.size();
    o.nodes_per_hop.push_back((int64_t)(end - begin));
    if (a.directed) o.edges_per_hop.push_back(hop_edges);
  }

  if (!a.directed) {
    // Induced-subgraph pass (the reference DOCUMENTS this semantics —
    // pyg_lib/sampler/__init__.py:69 "include all edges between all
    // sampled nodes" — but its kernel TORCH_CHECKs it away,
    // neighbor_kernel.cpp:501; implemented here): every CSR slot whose
    // endpoint was sampled becomes a local edge, in local-row order.
    // Per-hop attribution is meaningless for induced edges, so
    // edges_per_hop carries ONE entry: the induced edge count.
    for (size_t i = 0; i < o.nodes.size(); ++i) {
      const int64_t v = o.nodes[i];
      for (int64_t e = a.rowptr[v]; e < a.rowptr[v + 1]; ++e) {
        const int64_t loc = mapper.lookup(0, a.col[e]);
        if (loc < 0) continue;
        o.rows.push_back((int64_t)i);
        o.cols.push_back(loc);
        if (a.return_edge_id) o.eids.push_back(e);
      }
    }
    o.edges_per_hop.push_back((int64_t)o.rows.size());
  }
  mapper.end();
  return true;
}

}  // namespace

extern "C" {

// Handle workflow: call pygt_neighbor_sample once, read sizes, then copy
// out (or pad) and free.
SampleResult* pygt_neighbor_sample(
    const int64_t* rowptr, const int64_t* col, int64_t num_nodes,
    const int64_t* seed, int64_t num_seed, const int64_t* fanouts,
    int64_t num_hops, const double* edge_weight, const int64_t* node_time,
    const int64_t* edge_time, const int64_t* seed_time, int32_t replace,
    int32_t directed, int32_t disjoint, int32_t temporal_last,
    int32_t return_edge_id, int32_t distributed, uint64_t rng_seed) {
  SampleResult* r = acquire();
  SampleArgs a{rowptr, col,       num_nodes,  seed,
               num_seed, fanouts, num_hops,   edge_weight,
               node_time, edge_time, seed_time, (bool)replace,
               (bool)directed, (bool)disjoint, (bool)temporal_last,
               (bool)return_edge_id, (bool)distributed, rng_seed};
  if (!run_sample(a, *r)) {
    release(r);
    return nullptr;  // Python wrapper raises on NULL.
  }
  return r;
}

void pygt_result_sizes(SampleResult* r, int64_t* sizes /* [5] */) {
  sizes[0] = (int64_t)r->o.num_rows();
  sizes[1] = (int64_t)r->o.nodes.size();
  sizes[2] = (int64_t)r->o.eids.size();
  sizes[3] = (int64_t)r->o.nodes_per_hop.size();
  sizes[4] = (int64_t)r->o.edges_per_hop.size();
}

void pygt_result_copy(SampleResult* r, int64_t* rows, int64_t* cols,
                      int64_t* eids, int64_t* nodes, int64_t* batches,
                      int64_t* nodes_per_hop, int64_t* edges_per_hop) {
  auto cp = [](const std::vector<int64_t>& v, int64_t* dst) {
    if (dst && !v.empty()) std::memcpy(dst, v.data(), v.size() * 8);
  };
  if (rows && !r->o.dst_end.empty()) r->o.expand_rows(rows);
  cp(r->o.rows, rows);
  cp(r->o.cols, cols);
  cp(r->o.eids, eids);
  cp(r->o.nodes, nodes);
  cp(r->o.batches, batches);
  if (batches && r->o.batches.empty())  // not disjoint: every batch is 0
    std::memset(batches, 0, r->o.nodes.size() * 8);
  cp(r->o.nodes_per_hop, nodes_per_hop);
  cp(r->o.edges_per_hop, edges_per_hop);
}

// The sample as a padded batch of max_nodes nodes and max_edges edges,
// for a sample whose edges come in destination order (directed, not
// distributed: the frontier index of o.dst_end never falls), as
// padding.pad_sample_output lays it out for csc=True: the edges' CSR over
// destinations (rowptr [max_nodes + 1]; the sort is the identity),
// row = the source, col = the destination, pads max_nodes; edge ids pad
// -1; node ids pad 0, batches -1; masks 1 for the real slots. edge_id and
// batch may be null (without edge ids or disjoint batches in the sample,
// they read -1 and 0). Returns 0, -1 if the sample does not fit, -2 if
// its edges are not in destination order (undirected or distributed).
int32_t pygt_result_pad(SampleResult* r, int64_t max_nodes,
                        int64_t max_edges, int64_t* node_id, int32_t* batch,
                        uint8_t* node_mask, int32_t* rowptr, int32_t* row,
                        int32_t* col, int64_t* edge_id, uint8_t* edge_mask) {
  const Outputs& o = r->o;
  const int64_t n = (int64_t)o.nodes.size(), e = (int64_t)o.cols.size();
  if (!r->dst_order) return -2;
  if (n > max_nodes || e > max_edges) return -1;
  std::memcpy(node_id, o.nodes.data(), (size_t)n * 8);
  std::fill(node_id + n, node_id + max_nodes, 0);
  std::memset(node_mask, 1, (size_t)n);
  std::memset(node_mask + n, 0, (size_t)(max_nodes - n));
  if (batch) {
    const bool disjoint = !o.batches.empty() || n == 0;
    for (int64_t k = 0; k < n; ++k)
      batch[k] = disjoint ? (int32_t)o.batches[(size_t)k] : 0;
    std::fill(batch + n, batch + max_nodes, -1);
  }
  const int64_t expanded = (int64_t)o.dst_end.size();
  rowptr[0] = 0;
  for (int64_t j = 0; j < max_nodes; ++j)
    rowptr[j + 1] = (int32_t)(j < expanded ? o.dst_end[(size_t)j] : e);
  for (int64_t k = 0; k < e; ++k) row[k] = (int32_t)o.cols[(size_t)k];
  o.expand_rows(col);
  std::fill(row + e, row + max_edges, (int32_t)max_nodes);
  std::fill(col + e, col + max_edges, (int32_t)max_nodes);
  if (edge_id) {
    const int64_t ne = std::min(e, (int64_t)o.eids.size());
    std::memcpy(edge_id, o.eids.data(), (size_t)ne * 8);
    std::fill(edge_id + ne, edge_id + max_edges, -1);
  }
  std::memset(edge_mask, 1, (size_t)e);
  std::memset(edge_mask + e, 0, (size_t)(max_edges - e));
  return 0;
}

void pygt_result_free(SampleResult* r) { release(r); }

}  // extern "C"
