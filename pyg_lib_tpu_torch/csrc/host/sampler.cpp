// Copied from pyg_lib_tpu/csrc/sampler.cpp (logic unchanged), so the port's
// engine draws the same samples as the JAX package's for the same seed.

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
// Exposed as a C ABI for ctypes (no pybind11 in this image). All buffers
// are caller-allocated numpy arrays; outputs are written into pre-sized
// arenas with returned counts.

#include <cstring>

#include "sampling_core.h"

using namespace pygt;

namespace {

struct Outputs {
  std::vector<int64_t> rows, cols, eids, nodes, batches;
  std::vector<int64_t> nodes_per_hop, edges_per_hop;
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

// Layer-by-layer frontier expansion (reference sample<> routine,
// neighbor_kernel.cpp:332-514) with a begin/end sliding window over the
// flat sampled-nodes vector.
// Returns false on invalid input (out-of-range seed id, or temporal mode
// without disjoint — which would read an empty seed_times vector). The
// Python layer rejects both before calling, but the C ABI must not be one
// caller away from UB.
bool run_sample(const SampleArgs& a, Outputs& o) {
  const bool temporal = a.node_time || a.edge_time;
  if (temporal && !a.disjoint) return false;
  // Undirected (induced-subgraph) mode composes with neither disjoint
  // batching nor the distributed one-hop contract (reference intent:
  // neighbor_kernel.cpp:501-506 TORCH_CHECKs). Python rejects first.
  if (!a.directed && (a.disjoint || a.distributed)) return false;
  for (int64_t i = 0; i < a.num_seed; ++i)
    if (a.seed[i] < 0 || a.seed[i] >= a.num_nodes) return false;
  Mapper mapper(a.num_nodes, a.disjoint);
  IndexTracker tracker;
  std::vector<int64_t> offs;
  std::vector<double> scratch;
  std::vector<int64_t> seed_times;

  for (int64_t i = 0; i < a.num_seed; ++i) {
    int64_t b = a.disjoint ? i : 0;
    auto res = mapper.insert(b, a.seed[i]);
    if (res.second || a.distributed) {
      o.nodes.push_back(a.seed[i]);
      o.batches.push_back(b);
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
    int64_t hop_edges = 0;
    for (size_t i = begin; i < end; ++i) {
      const int64_t v = o.nodes[i];
      const int64_t b = a.disjoint ? o.batches[i] : 0;
      int64_t row_start = a.rowptr[v], row_end = a.rowptr[v + 1];
      bool skip = (row_end == row_start || count == 0);
      if (!skip && temporal) {
        const int64_t st = seed_times[(size_t)b];
        temporal_window(a.node_time, a.edge_time, a.col, st, a.temporal_last,
                        count, row_start, row_end);
        skip = row_end <= row_start;
      }
      if (!skip) {
        const int64_t population = row_end - row_start;
        SplitMix64 rng = site_rng(a.rng_seed, 0, (uint64_t)ell, (uint64_t)i,
                                  (uint64_t)v);
        if (a.edge_weight) {
          biased_sample_offsets(rng, a.edge_weight + row_start, population,
                                count, a.replace, offs, scratch);
        } else {
          sample_offsets(rng, tracker, population, count, a.replace, offs);
        }
        for (int64_t off : offs) {
          const int64_t e = row_start + off;
          const int64_t w = a.col[e];
          if (a.distributed) {
            o.nodes.push_back(w);
            o.batches.push_back(b);
            if (a.return_edge_id) o.eids.push_back(e);
            hop_edges++;
            continue;
          }
          auto res = mapper.insert(b, w);
          if (res.second) {
            o.nodes.push_back(w);
            o.batches.push_back(b);
          }
          if (!a.directed) continue;  // induced pass emits edges later
          hop_edges++;
          o.rows.push_back((int64_t)i);
          o.cols.push_back(res.first);
          if (a.return_edge_id) o.eids.push_back(e);
        }
      }
      // Distributed contract: per-frontier-node cumulative node count
      // (reference cumsum_neighbors_per_node, neighbor.cpp:99-127). The
      // rows vector is unused in distributed mode and carries it out.
      if (a.distributed) o.rows.push_back((int64_t)o.nodes.size());
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
  return true;
}

}  // namespace

extern "C" {

// Opaque result handle workflow: call neighbor_sample_cpp once, read sizes,
// then copy out and free.
struct SampleResult {
  Outputs o;
};

SampleResult* pygt_neighbor_sample(
    const int64_t* rowptr, const int64_t* col, int64_t num_nodes,
    const int64_t* seed, int64_t num_seed, const int64_t* fanouts,
    int64_t num_hops, const double* edge_weight, const int64_t* node_time,
    const int64_t* edge_time, const int64_t* seed_time, int32_t replace,
    int32_t directed, int32_t disjoint, int32_t temporal_last,
    int32_t return_edge_id, int32_t distributed, uint64_t rng_seed) {
  auto* r = new SampleResult();
  SampleArgs a{rowptr, col,       num_nodes,  seed,
               num_seed, fanouts, num_hops,   edge_weight,
               node_time, edge_time, seed_time, (bool)replace,
               (bool)directed, (bool)disjoint, (bool)temporal_last,
               (bool)return_edge_id, (bool)distributed, rng_seed};
  if (!run_sample(a, r->o)) {
    delete r;
    return nullptr;  // Python wrapper raises on NULL.
  }
  return r;
}

void pygt_result_sizes(SampleResult* r, int64_t* sizes /* [5] */) {
  sizes[0] = (int64_t)r->o.rows.size();
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
  cp(r->o.rows, rows);
  cp(r->o.cols, cols);
  cp(r->o.eids, eids);
  cp(r->o.nodes, nodes);
  cp(r->o.batches, batches);
  cp(r->o.nodes_per_hop, nodes_per_hop);
  cp(r->o.edges_per_hop, edges_per_hop);
}

void pygt_result_free(SampleResult* r) { delete r; }

}  // extern "C"
