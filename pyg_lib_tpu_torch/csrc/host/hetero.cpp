// Copied from pyg_lib_tpu/csrc/hetero.cpp (logic unchanged), so the port's
// engine draws the same samples as the JAX package's for the same seed.

// Host-side heterogeneous neighbor sampling engine (C++ fast path).
//
// TPU-native re-design of the reference hetero sampling routine
// (reference pyg_lib/csrc/sampler/cpu/neighbor_kernel.cpp:518-841):
// per-(src, rel, dst) edge-type samplers sharing per-node-type Mappers;
// layer-synchronous frontier expansion with per-node-type slice windows;
// edge types grouped by dst node type so each OpenMP thread owns its dst
// Mapper exclusively (reference :635-663 uses at::parallel_for the same
// way). Disjoint batch ids increment globally across seed node types
// (reference :670-699). Counter-based SplitMix64 streams keyed by
// (seed, edge_type, hop, frontier position, node) make the output
// independent of the thread schedule — a property the reference lacks.
//
// Outputs are ordered exactly like the single-threaded numpy
// specification (pyg_lib_tpu/sampler/_hetero_impl.py): within one dst
// group, edge types are processed in input order, so Mapper insertion
// order — and hence all local ids — match the numpy path whenever the
// same offsets are drawn (e.g. full-neighborhood sampling).

#include <cstring>
#include <omp.h>

#include "sampling_core.h"

using namespace pygt;

namespace {

struct HeteroArgs {
  int64_t T;  // node types
  int64_t K;  // edge types
  const int32_t* src_type;  // [K]
  const int32_t* dst_type;  // [K]
  const int64_t* rowptr_cat;
  const int64_t* rowptr_off;  // [K+1]
  const int64_t* col_cat;
  const int64_t* col_off;  // [K+1]
  const int64_t* num_nodes;  // [T]
  const int64_t* seed_cat;
  const int64_t* seed_off;  // [T+1]
  const int64_t* fanouts;  // [K, L]
  int64_t L;
  const double* weight_cat;      // nullable, edge-aligned like col_cat
  const int64_t* node_time_cat;  // nullable, node-type aligned
  const int64_t* node_time_off;  // [T+1] when node_time_cat
  const int64_t* edge_time_cat;  // nullable, edge-aligned
  const int64_t* seed_time_cat;  // nullable, seed-aligned
  const int32_t* has_weight;     // [K] 0/1 (weight_cat slots valid?)
  const int32_t* has_edge_time;  // [K]
  const int32_t* has_node_time;  // [T]
  bool replace;
  bool directed;  // false: discard hop edges, emit per-type induced edges
  bool disjoint;
  bool temporal_last;
  bool return_edge_id;
  uint64_t rng_seed;
};

struct HeteroOutputs {
  // Per edge type.
  std::vector<std::vector<int64_t>> rows, cols, eids, edges_per_hop;
  // Per node type.
  std::vector<std::vector<int64_t>> nodes, batches, nodes_per_hop;
};

// Returns false on invalid input: a seed id outside its type's node_time
// segment would read past the concatenated time array (num_nodes is
// estimated from rowptr/col/node_time extents and can undershoot, so the
// estimate alone cannot make the lookup safe). The numpy specification
// raises IndexError for the same inputs. Seed ids beyond the rowptr
// estimate are otherwise VALID (isolated nodes): the Mapper routes them
// through its exact-keyed rare path and expansion skips them (v >= n_src
// below), matching the numpy spec.
bool run_hetero(const HeteroArgs& a, HeteroOutputs& o) {
  const bool temporal = a.node_time_cat || a.edge_time_cat;
  if (!a.directed && a.disjoint) return false;  // Python rejects first
  if (a.node_time_cat) {
    for (int64_t t = 0; t < a.T; ++t) {
      if (!a.has_node_time[t]) continue;
      const int64_t nt_len = a.node_time_off[t + 1] - a.node_time_off[t];
      for (int64_t i = a.seed_off[t]; i < a.seed_off[t + 1]; ++i) {
        const int64_t v = a.seed_cat[i];
        if (v < 0 || v >= nt_len) return false;
      }
    }
  }
  o.rows.resize(a.K);
  o.cols.resize(a.K);
  o.eids.resize(a.K);
  o.edges_per_hop.assign(a.K, {});
  o.nodes.resize(a.T);
  o.batches.resize(a.T);
  o.nodes_per_hop.assign(a.T, {});

  std::vector<Mapper> mappers;
  mappers.reserve(a.T);
  for (int64_t t = 0; t < a.T; ++t)
    mappers.emplace_back(a.num_nodes[t], a.disjoint);

  // Seed init: batch counter increments across node types in input order.
  std::vector<int64_t> seed_times;
  std::vector<std::pair<int64_t, int64_t>> slices(a.T, {0, 0});
  int64_t batch_idx = 0;
  for (int64_t t = 0; t < a.T; ++t) {
    const int64_t s0 = a.seed_off[t], s1 = a.seed_off[t + 1];
    for (int64_t i = s0; i < s1; ++i) {
      const int64_t v = a.seed_cat[i];
      const int64_t b = a.disjoint ? batch_idx : 0;
      auto res = mappers[t].insert(b, v);
      if (res.second) {
        o.nodes[t].push_back(v);
        o.batches[t].push_back(b);
      }
      if (a.disjoint) {
        if (a.seed_time_cat) {
          seed_times.push_back(a.seed_time_cat[i]);
        } else if (a.node_time_cat && a.has_node_time[t]) {
          seed_times.push_back(a.node_time_cat[a.node_time_off[t] + v]);
        } else if (temporal) {
          seed_times.push_back(INT64_MAX);
        }
        batch_idx++;
      }
    }
    slices[t] = {0, (int64_t)o.nodes[t].size()};
    o.nodes_per_hop[t].push_back((int64_t)o.nodes[t].size());
  }

  // Group edge types by dst type: each group is owned by one thread per
  // hop, so its dst Mapper and output vectors have a single writer.
  std::vector<std::vector<int64_t>> groups(a.T);
  for (int64_t k = 0; k < a.K; ++k) groups[(size_t)a.dst_type[k]].push_back(k);
  std::vector<int64_t> active;  // dst types with at least one edge type
  for (int64_t t = 0; t < a.T; ++t)
    if (!groups[(size_t)t].empty()) active.push_back(t);

  // Per-hop staging: new frontier nodes are appended to thread-private
  // buffers and merged after the parallel region, so no thread ever
  // reallocates a vector another thread is reading (the reference merges
  // the same way after its parallel_for, neighbor_kernel.cpp:801-806).
  std::vector<std::vector<int64_t>> stage_nodes(a.T), stage_batches(a.T);

  for (int64_t ell = 0; ell < a.L; ++ell) {
#pragma omp parallel
    {
      IndexTracker tracker;
      std::vector<int64_t> offs;
      std::vector<double> scratch;
#pragma omp for schedule(dynamic, 1)
      for (size_t gi = 0; gi < active.size(); ++gi) {
        const int64_t dst = active[gi];
        auto& new_nodes = stage_nodes[(size_t)dst];
        auto& new_batches = stage_batches[(size_t)dst];
        for (int64_t k : groups[(size_t)dst]) {
          const int64_t src = a.src_type[k];
          const int64_t count = a.fanouts[k * a.L + ell];
          const int64_t* rowptr = a.rowptr_cat + a.rowptr_off[k];
          const int64_t n_src = a.rowptr_off[k + 1] - a.rowptr_off[k] - 1;
          const int64_t* col = a.col_cat + a.col_off[k];
          const double* weight =
              a.has_weight[k] ? a.weight_cat + a.col_off[k] : nullptr;
          const int64_t* etime =
              a.has_edge_time[k] ? a.edge_time_cat + a.col_off[k] : nullptr;
          const int64_t* ntime = (a.node_time_cat && a.has_node_time[dst])
                                     ? a.node_time_cat + a.node_time_off[dst]
                                     : nullptr;
          const auto [begin, end] = slices[(size_t)src];
          int64_t hop_edges = 0;
          for (int64_t i = begin; i < end; ++i) {
            const int64_t v = o.nodes[(size_t)src][(size_t)i];
            if (v < 0 || v >= n_src) continue;  // no out-edges of this type
            const int64_t b =
                a.disjoint ? o.batches[(size_t)src][(size_t)i] : 0;
            int64_t row_start = rowptr[v], row_end = rowptr[v + 1];
            if (row_end == row_start || count == 0) continue;
            if (ntime || etime) {
              const int64_t st = seed_times[(size_t)b];
              temporal_window(ntime, etime, col, st, a.temporal_last, count,
                              row_start, row_end);
              if (row_end <= row_start) continue;
            }
            const int64_t population = row_end - row_start;
            SplitMix64 rng = site_rng(a.rng_seed, (uint64_t)(k + 1),
                                      (uint64_t)ell, (uint64_t)i, (uint64_t)v);
            if (weight) {
              biased_sample_offsets(rng, weight + row_start, population, count,
                                    a.replace, offs, scratch);
            } else {
              sample_offsets(rng, tracker, population, count, a.replace, offs);
            }
            for (int64_t off : offs) {
              const int64_t e = row_start + off;
              const int64_t w = col[e];
              auto res = mappers[(size_t)dst].insert(b, w);
              if (res.second) {
                new_nodes.push_back(w);
                new_batches.push_back(b);
              }
              if (!a.directed) continue;  // induced pass emits edges later
              hop_edges++;
              o.rows[(size_t)k].push_back(i);
              o.cols[(size_t)k].push_back(res.first);
              if (a.return_edge_id) o.eids[(size_t)k].push_back(e);
            }
          }
          if (a.directed) o.edges_per_hop[(size_t)k].push_back(hop_edges);
        }
      }
    }
    // Merge staged frontiers, then advance slices.
    for (int64_t t = 0; t < a.T; ++t) {
      auto& nn = stage_nodes[(size_t)t];
      auto& nb = stage_batches[(size_t)t];
      o.nodes[(size_t)t].insert(o.nodes[(size_t)t].end(), nn.begin(),
                                nn.end());
      o.batches[(size_t)t].insert(o.batches[(size_t)t].end(), nb.begin(),
                                  nb.end());
      nn.clear();
      nb.clear();
      slices[t] = {slices[t].second, (int64_t)o.nodes[(size_t)t].size()};
      o.nodes_per_hop[t].push_back(slices[t].second - slices[t].first);
    }
  }

  if (!a.directed) {
    // Per-edge-type induced-subgraph pass (reference-documented
    // undirected semantics, pyg_lib/sampler/__init__.py:69; its kernel
    // rejects it at neighbor_kernel.cpp:822): for every sampled src node
    // of type src(k), every type-k CSR slot whose endpoint was sampled
    // into dst(k)'s mapper becomes a local edge. edges_per_hop carries
    // ONE entry per type (hop attribution is meaningless here). Each
    // edge type is independent — parallelise over types.
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t k = 0; k < a.K; ++k) {
      const int64_t src = a.src_type[k], dst = a.dst_type[k];
      const int64_t* rowptr = a.rowptr_cat + a.rowptr_off[k];
      const int64_t n_src = a.rowptr_off[k + 1] - a.rowptr_off[k] - 1;
      const int64_t* col = a.col_cat + a.col_off[k];
      const auto& src_nodes = o.nodes[(size_t)src];
      const Mapper& dst_map = mappers[(size_t)dst];
      for (size_t i = 0; i < src_nodes.size(); ++i) {
        const int64_t v = src_nodes[i];
        if (v < 0 || v >= n_src) continue;  // no out-edges of this type
        for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
          const int64_t loc = dst_map.lookup(0, col[e]);
          if (loc < 0) continue;
          o.rows[(size_t)k].push_back((int64_t)i);
          o.cols[(size_t)k].push_back(loc);
          if (a.return_edge_id) o.eids[(size_t)k].push_back(e);
        }
      }
      o.edges_per_hop[(size_t)k].push_back(
          (int64_t)o.rows[(size_t)k].size());
    }
  }
  return true;
}

}  // namespace

extern "C" {

struct HeteroResult {
  HeteroOutputs o;
};

HeteroResult* pygt_hetero_sample(
    int64_t T, int64_t K, const int32_t* src_type, const int32_t* dst_type,
    const int64_t* rowptr_cat, const int64_t* rowptr_off,
    const int64_t* col_cat, const int64_t* col_off, const int64_t* num_nodes,
    const int64_t* seed_cat, const int64_t* seed_off, const int64_t* fanouts,
    int64_t L, const double* weight_cat, const int64_t* node_time_cat,
    const int64_t* node_time_off, const int64_t* edge_time_cat,
    const int64_t* seed_time_cat, const int32_t* has_weight,
    const int32_t* has_edge_time, const int32_t* has_node_time,
    int32_t replace, int32_t directed, int32_t disjoint,
    int32_t temporal_last, int32_t return_edge_id, uint64_t rng_seed) {
  auto* r = new HeteroResult();
  HeteroArgs a{T, K, src_type, dst_type, rowptr_cat, rowptr_off, col_cat,
               col_off, num_nodes, seed_cat, seed_off, fanouts, L,
               weight_cat, node_time_cat, node_time_off, edge_time_cat,
               seed_time_cat, has_weight, has_edge_time, has_node_time,
               (bool)replace, (bool)directed, (bool)disjoint,
               (bool)temporal_last, (bool)return_edge_id, rng_seed};
  if (!run_hetero(a, r->o)) {
    delete r;
    return nullptr;  // Python wrapper raises on NULL.
  }
  return r;
}

// sizes layout: edge_sizes [K], node_sizes [T], eph_len [K], nph_len [T].
void pygt_hetero_sizes(HeteroResult* r, int64_t* edge_sizes,
                       int64_t* node_sizes) {
  for (size_t k = 0; k < r->o.rows.size(); ++k)
    edge_sizes[k] = (int64_t)r->o.rows[k].size();
  for (size_t t = 0; t < r->o.nodes.size(); ++t)
    node_sizes[t] = (int64_t)r->o.nodes[t].size();
}

void pygt_hetero_copy_edges(HeteroResult* r, int64_t k, int64_t* rows,
                            int64_t* cols, int64_t* eids,
                            int64_t* edges_per_hop) {
  auto cp = [](const std::vector<int64_t>& v, int64_t* dst) {
    if (dst && !v.empty()) std::memcpy(dst, v.data(), v.size() * 8);
  };
  cp(r->o.rows[(size_t)k], rows);
  cp(r->o.cols[(size_t)k], cols);
  cp(r->o.eids[(size_t)k], eids);
  cp(r->o.edges_per_hop[(size_t)k], edges_per_hop);
}

void pygt_hetero_copy_nodes(HeteroResult* r, int64_t t, int64_t* nodes,
                            int64_t* batches, int64_t* nodes_per_hop) {
  auto cp = [](const std::vector<int64_t>& v, int64_t* dst) {
    if (dst && !v.empty()) std::memcpy(dst, v.data(), v.size() * 8);
  };
  cp(r->o.nodes[(size_t)t], nodes);
  cp(r->o.batches[(size_t)t], batches);
  cp(r->o.nodes_per_hop[(size_t)t], nodes_per_hop);
}

void pygt_hetero_free(HeteroResult* r) { delete r; }

// Runtime OpenMP width control (OMP_NUM_THREADS is only read at library
// load, so benchmarks racing 1-vs-8 threads need a live switch).
void pygt_set_num_threads(int32_t n) { omp_set_num_threads((int)n); }

int32_t pygt_get_max_threads() { return (int32_t)omp_get_max_threads(); }

}  // extern "C"
