// Copied from pyg_lib_tpu/csrc/graph_ops.cpp (logic unchanged), so the port's
// engine draws the same samples as the JAX package's for the same seed.

// Host-side graph ops: induced subgraph and uniform random walks.
//
// TPU-native counterparts of the reference kernels
// (reference pyg_lib/csrc/sampler/cpu/subgraph_kernel.cpp:13-89 two-pass
// count/cumsum/fill; csrc/sampler/cpu/random_walk_kernel.cpp:12-51
// per-seed sequential walk under at::parallel_for). OpenMP parallel with
// counter-based RNG so walks are reproducible under any thread count.

#include <algorithm>
#include <cstring>
#include <omp.h>
#include <vector>

#include "sampling_core.h"

using namespace pygt;

extern "C" {

struct SubgraphResult {
  std::vector<int64_t> rowptr, col, eid;
};

// Global->local lookup for the induced pass: dense vector when the node
// set is a fair fraction of the graph, open-addressing hash map when it
// is tiny — a dense [num_nodes] memset per call cost 15 ms at N=1M with
// 1k nodes, 18x slower than the reference's per-call hashmap.
struct LocalMap {
  bool dense;
  std::vector<int64_t> vec;
  FlatHashMap map;

  LocalMap(int64_t num_nodes, const int64_t* nodes, int64_t n_out) {
    dense = n_out * 64 >= num_nodes;
    if (dense) {
      vec.assign((size_t)num_nodes, -1);
      for (int64_t i = 0; i < n_out; ++i)
        if (nodes[i] >= 0 && nodes[i] < num_nodes)
          vec[(size_t)nodes[i]] = i;
    } else {
      for (int64_t i = 0; i < n_out; ++i)
        if (nodes[i] >= 0 && nodes[i] < num_nodes)
          map.emplace((uint64_t)nodes[i], i);
    }
  }
  inline int64_t get(int64_t node) const {
    if (dense) {
      // Out-of-range col ids (malformed CSR) read as absent, not UB.
      if (node < 0 || (size_t)node >= vec.size()) return -1;
      return vec[(size_t)node];
    }
    return node < 0 ? -1 : map.find((uint64_t)node);
  }
};

// Induced subgraph on `nodes` (local ids = position in `nodes`):
// SINGLE pass — each thread owns a contiguous node range (static
// schedule), appending matches to private buffers that concatenate in
// node order. One pass halves the random row-page touches vs the
// classic count/cumsum/fill two-pass, which dominate at small
// |nodes| on big graphs (reference subgraph_kernel.cpp:13-89 is
// two-pass; measured 1.8 ms -> ~1.0 ms at 1k nodes / 1M-node graph).
SubgraphResult* pygt_subgraph(const int64_t* rowptr, const int64_t* col,
                              int64_t num_nodes, const int64_t* nodes,
                              int64_t n_out, int32_t return_edge_id) {
  auto* r = new SubgraphResult();
  LocalMap local(num_nodes, nodes, n_out);

  r->rowptr.assign((size_t)n_out + 1, 0);
  const int nt = omp_get_max_threads();
  std::vector<std::vector<int64_t>> cols((size_t)nt), eids((size_t)nt);
#pragma omp parallel num_threads(nt)
  {
    const int t = omp_get_thread_num();
    auto& c = cols[(size_t)t];
    auto& g = eids[(size_t)t];
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_out; ++i) {
      const int64_t v = nodes[i];
      int64_t deg = 0;
      if (v >= 0 && v < num_nodes) {
        for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
          const int64_t w = local.get(col[e]);
          if (w >= 0) {
            c.push_back(w);
            if (return_edge_id) g.push_back(e);
            deg++;
          }
        }
      }
      r->rowptr[(size_t)i + 1] = deg;
    }
  }
  for (int64_t i = 0; i < n_out; ++i)
    r->rowptr[(size_t)i + 1] += r->rowptr[(size_t)i];
  const int64_t total = r->rowptr[(size_t)n_out];
  r->col.reserve((size_t)total);
  if (return_edge_id) r->eid.reserve((size_t)total);
  for (int t = 0; t < nt; ++t) {
    r->col.insert(r->col.end(), cols[(size_t)t].begin(),
                  cols[(size_t)t].end());
    if (return_edge_id)
      r->eid.insert(r->eid.end(), eids[(size_t)t].begin(),
                    eids[(size_t)t].end());
  }
  return r;
}

int64_t pygt_subgraph_num_edges(SubgraphResult* r) {
  return (int64_t)r->col.size();
}

void pygt_subgraph_copy(SubgraphResult* r, int64_t* rowptr, int64_t* col,
                        int64_t* eid) {
  std::memcpy(rowptr, r->rowptr.data(), r->rowptr.size() * 8);
  if (!r->col.empty()) std::memcpy(col, r->col.data(), r->col.size() * 8);
  if (eid && !r->eid.empty())
    std::memcpy(eid, r->eid.data(), r->eid.size() * 8);
}

void pygt_subgraph_free(SubgraphResult* r) { delete r; }

// Uniform random walks: out[i, :] is the walk from seed[i]; dead ends
// repeat the current node (reference random_walk_kernel.cpp:32-43).
void pygt_random_walk(const int64_t* rowptr, const int64_t* col,
                      const int64_t* seed, int64_t n_seed,
                      int64_t walk_length, uint64_t rng_seed, int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_seed; ++i) {
    SplitMix64 rng = site_rng(rng_seed, 0, 0, (uint64_t)i,
                              (uint64_t)seed[i]);
    int64_t* walk = out + i * (walk_length + 1);
    int64_t cur = seed[i];
    walk[0] = cur;
    for (int64_t s = 1; s <= walk_length; ++s) {
      const int64_t lo = rowptr[cur], hi = rowptr[cur + 1];
      if (hi > lo) cur = col[lo + (int64_t)rng.bounded((uint64_t)(hi - lo))];
      walk[s] = cur;
    }
  }
}

// node2vec second-order walks via rejection sampling (Grover &
// Leskovec 2016, §3.2): candidate neighbors of the current node are
// drawn uniformly and accepted with probability w / w_max where w is
// 1/p (return to previous), 1 (common neighbor of previous), or 1/q
// (distance-2). BEYOND the reference, which rejects p != 1 || q != 1
// (reference csrc/sampler/cpu/random_walk_kernel.cpp:19-20). ``col``
// must be sorted within each row (the Python wrapper sorts once) so the
// distance-1 test is a binary search. Deterministic per (rng_seed, i).
void pygt_random_walk_pq(const int64_t* rowptr, const int64_t* col,
                         const int64_t* seed, int64_t n_seed,
                         int64_t walk_length, double p, double q,
                         uint64_t rng_seed, int64_t* out) {
  const double wp = 1.0 / p, wq = 1.0 / q;
  const double w_max = std::max(1.0, std::max(wp, wq));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_seed; ++i) {
    SplitMix64 rng = site_rng(rng_seed, 1, 0, (uint64_t)i,
                              (uint64_t)seed[i]);
    int64_t* walk = out + i * (walk_length + 1);
    int64_t cur = seed[i], prev = -1;
    walk[0] = cur;
    for (int64_t s = 1; s <= walk_length; ++s) {
      const int64_t lo = rowptr[cur], hi = rowptr[cur + 1];
      if (hi <= lo) {  // dead end: repeat (reference contract)
        walk[s] = cur;
        prev = cur;
        continue;
      }
      int64_t nxt = cur;
      if (prev < 0) {
        nxt = col[lo + (int64_t)rng.bounded((uint64_t)(hi - lo))];
      } else {
        const int64_t plo = rowptr[prev], phi = rowptr[prev + 1];
        auto weight_of = [&](int64_t cand) -> double {
          if (cand == prev) return wp;
          if (std::binary_search(col + plo, col + phi, cand)) return 1.0;
          return wq;
        };
        bool accepted = false;
        for (int attempt = 0; attempt < 64; ++attempt) {
          const int64_t cand =
              col[lo + (int64_t)rng.bounded((uint64_t)(hi - lo))];
          nxt = cand;
          if (rng.uniform() * w_max <= weight_of(cand)) {
            accepted = true;
            break;
          }
        }
        if (!accepted) {
          // 64 rejections (extreme p/q at this node): draw EXACTLY from
          // the node2vec distribution via the weighted CDF — keeping
          // the last rejected uniform candidate would bias the walk.
          double total = 0.0;
          for (int64_t e = lo; e < hi; ++e) total += weight_of(col[e]);
          double r = rng.uniform() * total, acc = 0.0;
          nxt = col[hi - 1];
          for (int64_t e = lo; e < hi; ++e) {
            acc += weight_of(col[e]);
            if (r <= acc) {
              nxt = col[e];
              break;
            }
          }
        }
      }
      walk[s] = nxt;
      prev = cur;
      cur = nxt;
    }
  }
}

}  // extern "C"
