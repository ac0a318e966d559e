// Copied from pyg_lib_tpu/csrc/partition.cpp (logic unchanged), so the port's
// engine draws the same samples as the JAX package's for the same seed.

// Native graph-partitioning fast path (grow + refine).
//
// The numpy implementation in pyg_lib_tpu/partition/__init__.py is the
// specification; these kernels exist because this VM faults fresh pages
// in at ~15 MB/s, making every numpy temporary of O(E) size cost
// seconds (BENCHMARKS.md environment facts).  The C++ passes stream the
// CSR in place with zero O(E) temporaries, so a 10M-node graph refines
// in seconds instead of minutes.
//
// Role counterpart of the reference's vendored METIS
// (reference pyg_lib/csrc/partition/cpu/metis_kernel.cpp:14-53), which
// BASELINE.json explicitly replaces with a balance+locality
// partitioner: balanced multi-source BFS growth, then greedy boundary
// refinement (one-sweep Kernighan-Lin flavour).

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

extern "C" {

// Balanced multi-source BFS region growing.
//
// part[n]: in/out, -1 = unassigned; only nodes listed in `sub` (or all
// when sub == nullptr) are touched.  `seeds` are caller-chosen (the
// Python layer draws them from its RNG so the random stream matches the
// numpy spec).  Node-at-a-time round-robin over parts: each part claims
// the neighborhood of one frontier node per round until its weight
// target is met — finer balance interleaving than level-synchronous
// claiming.  Leftover (unreached) nodes go to the most under-target
// part.
void pygt_part_grow(const int64_t* rowptr, const int64_t* col, int64_t n,
                    const double* nw, int64_t k, const double* targets,
                    const int64_t* sub, int64_t sub_len,
                    const int64_t* seeds, int64_t num_seeds, int64_t* part,
                    double* load) {
  std::vector<uint8_t> in_sub;
  if (sub != nullptr) {
    in_sub.assign((size_t)n, 0);
    for (int64_t i = 0; i < sub_len; ++i) in_sub[(size_t)sub[i]] = 1;
  }
  const int64_t m = (sub == nullptr) ? n : sub_len;
  auto member = [&](int64_t v) {
    return sub == nullptr ? true : (bool)in_sub[(size_t)v];
  };

  for (int64_t p = 0; p < k; ++p) load[p] = 0.0;
  // Per-part FIFO queues (append-only vector + head cursor; every node
  // enters at most one queue once).
  std::vector<std::vector<int64_t>> queues((size_t)k);
  std::vector<size_t> qhead((size_t)k, 0);

  for (int64_t p = 0; p < num_seeds && p < k; ++p) {
    const int64_t s = seeds[p];
    part[s] = p;
    load[p] = nw ? nw[s] : 1.0;
    queues[(size_t)p].push_back(s);
  }

  bool active = true;
  while (active) {
    active = false;
    for (int64_t p = 0; p < k; ++p) {
      auto& q = queues[(size_t)p];
      size_t& h = qhead[(size_t)p];
      if (load[p] >= targets[p] || h >= q.size()) continue;
      const int64_t v = q[h++];
      active = true;
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
        const int64_t w = col[e];
        if (part[w] < 0 && member(w)) {
          part[w] = p;
          load[p] += nw ? nw[w] : 1.0;
          q.push_back(w);
        }
      }
      if (h < q.size()) active = true;
    }
  }

  // Leftovers: most under-target part first (matches the spec's
  // argmin(load / target)).
  for (int64_t i = 0; i < m; ++i) {
    const int64_t v = (sub == nullptr) ? i : sub[i];
    if (part[v] >= 0) continue;
    int64_t best = 0;
    double best_ratio = 1e300;
    for (int64_t p = 0; p < k; ++p) {
      const double t = targets[p] > 1e-12 ? targets[p] : 1e-12;
      const double ratio = load[p] / t;
      if (ratio < best_ratio) {
        best_ratio = ratio;
        best = p;
      }
    }
    part[v] = best;
    load[best] += nw ? nw[v] : 1.0;
  }
}

// Greedy boundary refinement: move a node to the partition holding most
// of its (weighted) outgoing edges when balance permits.  Sequential
// sweep with immediate moves; O(E) per pass, O(k) scratch.  Returns the
// number of passes that made at least one move.
int64_t pygt_part_refine(const int64_t* rowptr, const int64_t* col,
                         int64_t n, const double* nw, const double* ew,
                         int64_t* part, int64_t k, int64_t passes,
                         double balance) {
  std::vector<double> load((size_t)k, 0.0);
  double total = 0.0;
  for (int64_t v = 0; v < n; ++v) {
    const double w = nw ? nw[v] : 1.0;
    load[(size_t)part[v]] += w;
    total += w;
  }
  const double cap = total / (double)k * balance;

  // Epoch-stamped per-part gain scratch: cleared in O(1) per node.
  std::vector<double> gain((size_t)k, 0.0);
  std::vector<int64_t> stamp((size_t)k, -1);

  int64_t effective_passes = 0;
  for (int64_t pass = 0; pass < passes; ++pass) {
    int64_t moved = 0;
    for (int64_t v = 0; v < n; ++v) {
      const int64_t p_own = part[v];
      bool boundary = false;
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e) {
        const int64_t p = part[col[e]];
        if (p != p_own) boundary = true;
        if (stamp[(size_t)p] != v) {
          stamp[(size_t)p] = v;
          gain[(size_t)p] = 0.0;
        }
        gain[(size_t)p] += ew ? ew[e] : 1.0;
      }
      if (!boundary) continue;
      const double own = stamp[(size_t)p_own] == v ? gain[(size_t)p_own]
                                                   : 0.0;
      int64_t best = p_own;
      double best_gain = own;
      for (int64_t p = 0; p < k; ++p) {  // first max = lowest part id
        if (stamp[(size_t)p] == v && gain[(size_t)p] > best_gain) {
          best_gain = gain[(size_t)p];
          best = p;
        }
      }
      const double w = nw ? nw[v] : 1.0;
      if (best == p_own || load[(size_t)best] + w > cap) continue;
      part[v] = best;
      load[(size_t)p_own] -= w;
      load[(size_t)best] += w;
      moved++;
    }
    if (moved == 0) break;
    effective_passes++;
  }
  return effective_passes;
}

// Edge cut (weighted) — O(E) streaming, no temporaries.
double pygt_edge_cut(const int64_t* rowptr, const int64_t* col, int64_t n,
                     const int64_t* part, const double* ew) {
  double cut = 0.0;
  for (int64_t v = 0; v < n; ++v)
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e)
      if (part[v] != part[col[e]]) cut += ew ? ew[e] : 1.0;
  return cut;
}

}  // extern "C"
