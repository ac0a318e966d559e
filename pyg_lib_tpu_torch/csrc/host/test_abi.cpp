// Copied from pyg_lib_tpu/csrc/test_abi.cpp (logic unchanged): the C-ABI
// edge-case suite, here run against the port's copy of the engine. Built
// by _build.build_abi_test() and run by tests/test_torch_cpp_abi.py.

// Direct C-ABI edge-case tests for the native sampling engine.
//
// Counterpart of the reference gtest suite
// (reference test/csrc/sampler/test_neighbor.cpp:8-330,
// cmake/test.cmake): adversarial sizes exercised AT THE ABI — zero
// seeds, zero edges, empty hetero types, out-of-range/temporal-invalid
// inputs (must return NULL, never read out of bounds), and the
// cycle-graph fixture with hand-computable full-fanout output
// (reference test/csrc/graph.h:5-18). Built and run by
// tests/test_cpp_abi.py; exits non-zero on the first failure.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
struct SampleResult;
SampleResult* pygt_neighbor_sample(
    const int64_t* rowptr, const int64_t* col, int64_t num_nodes,
    const int64_t* seed, int64_t num_seed, const int64_t* fanouts,
    int64_t num_hops, const double* edge_weight, const int64_t* node_time,
    const int64_t* edge_time, const int64_t* seed_time, int32_t replace,
    int32_t directed, int32_t disjoint, int32_t temporal_last,
    int32_t return_edge_id, int32_t distributed, uint64_t rng_seed);
void pygt_result_sizes(SampleResult*, int64_t* sizes);
void pygt_result_copy(SampleResult*, int64_t* rows, int64_t* cols,
                      int64_t* eids, int64_t* nodes, int64_t* batches,
                      int64_t* nodes_per_hop, int64_t* edges_per_hop);
void pygt_result_free(SampleResult*);

struct HeteroResult;
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
    int32_t temporal_last, int32_t return_edge_id, uint64_t rng_seed);
void pygt_hetero_sizes(HeteroResult*, int64_t* edge_sizes,
                       int64_t* node_sizes);
void pygt_hetero_free(HeteroResult*);
}

#define CHECK(cond)                                                   \
  do {                                                                \
    if (!(cond)) {                                                    \
      std::fprintf(stderr, "FAILED %s:%d: %s\n", __FILE__, __LINE__, \
                   #cond);                                            \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

static SampleResult* homo(const std::vector<int64_t>& rowptr,
                          const std::vector<int64_t>& col,
                          const std::vector<int64_t>& seed,
                          const std::vector<int64_t>& fanouts,
                          int32_t disjoint = 0,
                          const int64_t* node_time = nullptr,
                          int32_t directed = 1) {
  return pygt_neighbor_sample(
      rowptr.data(), col.data(), (int64_t)rowptr.size() - 1, seed.data(),
      (int64_t)seed.size(), fanouts.data(), (int64_t)fanouts.size(),
      nullptr, node_time, nullptr, nullptr, 0, directed, disjoint, 0, 1, 0,
      42);
}

int main() {
  // 1. Zero seeds on a zero-edge graph.
  {
    std::vector<int64_t> rowptr = {0, 0, 0};
    std::vector<int64_t> col;
    std::vector<int64_t> seed;
    std::vector<int64_t> fan = {2};
    auto* r = homo(rowptr, col, seed, fan);
    CHECK(r != nullptr);
    int64_t sizes[5];
    pygt_result_sizes(r, sizes);
    CHECK(sizes[0] == 0 && sizes[1] == 0);
    pygt_result_free(r);
  }

  // 2. Zero hops.
  {
    std::vector<int64_t> rowptr = {0, 1, 2};
    std::vector<int64_t> col = {1, 0};
    std::vector<int64_t> seed = {0};
    std::vector<int64_t> fan;
    auto* r = homo(rowptr, col, seed, fan);
    CHECK(r != nullptr);
    int64_t sizes[5];
    pygt_result_sizes(r, sizes);
    CHECK(sizes[1] == 1);  // just the seed
    pygt_result_free(r);
  }

  // 3. Out-of-range / negative seeds -> NULL, not UB.
  {
    std::vector<int64_t> rowptr = {0, 1, 2};
    std::vector<int64_t> col = {1, 0};
    std::vector<int64_t> fan = {1};
    std::vector<int64_t> bad1 = {7};
    std::vector<int64_t> bad2 = {-1};
    CHECK(homo(rowptr, col, bad1, fan) == nullptr);
    CHECK(homo(rowptr, col, bad2, fan) == nullptr);
  }

  // 4. Temporal without disjoint -> NULL (empty seed_times was one
  //    caller away from OOB before round 2).
  {
    std::vector<int64_t> rowptr = {0, 1, 2};
    std::vector<int64_t> col = {1, 0};
    std::vector<int64_t> seed = {0};
    std::vector<int64_t> fan = {1};
    std::vector<int64_t> node_time = {0, 1};
    CHECK(homo(rowptr, col, seed, fan, /*disjoint=*/0,
               node_time.data()) == nullptr);
    auto* ok = homo(rowptr, col, seed, fan, /*disjoint=*/1,
                    node_time.data());
    CHECK(ok != nullptr);
    pygt_result_free(ok);
  }

  // 5. Cycle-graph full fanout: hand-computable (reference fixture).
  //    6-cycle, seed {0}, fanouts {-1}: hop 1 = neighbors {5, 1}.
  {
    const int64_t n = 6;
    std::vector<int64_t> rowptr(n + 1), col(2 * n);
    for (int64_t v = 0; v <= n; ++v) rowptr[v] = 2 * v;
    for (int64_t v = 0; v < n; ++v) {
      col[2 * v] = (v - 1 + n) % n;
      col[2 * v + 1] = (v + 1) % n;
    }
    std::vector<int64_t> seed = {0};
    std::vector<int64_t> fan = {-1};
    auto* r = homo(rowptr, col, seed, fan);
    CHECK(r != nullptr);
    int64_t sizes[5];
    pygt_result_sizes(r, sizes);
    CHECK(sizes[0] == 2);  // two edges
    CHECK(sizes[1] == 3);  // nodes {0, 5, 1}
    std::vector<int64_t> rows(sizes[0]), cols(sizes[0]), eids(sizes[2]),
        nodes(sizes[1]), batches(sizes[1]), nph(sizes[3]), eph(sizes[4]);
    pygt_result_copy(r, rows.data(), cols.data(), eids.data(),
                     nodes.data(), batches.data(), nph.data(), eph.data());
    CHECK(nodes[0] == 0 && nodes[1] == 5 && nodes[2] == 1);
    CHECK(rows[0] == 0 && rows[1] == 0);
    CHECK(cols[0] == 1 && cols[1] == 2);
    pygt_result_free(r);
  }

  // 6. Hetero: empty node type (no seeds, no edges of its own).
  {
    // types: 0='u' (2 nodes), 1='v' (0 nodes); edge type u->u only.
    int32_t src_type[] = {0};
    int32_t dst_type[] = {0};
    std::vector<int64_t> rowptr_cat = {0, 1, 2};
    std::vector<int64_t> rowptr_off = {0, 3};
    std::vector<int64_t> col_cat = {1, 0};
    std::vector<int64_t> col_off = {0, 2};
    std::vector<int64_t> num_nodes = {2, 0};
    std::vector<int64_t> seed_cat = {0};
    std::vector<int64_t> seed_off = {0, 1, 1};  // 1 'u' seed, 0 'v' seeds
    std::vector<int64_t> fanouts = {1};
    int32_t has_w[] = {0};
    int32_t has_et[] = {0};
    int32_t has_nt[] = {0, 0};
    auto* h = pygt_hetero_sample(
        2, 1, src_type, dst_type, rowptr_cat.data(), rowptr_off.data(),
        col_cat.data(), col_off.data(), num_nodes.data(), seed_cat.data(),
        seed_off.data(), fanouts.data(), 1, nullptr, nullptr, nullptr,
        nullptr, nullptr, has_w, has_et, has_nt, 0, 1, 0, 0, 1, 9);
    CHECK(h != nullptr);
    int64_t edge_sizes[1], node_sizes[2];
    pygt_hetero_sizes(h, edge_sizes, node_sizes);
    CHECK(edge_sizes[0] == 1);
    CHECK(node_sizes[1] == 0);  // empty type stays empty
    pygt_hetero_free(h);
  }

  // 7. Hetero: disjoint temporal seed past the node_time segment -> NULL.
  {
    int32_t src_type[] = {0};
    int32_t dst_type[] = {0};
    std::vector<int64_t> rowptr_cat = {0, 1, 2, 3};
    std::vector<int64_t> rowptr_off = {0, 4};
    std::vector<int64_t> col_cat = {1, 2, 0};
    std::vector<int64_t> col_off = {0, 3};
    std::vector<int64_t> num_nodes = {3};
    std::vector<int64_t> seed_cat = {2};
    std::vector<int64_t> seed_off = {0, 1};
    std::vector<int64_t> fanouts = {1};
    std::vector<int64_t> node_time_cat = {5, 6};  // SHORT: 2 < 3 nodes
    std::vector<int64_t> node_time_off = {0, 2};
    int32_t has_w[] = {0};
    int32_t has_et[] = {0};
    int32_t has_nt[] = {1};
    auto* h = pygt_hetero_sample(
        1, 1, src_type, dst_type, rowptr_cat.data(), rowptr_off.data(),
        col_cat.data(), col_off.data(), num_nodes.data(), seed_cat.data(),
        seed_off.data(), fanouts.data(), 1, nullptr, node_time_cat.data(),
        node_time_off.data(), nullptr, nullptr, has_w, has_et, has_nt, 0,
        1, 1, 0, 1, 9);
    CHECK(h == nullptr);
  }

  // 8. Undirected induced subgraph on the 6-cycle: seed {0}, fanout
  //    {-1} samples nodes {0, 5, 1}; induced edges are every cycle edge
  //    among them: 0->5, 0->1, 5->0, 1->0 (2 local edges per node order).
  {
    const int64_t n = 6;
    std::vector<int64_t> rowptr(n + 1), col(2 * n);
    for (int64_t v = 0; v <= n; ++v) rowptr[v] = 2 * v;
    for (int64_t v = 0; v < n; ++v) {
      col[2 * v] = (v - 1 + n) % n;
      col[2 * v + 1] = (v + 1) % n;
    }
    std::vector<int64_t> seed = {0};
    std::vector<int64_t> fan = {-1};
    auto* r = homo(rowptr, col, seed, fan, /*disjoint=*/0, nullptr,
                   /*directed=*/0);
    CHECK(r != nullptr);
    int64_t sizes[5];
    pygt_result_sizes(r, sizes);
    CHECK(sizes[1] == 3);  // nodes {0, 5, 1}
    CHECK(sizes[0] == 4);  // induced: 0->5, 0->1, 5->0, 1->0
    CHECK(sizes[4] == 1);  // ONE edges_per_hop entry (induced total)
    std::vector<int64_t> rows(sizes[0]), cols(sizes[0]), eids(sizes[2]),
        nodes(sizes[1]), batches(sizes[1]), nph(sizes[3]), eph(sizes[4]);
    pygt_result_copy(r, rows.data(), cols.data(), eids.data(),
                     nodes.data(), batches.data(), nph.data(), eph.data());
    CHECK(eph[0] == 4);
    // local-row order: node 0 first (edges to locals 1, 2), then 5, 1.
    CHECK(rows[0] == 0 && cols[0] == 1);  // 0 -> 5
    CHECK(rows[1] == 0 && cols[1] == 2);  // 0 -> 1
    CHECK(rows[2] == 1 && cols[2] == 0);  // 5 -> 0 (5's nbr 4 unsampled)
    CHECK(rows[3] == 2 && cols[3] == 0);  // 1 -> 0 (1's nbr 2 unsampled)
    pygt_result_free(r);

    // Undirected + disjoint -> NULL.
    CHECK(homo(rowptr, col, seed, fan, /*disjoint=*/1, nullptr,
               /*directed=*/0) == nullptr);
  }

  std::printf("ABI TESTS PASSED\n");
  return 0;
}
