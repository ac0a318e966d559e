"""Host-side neighbor sampling — numpy reference implementation.

A copy of ``pyg_lib_tpu/sampler/_numpy_impl.py`` (logic unchanged): the port
keeps its own specification, and the same ``Generator`` draws the same
samples in both packages.

Behavioural counterpart of the reference C++ sampling engine
(reference ``pyg_lib/csrc/sampler/cpu/neighbor_kernel.cpp``):

* uniform sampling: full / with-replacement / without-replacement via
  partial Fisher-Yates with an IndexTracker (``neighbor_kernel.cpp:177-243``)
* biased sampling: multinomial for replace, Efraimidis-Spirakis
  ``log(rand)/weight`` top-k for without-replacement (``:245-285``)
* node/edge-temporal sampling: binary search over time-sorted neighborhoods
  (``:74-144``), strategies ``uniform`` / ``last``
* disjoint mode: node identity is the pair ``(batch, node)`` (``:21-29``)
* dedup through a Mapper; rows/cols relabelled to local ids (``:287-317``)

This module is the *specification*: the C++ fast path
(``pyg_lib_tpu_torch/csrc/host``) must match it on structural invariants,
and tests
treat it as golden.  RNG is a ``numpy.random.Generator`` — deterministic
under a fixed seed, independent of thread count (unlike the reference's
ATen-order-dependent RNG; SURVEY.md §7 hard part 3).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ['neighbor_sample_np', 'sample_one_hop_np']


def _temporal_row_slice(col, time, row_start, row_end, seed_time, is_edge,
                        strategy, count):
    """Shrink [row_start, row_end) to neighbors satisfying
    time[...] <= seed_time (reference ``neighbor_kernel.cpp:74-144``).
    Assumes time-sorted neighborhoods."""
    if is_edge:
        keys = time[row_start:row_end]
    else:
        keys = time[col[row_start:row_end]]
    row_end = row_start + int(np.searchsorted(keys, seed_time, side='right'))
    if strategy == 'last' and count >= 0:
        row_start = max(row_start, row_end - count)
    return row_start, row_end


def _sample_indices(rng: np.random.Generator, population: int, count: int,
                    replace: bool) -> np.ndarray:
    """Edge offsets within [0, population) (reference ``_sample`` cases,
    ``neighbor_kernel.cpp:185-243``)."""
    if count < 0 or (not replace and count >= population):
        return np.arange(population)
    if replace:
        return rng.integers(0, population, size=count)
    # Partial Fisher-Yates with IndexTracker semantics.
    seen = set()
    out = np.empty(count, dtype=np.int64)
    k = 0
    for i in range(population - count, population):
        rnd = int(rng.integers(0, i + 1))
        if rnd in seen:
            rnd = i
        seen.add(rnd)
        out[k] = rnd
        k += 1
    return out


def _biased_sample_indices(rng: np.random.Generator, weight: np.ndarray,
                           count: int, replace: bool) -> np.ndarray:
    population = len(weight)
    if count < 0 or (not replace and count >= population):
        return np.arange(population)
    if replace:
        total = weight.sum()
        if total <= 0:
            # All-zero neighborhood weights: fall back to uniform like
            # the C++ engine (sampling_core.h) — NaN probabilities would
            # crash rng.choice (the reference's at::multinomial also
            # errors on this degenerate input).
            return rng.integers(0, population, size=count)
        return rng.choice(population, size=count, p=weight / total)
    # Efraimidis-Spirakis: top-k of log(u)/w (reference
    # ``neighbor_kernel.cpp:264-278``).
    u = rng.random(population)
    with np.errstate(divide='ignore'):
        key = np.log(u) / weight  # zero weight -> -inf key: never sampled
    return np.argpartition(-key, count - 1)[:count]


def neighbor_sample_np(
    rowptr: np.ndarray,
    col: np.ndarray,
    seed: np.ndarray,
    num_neighbors: List[int],
    node_time: Optional[np.ndarray] = None,
    edge_time: Optional[np.ndarray] = None,
    seed_time: Optional[np.ndarray] = None,
    edge_weight: Optional[np.ndarray] = None,
    csc: bool = False,
    replace: bool = False,
    directed: bool = True,
    disjoint: bool = False,
    temporal_strategy: str = 'uniform',
    return_edge_id: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray],
           List[int], List[int]]:
    """Multi-hop recursive neighbor sampling; see
    ``pyg_lib_tpu_torch.sampler.neighbor_sample`` for the public contract
    (parity: reference ``pyg_lib/sampler/__init__.py:11-100``)."""
    if (node_time is not None or edge_time is not None) and not disjoint:
        raise ValueError(
            'Temporal sampling needs to create disjoint subgraphs')
    if node_time is not None and edge_time is not None:
        raise ValueError(
            'Only one of node-level or edge-level sampling is supported')
    if edge_time is not None and seed_time is None:
        raise ValueError('Seed time needs to be specified')
    if temporal_strategy not in ('uniform', 'last'):
        raise ValueError('No valid temporal strategy found')
    if edge_weight is not None and (node_time is not None
                                    or edge_time is not None):
        raise ValueError('Biased temporal sampling not yet supported')
    if not directed and disjoint:
        raise ValueError(
            'Undirected sampling cannot create disjoint subgraphs')
    if rng is None:
        rng = np.random.default_rng()

    temporal = node_time is not None or edge_time is not None

    # Node identity: scalar or (batch, node) pair in disjoint mode.
    mapper: Dict = {}
    sampled_batch: List[int] = []
    sampled_nodes: List[int] = []
    seed_times: List[int] = []

    for i, s in enumerate(np.asarray(seed).tolist()):
        key = (i, s) if disjoint else s
        if key not in mapper:
            mapper[key] = len(mapper)
            sampled_batch.append(i)
            sampled_nodes.append(s)
        elif disjoint:
            raise AssertionError('duplicate disjoint seed')
    if disjoint:
        if seed_time is not None:
            seed_times = list(np.asarray(seed_time))
        elif node_time is not None:
            seed_times = list(np.asarray(node_time)[np.asarray(seed)])

    rows: List[int] = []
    cols: List[int] = []
    edge_ids: List[int] = []
    num_sampled_nodes_per_hop = [len(sampled_nodes)]
    num_sampled_edges_per_hop = []

    begin, end = 0, len(sampled_nodes)
    for ell, count in enumerate(num_neighbors):
        hop_edges = 0
        for i in range(begin, end):
            v = sampled_nodes[i]
            batch = sampled_batch[i] if disjoint else 0
            row_start, row_end = int(rowptr[v]), int(rowptr[v + 1])
            if row_end - row_start == 0 or count == 0:
                continue
            if temporal:
                st = seed_times[batch]
                row_start, row_end = _temporal_row_slice(
                    col, edge_time if edge_time is not None else node_time,
                    row_start, row_end, st, edge_time is not None,
                    temporal_strategy, count)
                if row_end - row_start == 0:
                    continue
            population = row_end - row_start
            if edge_weight is not None:
                offs = _biased_sample_indices(
                    rng, np.asarray(edge_weight)[row_start:row_end], count,
                    replace)
            else:
                offs = _sample_indices(rng, population, count, replace)
            for off in offs:
                e = row_start + int(off)
                w = int(col[e])
                key = (batch, w) if disjoint else w
                res = mapper.get(key)
                if res is None:
                    res = len(mapper)
                    mapper[key] = res
                    sampled_batch.append(batch)
                    sampled_nodes.append(w)
                if not directed:
                    continue  # induced pass emits edges after all hops
                hop_edges += 1
                rows.append(i)
                cols.append(res)
                if return_edge_id:
                    edge_ids.append(e)
        begin, end = end, len(sampled_nodes)
        num_sampled_nodes_per_hop.append(end - begin)
        if directed:
            num_sampled_edges_per_hop.append(hop_edges)

    if not directed:
        # Induced-subgraph pass (the reference DOCUMENTS this semantics —
        # ``pyg_lib/sampler/__init__.py:69`` "include all edges between
        # all sampled nodes" — but its kernel rejects it,
        # ``neighbor_kernel.cpp:501``; implemented here): every CSR slot
        # whose endpoint was sampled becomes a local edge, in local-row
        # order. Hop attribution is meaningless for induced edges, so
        # ``num_sampled_edges_per_hop`` carries ONE entry: the total.
        for i, v in enumerate(sampled_nodes):
            for e in range(int(rowptr[v]), int(rowptr[v + 1])):
                loc = mapper.get(int(col[e]))
                if loc is None:
                    continue
                rows.append(i)
                cols.append(loc)
                if return_edge_id:
                    edge_ids.append(e)
        num_sampled_edges_per_hop.append(len(rows))

    if disjoint:
        node_id = np.stack([
            np.asarray(sampled_batch, np.int64),
            np.asarray(sampled_nodes, np.int64),
        ], axis=1)
    else:
        node_id = np.asarray(sampled_nodes, np.int64)
    out_row = np.asarray(rows, np.int64)
    out_col = np.asarray(cols, np.int64)
    if csc:
        out_row, out_col = out_col, out_row
    out_edge_id = np.asarray(edge_ids, np.int64) if return_edge_id else None
    return (out_row, out_col, node_id, out_edge_id,
            num_sampled_nodes_per_hop, num_sampled_edges_per_hop)


def sample_one_hop_np(
    rowptr: np.ndarray,
    col: np.ndarray,
    seed: np.ndarray,
    count: int,
    replace: bool = False,
    edge_weight: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-hop distributed sampling building block: NO relabeling, returns
    ``(nodes_with_dupes, edge_ids, cumsum_neighbors_per_node)``.

    Parity: reference ``dist_neighbor_sample``
    (``csrc/sampler/neighbor.cpp:99-127``; distributed ``add`` path
    ``neighbor_kernel.cpp:295-301``).  ``nodes`` starts with the seeds.
    """
    if rng is None:
        rng = np.random.default_rng()
    seed = np.asarray(seed)
    nodes: List[int] = list(seed.tolist())
    edge_ids: List[int] = []
    cumsum = [len(nodes)]
    for v in seed.tolist():
        row_start, row_end = int(rowptr[v]), int(rowptr[v + 1])
        population = row_end - row_start
        if population > 0 and count != 0:
            if edge_weight is not None:
                offs = _biased_sample_indices(
                    rng, np.asarray(edge_weight)[row_start:row_end], count,
                    replace)
            else:
                offs = _sample_indices(rng, population, count, replace)
            for off in offs:
                e = row_start + int(off)
                nodes.append(int(col[e]))
                edge_ids.append(e)
        cumsum.append(len(nodes))
    return (np.asarray(nodes, np.int64), np.asarray(edge_ids, np.int64),
            np.asarray(cumsum, np.int64))
