"""Heterogeneous neighbor sampling — numpy reference implementation.

A copy of ``pyg_lib_tpu/sampler/_hetero_impl.py`` (logic unchanged): the port
keeps its own specification, and the same ``Generator`` draws the same
samples in both packages.

Behavioural counterpart of the reference hetero sampling routine
(reference ``pyg_lib/csrc/sampler/cpu/neighbor_kernel.cpp:518-841``):
per-(src, rel, dst) edge-type samplers sharing per-node-type Mappers;
layer-synchronous frontier expansion with per-node-type slice windows;
disjoint batch ids increment globally across seed node types
(``neighbor_kernel.cpp:670-699``); temporal constraints are keyed by dst
node type (node_time) or by edge type (edge_time).

The reference parallelises over groups of edge types sharing a dst type
(``:646-663``); here edge types are processed in order — the C++ fast path
(``pyg_lib_tpu_torch/csrc/host``) restores thread-per-dst-type
parallelism with the
same output contract.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from pyg_lib_tpu_torch.sampler._numpy_impl import (
    _biased_sample_indices,
    _sample_indices,
    _temporal_row_slice,
)

EdgeType = Tuple[str, str, str]

__all__ = ['hetero_neighbor_sample_np']


def hetero_neighbor_sample_np(
    rowptr_dict: Dict[EdgeType, np.ndarray],
    col_dict: Dict[EdgeType, np.ndarray],
    seed_dict: Dict[str, np.ndarray],
    num_neighbors_dict: Dict[EdgeType, List[int]],
    node_time_dict: Optional[Dict[str, np.ndarray]] = None,
    edge_time_dict: Optional[Dict[EdgeType, np.ndarray]] = None,
    seed_time_dict: Optional[Dict[str, np.ndarray]] = None,
    edge_weight_dict: Optional[Dict[EdgeType, np.ndarray]] = None,
    csc: bool = False,
    replace: bool = False,
    directed: bool = True,
    disjoint: bool = False,
    temporal_strategy: str = 'uniform',
    return_edge_id: bool = True,
    rng: Optional[np.random.Generator] = None,
):
    """See ``pyg_lib_tpu_torch.sampler.hetero_neighbor_sample`` for the public
    contract (parity: reference ``pyg_lib/sampler/__init__.py:103-201``)."""
    temporal = node_time_dict is not None or edge_time_dict is not None
    if temporal and not disjoint:
        raise ValueError(
            'Temporal sampling needs to create disjoint subgraphs')
    if node_time_dict is not None and edge_time_dict is not None:
        raise ValueError(
            'Only one of node-level or edge-level sampling is supported')
    if edge_time_dict is not None and seed_time_dict is None:
        raise ValueError('Seed time needs to be specified')
    if not directed and disjoint:
        raise ValueError(
            'Undirected sampling cannot create disjoint subgraphs')
    if rng is None:
        rng = np.random.default_rng()

    edge_types = list(rowptr_dict.keys())
    src_of = (lambda k: k[0]) if not csc else (lambda k: k[2])
    dst_of = (lambda k: k[2]) if not csc else (lambda k: k[0])
    node_types = sorted({src_of(k) for k in edge_types}
                        | {dst_of(k) for k in edge_types}
                        | set(seed_dict.keys()))

    L = max(len(v) for v in num_neighbors_dict.values())

    sampled_batch = {t: [] for t in node_types}
    sampled_nodes = {t: [] for t in node_types}
    mappers: Dict[str, Dict] = {t: {} for t in node_types}
    slices = {t: (0, 0) for t in node_types}
    rows = {k: [] for k in edge_types}
    cols = {k: [] for k in edge_types}
    eids = {k: [] for k in edge_types}
    num_nodes_per_hop = {t: [0] for t in node_types}
    num_edges_per_hop = {k: [] for k in edge_types}
    seed_times: List[int] = []

    batch_idx = 0
    for t, seed in seed_dict.items():
        seed = np.asarray(seed)
        for s in seed.tolist():
            key = (batch_idx, s) if disjoint else s
            if key not in mappers[t]:
                mappers[t][key] = len(mappers[t])
                sampled_batch[t].append(batch_idx)
                sampled_nodes[t].append(s)
            if disjoint:
                batch_idx += 1
        # Frontier window over the DEDUPED per-type node list (duplicate
        # seeds collapse in the mapper; a len(seed)-wide window would
        # walk past hop 0 into freshly-sampled nodes, diverging from the
        # C++ engine).
        slices[t] = (0, len(sampled_nodes[t]))
        if disjoint:
            if seed_time_dict is not None:
                seed_times.extend(np.asarray(seed_time_dict[t]).tolist())
            elif node_time_dict is not None:
                seed_times.extend(
                    np.asarray(node_time_dict[t])[seed].tolist())
        num_nodes_per_hop[t][0] = len(sampled_nodes[t])

    for ell in range(L):
        for k in edge_types:
            src, dst = src_of(k), dst_of(k)
            counts = num_neighbors_dict[k]
            count = counts[ell] if ell < len(counts) else 0
            rowptr, col = rowptr_dict[k], col_dict[k]
            begin, end = slices[src]
            hop_edges = 0
            weight = None if (edge_weight_dict is None
                              or k not in edge_weight_dict) else np.asarray(
                                  edge_weight_dict[k])
            nt = None if (node_time_dict is None
                          or dst not in node_time_dict) else np.asarray(
                              node_time_dict[dst])
            et = None if (edge_time_dict is None
                          or k not in edge_time_dict) else np.asarray(
                              edge_time_dict[k])
            for i in range(begin, end):
                v = sampled_nodes[src][i]
                b = sampled_batch[src][i] if disjoint else 0
                row_start, row_end = int(rowptr[v]), int(rowptr[v + 1])
                if row_end - row_start == 0 or count == 0:
                    continue
                if nt is not None or et is not None:
                    st = seed_times[b]
                    row_start, row_end = _temporal_row_slice(
                        col, et if et is not None else nt, row_start,
                        row_end, st, et is not None, temporal_strategy,
                        count)
                    if row_end - row_start == 0:
                        continue
                if weight is not None:
                    offs = _biased_sample_indices(
                        rng, weight[row_start:row_end], count, replace)
                else:
                    offs = _sample_indices(rng, row_end - row_start, count,
                                           replace)
                for off in offs:
                    e = row_start + int(off)
                    w = int(col[e])
                    key = (b, w) if disjoint else w
                    res = mappers[dst].get(key)
                    if res is None:
                        res = len(mappers[dst])
                        mappers[dst][key] = res
                        sampled_batch[dst].append(b)
                        sampled_nodes[dst].append(w)
                    if not directed:
                        continue  # induced pass emits edges after all hops
                    hop_edges += 1
                    rows[k].append(i)
                    cols[k].append(res)
                    if return_edge_id:
                        eids[k].append(e)
            if directed:
                num_edges_per_hop[k].append(hop_edges)
        for t in node_types:
            slices[t] = (slices[t][1], len(sampled_nodes[t]))
            num_nodes_per_hop[t].append(slices[t][1] - slices[t][0])

    if not directed:
        # Per-edge-type induced-subgraph pass (reference-documented
        # undirected semantics, ``pyg_lib/sampler/__init__.py:69``; its
        # kernel rejects it, ``neighbor_kernel.cpp:822``): every type-k
        # CSR slot from a sampled src node to a sampled dst node becomes
        # a local edge. ``num_edges_per_hop[k]`` carries ONE entry.
        for k in edge_types:
            src, dst = src_of(k), dst_of(k)
            rowptr, col = rowptr_dict[k], col_dict[k]
            n_src = len(rowptr) - 1
            for i, v in enumerate(sampled_nodes[src]):
                if v < 0 or v >= n_src:
                    continue  # no out-edges of this type
                for e in range(int(rowptr[v]), int(rowptr[v + 1])):
                    loc = mappers[dst].get(int(col[e]))
                    if loc is None:
                        continue
                    rows[k].append(i)
                    cols[k].append(loc)
                    if return_edge_id:
                        eids[k].append(e)
            num_edges_per_hop[k].append(len(rows[k]))

    out_node_id = {}
    for t in node_types:
        if disjoint:
            out_node_id[t] = np.stack([
                np.asarray(sampled_batch[t], np.int64),
                np.asarray(sampled_nodes[t], np.int64),
            ], axis=1) if sampled_nodes[t] else np.zeros((0, 2), np.int64)
        else:
            out_node_id[t] = np.asarray(sampled_nodes[t], np.int64)
    out_row, out_col, out_eid = {}, {}, ({} if return_edge_id else None)
    for k in edge_types:
        r = np.asarray(rows[k], np.int64)
        c = np.asarray(cols[k], np.int64)
        if csc:
            r, c = c, r
        out_row[k], out_col[k] = r, c
        if return_edge_id:
            out_eid[k] = np.asarray(eids[k], np.int64)
    return (out_row, out_col, out_node_id, out_eid, num_nodes_per_hop,
            num_edges_per_hop)
