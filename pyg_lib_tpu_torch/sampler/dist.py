"""Distributed sampling protocol: sample -> merge -> relabel (port of
``pyg_lib_tpu/sampler/dist.py``, host numpy, logic unchanged).

Host-side counterpart of the reference distributed op triple
(reference ``pyg_lib/csrc/sampler/neighbor.cpp:99-127`` dist_neighbor_sample,
``csrc/sampler/cpu/dist_merge_outputs_kernel.cpp:15-131`` merge,
``csrc/sampler/cpu/dist_relabel_kernel.cpp:30-94`` relabel).

The protocol is pure functions over numpy arrays. A coordinator
repeatedly:

1. calls :func:`dist_neighbor_sample` on each partition's local graph,
2. stitches per-partition outputs back into seed order with
   :func:`merge_sampler_outputs`,
3. after the final hop, relabels global ids to local contiguous ids with
   :func:`relabel_neighborhood`.

In a deployment, step 1 runs in each partition's sampling service
(``sampler.transport``) and the features of the batch arrive by a
collective of the ranks (``sampler.dist_service.collective_feature_fetch``)
instead of RPC. The same seeds give the JAX package's samples bit for bit.
"""

from typing import List, Optional, Tuple

import numpy as np

from pyg_lib_tpu_torch.sampler._numpy_impl import sample_one_hop_np

__all__ = [
    'dist_neighbor_sample',
    'merge_sampler_outputs',
    'relabel_neighborhood',
    'hetero_relabel_neighborhood',
]


def dist_neighbor_sample(
    rowptr: np.ndarray,
    col: np.ndarray,
    seed: np.ndarray,
    num_neighbors: int,
    replace: bool = False,
    edge_weight: Optional[np.ndarray] = None,
    rng=None,
    impl: str = 'auto',
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-hop sampling WITHOUT local relabeling.

    Returns ``(nodes, edge_ids, cumsum_neighbors_per_node)`` where ``nodes``
    starts with the seeds and ``cumsum_neighbors_per_node[i+1]`` is the
    total node count after expanding seed ``i`` (reference contract,
    ``csrc/sampler/neighbor.cpp:99-127``). ``impl`` is 'cpp' (the C++
    engine; 'auto' is its other name, as everywhere in the port's
    ``sampler``) or 'numpy'.
    """
    from pyg_lib_tpu_torch.sampler import _cpp, _use_cpp

    if _use_cpp(impl):
        return _cpp.neighbor_sample_cpp(
            np.asarray(rowptr), np.asarray(col), np.asarray(seed),
            [num_neighbors], edge_weight=None if edge_weight is None else
            np.asarray(edge_weight), replace=replace, distributed=True,
            rng_seed=_cpp.rng_seed_from(rng))
    if rng is not None and not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    return sample_one_hop_np(rowptr, col, seed, num_neighbors, replace,
                             edge_weight, rng)


def merge_sampler_outputs(
    node_ids: List[np.ndarray],
    edge_ids: List[np.ndarray],
    cumsum_neighbors_per_node: List[np.ndarray],
    partition_ids: np.ndarray,
    partition_orders: np.ndarray,
    num_partitions: int,  # accepted for reference API parity (unused)
    num_neighbors: int,  # accepted for reference API parity (unused)
    batch: Optional[np.ndarray] = None,
    disjoint: bool = False,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], List[int]]:
    """Merges per-partition sampler outputs back into global seed order.

    ``partition_ids[j]`` / ``partition_orders[j]`` give, for the j-th seed in
    the coordinator's order, which partition sampled it and at which position
    in that partition's seed list.  Mirrors the pad-into-``p_size x offset``
    grid + compact algorithm of the reference
    (``dist_merge_outputs_kernel.cpp:15-131``), returning
    ``(node_ids, edge_ids, batch?, num_sampled_neighbors_per_node)``.
    Seed nodes themselves are omitted from the merged node list.
    """
    partition_ids = np.asarray(partition_ids)
    partition_orders = np.asarray(partition_orders)
    p_size = len(partition_ids)

    out_nodes: List[np.ndarray] = []
    out_edges: List[np.ndarray] = []
    out_batch: List[np.ndarray] = []
    num_sampled_neighbors_per_node: List[int] = []

    for j in range(p_size):
        p_id = int(partition_ids[j])
        p_order = int(partition_orders[j])
        cumsum = cumsum_neighbors_per_node[p_id]
        begin_node = int(cumsum[p_order])
        end_node = int(cumsum[p_order + 1])
        begin_edge = begin_node - int(cumsum[0])
        end_edge = end_node - int(cumsum[0])
        out_nodes.append(np.asarray(node_ids[p_id])[begin_node:end_node])
        out_edges.append(np.asarray(edge_ids[p_id])[begin_edge:end_edge])
        if disjoint:
            if batch is None:
                raise ValueError('disjoint merge requires batch')
            out_batch.append(
                np.full(end_node - begin_node, np.asarray(batch)[j],
                        dtype=np.int64))
        num_sampled_neighbors_per_node.append(end_node - begin_node)

    merged_nodes = (np.concatenate(out_nodes)
                    if out_nodes else np.zeros(0, np.int64))
    merged_edges = (np.concatenate(out_edges)
                    if out_edges else np.zeros(0, np.int64))
    merged_batch = (np.concatenate(out_batch) if disjoint and out_batch else
                    (np.zeros(0, np.int64) if disjoint else None))
    return (merged_nodes, merged_edges, merged_batch,
            num_sampled_neighbors_per_node)


def relabel_neighborhood(
    seed: np.ndarray,
    sampled_nodes_with_duplicates: np.ndarray,
    num_sampled_neighbors_per_node: List[int],
    num_nodes: int,
    batch: Optional[np.ndarray] = None,
    csc: bool = False,
    disjoint: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Relabels merged global node ids to local contiguous ids; emits
    ``(row, col)``.

    Parity: reference ``relabel_neighborhood``
    (``dist_relabel_kernel.cpp:30-94``): the mapper is seeded with the seed
    nodes (locals ``0..len(seed)-1``); row ``i`` is the local id of the i-th
    expanded node in coordinator order.  Precondition (shared with the
    reference kernel): ``seed`` contains no duplicates — duplicated seeds
    would make enumeration order diverge from mapper locals.
    """
    seed = np.asarray(seed)
    nodes = np.asarray(sampled_nodes_with_duplicates)
    if disjoint:
        if batch is None:
            raise ValueError(
                'Batch needs to be specified to create disjoint subgraphs')
        batch = np.asarray(batch)
        if len(batch) != len(nodes):
            raise ValueError('Each node must belong to a subgraph')

    mapper = {}
    for i, s in enumerate(seed.tolist()):
        key = (i, s) if disjoint else s
        mapper.setdefault(key, len(mapper))

    rows, cols = [], []
    begin = 0
    for i, n in enumerate(num_sampled_neighbors_per_node):
        for j in range(begin, begin + n):
            key = ((int(batch[j]), int(nodes[j])) if disjoint else
                   int(nodes[j]))
            res = mapper.get(key)
            if res is None:
                res = len(mapper)
                mapper[key] = res
            rows.append(i)
            cols.append(res)
        begin += n

    row = np.asarray(rows, np.int64)
    col = np.asarray(cols, np.int64)
    if csc:
        row, col = col, row
    return row, col


def hetero_relabel_neighborhood(
    node_types: List[str],
    edge_types: List[Tuple[str, str, str]],
    seed_dict,
    sampled_nodes_with_duplicates_dict,
    num_sampled_neighbors_per_node_dict,
    num_nodes_dict,
    batch_dict=None,
    csc: bool = False,
    disjoint: bool = False,
):
    """Heterogeneous relabel (reference ``dist_relabel_kernel.cpp:96-269``).

    ``num_sampled_neighbors_per_node_dict`` maps each edge type to a list of
    per-layer lists of neighbor counts (one count per expanded src node, in
    coordinator order).  Per-dst-type mappers are seeded with the dst-type
    seeds; src-local ids advance layer by layer per src type.
    """
    src_of = (lambda k: k[0]) if not csc else (lambda k: k[2])
    dst_of = (lambda k: k[2]) if not csc else (lambda k: k[0])

    mappers = {t: {} for t in node_types}
    batch_offset = {}
    off = 0
    for t, seed in seed_dict.items():
        seed = np.asarray(seed)
        batch_offset[t] = off
        for i, s in enumerate(seed.tolist()):
            key = (off + i, int(s)) if disjoint else int(s)
            mappers[t].setdefault(key, len(mappers[t]))
        off += len(seed)

    rows = {k: [] for k in edge_types}
    cols = {k: [] for k in edge_types}
    # Per-DST-TYPE read position into that type's merged node stream: the
    # stream concatenates every edge type's (and layer's) merged output in
    # coordinator append order, so edge types sharing a dst type must
    # advance ONE shared cursor (reference slice_dict,
    # dist_relabel_kernel.cpp:219-233) — a per-edge-type cursor would
    # re-read another edge type's region.
    pos = {t: 0 for t in node_types}
    num_layers = max(
        (len(v) for v in num_sampled_neighbors_per_node_dict.values()),
        default=0)
    # Track how many locals each src type has after each layer (locals are
    # allocated in mapper insertion order, mirroring the sampler).
    src_base = {t: 0 for t in node_types}

    for ell in range(num_layers):
        layer_end = {}
        for k in edge_types:
            src, dst = src_of(k), dst_of(k)
            per_layer = num_sampled_neighbors_per_node_dict.get(k, [])
            counts = per_layer[ell] if ell < len(per_layer) else []
            nodes = np.asarray(sampled_nodes_with_duplicates_dict[dst])
            bt = (np.asarray(batch_dict[dst])
                  if disjoint and batch_dict is not None else None)
            p = pos[dst]
            for i, n in enumerate(counts):
                local_src = src_base[src] + i
                for j in range(p, p + int(n)):
                    key = ((int(bt[j]), int(nodes[j])) if disjoint else
                           int(nodes[j]))
                    res = mappers[dst].get(key)
                    if res is None:
                        res = len(mappers[dst])
                        mappers[dst][key] = res
                    rows[k].append(local_src)
                    cols[k].append(res)
                p += int(n)
            pos[dst] = p
            # Same-src edge types may report different per-layer list
            # lengths; the frontier advances by the LARGEST reported
            # count (setdefault's first-wins misnumbered later layers).
            layer_end[src] = max(layer_end.get(src, 0),
                                 src_base[src] + len(counts))
        for t in node_types:
            src_base[t] = layer_end.get(t, src_base[t])

    out_row, out_col = {}, {}
    for k in edge_types:
        r = np.asarray(rows[k], np.int64)
        c = np.asarray(cols[k], np.int64)
        if csc:
            r, c = c, r
        out_row[k], out_col[k] = r, c
    return out_row, out_col
