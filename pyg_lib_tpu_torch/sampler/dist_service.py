"""Distributed neighbour-sampling service and the partition-book feature
fetch (port of ``pyg_lib_tpu/sampler/dist_service.py``).

The reference ships only the protocol kernels (sample/merge/relabel:
``pyg_lib/csrc/sampler/neighbor.cpp:99-127``,
``csrc/sampler/cpu/dist_merge_outputs_kernel.cpp``,
``csrc/sampler/cpu/dist_relabel_kernel.cpp``); the orchestration lives in
PyG's ``torch_geometric.distributed`` with TensorPipe RPC. Here each
partition's one-hop call is the service body (in process, or over
``sampler.transport``), and the feature fetch is a collective of the ranks
keyed by the partition book, in place of RPC feature stores.

The partition books, graphs and samplers are host numpy copies of the
JAX package's, so the same seeds give its samples bit for bit.
:func:`collective_feature_fetch` runs in every rank of a mesh axis
(``parallel.make_mesh``) on this rank's feature shard.
"""

import zlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from pyg_lib_tpu_torch.sampler.dist import (
    dist_neighbor_sample,
    merge_sampler_outputs,
    relabel_neighborhood,
)

__all__ = [
    'PartitionBook', 'DistGraph', 'partition_graph',
    'DistNeighborSampler', 'collective_feature_fetch',
    'HeteroDistGraph', 'partition_hetero_graph',
    'HeteroDistNeighborSampler', 'hetero_collective_feature_fetch',
]


class PartitionBook(NamedTuple):
    """Range partition book: node ``v`` belongs to partition
    ``searchsorted(bounds, v, 'right') - 1``. (The reference delegates
    partitioning to METIS + PyG's ``LocalGraphStore`` partition book;
    contiguous ranges keep the device-side owner computation a single
    subtract/compare — reorder with ``partition.metis`` first
    for locality.)"""
    bounds: np.ndarray  # [P+1] int64

    @property
    def num_partitions(self) -> int:
        return len(self.bounds) - 1

    def owner(self, ids: np.ndarray) -> np.ndarray:
        return (np.searchsorted(self.bounds, np.asarray(ids), 'right') -
                1).astype(np.int64)


class DistGraph(NamedTuple):
    """Node-partitioned CSR: partition ``p`` owns rows
    ``[bounds[p], bounds[p+1])`` and stores their out-edges with GLOBAL
    column ids (the reference's per-partition ``LocalGraphStore`` holds
    the same local-rows/global-cols layout)."""
    book: PartitionBook
    rowptr_parts: Tuple[np.ndarray, ...]
    col_parts: Tuple[np.ndarray, ...]
    num_nodes: int


def partition_graph(rowptr, col, num_partitions: int) -> DistGraph:
    """Split a global CSR into ``num_partitions`` contiguous row ranges."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    n = len(rowptr) - 1
    bounds = np.linspace(0, n, num_partitions + 1).astype(np.int64)
    rps, cls = [], []
    for p in range(num_partitions):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        rps.append(rowptr[lo:hi + 1] - rowptr[lo])
        cls.append(col[rowptr[lo]:rowptr[hi]])
    return DistGraph(book=PartitionBook(bounds=bounds),
                     rowptr_parts=tuple(rps), col_parts=tuple(cls),
                     num_nodes=n)


class DistNeighborSampler:
    """Coordinator for the sample -> merge -> relabel protocol loop.

    Each hop: frontier nodes are grouped by owning partition, every
    partition samples ONE hop without relabeling
    (:func:`dist_neighbor_sample` — its call boundary is where an RPC
    would sit on a multi-host deployment), outputs are stitched back into
    frontier order (:func:`merge_sampler_outputs`), and after the last
    hop one global->local relabel produces the final (row, col, node_id)
    exactly like the single-machine sampler (the reference protocol).
    """

    def __init__(self, graph: DistGraph, rng: int = 0, replace: bool = False,
                 impl: str = 'auto', service=None):
        self.graph = graph
        self.rng = rng
        self.replace = replace
        self.impl = impl
        self.service = service  # transport.SamplingService (else in-proc)
        self._step = 0
        # Global edge id of each partition's first local edge (partition
        # CSRs are contiguous row-range slices of the global CSR).
        sizes = [len(c) for c in graph.col_parts]
        self._edge_off = np.concatenate(
            [[0], np.cumsum(sizes)]).astype(np.int64)

    def _sample_partition(self, p: int, seeds: np.ndarray,
                          num_neighbors: int, rng_seed: int):
        """One partition's service call (local seeds -> one hop)."""
        lo = int(self.graph.book.bounds[p])
        local = seeds - lo
        nodes, eids, cumsum = dist_neighbor_sample(
            self.graph.rowptr_parts[p], self.graph.col_parts[p], local,
            num_neighbors, replace=self.replace, rng=rng_seed,
            impl=self.impl)
        # Local seeds echo first in `nodes`; cols are already global.
        nodes = nodes.copy()
        nodes[:len(seeds)] += lo
        # Edge ids localize per partition; globalize with the edge offset
        # (edge-feature consumers must not see colliding local ids).
        eids = eids + self._edge_off[p]
        return nodes, eids, cumsum

    def _scatter_sample(self, requests):
        """``{p: (seeds, fanout, rng_seed)}`` -> per-partition one-hop
        results, re-globalised. Over a :class:`SamplingService` the sends
        are pipelined so partitions sample concurrently (the in-process
        fallback runs them sequentially — same bits, counter RNG)."""
        if self.service is None:
            return {
                p: self._sample_partition(p, seeds, fanout, rng_seed)
                for p, (seeds, fanout, rng_seed) in requests.items()
            }
        wire = {
            p: ('sample', seeds - int(self.graph.book.bounds[p]), fanout,
                rng_seed, self.replace, self.impl)
            for p, (seeds, fanout, rng_seed) in requests.items()
        }
        raw = self.service.scatter(wire)
        out = {}
        for p, (nodes, eids, cumsum) in raw.items():
            nodes = nodes.copy()
            n_seeds = len(requests[p][0])
            nodes[:n_seeds] += int(self.graph.book.bounds[p])
            out[p] = (nodes, eids + self._edge_off[p], cumsum)
        return out

    def sample(self, seeds: np.ndarray, fanouts: List[int]):
        """Multi-hop sampling; returns ``(row, col, node_id,
        num_sampled_nodes_per_hop)`` with local contiguous ids."""
        seeds = np.asarray(seeds, dtype=np.int64)
        frontier = seeds
        sampled_with_dupes: List[np.ndarray] = []
        counts_per_node: List[int] = []
        nodes_per_hop = [len(seeds)]
        # Mirror of relabel's mapper: the next hop expands the NEW unique
        # nodes in first-seen order (the single-machine sampler's sliding
        # window over deduped locals). Expanding the raw merged stream
        # would misalign relabel's row ids, which assume the i-th count
        # belongs to mapper-local i (duplicate frontier nodes shift every
        # later row).
        seen = set(int(v) for v in seeds)
        for hop, fanout in enumerate(fanouts):
            owner = self.graph.book.owner(frontier)
            partition_ids = owner
            partition_orders = np.zeros(len(frontier), np.int64)
            requests = {}
            for p in range(self.graph.book.num_partitions):
                mask = owner == p
                partition_orders[mask] = np.arange(int(mask.sum()))
                if mask.any():
                    rng_seed = (self.rng * 1_000_003 + self._step * 101 +
                                hop * 7919 + p)
                    requests[p] = (frontier[mask], fanout, rng_seed)
            results = self._scatter_sample(requests)
            per_part_nodes, per_part_eids, per_part_cumsum = [], [], []
            for p in range(self.graph.book.num_partitions):
                if p not in results:
                    per_part_nodes.append(np.zeros(0, np.int64))
                    per_part_eids.append(np.zeros(0, np.int64))
                    per_part_cumsum.append(np.zeros(1, np.int64))
                    continue
                nodes, eids, cumsum = results[p]
                per_part_nodes.append(nodes)
                per_part_eids.append(eids)
                per_part_cumsum.append(cumsum)
            merged_nodes, _, _, counts = merge_sampler_outputs(
                per_part_nodes, per_part_eids, per_part_cumsum,
                partition_ids, partition_orders,
                self.graph.book.num_partitions, fanout)
            sampled_with_dupes.append(merged_nodes)
            counts_per_node.extend(counts)
            new = []
            for v in merged_nodes.tolist():
                if v not in seen:
                    seen.add(v)
                    new.append(v)
            frontier = np.asarray(new, np.int64)
            # Per-hop counts are NEW unique nodes, like the single-machine
            # sampler's num_sampled_nodes_per_hop.
            nodes_per_hop.append(len(new))
        self._step += 1
        all_sampled = (np.concatenate(sampled_with_dupes)
                       if sampled_with_dupes else np.zeros(0, np.int64))
        row, col = relabel_neighborhood(seeds, all_sampled, counts_per_node,
                                        self.graph.num_nodes)
        # node_id = unique nodes in first-seen order (seed-first), exactly
        # the mapper order relabel used.
        seen = {}
        for v in np.concatenate([seeds, all_sampled]):
            if int(v) not in seen:
                seen[int(v)] = len(seen)
        node_id = np.fromiter(seen.keys(), np.int64, len(seen))
        return row, col, node_id, nodes_per_hop


def collective_feature_fetch(mesh, x_shard, ids, axis: str = 'data'):
    """Feature fetch keyed by the (range) partition book, in one rank of
    ``mesh``'s ``axis``.

    ``x_shard``: ``[n_local, F]`` this rank's rows of the ``[P * n_local,
    F]`` features (equal shards: pad the node count). ``ids``: ``[B]``
    global node ids, the same in every rank (pad slots may point
    anywhere). Each rank takes its owned rows and puts zeros elsewhere,
    and an all-reduce sum over the axis delivers the full ``[B, F]``
    batch to every rank. (The JAX function takes the sharded global
    matrix and runs one ``psum`` inside ``shard_map``.)
    """
    import torch
    import torch.distributed as dist

    from pyg_lib_tpu_torch.parallel import _collectives as C

    group = mesh.get_group(axis)
    n_local = x_shard.shape[0]
    lo = dist.get_rank(group) * n_local
    ids = torch.as_tensor(ids, device=x_shard.device).long()
    rows = x_shard.index_select(0, (ids - lo).clamp(0, n_local - 1))
    mine = ((ids >= lo) & (ids < lo + n_local))[:, None]
    out = torch.where(mine, rows, torch.zeros_like(rows))
    return C.all_reduce_(out, group)


class HeteroDistGraph(NamedTuple):
    """Per-node-type partition books + per-(edge type, partition) CSR
    slices: partition ``p`` owns each type's node range and the OUT-edges
    (toward any type) of its owned rows, global col ids — the hetero
    analog of :class:`DistGraph` (reference orchestration lives in PyG's
    ``torch_geometric.distributed`` hetero path; the kernels are the same
    dist triple)."""
    books: Dict  # node type -> PartitionBook
    rowptr_parts: Dict  # (edge type, p) -> local rowptr
    col_parts: Dict  # (edge type, p) -> global cols
    num_nodes: Dict  # node type -> count
    edge_types: Tuple


def partition_hetero_graph(rowptr_dict, col_dict, num_nodes_dict,
                           num_partitions: int) -> HeteroDistGraph:
    """Range-partition every node type; slice each edge type's dst-major
    CSR by its dst type's ranges."""
    books = {}
    for t, n in num_nodes_dict.items():
        books[t] = PartitionBook(
            bounds=np.linspace(0, n, num_partitions + 1).astype(np.int64))
    rowptr_parts, col_parts = {}, {}
    for k, rowptr in rowptr_dict.items():
        rowptr = np.asarray(rowptr, np.int64)
        col = np.asarray(col_dict[k], np.int64)
        bounds = books[k[0]].bounds  # src-major CSR (library convention)
        for p in range(num_partitions):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            rowptr_parts[(k, p)] = rowptr[lo:hi + 1] - rowptr[lo]
            col_parts[(k, p)] = col[rowptr[lo]:rowptr[hi]]
    return HeteroDistGraph(books=books, rowptr_parts=rowptr_parts,
                           col_parts=col_parts,
                           num_nodes=dict(num_nodes_dict),
                           edge_types=tuple(sorted(rowptr_dict)))


class HeteroDistNeighborSampler:
    """Hetero coordinator: per hop and edge type, the frontier of the
    edge type's OWNING type is grouped by partition, each partition
    samples one hop over its slice (:func:`dist_neighbor_sample` — the
    RPC seam), outputs merge back into frontier order, and one
    :func:`pyg_lib_tpu_torch.sampler.dist.hetero_relabel_neighborhood` call at
    the end produces per-type local ids exactly like the single-machine
    hetero sampler."""

    def __init__(self, graph: HeteroDistGraph, rng: int = 0,
                 replace: bool = False, impl: str = 'auto', service=None):
        self.graph = graph
        self.rng = rng
        self.replace = replace
        self.impl = impl
        self.service = service  # transport.SamplingService (else in-proc)
        self._step = 0
        # Per edge type: global edge id of each partition's first edge.
        num_parts = next(iter(graph.books.values())).num_partitions
        self._edge_off = {}
        for k in graph.edge_types:
            sizes = [
                len(graph.col_parts[(k, p)]) for p in range(num_parts)
            ]
            self._edge_off[k] = np.concatenate(
                [[0], np.cumsum(sizes)]).astype(np.int64)

    def _scatter_sample(self, k, requests):
        """``{p: (local_seeds, fanout, rng_seed)}`` for edge type ``k``
        -> per-partition one-hop results (pipelined over the service)."""
        if self.service is None:
            return {
                p: dist_neighbor_sample(self.graph.rowptr_parts[(k, p)],
                                        self.graph.col_parts[(k, p)], seeds,
                                        fanout, replace=self.replace,
                                        rng=rng_seed, impl=self.impl)
                for p, (seeds, fanout, rng_seed) in requests.items()
            }
        wire = {
            p: ('hetero_sample', k, seeds, fanout, rng_seed, self.replace,
                self.impl)
            for p, (seeds, fanout, rng_seed) in requests.items()
        }
        return self.service.scatter(wire)

    def sample(self, seed_dict, num_neighbors_dict):
        from pyg_lib_tpu_torch.sampler.dist import hetero_relabel_neighborhood

        g = self.graph
        node_types = sorted(g.num_nodes)
        edge_types = list(g.edge_types)
        num_layers = max(len(v) for v in num_neighbors_dict.values())

        frontier = {t: np.asarray(seed_dict.get(t, np.zeros(0, np.int64)),
                                  np.int64) for t in node_types}
        streams = {t: [] for t in node_types}  # sampled w/ dupes per type
        counts_dict = {k: [] for k in edge_types}
        # Per-type mirror of relabel's mappers: the next layer expands
        # only NEW unique nodes in first-seen (mapper-insertion) order —
        # relabel's src locals for layer ell+1 are exactly the locals
        # allocated in layer ell (reference srcs_slice_dict advance,
        # dist_relabel_kernel.cpp:240-258).
        seen = {t: set(int(v) for v in frontier[t]) for t in node_types}

        for ell in range(num_layers):
            new_frontier = {t: [] for t in node_types}
            for k in edge_types:
                # src-major CSRs (library convention): expanding an edge
                # type walks from its SRC-type frontier to DST neighbors.
                own_t, nbr_t = k[0], k[2]
                fanouts = num_neighbors_dict.get(k, [])
                fanout = fanouts[ell] if ell < len(fanouts) else 0
                fr = frontier[own_t]
                owner = g.books[own_t].owner(fr) if len(fr) else np.zeros(
                    0, np.int64)
                orders = np.zeros(len(fr), np.int64)
                requests = {}
                # Stable across interpreters (hash() of str is
                # PYTHONHASHSEED-randomised, which would break
                # cross-run/cross-host reproducibility); constant per
                # edge type, so computed once outside the partition loop.
                k_hash = zlib.crc32('__'.join(k).encode())
                for p in range(g.books[own_t].num_partitions):
                    mask = owner == p
                    orders[mask] = np.arange(int(mask.sum()))
                    if mask.any():
                        lo = int(g.books[own_t].bounds[p])
                        rng_seed = (self.rng * 1_000_003 +
                                    self._step * 101 + ell * 7919 +
                                    k_hash % 1000 + p)
                        requests[p] = (fr[mask] - lo, fanout, rng_seed)
                results = self._scatter_sample(k, requests)
                nodes_p, eids_p, cum_p = [], [], []
                for p in range(g.books[own_t].num_partitions):
                    if p not in results:
                        nodes_p.append(np.zeros(0, np.int64))
                        eids_p.append(np.zeros(0, np.int64))
                        cum_p.append(np.zeros(1, np.int64))
                        continue
                    nodes, eids, cumsum = results[p]
                    nodes = nodes.copy()
                    nodes[:len(requests[p][0])] += int(
                        g.books[own_t].bounds[p])  # re-globalise seeds
                    nodes_p.append(nodes)
                    # Globalise edge ids with the partition's edge offset.
                    eids_p.append(eids + self._edge_off[k][p])
                    cum_p.append(cumsum)
                merged, _, _, counts = merge_sampler_outputs(
                    nodes_p, eids_p, cum_p, owner, orders,
                    g.books[own_t].num_partitions, fanout)
                counts_dict[k].append(counts)
                streams[nbr_t].append(merged)
                for v in merged.tolist():
                    if v not in seen[nbr_t]:
                        seen[nbr_t].add(v)
                        new_frontier[nbr_t].append(v)
            frontier = {
                t: np.asarray(v, np.int64)
                for t, v in new_frontier.items()
            }

        sampled = {t: (np.concatenate(v) if v else np.zeros(0, np.int64))
                   for t, v in streams.items()}
        seed_d = {t: np.asarray(seed_dict.get(t, np.zeros(0, np.int64)))
                  for t in node_types}
        row_d, col_d = hetero_relabel_neighborhood(
            node_types, edge_types, seed_d, sampled,
            {k: counts_dict[k] for k in edge_types}, dict(g.num_nodes))
        node_id = {}
        for t in node_types:
            seen = {}
            for v in np.concatenate([seed_d[t], sampled[t]]):
                if int(v) not in seen:
                    seen[int(v)] = len(seen)
            node_id[t] = np.fromiter(seen.keys(), np.int64, len(seen))
        self._step += 1
        return row_d, col_d, node_id


def hetero_collective_feature_fetch(mesh, x_shard_dict, ids_dict,
                                    axis: str = 'data'):
    """Per-node-type :func:`collective_feature_fetch` (hetero batches
    fetch one padded id table per type), in one rank of ``mesh``'s
    ``axis``: ``x_shard_dict`` holds this rank's rows of each type."""
    return {t: collective_feature_fetch(mesh, x_shard_dict[t],
                                        ids_dict[t], axis=axis)
            for t in ids_dict}
