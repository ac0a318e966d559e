"""Stateful host objects (port of ``pyg_lib_tpu.classes``).

Plain picklable Python objects, as in the JAX package: ``HashMap`` (sorted
keys and binary search on the host), ``DeviceHashMap`` (the same over a
sorted key tensor on the card, ``torch.searchsorted``), the stateful
``NeighborSampler`` and ``HeteroNeighborSampler`` over the port's
sampler, and ``MetapathTracker``.
"""

from typing import Dict, List, Optional

import numpy as np

import torch

from pyg_lib_tpu_torch.sampler import (hetero_neighbor_sample,
                                       neighbor_sample)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['HashMap', 'DeviceHashMap', 'NeighborSampler',
           'HeteroNeighborSampler', 'MetapathTracker']


class HashMap:
    """Persistent key -> index map for node-ID lookup / feature fetch.

    Counterpart of reference ``CPUHashMap``/``CUDAHashMap``
    (``csrc/classes/cpu/hash_map.cpp:20-171``, ``cuda/hash_map.cu:33-110``).
    Vectorised sort + binary search instead of a pointer-chasing hash table:
    ``get`` on m queries is O(m log n) with perfect memory streaming, which
    beats a serial hashmap on the wide batched queries this is used for.
    Picklable via ``keys()`` like the reference (``hash_map.cpp:265-275``).
    """

    def __init__(self, keys):
        keys = np.asarray(keys)
        if keys.ndim != 1:
            raise ValueError('HashMap keys must be 1-D')
        self._keys = keys
        self._order = np.argsort(keys, kind='stable')
        self._sorted = keys[self._order]
        if len(self._sorted) > 1 and (self._sorted[1:]
                                      == self._sorted[:-1]).any():
            raise ValueError('HashMap keys must be unique')

    def get(self, queries) -> np.ndarray:
        """Returns the index of each query in ``keys`` (-1 if absent)."""
        q = np.asarray(queries)
        pos = np.searchsorted(self._sorted, q)
        pos = np.minimum(pos, len(self._sorted) - 1)
        if len(self._sorted) == 0:
            return np.full(q.shape, -1, np.int64)
        found = self._sorted[pos] == q
        return np.where(found, self._order[pos], -1).astype(np.int64)

    def keys(self) -> np.ndarray:
        return self._keys

    def __len__(self):
        return len(self._keys)

    def __getstate__(self):
        return {'keys': self._keys}

    def __setstate__(self, state):
        self.__init__(state['keys'])


class DeviceHashMap:
    """Key -> index map on the card, for id lookups without a trip to the
    host.

    Counterpart of the JAX package's ``DeviceHashMap`` and the reference's
    ``CUDAHashMap``: the keys sorted once on the host, their order kept
    beside them, and ``get`` a ``torch.searchsorted`` over the sorted keys
    on their device. Keys are int64; an absent key gives -1. The tensors
    live on ``device`` (default: the CUDA card). Picklable via ``keys()``.
    """

    def __init__(self, keys, device=None):
        keys_np = np.asarray(keys)
        if keys_np.ndim != 1:
            raise ValueError('DeviceHashMap keys must be 1-D')
        keys_np = keys_np.astype(np.int64)
        order = np.argsort(keys_np, kind='stable')
        sorted_np = keys_np[order]
        if len(sorted_np) > 1 and (sorted_np[1:] == sorted_np[:-1]).any():
            raise ValueError('DeviceHashMap keys must be unique')
        self.device = _resolve_device(device)
        self._keys_np = keys_np
        self._sorted = torch.from_numpy(sorted_np).to(self.device)
        self._order = torch.from_numpy(order.astype(np.int64)).to(
            self.device)

    def get(self, queries) -> torch.Tensor:
        """Index of each query in ``keys`` (-1 if absent), an int64 tensor
        on the map's device."""
        q = torch.as_tensor(queries, dtype=torch.int64, device=self.device)
        if len(self._keys_np) == 0:
            return torch.full(q.shape, -1, dtype=torch.int64,
                              device=self.device)
        pos = torch.searchsorted(self._sorted, q).clamp(
            max=self._sorted.shape[0] - 1)
        found = self._sorted[pos] == q
        return torch.where(found, self._order[pos], torch.full_like(pos, -1))

    def keys(self) -> np.ndarray:
        return self._keys_np

    def __len__(self):
        return len(self._keys_np)

    def __getstate__(self):
        return {'keys': self._keys_np, 'device': str(self.device)}

    def __setstate__(self, state):
        self.__init__(state['keys'], device=state['device'])


class NeighborSampler:
    """Stateful homogeneous sampler holding graph refs.

    Counterpart of reference ``torch.classes.pyg.NeighborSampler``
    (``csrc/classes/cpu/neighbor_sampler.cpp:16-60`` — whose ``sample()``
    is an unimplemented stub in the reference; this one works).
    """

    def __init__(self, rowptr, col, edge_weight=None, node_time=None,
                 edge_time=None):
        self.rowptr = np.asarray(rowptr)
        self.col = np.asarray(col)
        self.edge_weight = None if edge_weight is None else np.asarray(
            edge_weight)
        self.node_time = None if node_time is None else np.asarray(node_time)
        self.edge_time = None if edge_time is None else np.asarray(edge_time)

    def sample(self, num_neighbors: List[int], seed, seed_time=None,
               csc: bool = False, replace: bool = False,
               directed: bool = True, disjoint: bool = False,
               temporal_strategy: str = 'uniform',
               return_edge_id: bool = True, rng=None):
        return neighbor_sample(
            self.rowptr, self.col, seed, num_neighbors,
            node_time=self.node_time, edge_time=self.edge_time,
            seed_time=seed_time, edge_weight=self.edge_weight, csc=csc,
            replace=replace, directed=directed, disjoint=disjoint,
            temporal_strategy=temporal_strategy,
            return_edge_id=return_edge_id, rng=rng)


class HeteroNeighborSampler:
    """Stateful heterogeneous sampler constructed once with graph dicts.

    Counterpart of reference ``torch.classes.pyg.HeteroNeighborSampler``
    (``csrc/classes/cpu/neighbor_sampler.h:58-158``).  ``sample`` returns
    the standard 6-tuple plus a per-node-type ``batch`` dict (the reference
    additionally returns per-node batch vectors).
    """

    def __init__(self, node_types, edge_types, rowptr_dict, col_dict,
                 node_time_dict=None, edge_time_dict=None,
                 edge_weight_dict=None):
        self.node_types = list(node_types)
        self.edge_types = list(edge_types)
        self.rowptr_dict = {k: np.asarray(v) for k, v in rowptr_dict.items()}
        self.col_dict = {k: np.asarray(v) for k, v in col_dict.items()}
        self.node_time_dict = node_time_dict
        self.edge_time_dict = edge_time_dict
        self.edge_weight_dict = edge_weight_dict

    def sample(self, num_neighbors_dict, seed_dict, seed_time_dict=None,
               csc: bool = False, replace: bool = False,
               directed: bool = True, disjoint: bool = False,
               temporal_strategy: str = 'uniform',
               return_edge_id: bool = True, rng=None):
        out = hetero_neighbor_sample(
            self.rowptr_dict, self.col_dict, seed_dict, num_neighbors_dict,
            node_time_dict=self.node_time_dict,
            edge_time_dict=self.edge_time_dict,
            seed_time_dict=seed_time_dict,
            edge_weight_dict=self.edge_weight_dict, csc=csc, replace=replace,
            directed=directed, disjoint=disjoint,
            temporal_strategy=temporal_strategy,
            return_edge_id=return_edge_id, rng=rng)
        row, col, node_id, eid, nnph, neph = out
        batch = None
        if disjoint:
            # Disjoint node ids are ALWAYS [N, 2] (batch, node) pairs —
            # both the numpy spec and the C++ engine emit 2-D arrays
            # (including the empty np.zeros((0, 2)) case).
            batch = {t: v[:, 0] for t, v in node_id.items()}
            node_id = {t: v[:, 1] for t, v in node_id.items()}
        return row, col, node_id, batch, eid, nnph, neph


class MetapathTracker:
    """Pre-computes the tree of possible metapaths for (edge_types x hops)
    and expected vs reported sample counts per batch.

    Counterpart of reference ``MetapathTracker``
    (``csrc/classes/cpu/neighbor_sampler.h:14-56``, ctor
    ``csrc/classes/cpu/neighbor_sampler.cpp:62-99``), used for balanced
    sampling accounting in the class-based hetero sampler.  Edge types are
    ``(src, rel, dst)`` tuples (no ``"src__rel__dst"`` mangling).
    """

    def __init__(self, edge_types, num_neighbors: Dict, seed_node_types):
        self.edge_types = list(edge_types)
        self.num_neighbors = {k: list(v) for k, v in num_neighbors.items()}
        self.n_metapaths = 0
        self.seed_metapaths: Dict[str, int] = {}
        # rel edge type -> {src metapath id -> dst metapath id}
        self.metapath_tree: Dict[tuple, Dict[int, int]] = {}
        self.expected_sample_size: Dict[int, Dict[int, int]] = {}
        self.reported_sample_size: Dict[int, Dict[int, int]] = {}

        sampled: Dict[str, List[int]] = {}
        for node_t in seed_node_types:
            self.seed_metapaths[node_t] = self.n_metapaths
            sampled[node_t] = [self.n_metapaths]
            self.n_metapaths += 1
        num_hops = max((len(v) for v in self.num_neighbors.values()),
                       default=0)
        for _ in range(num_hops):
            source, sampled = sampled, {}
            for edge_t in self.edge_types:
                src_t, _, dst_t = edge_t
                if src_t not in source:
                    continue
                for mp in source[src_t]:
                    new_id = self.n_metapaths
                    self.n_metapaths += 1
                    sampled.setdefault(dst_t, []).append(new_id)
                    self.metapath_tree.setdefault(edge_t, {})[mp] = new_id

    def get_neighbor_metapath(self, metapath_id: int, edge_type) -> int:
        return self.metapath_tree[edge_type][metapath_id]

    def get_sample_size(self, batch_id: int, src_metapath_id: int,
                        edge_type) -> int:
        dst = self.get_neighbor_metapath(src_metapath_id, edge_type)
        return self.expected_sample_size.get(batch_id, {}).get(dst, 0)

    def report_sample_size(self, batch_id: int, metapath_id: int,
                           n_sampled: int) -> None:
        d = self.reported_sample_size.setdefault(batch_id, {})
        d[metapath_id] = d.get(metapath_id, 0) + n_sampled

    def get_reported_sample_size(self, batch_id: int,
                                 metapath_id: int) -> int:
        return self.reported_sample_size.get(batch_id, {}).get(
            metapath_id, 0)

    def init_batch(self, batch_id: int, node_t: str,
                   batch_size: int) -> int:
        seed_mp = self.seed_metapaths[node_t]
        self.reported_sample_size.setdefault(batch_id,
                                             {})[seed_mp] = batch_size
        self.expected_sample_size.setdefault(batch_id,
                                             {})[seed_mp] = batch_size
        self._init_expected(seed_mp, batch_id, 0)
        return seed_mp

    def _init_expected(self, src_mp: int, batch_id: int, hop: int) -> None:
        for edge_t, tree in self.metapath_tree.items():
            if src_mp not in tree:
                continue
            dst_mp = tree[src_mp]
            fanouts = self.num_neighbors.get(edge_t, [])
            mult = fanouts[hop] if hop < len(fanouts) else 0
            if mult > 0:
                self.expected_sample_size[batch_id][dst_mp] = (
                    mult * self.expected_sample_size[batch_id][src_mp])
                self._init_expected(dst_mp, batch_id, hop + 1)
