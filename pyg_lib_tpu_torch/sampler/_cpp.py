"""ctypes bindings of the host sampling engine (``csrc/host``).

Port of ``pyg_lib_tpu/sampler/_cpp.py``. The engine (neighbour sampling,
hetero sampling, subgraph, random walks with and without p/q, and the
partitioner's growth, refinement and edge cut) is built with ``g++`` into
``pyg_lib_tpu_torch/_build/`` at its first call (``_build.load_host``);
a failed build raises. Unlike the JAX loader, nothing here falls back to
numpy: the numpy specification runs only where a caller asks for it with
``impl='numpy'``.

``calls`` counts the engine's calls by entry point, so a run can show
that the engine, not numpy, drew its samples. The engine releases the GIL
during each call (ctypes does), so threads that sample overlap; each call
takes its working memory from a pool the engine keeps, so a thread that
samples batch after batch touches no fresh pages.

:func:`neighbor_sample_padded_cpp` keeps a sample inside the engine, for
:meth:`EngineSample.pad` to write as the padded batch in one call.
"""

import ctypes
import threading
from typing import List, Optional

import numpy as np

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.sampler.padding import BudgetExceeded, PaddedBatch

__all__ = ['EngineSample', 'calls', 'edge_cut_cpp', 'get_lib',
           'hetero_neighbor_sample_cpp', 'neighbor_sample_cpp',
           'neighbor_sample_padded_cpp', 'part_grow_cpp', 'part_refine_cpp',
           'random_walk_cpp', 'random_walk_pq_cpp', 'rng_seed_from',
           'set_num_threads', 'subgraph_cpp']

# Engine calls by entry point (the loader's threads add to it too).
calls = {name: 0 for name in ('neighbor_sample', 'neighbor_sample_padded',
                              'hetero_neighbor_sample', 'subgraph',
                              'random_walk', 'random_walk_pq', 'part_grow',
                              'part_refine', 'edge_cut')}
_calls_lock = threading.Lock()
_lib = _held_lib = None


def _count(name: str) -> None:
    with _calls_lock:
        calls[name] += 1


def _declare(lib) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
    lib.pygt_neighbor_sample.restype = ctypes.c_void_p
    lib.pygt_neighbor_sample.argtypes = [
        i64p, i64p, i64, i64p, i64, i64p, i64, f64p, i64p, i64p, i64p, i32,
        i32, i32, i32, i32, i32, u64]
    lib.pygt_result_sizes.argtypes = [ctypes.c_void_p, i64p]
    lib.pygt_result_copy.argtypes = [ctypes.c_void_p] + [i64p] * 7
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pygt_result_pad.restype = i32
    lib.pygt_result_pad.argtypes = [ctypes.c_void_p, i64, i64, i64p, i32p,
                                    u8p, i32p, i32p, i32p, i64p, u8p]
    lib.pygt_result_free.argtypes = [ctypes.c_void_p]
    lib.pygt_hetero_sample.restype = ctypes.c_void_p
    lib.pygt_hetero_sample.argtypes = [
        i64, i64, i32p, i32p, i64p, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
        i64, f64p, i64p, i64p, i64p, i64p, i32p, i32p, i32p, i32, i32, i32,
        i32, i32, u64]
    lib.pygt_hetero_sizes.argtypes = [ctypes.c_void_p, i64p, i64p]
    lib.pygt_hetero_copy_edges.argtypes = [ctypes.c_void_p, i64, i64p, i64p,
                                           i64p, i64p]
    lib.pygt_hetero_copy_nodes.argtypes = [ctypes.c_void_p, i64, i64p, i64p,
                                           i64p]
    lib.pygt_hetero_free.argtypes = [ctypes.c_void_p]
    lib.pygt_set_num_threads.argtypes = [i32]
    lib.pygt_get_max_threads.restype = i32
    lib.pygt_subgraph.restype = ctypes.c_void_p
    lib.pygt_subgraph.argtypes = [i64p, i64p, i64, i64p, i64, i32]
    lib.pygt_subgraph_num_edges.restype = i64
    lib.pygt_subgraph_num_edges.argtypes = [ctypes.c_void_p]
    lib.pygt_subgraph_copy.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
    lib.pygt_subgraph_free.argtypes = [ctypes.c_void_p]
    lib.pygt_random_walk.argtypes = [i64p, i64p, i64p, i64, i64, u64, i64p]
    lib.pygt_random_walk_pq.argtypes = [i64p, i64p, i64p, i64, i64,
                                        ctypes.c_double, ctypes.c_double, u64,
                                        i64p]
    lib.pygt_part_grow.argtypes = [i64p, i64p, i64, f64p, i64, f64p, i64p,
                                   i64, i64p, i64, i64p, f64p]
    lib.pygt_part_refine.restype = i64
    lib.pygt_part_refine.argtypes = [i64p, i64p, i64, f64p, f64p, i64p, i64,
                                     i64, ctypes.c_double]
    lib.pygt_edge_cut.restype = ctypes.c_double
    lib.pygt_edge_cut.argtypes = [i64p, i64p, i64, i64p, f64p]


def get_lib() -> ctypes.CDLL:
    """The engine's library with its functions declared, built at the
    first call; raises if it cannot be built."""
    global _lib
    if _lib is None:
        lib = _build.load_host()
        _declare(lib)
        _lib = lib
    return _lib


def _held() -> ctypes.PyDLL:
    """The engine's library again, its calls holding the GIL: for a
    result's small calls (its sizes, its per-hop counts, its free), which
    take microseconds, where a call that lets the GIL go must wait to take
    it back while other threads run Python."""
    global _held_lib
    if _held_lib is None:
        held = ctypes.PyDLL(get_lib()._name)
        _declare(held)
        _held_lib = held
    return _held_lib


def set_num_threads(n: int) -> None:
    """Set the engine's OpenMP width at run time (``OMP_NUM_THREADS`` is
    read only when the library loads)."""
    get_lib().pygt_set_num_threads(int(n))


def rng_seed_from(rng) -> int:
    """The engine's integer seed: ``rng`` itself when it is an int, else
    one draw from ``np.random.default_rng(rng)`` (a ``Generator`` is used
    as it is), as the JAX package derives it."""
    if isinstance(rng, int):
        return rng
    return int(np.random.default_rng(rng).integers(2**63))


def _ptr(a: Optional[np.ndarray], typ=ctypes.c_int64):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _opt(a, dtype) -> Optional[np.ndarray]:
    return None if a is None else np.ascontiguousarray(a, dtype)


def _sample(lib, entry: str, rowptr, col, seed, num_neighbors,
            node_time=None, edge_time=None, seed_time=None, edge_weight=None,
            replace=False, directed=True, disjoint=False,
            temporal_strategy='uniform', return_edge_id=True,
            distributed=False, rng_seed=0):
    """The engine's handle of one sample (free it with
    ``pygt_result_free``), counted in ``calls[entry]``."""
    _count(entry)
    rowptr, col, seed = _i64(rowptr), _i64(col), _i64(seed)
    fanouts = _i64(num_neighbors)
    ew = _opt(edge_weight, np.float64)
    nt, et, st = (_opt(a, np.int64) for a in (node_time, edge_time,
                                              seed_time))
    handle = lib.pygt_neighbor_sample(
        _ptr(rowptr), _ptr(col), len(rowptr) - 1, _ptr(seed), len(seed),
        _ptr(fanouts), len(fanouts), _ptr(ew, ctypes.c_double), _ptr(nt),
        _ptr(et), _ptr(st), int(replace), int(directed), int(disjoint),
        int(temporal_strategy == 'last'), int(return_edge_id),
        int(distributed), rng_seed & (2**64 - 1))
    if not handle:
        raise IndexError(
            'neighbor_sample: seed id out of range [0, num_nodes), or '
            'temporal sampling without disjoint=True')
    return handle


def _sizes(handle):
    """Edges, nodes, edge ids, and the per-hop node and edge counts."""
    sizes = np.zeros(5, np.int64)
    _held().pygt_result_sizes(handle, _ptr(sizes))
    return map(int, sizes)


def neighbor_sample_cpp(rowptr: np.ndarray, col: np.ndarray,
                        seed: np.ndarray, num_neighbors: List[int],
                        node_time=None, edge_time=None, seed_time=None,
                        edge_weight=None, csc: bool = False,
                        replace: bool = False, directed: bool = True,
                        disjoint: bool = False,
                        temporal_strategy: str = 'uniform',
                        return_edge_id: bool = True,
                        distributed: bool = False, rng_seed: int = 0):
    """The engine's neighbour sampler; returns the numpy specification's
    tuple (or the distributed triple with ``distributed=True``)."""
    lib = get_lib()
    handle = _sample(lib, 'neighbor_sample', rowptr, col, seed,
                     num_neighbors, node_time, edge_time, seed_time,
                     edge_weight, replace, directed, disjoint,
                     temporal_strategy, return_edge_id, distributed,
                     rng_seed)
    try:
        n_edges, n_nodes, n_eids, n_nph, n_eph = _sizes(handle)
        rows = np.empty(n_edges, np.int64)
        cols = np.empty(n_edges, np.int64)
        eids = np.empty(n_eids, np.int64)
        nodes = np.empty(n_nodes, np.int64)
        batches = np.empty(n_nodes, np.int64)
        nph = np.empty(n_nph, np.int64)
        eph = np.empty(n_eph, np.int64)
        lib.pygt_result_copy(handle, _ptr(rows), _ptr(cols), _ptr(eids),
                             _ptr(nodes), _ptr(batches), _ptr(nph),
                             _ptr(eph))
    finally:
        _held().pygt_result_free(handle)
    if distributed:
        # rows holds the cumulative node count after each hop; the seed
        # count goes first.
        cumsum = np.concatenate([[len(seed)], rows]).astype(np.int64)
        return nodes, eids, cumsum
    node_id = np.stack([batches, nodes], axis=1) if disjoint else nodes
    out_row, out_col = (cols, rows) if csc else (rows, cols)
    return (out_row, out_col, node_id, eids if return_edge_id else None,
            nph.tolist(), eph.tolist())


class EngineSample:
    """A directed sample that the engine keeps
    (:func:`neighbor_sample_padded_cpp`): its edges come in destination
    order, so :meth:`pad` writes the padded batch of ``csc=True`` straight
    from the engine's arrays, in one call that releases the GIL, with no
    sort. ``num_nodes``, ``num_edges``, ``nodes_per_hop`` and
    ``edges_per_hop`` are the sample's counts. The engine's memory goes
    back to its pool once a batch is written, or at :meth:`close`."""

    def __init__(self, lib, handle, disjoint: bool, return_edge_id: bool):
        held = _held()
        self._lib, self._handle, self._free = lib, handle, \
            held.pygt_result_free
        self.disjoint, self.return_edge_id = disjoint, return_edge_id
        self.num_edges, self.num_nodes, _, n_nph, n_eph = _sizes(handle)
        nph = np.empty(n_nph, np.int64)
        eph = np.empty(n_eph, np.int64)
        held.pygt_result_copy(handle, None, None, None, None, None,
                              _ptr(nph), _ptr(eph))
        self.nodes_per_hop, self.edges_per_hop = nph.tolist(), eph.tolist()

    def pad(self, max_nodes: int, max_edges: int,
            num_seeds: int) -> PaddedBatch:
        """The sample padded to ``max_nodes`` nodes and ``max_edges`` edges,
        byte for byte ``padding.pad_sample_output`` of its ``csc=True``
        tuple; raises :class:`~padding.BudgetExceeded` as that does, and
        the sample stays for a larger bucket."""
        if self._handle is None:
            raise RuntimeError('the sample was padded or closed already')
        n, e = self.num_nodes, self.num_edges
        if n > max_nodes:
            raise BudgetExceeded(f'{n} nodes > budget {max_nodes}')
        if e > max_edges:
            raise BudgetExceeded(f'{e} edges > budget {max_edges}')
        node_id = np.empty(max_nodes, np.int64)
        batch = np.empty(max_nodes, np.int32) if self.disjoint else None
        node_mask = np.empty(max_nodes, bool)
        rowptr = np.empty(max_nodes + 1, np.int32)
        row = np.empty(max_edges, np.int32)
        col = np.empty(max_edges, np.int32)
        edge_id = np.empty(max_edges, np.int64) if self.return_edge_id \
            else None
        edge_mask = np.empty(max_edges, bool)
        i32, u8 = ctypes.c_int32, ctypes.c_uint8
        rc = self._lib.pygt_result_pad(
            self._handle, max_nodes, max_edges, _ptr(node_id),
            _ptr(batch, i32), _ptr(node_mask, u8), _ptr(rowptr, i32),
            _ptr(row, i32), _ptr(col, i32), _ptr(edge_id),
            _ptr(edge_mask, u8))
        if rc != 0:
            raise RuntimeError(f'pygt_result_pad returned {rc}')
        self.close()
        return PaddedBatch(
            node_id=node_id, batch=batch, row=row, col=col, edge_id=edge_id,
            rowptr=rowptr, node_mask=node_mask, edge_mask=edge_mask,
            num_nodes=n, num_edges=e,
            num_sampled_nodes_per_hop=list(self.nodes_per_hop),
            num_sampled_edges_per_hop=list(self.edges_per_hop),
            num_seeds=num_seeds)

    def close(self) -> None:
        """Give the engine's memory back (a later :meth:`pad` raises)."""
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)

    def __del__(self):
        self.close()


def neighbor_sample_padded_cpp(rowptr: np.ndarray, col: np.ndarray,
                               seed: np.ndarray, num_neighbors: List[int],
                               node_time=None, edge_time=None,
                               seed_time=None, edge_weight=None,
                               replace: bool = False, disjoint: bool = False,
                               temporal_strategy: str = 'uniform',
                               return_edge_id: bool = True,
                               rng_seed: int = 0) -> EngineSample:
    """The engine's directed neighbour sample, kept in the engine as an
    :class:`EngineSample`: the same draws as :func:`neighbor_sample_cpp`
    with ``csc=True``, for the padded batch."""
    lib = get_lib()
    handle = _sample(lib, 'neighbor_sample_padded', rowptr, col, seed,
                     num_neighbors, node_time, edge_time, seed_time,
                     edge_weight, replace, disjoint=disjoint,
                     temporal_strategy=temporal_strategy,
                     return_edge_id=return_edge_id, rng_seed=rng_seed)
    return EngineSample(lib, handle, disjoint, return_edge_id)


# -- heterogeneous sampling -------------------------------------------------


def _cat(arrs, dtype):
    """The arrays end to end, and the offsets of each."""
    offs = np.zeros(len(arrs) + 1, np.int64)
    for i, a in enumerate(arrs):
        offs[i + 1] = offs[i] + len(a)
    flat = (np.ascontiguousarray(np.concatenate(
        [np.asarray(a, dtype) for a in arrs]), dtype)
            if len(arrs) else np.zeros(0, dtype))
    return flat, offs


class _HeteroGraph:
    """The per-edge-type CSRs laid end to end for the engine (O(E) to
    build, so cached by :func:`hetero_neighbor_sample_cpp`).

    Node types go seed types first, in ``seed_types``' order, then the
    rest sorted: the engine numbers disjoint batches in that slot order,
    which is then the numpy specification's order over ``seed_dict``.
    """

    def __init__(self, rowptr_dict, col_dict, seed_types, csc,
                 node_time_dict, edge_time_dict, edge_weight_dict):
        # The cache is keyed by these arrays' addresses: holding them
        # keeps the addresses from being reused while the entry lives.
        self._refs = (rowptr_dict, col_dict, node_time_dict, edge_time_dict,
                      edge_weight_dict)
        edge_types = list(rowptr_dict)
        src_of = (lambda k: k[2]) if csc else (lambda k: k[0])
        dst_of = (lambda k: k[0]) if csc else (lambda k: k[2])
        rest = sorted(({src_of(k) for k in edge_types}
                       | {dst_of(k) for k in edge_types}) - set(seed_types))
        node_types = list(seed_types) + rest
        t_idx = {t: i for i, t in enumerate(node_types)}
        T, K = len(node_types), len(edge_types)
        self.src_type = np.asarray([t_idx[src_of(k)] for k in edge_types],
                                   np.int32)
        self.dst_type = np.asarray([t_idx[dst_of(k)] for k in edge_types],
                                   np.int32)
        rowptrs = [rowptr_dict[k] for k in edge_types]
        cols = [col_dict[k] for k in edge_types]
        self.rowptr_cat, self.rowptr_off = _cat(rowptrs, np.int64)
        self.col_cat, self.col_off = _cat(cols, np.int64)

        num_nodes = np.zeros(T, np.int64)
        for k, rp in zip(edge_types, rowptrs):
            i = t_idx[src_of(k)]
            num_nodes[i] = max(num_nodes[i], len(rp) - 1)
        for k, c in zip(edge_types, cols):
            if len(c):
                i = t_idx[dst_of(k)]
                num_nodes[i] = max(num_nodes[i], int(np.max(c)) + 1)
        if node_time_dict:
            for t, nt in node_time_dict.items():
                if t in t_idx:
                    num_nodes[t_idx[t]] = max(num_nodes[t_idx[t]], len(nt))

        def per_edge_type(d, dtype):
            """``d``'s arrays end to end (zeros for the types it lacks)
            and which types it has; ``(None, zeros)`` without ``d``."""
            has = np.zeros(K, np.int32)
            if not d:
                return None, has
            arrs = []
            for i, k in enumerate(edge_types):
                if d.get(k) is not None:
                    has[i] = 1
                    arrs.append(np.asarray(d[k], dtype))
                else:
                    arrs.append(np.zeros(len(cols[i]), dtype))
            return _cat(arrs, dtype)[0], has

        self.weight_cat, self.has_weight = per_edge_type(edge_weight_dict,
                                                         np.float64)
        self.edge_time_cat, self.has_edge_time = per_edge_type(
            edge_time_dict, np.int64)
        self.has_node_time = np.zeros(T, np.int32)
        self.node_time_cat = self.node_time_off = None
        if node_time_dict:
            arrs = []
            for i, t in enumerate(node_types):
                if node_time_dict.get(t) is not None:
                    self.has_node_time[i] = 1
                    nt = np.asarray(node_time_dict[t], np.int64)
                    if len(nt) < int(num_nodes[i]):
                        # The specification raises on time[col] past the
                        # array; laid end to end, the next type's times
                        # would be read instead.
                        raise IndexError(
                            f'node_time_dict[{t!r}] has {len(nt)} entries '
                            f'but node ids reach {int(num_nodes[i]) - 1}')
                    arrs.append(nt)
                else:
                    arrs.append(np.zeros(int(num_nodes[i]), np.int64))
            self.node_time_cat, self.node_time_off = _cat(arrs, np.int64)
        self.edge_types, self.node_types = edge_types, node_types
        self.T, self.K = T, K
        self.num_nodes = num_nodes


# At most this many flattened graphs are cached, the oldest dropped first.
_HETERO_CACHE: dict = {}
_HETERO_CACHE_ENTRIES = 4
_hetero_lock = threading.Lock()


def _fingerprint(rowptr_dict, col_dict, seed_types, csc, node_time_dict,
                 edge_time_dict, edge_weight_dict):
    def sig(d):
        if not d:
            return None
        return tuple((k, a.ctypes.data, a.shape[0], a.strides, str(a.dtype))
                     for k, a in ((k, np.asarray(v)) for k, v in d.items()))

    return (sig(rowptr_dict), sig(col_dict), tuple(seed_types), csc,
            sig(node_time_dict), sig(edge_time_dict), sig(edge_weight_dict))


def hetero_neighbor_sample_cpp(rowptr_dict, col_dict, seed_dict,
                               num_neighbors_dict, node_time_dict=None,
                               edge_time_dict=None, seed_time_dict=None,
                               edge_weight_dict=None, csc: bool = False,
                               replace: bool = False, directed: bool = True,
                               disjoint: bool = False,
                               temporal_strategy: str = 'uniform',
                               return_edge_id: bool = True,
                               rng_seed: int = 0):
    """The engine's hetero sampler; the numpy specification's tuple
    (``_hetero_impl.py``), keys kept.

    The flattened graph is cached by the addresses of the arrays given
    (converted first, so the cache holds exactly those), up to 4 graphs:
    graph arrays must not change in place between calls.
    """
    lib = get_lib()
    conv = lambda d: None if d is None else {k: np.asarray(v)
                                             for k, v in d.items()}
    rowptr_dict, col_dict = conv(rowptr_dict), conv(col_dict)
    node_time_dict, edge_time_dict = conv(node_time_dict), conv(
        edge_time_dict)
    edge_weight_dict = conv(edge_weight_dict)
    fp = _fingerprint(rowptr_dict, col_dict, tuple(seed_dict), csc,
                      node_time_dict, edge_time_dict, edge_weight_dict)
    with _hetero_lock:
        g = _HETERO_CACHE.get(fp)
        if g is None:
            if len(_HETERO_CACHE) >= _HETERO_CACHE_ENTRIES:
                _HETERO_CACHE.pop(next(iter(_HETERO_CACHE)))
            g = _HeteroGraph(rowptr_dict, col_dict, tuple(seed_dict), csc,
                             node_time_dict, edge_time_dict,
                             edge_weight_dict)
            _HETERO_CACHE[fp] = g
    return _hetero_run(lib, g, seed_dict, num_neighbors_dict, seed_time_dict,
                       csc, replace, directed, disjoint, temporal_strategy,
                       return_edge_id, rng_seed)


def _hetero_run(lib, g, seed_dict, num_neighbors_dict, seed_time_dict, csc,
                replace, directed, disjoint, temporal_strategy,
                return_edge_id, rng_seed):
    edge_types, node_types = g.edge_types, g.node_types
    T, K = g.T, g.K
    L = max(len(v) for v in num_neighbors_dict.values())
    if disjoint and seed_time_dict is None and g.node_time_cat is not None:
        for t in seed_dict:
            ti = node_types.index(t)
            if len(np.asarray(seed_dict[t])) and not g.has_node_time[ti]:
                # The specification indexes node_time_dict[t].
                raise KeyError(
                    f'node_time_dict is missing seed node type {t!r}')
    seeds = {t: np.zeros(0, np.int64) for t in node_types}
    seed_times = {t: None for t in node_types}
    for t, s in seed_dict.items():
        seeds[t] = _i64(s)
        if seed_time_dict is not None and t in seed_time_dict:
            seed_times[t] = _i64(seed_time_dict[t])
    seed_cat, seed_off = _cat([seeds[t] for t in node_types], np.int64)
    seed_time_cat = None
    if seed_time_dict is not None:
        arrs = []
        for t in node_types:
            if seed_times[t] is None and len(seeds[t]):
                # The specification raises for a seed type without times.
                raise KeyError(
                    f'seed_time_dict is missing seed node type {t!r}')
            arrs.append(seed_times[t] if seed_times[t] is not None else
                        np.zeros(len(seeds[t]), np.int64))
        seed_time_cat, _ = _cat(arrs, np.int64)
    fanouts = np.zeros((K, L), np.int64)
    for i, k in enumerate(edge_types):
        v = list(num_neighbors_dict[k])
        fanouts[i, :len(v)] = v

    i32 = ctypes.c_int32
    handle = lib.pygt_hetero_sample(
        T, K, _ptr(g.src_type, i32), _ptr(g.dst_type, i32),
        _ptr(g.rowptr_cat), _ptr(g.rowptr_off), _ptr(g.col_cat),
        _ptr(g.col_off), _ptr(g.num_nodes), _ptr(seed_cat), _ptr(seed_off),
        _ptr(fanouts), L, _ptr(g.weight_cat, ctypes.c_double),
        _ptr(g.node_time_cat), _ptr(g.node_time_off), _ptr(g.edge_time_cat),
        _ptr(seed_time_cat), _ptr(g.has_weight, i32),
        _ptr(g.has_edge_time, i32), _ptr(g.has_node_time, i32),
        int(replace), int(directed), int(disjoint),
        int(temporal_strategy == 'last'), int(return_edge_id),
        rng_seed & (2**64 - 1))
    _count('hetero_neighbor_sample')
    if not handle:
        raise IndexError(
            "hetero_neighbor_sample: a seed id is outside its node type's "
            'range or node_time segment')
    try:
        edge_sizes = np.zeros(K, np.int64)
        node_sizes = np.zeros(T, np.int64)
        lib.pygt_hetero_sizes(handle, _ptr(edge_sizes), _ptr(node_sizes))
        out_row, out_col = {}, {}
        out_eid = {} if return_edge_id else None
        num_edges_per_hop = {}
        for i, k in enumerate(edge_types):
            ne = int(edge_sizes[i])
            rows = np.empty(ne, np.int64)
            cols = np.empty(ne, np.int64)
            eids = np.empty(ne if return_edge_id else 0, np.int64)
            # Undirected sampling gives one induced-edge total a type.
            eph = np.empty(L if directed else 1, np.int64)
            lib.pygt_hetero_copy_edges(handle, i, _ptr(rows), _ptr(cols),
                                       _ptr(eids), _ptr(eph))
            out_row[k], out_col[k] = (cols, rows) if csc else (rows, cols)
            if return_edge_id:
                out_eid[k] = eids
            num_edges_per_hop[k] = eph.tolist()
        out_node_id, num_nodes_per_hop = {}, {}
        for i, t in enumerate(node_types):
            nn = int(node_sizes[i])
            nodes = np.empty(nn, np.int64)
            batches = np.empty(nn, np.int64)
            nph = np.empty(L + 1, np.int64)
            lib.pygt_hetero_copy_nodes(handle, i, _ptr(nodes), _ptr(batches),
                                       _ptr(nph))
            out_node_id[t] = (np.stack([batches, nodes], axis=1)
                              if disjoint else nodes)
            num_nodes_per_hop[t] = nph.tolist()
    finally:
        lib.pygt_hetero_free(handle)
    return (out_row, out_col, out_node_id, out_eid, num_nodes_per_hop,
            num_edges_per_hop)


# -- subgraph, random walks -------------------------------------------------


def subgraph_cpp(rowptr, col, nodes, return_edge_id: bool = True):
    """The engine's induced subgraph: local ``(rowptr, col, edge_id?)``."""
    lib = get_lib()
    rowptr, col, nodes = _i64(rowptr), _i64(col), _i64(nodes)
    n_out = len(nodes)
    handle = lib.pygt_subgraph(_ptr(rowptr), _ptr(col), len(rowptr) - 1,
                               _ptr(nodes), n_out, int(return_edge_id))
    _count('subgraph')
    try:
        ne = lib.pygt_subgraph_num_edges(handle)
        out_rowptr = np.empty(n_out + 1, np.int64)
        out_col = np.empty(ne, np.int64)
        out_eid = np.empty(ne if return_edge_id else 0, np.int64)
        lib.pygt_subgraph_copy(handle, _ptr(out_rowptr), _ptr(out_col),
                               _ptr(out_eid))
    finally:
        lib.pygt_subgraph_free(handle)
    return out_rowptr, out_col, (out_eid if return_edge_id else None)


def random_walk_cpp(rowptr, col, seed, walk_length: int, rng_seed: int = 0):
    """The engine's uniform walks, ``[len(seed), walk_length + 1]``."""
    lib = get_lib()
    rowptr, col, seed = _i64(rowptr), _i64(col), _i64(seed)
    out = np.empty((len(seed), walk_length + 1), np.int64)
    lib.pygt_random_walk(_ptr(rowptr), _ptr(col), _ptr(seed), len(seed),
                         walk_length, rng_seed & (2**64 - 1), _ptr(out))
    _count('random_walk')
    return out


def random_walk_pq_cpp(rowptr, col_sorted, seed, walk_length: int, p: float,
                       q: float, rng_seed: int = 0):
    """The engine's node2vec walks; ``col_sorted`` sorted within each
    row (``sampler.random_walk`` sorts and caches it)."""
    lib = get_lib()
    rowptr, col_sorted, seed = _i64(rowptr), _i64(col_sorted), _i64(seed)
    out = np.empty((len(seed), walk_length + 1), np.int64)
    lib.pygt_random_walk_pq(_ptr(rowptr), _ptr(col_sorted), _ptr(seed),
                            len(seed), walk_length, float(p), float(q),
                            rng_seed & (2**64 - 1), _ptr(out))
    _count('random_walk_pq')
    return out


# -- the partitioner --------------------------------------------------------


def part_grow_cpp(rowptr, col, nw, k, targets, sub, seeds, part, load):
    """Balanced BFS growth from ``seeds``; writes ``part`` and ``load``
    (int64 and f64 arrays the caller owns)."""
    lib = get_lib()
    lib.pygt_part_grow(
        _ptr(rowptr), _ptr(col), len(rowptr) - 1,
        _ptr(nw, ctypes.c_double), k, _ptr(targets, ctypes.c_double),
        _ptr(sub), 0 if sub is None else len(sub), _ptr(seeds), len(seeds),
        _ptr(part), _ptr(load, ctypes.c_double))
    _count('part_grow')


def part_refine_cpp(rowptr, col, nw, ew, part, k, passes, balance):
    """Greedy boundary refinement of ``part`` in place; returns the
    engine's count of moves."""
    lib = get_lib()
    moved = lib.pygt_part_refine(
        _ptr(rowptr), _ptr(col), len(rowptr) - 1, _ptr(nw, ctypes.c_double),
        _ptr(ew, ctypes.c_double), _ptr(part), k, passes, float(balance))
    _count('part_refine')
    return moved


def edge_cut_cpp(rowptr, col, part, ew=None) -> float:
    """The (weighted) count of edges whose ends lie in two parts."""
    lib = get_lib()
    cut = lib.pygt_edge_cut(_ptr(rowptr), _ptr(col), len(rowptr) - 1,
                            _ptr(part), _ptr(ew, ctypes.c_double))
    _count('edge_cut')
    return cut
