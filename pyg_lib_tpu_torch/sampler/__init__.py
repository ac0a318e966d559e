"""Host-side graph sampling (port of ``pyg_lib_tpu.sampler``).

Sampling runs on the host and returns numpy arrays, as in the JAX
package; ``sampler.padding`` turns them into fixed-shape batches, and
``loader.NeighborLoader`` ships those to the card.

Every entry point takes ``rng`` (an int seed, a ``numpy`` ``Generator``
or ``None``) and ``impl``: ``'cpp'`` runs the C++ engine of ``csrc/host``
(``sampler._cpp``; built at first use, and a failed build raises),
``'numpy'`` runs the numpy specification, and ``'auto'``, the default, is
only another name for ``'cpp'``. The engine's integer seed comes from
``rng`` as the JAX package derives it (``_cpp.rng_seed_from``), so the
same seed gives the same samples in both packages bit for bit.

``'auto'`` differs from the JAX package's: there a ``Generator`` ``rng``
(and a failed build) runs numpy; here it seeds the engine by one draw of
it, as ``'cpp'`` does there. Code ported from the JAX package that wants
its numpy samples passes ``impl='numpy'``.

The distributed sampling protocol (``sampler.dist``:
``dist_neighbor_sample``, ``merge_sampler_outputs``,
``relabel_neighborhood``, ``hetero_relabel_neighborhood``) is exported
here as in the JAX package; ``sampler.dist_service`` has the partition
books, the coordinators and ``collective_feature_fetch``, and
``sampler.transport`` / ``sampler.serve`` the partition servers.
"""

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from pyg_lib_tpu_torch.sampler import _cpp, padding
from pyg_lib_tpu_torch.sampler._hetero_impl import hetero_neighbor_sample_np
from pyg_lib_tpu_torch.sampler._numpy_impl import neighbor_sample_np
from pyg_lib_tpu_torch.sampler.dist import (dist_neighbor_sample,
                                            hetero_relabel_neighborhood,
                                            merge_sampler_outputs,
                                            relabel_neighborhood)

NodeType = str
EdgeType = Tuple[str, str, str]
Rng = Union[None, int, np.random.Generator]

__all__ = ['dist_neighbor_sample', 'hetero_neighbor_sample',
           'hetero_relabel_neighborhood', 'merge_sampler_outputs',
           'neighbor_sample', 'padding', 'random_walk',
           'relabel_neighborhood', 'sample_for_padding', 'subgraph']


def _np(x):
    return None if x is None else np.asarray(x)


def _rng(rng: Rng) -> np.random.Generator:
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


def _use_cpp(impl: str) -> bool:
    """``impl`` is 'cpp' or its alias 'auto' (the engine), or 'numpy'."""
    if impl not in ('auto', 'cpp', 'numpy'):
        raise ValueError(f"impl must be 'auto', 'cpp' or 'numpy', got "
                         f'{impl!r}')
    return impl != 'numpy'


def _sample_kwargs(node_time, edge_time, seed_time, edge_weight, csc,
                   replace, directed, disjoint, temporal_strategy,
                   return_edge_id):
    """:func:`neighbor_sample`'s options, checked as the JAX package
    checks them."""
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
    return dict(node_time=_np(node_time), edge_time=_np(edge_time),
                seed_time=_np(seed_time), edge_weight=_np(edge_weight),
                csc=csc, replace=replace, directed=directed,
                disjoint=disjoint, temporal_strategy=temporal_strategy,
                return_edge_id=return_edge_id)


def neighbor_sample(rowptr, col, seed, num_neighbors: List[int],
                    node_time=None, edge_time=None, seed_time=None,
                    edge_weight=None, csc: bool = False,
                    replace: bool = False, directed: bool = True,
                    disjoint: bool = False,
                    temporal_strategy: str = 'uniform',
                    return_edge_id: bool = True, rng: Rng = None,
                    impl: str = 'auto'):
    """Samples ``num_neighbors[h]`` neighbours a node at hop ``h`` from
    ``seed`` in the CSR graph ``(rowptr, col)``.

    Returns ``(row, col, node_id, edge_id?, num_sampled_nodes_per_hop,
    num_sampled_edges_per_hop)`` with local (relabelled) row and col ids;
    with ``disjoint=True``, ``node_id`` is ``[N, 2]`` ``(batch, node)``
    pairs. ``directed=False`` returns every edge among the sampled nodes
    (the induced subgraph), with one total in
    ``num_sampled_edges_per_hop``; it excludes ``disjoint``. Temporal
    sampling (``node_time``/``edge_time``) needs ``disjoint=True``.
    ``impl='auto'`` is ``'cpp'`` (not the JAX package's ``'auto'``).
    """
    kw = _sample_kwargs(node_time, edge_time, seed_time, edge_weight, csc,
                        replace, directed, disjoint, temporal_strategy,
                        return_edge_id)
    if _use_cpp(impl):
        return _cpp.neighbor_sample_cpp(
            _np(rowptr), _np(col), _np(seed), list(num_neighbors),
            rng_seed=_cpp.rng_seed_from(rng), **kw)
    return neighbor_sample_np(_np(rowptr), _np(col), _np(seed),
                              list(num_neighbors), rng=_rng(rng), **kw)


def sample_for_padding(rowptr, col, seed, num_neighbors: List[int],
                       node_time=None, edge_time=None, seed_time=None,
                       edge_weight=None, csc: bool = False,
                       replace: bool = False, directed: bool = True,
                       disjoint: bool = False,
                       temporal_strategy: str = 'uniform',
                       return_edge_id: bool = True, rng: Rng = None,
                       impl: str = 'auto'):
    """:func:`neighbor_sample` (the same arguments and draws) for
    :func:`padding.pad_sample_output`. Where the engine samples with
    ``csc=True`` and ``directed=True``, its edges come in destination
    order and the sample stays in the engine: a
    :class:`~pyg_lib_tpu_torch.sampler._cpp.EngineSample`, whose
    ``pad(max_nodes, max_edges, num_seeds)`` writes the padded batch with
    no sort, byte for byte ``pad_sample_output``'s. Otherwise the tuple
    of :func:`neighbor_sample`."""
    kw = _sample_kwargs(node_time, edge_time, seed_time, edge_weight, csc,
                        replace, directed, disjoint, temporal_strategy,
                        return_edge_id)
    if not (csc and directed and _use_cpp(impl)):
        return neighbor_sample(rowptr, col, seed, num_neighbors, rng=rng,
                               impl=impl, **kw)
    del kw['csc'], kw['directed']
    return _cpp.neighbor_sample_padded_cpp(
        _np(rowptr), _np(col), _np(seed), list(num_neighbors),
        rng_seed=_cpp.rng_seed_from(rng), **kw)


def hetero_neighbor_sample(
        rowptr_dict: Dict[EdgeType, np.ndarray],
        col_dict: Dict[EdgeType, np.ndarray],
        seed_dict: Dict[NodeType, np.ndarray],
        num_neighbors_dict: Dict[EdgeType, List[int]],
        node_time_dict=None, edge_time_dict=None, seed_time_dict=None,
        edge_weight_dict=None, csc: bool = False, replace: bool = False,
        directed: bool = True, disjoint: bool = False,
        temporal_strategy: str = 'uniform', return_edge_id: bool = True,
        rng: Rng = None, impl: str = 'auto'):
    """Multi-hop sampling over per-edge-type CSR graphs keyed by
    ``(src, rel, dst)``; the same 6-tuple as :func:`neighbor_sample`, each
    part a dict by node or edge type. ``directed=False`` gives, per edge
    type, every edge between its sampled node types.
    ``impl='auto'`` is ``'cpp'`` (not the JAX package's ``'auto'``).
    """
    temporal = node_time_dict is not None or edge_time_dict is not None
    if temporal and not disjoint:
        raise ValueError(
            'Temporal sampling needs to create disjoint subgraphs')
    if node_time_dict is not None and edge_time_dict is not None:
        raise ValueError(
            'Only one of node-level or edge-level sampling is supported')
    if edge_time_dict is not None and seed_time_dict is None:
        raise ValueError('Seed time needs to be specified')
    if temporal_strategy not in ('uniform', 'last'):
        raise ValueError('No valid temporal strategy found')
    if not directed and disjoint:
        raise ValueError(
            'Undirected sampling cannot create disjoint subgraphs')
    conv = lambda d: None if d is None else {k: _np(v) for k, v in d.items()}
    args = (conv(rowptr_dict), conv(col_dict), conv(seed_dict),
            {k: list(v) for k, v in num_neighbors_dict.items()})
    kw = dict(node_time_dict=conv(node_time_dict),
              edge_time_dict=conv(edge_time_dict),
              seed_time_dict=conv(seed_time_dict),
              edge_weight_dict=conv(edge_weight_dict), csc=csc,
              replace=replace, directed=directed, disjoint=disjoint,
              temporal_strategy=temporal_strategy,
              return_edge_id=return_edge_id)
    if _use_cpp(impl):
        return _cpp.hetero_neighbor_sample_cpp(
            *args, rng_seed=_cpp.rng_seed_from(rng), **kw)
    return hetero_neighbor_sample_np(*args, rng=_rng(rng), **kw)


def subgraph(rowptr, col, nodes, return_edge_id: bool = True,
             impl: str = 'auto'
             ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The subgraph induced by ``nodes``, as a local CSR ``(rowptr, col,
    edge_id?)``.
    ``impl='auto'`` is ``'cpp'`` (not the JAX package's ``'auto'``).
    """
    rowptr, col, nodes = _np(rowptr), _np(col), _np(nodes)
    if _use_cpp(impl):
        return _cpp.subgraph_cpp(rowptr, col, nodes, return_edge_id)
    n_out = len(nodes)
    local = {int(v): i for i, v in enumerate(nodes.tolist())}
    out_rowptr = np.zeros(n_out + 1, dtype=rowptr.dtype)
    out_cols: List[int] = []
    out_eids: List[int] = []
    for i, v in enumerate(nodes.tolist()):
        for e in range(int(rowptr[v]), int(rowptr[v + 1])):
            w = local.get(int(col[e]))
            if w is not None:
                out_cols.append(w)
                if return_edge_id:
                    out_eids.append(e)
        out_rowptr[i + 1] = len(out_cols)
    out_col = np.asarray(out_cols, dtype=col.dtype)
    out_eid = np.asarray(out_eids, np.int64) if return_edge_id else None
    return out_rowptr, out_col, out_eid


def _sorted_rows(rowptr: np.ndarray, col: np.ndarray) -> np.ndarray:
    """``col`` with each row's neighbours sorted (binary-searchable)."""
    out = col.copy()
    for v in range(len(rowptr) - 1):
        lo, hi = rowptr[v], rowptr[v + 1]
        if hi - lo > 1:
            out[lo:hi] = np.sort(out[lo:hi])
    return out


# Row-sorted columns of the p/q walks' graphs: at most 4, the oldest
# dropped first, keyed by buffer identity for numpy arrays (checked by a
# cheap fingerprint) and by content otherwise.
_SORTED_COL_CACHE: dict = {}


def _graph_fingerprint(rowptr, col):
    return (int(rowptr[-1]), int(rowptr.sum() % (1 << 62)),
            int(col.sum() % (1 << 62)) if len(col) else 0)


def _random_walk_pq(rowptr, col, seed, walk_length, p, q, rng, use_cpp,
                    stable_buffers: bool):
    if stable_buffers:
        key = ('id', rowptr.ctypes.data, rowptr.shape[0], col.ctypes.data,
               col.shape[0])
    else:
        import hashlib

        key = ('sha',
               hashlib.sha1(np.ascontiguousarray(rowptr).tobytes()).
               hexdigest(),
               hashlib.sha1(np.ascontiguousarray(col).tobytes()).hexdigest())
    fp = _graph_fingerprint(rowptr, col)
    hit = _SORTED_COL_CACHE.get(key)
    if hit is None or hit[1] != fp:
        hit = (_sorted_rows(np.asarray(rowptr, np.int64),
                            np.asarray(col, np.int64)), fp)
        if key not in _SORTED_COL_CACHE and len(_SORTED_COL_CACHE) >= 4:
            _SORTED_COL_CACHE.pop(next(iter(_SORTED_COL_CACHE)))
        _SORTED_COL_CACHE[key] = hit
    col_sorted = hit[0]
    if use_cpp:
        return _cpp.random_walk_pq_cpp(rowptr, col_sorted, seed, walk_length,
                                       p, q, _cpp.rng_seed_from(rng))
    # The numpy specification: the same rejection sampling.
    gen = _rng(rng)
    w_p, w_q = 1.0 / p, 1.0 / q
    w_max = max(1.0, w_p, w_q)
    out = np.empty((len(seed), walk_length + 1), np.int64)
    for i, s0 in enumerate(np.asarray(seed, np.int64)):
        cur, prev = int(s0), -1
        out[i, 0] = cur
        for s in range(1, walk_length + 1):
            lo, hi = rowptr[cur], rowptr[cur + 1]
            if hi <= lo:
                out[i, s] = cur
                prev = cur
                continue
            if prev < 0:
                nxt = int(col_sorted[lo + gen.integers(hi - lo)])
            else:
                plo, phi = rowptr[prev], rowptr[prev + 1]
                nbrs_prev = col_sorted[plo:phi]
                nxt = None
                for _ in range(64):
                    cand = int(col_sorted[lo + gen.integers(hi - lo)])
                    if cand == prev:
                        w = w_p
                    elif np.searchsorted(nbrs_prev, cand) < len(
                            nbrs_prev) and nbrs_prev[np.searchsorted(
                                nbrs_prev, cand)] == cand:
                        w = 1.0
                    else:
                        w = w_q
                    nxt = cand
                    if gen.uniform() * w_max <= w:
                        break
                else:
                    # 64 rejections: draw exactly from the node2vec
                    # distribution through the weighted CDF.
                    nbrs = col_sorted[lo:hi]
                    pos = np.searchsorted(nbrs_prev, nbrs)
                    in_prev = (pos < len(nbrs_prev)) & (nbrs_prev[
                        np.minimum(pos, max(len(nbrs_prev) - 1, 0))]
                        == nbrs)
                    w_all = np.where(nbrs == prev, w_p,
                                     np.where(in_prev, 1.0, w_q))
                    cdf = np.cumsum(w_all)
                    r = gen.uniform() * cdf[-1]
                    nxt = int(nbrs[min(np.searchsorted(cdf, r, 'right'),
                                       len(nbrs) - 1)])
            out[i, s] = nxt
            prev, cur = cur, nxt
    return out


def random_walk(rowptr, col, seed, walk_length: int, p: float = 1.0,
                q: float = 1.0, rng: Rng = None,
                impl: str = 'auto') -> np.ndarray:
    """Random walks of ``walk_length`` steps from each seed,
    ``[len(seed), walk_length + 1]``; with ``p``/``q`` not 1, node2vec's
    second-order walks (rejection sampling: a uniform neighbour is taken
    with probability ``w / w_max``, ``w`` in ``{1/p, 1, 1/q}``). A node
    with no neighbours repeats itself for the rest of the walk.
    ``impl='auto'`` is ``'cpp'`` (not the JAX package's ``'auto'``).
    """
    stable = isinstance(rowptr, np.ndarray) and isinstance(col, np.ndarray)
    rowptr, col, seed = _np(rowptr), _np(col), _np(seed)
    use_cpp = _use_cpp(impl)
    if p != 1.0 or q != 1.0:
        return _random_walk_pq(rowptr, col, seed, walk_length, p, q, rng,
                               use_cpp, stable)
    if use_cpp:
        return _cpp.random_walk_cpp(rowptr, col, seed, walk_length,
                                    _cpp.rng_seed_from(rng))
    gen = _rng(rng)
    out = np.empty((len(seed), walk_length + 1), dtype=np.int64)
    out[:, 0] = seed
    cur = seed.astype(np.int64).copy()
    for step in range(1, walk_length + 1):
        deg = rowptr[cur + 1] - rowptr[cur]
        has = deg > 0
        offs = np.zeros_like(cur)
        if has.any():
            offs[has] = gen.integers(0, deg[has])
        if len(col):
            nxt = np.where(has, col[np.minimum(rowptr[cur] + offs,
                                               len(col) - 1)], cur)
        else:  # no edges: every node repeats itself
            nxt = cur
        out[:, step] = nxt
        cur = nxt
    return out

