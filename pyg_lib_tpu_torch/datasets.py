"""Graph readers and synthetic graph generators (port of
``pyg_lib_tpu/datasets.py``, numpy, logic unchanged).

The readers take files already on disk (``.npz``, MatrixMarket, SuiteSparse
``.mat``, edge lists); nothing downloads. The generators are synthetic
stand-ins with controllable structure: a stochastic block model whose
communities are recoverable by message passing (a GNN that works learns
them; one that is broken does not), power-law graphs and planted
partitions.
"""

import os
from typing import Optional, Tuple

import numpy as np

__all__ = ['sbm_graph', 'powerlaw_graph', 'clustered_graph', 'to_csr',
           'load_csr', 'save_csr', 'get_sparse_matrix']


def to_csr(src: np.ndarray, dst: np.ndarray,
           num_nodes: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO -> CSR; returns (rowptr, col, perm) with ``perm`` the edge
    permutation applied (for carrying edge attributes along)."""
    perm = np.argsort(src, kind='stable')
    src, dst = src[perm], dst[perm]
    counts = np.bincount(src, minlength=num_nodes)
    rowptr = np.zeros(num_nodes + 1, np.int64)
    rowptr[1:] = np.cumsum(counts)
    return rowptr, dst.astype(np.int64), perm


def save_csr(path: str, rowptr: np.ndarray, col: np.ndarray,
             **extras: np.ndarray) -> None:
    """Write a CSR graph (plus optional aligned arrays such as features
    ``x``, labels ``y``, masks, edge weights) as a compressed ``.npz``
    that ``load_csr`` reads back unmodified."""
    np.savez_compressed(path, rowptr=np.asarray(rowptr, np.int64),
                        col=np.asarray(col, np.int64), **extras)


def load_csr(path: str) -> dict:
    """Load a graph from disk into CSR form.

    The on-disk-dataset entry point (reference analog:
    ``pyg_lib/testing.py:78-120`` ``get_sparse_matrix``, which fetches
    SuiteSparse ``.mat`` files; this loader downloads nothing and reads
    files already on disk).  Returns a dict with at least
    ``rowptr`` / ``col`` (int64) plus any auxiliary arrays found.

    Supported formats, keyed by extension:

    * ``.npz`` — numpy archive with either ``rowptr``+``col`` (used as
      is), or an edge list as ``edge_index`` ``[2, E]`` (or ``src`` +
      ``dst``/``row``+``col`` 1-D pairs), converted via :func:`to_csr`
      with edge-aligned arrays permuted along.  Every other key is
      passed through.
    * ``.mtx`` / ``.mtx.gz`` — MatrixMarket coordinate format (the
      SuiteSparse download format); pattern/real/integer fields, 1-based
      indices.  Real values land in ``edge_weight``.
    * ``.mat`` — SuiteSparse MATLAB bundle (``Problem.A``), read with
      scipy like the reference does.
    * ``.txt`` / ``.csv`` / ``.tsv`` / ``.el`` (optionally ``.gz``) —
      whitespace/comma-separated edge list, ``#``/``%`` comments,
      2 or 3 columns (src, dst[, weight]).
    """
    lower = path.lower()
    stripped = lower[:-3] if lower.endswith('.gz') else lower
    if stripped.endswith('.npz'):
        with np.load(path, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
        if 'rowptr' in data and 'col' in data:
            data['rowptr'] = np.asarray(data['rowptr'], np.int64)
            data['col'] = np.asarray(data['col'], np.int64)
            return data
        if 'edge_index' in data:
            src, dst = data.pop('edge_index')
        elif 'src' in data and 'dst' in data:
            src, dst = data.pop('src'), data.pop('dst')
        elif 'row' in data and 'col' in data:
            src, dst = data.pop('row'), data.pop('col')
        else:
            raise ValueError(
                f'{path}: expected rowptr+col, edge_index, src+dst, or '
                f'row+col arrays; found {sorted(data)}')
        return _from_edges(np.asarray(src, np.int64),
                           np.asarray(dst, np.int64), data)
    if stripped.endswith('.mtx'):
        return _load_mtx(path)
    if stripped.endswith('.mat'):
        from scipy.io import loadmat

        mat = loadmat(path)['Problem'][0][0][2].tocsr()
        return {'rowptr': np.asarray(mat.indptr, np.int64),
                'col': np.asarray(mat.indices, np.int64)}
    if stripped.endswith(('.txt', '.csv', '.tsv', '.el')):
        return _load_edge_list(path)
    raise ValueError(f'{path}: unsupported dataset extension '
                     '(expected .npz, .mtx[.gz], .mat, or an edge list)')


def _open_maybe_gz(path: str):
    if path.lower().endswith('.gz'):
        import gzip

        return gzip.open(path, 'rt')
    return open(path, 'r')


def _from_edges(src: np.ndarray, dst: np.ndarray, extras: dict,
                num_nodes: Optional[int] = None) -> dict:
    if num_nodes is None:
        n_extra = extras.get('num_nodes')
        num_nodes = (int(n_extra) if n_extra is not None else
                     int(max(src.max(initial=-1), dst.max(initial=-1))) + 1)
    extras.pop('num_nodes', None)
    rowptr, col, perm = to_csr(src, dst, num_nodes)
    out = {'rowptr': rowptr, 'col': col}
    for k, v in extras.items():
        v = np.asarray(v)
        # Edge-aligned arrays follow the CSR edge permutation.
        out[k] = v[perm] if v.shape[:1] == (len(col), ) else v
    return out


def _load_mtx(path: str) -> dict:
    with _open_maybe_gz(path) as f:
        header = f.readline().split()
        if len(header) < 4 or header[0] != '%%MatrixMarket':
            raise ValueError(f'{path}: not a MatrixMarket file')
        if header[2] != 'coordinate':
            raise ValueError(f'{path}: only coordinate (sparse) supported')
        field = header[3]
        symmetric = len(header) > 4 and header[4] in ('symmetric',
                                                      'skew-symmetric')
        line = f.readline()
        while line.startswith('%') or not line.strip():
            line = f.readline()
        n_rows, n_cols, _nnz = (int(v) for v in line.split()[:3])
        body = np.loadtxt(f, ndmin=2)
    if body.size == 0:
        body = body.reshape(0, 2 if field == 'pattern' else 3)
    src = body[:, 0].astype(np.int64) - 1  # 1-based -> 0-based
    dst = body[:, 1].astype(np.int64) - 1
    w = body[:, 2] if (field != 'pattern' and body.shape[1] > 2) else None
    if symmetric:
        off = src != dst
        src, dst = (np.concatenate([src, dst[off]]),
                    np.concatenate([dst, src[off]]))
        if w is not None:
            w = np.concatenate([w, w[off]])
    extras = {} if w is None else {'edge_weight': w}
    return _from_edges(src, dst, extras, num_nodes=max(n_rows, n_cols))


def _load_edge_list(path: str) -> dict:
    lower = path.lower()
    stripped = lower[:-3] if lower.endswith('.gz') else lower
    with _open_maybe_gz(path) as f:
        body = np.loadtxt(f, comments=('#', '%'), ndmin=2,
                          delimiter=',' if stripped.endswith('.csv')
                          else None)
    if body.size == 0:
        body = body.reshape(0, 2)
    src = body[:, 0].astype(np.int64)
    dst = body[:, 1].astype(np.int64)
    extras = ({'edge_weight': body[:, 2]} if body.shape[1] > 2 else {})
    return _from_edges(src, dst, extras)


def get_sparse_matrix(group: str, name: str) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """SuiteSparse graph ``(rowptr, col)`` from the local cache.

    Mirrors the reference's ``get_sparse_matrix``
    (``pyg_lib/testing.py:78-120``) minus the download: the file must
    already sit in the home/cache dir
    (``$PYG_LIB_TPU_HOME``) as ``{name}.mat``, ``{name}.mtx[.gz]`` or
    ``{name}.npz``.
    """
    from pyg_lib_tpu_torch.home import get_home_dir

    home = get_home_dir()
    for cand in (f'{name}.npz', f'{name}.mtx', f'{name}.mtx.gz',
                 f'{name}.mat'):
        path = os.path.join(home, cand)
        if os.path.exists(path):
            d = load_csr(path)
            return d['rowptr'], d['col']
    raise FileNotFoundError(
        f'{name} not found in {home}; place {name}.mat (from '
        f'https://sparse.tamu.edu/mat/{group}/{name}.mat), {name}.mtx or '
        f'{name}.npz there (nothing is downloaded)')


def sbm_graph(num_nodes: int = 400, num_classes: int = 4,
              p_in: float = 0.06, p_out: float = 0.004,
              feat_dim: int = 16, noise: float = 1.0,
              seed: int = 0):
    """Stochastic block model with class-informative features.

    Returns dict with rowptr, col, x, y, train/val/test masks. Features are
    a noisy one-hot-ish embedding of the class, so both structure and
    features carry signal (like citation networks).
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)
    # Sample undirected edges blockwise.
    srcs, dsts = [], []
    for i in range(num_nodes):
        same = y == y[i]
        p = np.where(same, p_in, p_out)
        p[i] = 0
        nbrs = np.nonzero(rng.random(num_nodes) < p)[0]
        srcs.append(np.full(len(nbrs), i))
        dsts.append(nbrs)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    # Symmetrise + dedup: a pair drawn independently in both directions
    # would otherwise appear twice per direction, double-counting those
    # neighbors in every aggregation built on this generator.
    src2 = np.concatenate([src, dst])
    dst2 = np.concatenate([dst, src])
    pair = np.unique(np.stack([src2, dst2], 1), axis=0)
    rowptr, col, _ = to_csr(pair[:, 0], pair[:, 1], num_nodes)

    proto = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    x = proto[y] + noise * rng.normal(size=(num_nodes, feat_dim)).astype(
        np.float32)

    idx = rng.permutation(num_nodes)
    train = np.zeros(num_nodes, bool)
    val = np.zeros(num_nodes, bool)
    test = np.zeros(num_nodes, bool)
    train[idx[:num_nodes // 2]] = True
    val[idx[num_nodes // 2:num_nodes * 3 // 4]] = True
    test[idx[num_nodes * 3 // 4:]] = True
    return {
        'rowptr': rowptr, 'col': col, 'x': x, 'y': y.astype(np.int32),
        'train_mask': train, 'val_mask': val, 'test_mask': test,
        'num_classes': num_classes,
    }


def powerlaw_graph(num_nodes: int, avg_degree: int = 16,
                   alpha: float = 1.5, seed: int = 0):
    """Power-law out-degree graph (Zipf-ish), CSR. For benchmarks."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=num_nodes).astype(np.float64)
    raw = np.minimum(raw, 10 * avg_degree)
    deg = np.maximum(
        (raw * (avg_degree * num_nodes / raw.sum())).astype(np.int64), 0)
    rowptr = np.zeros(num_nodes + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, num_nodes, size=int(rowptr[-1])).astype(np.int64)
    return rowptr, col


def clustered_graph(num_nodes: int, num_clusters: int,
                    avg_degree: int = 16, p_intra: float = 0.9,
                    seed: int = 0):
    """Planted-partition graph at benchmark scale, O(E) generation.

    Each node draws ``avg_degree`` neighbors, a ``p_intra`` fraction
    uniformly within its own (equal-sized, id-contiguous) cluster and the
    rest uniformly over the whole graph — the community structure of
    real-world graphs (ogbn-class citation/product graphs) that
    :func:`sbm_graph`'s O(n^2) sampler cannot reach at kernel-benchmark
    sizes. Returns ``(rowptr, col, cluster)`` with nodes labeled
    cluster-contiguously (shuffle with a random permutation to model an
    unfavourable labeling).
    """
    rng = np.random.default_rng(seed)
    size = -(-num_nodes // num_clusters)
    deg = rng.poisson(avg_degree, size=num_nodes).astype(np.int64)
    rowptr = np.zeros(num_nodes + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    e = int(rowptr[-1])
    row = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    cluster_of_row = row // size
    lo = cluster_of_row * size
    hi = np.minimum(lo + size, num_nodes)
    intra = rng.random(e) < p_intra
    col = np.where(
        intra,
        lo + (rng.random(e) * (hi - lo)).astype(np.int64),
        rng.integers(0, num_nodes, size=e),
    )
    cluster = (np.arange(num_nodes, dtype=np.int64) // size)
    return rowptr, col.astype(np.int64), cluster
