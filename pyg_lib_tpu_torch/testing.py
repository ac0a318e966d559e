"""Test fixtures (counterpart of ``pyg_lib_tpu.testing``) and the
synthetic graphs the card's checks and timings run on."""

import functools

import numpy as np
import torch

__all__ = ['HUGE_EDGES', 'HUGE_NODES', 'MAG_EDGES', 'MAG_NODES', 'SEED',
           'assert_allclose', 'cycle_graph', 'huge_graph', 'mag_graph',
           'powerlaw_graph', 'uniform_graph', 'withSeed']

# The reference's seed (pyg_lib/testing.py:15-21).
SEED = 12345

# ogbn-mag's published node and edge counts (OGB, full size), with the
# relations named as in the dataset.
MAG_NODES = {'paper': 736_389, 'author': 1_134_649, 'institution': 8_740,
             'field_of_study': 59_965}
MAG_EDGES = {('paper', 'cites', 'paper'): 5_416_271,
             ('author', 'writes', 'paper'): 7_145_660,
             ('author', 'affiliated_with', 'institution'): 1_043_998,
             ('paper', 'has_topic', 'field_of_study'): 7_505_078}


def withSeed(fn):
    """Runs ``fn`` with numpy's global generator and torch's default
    generator seeded with :data:`SEED` (the JAX package injects a
    ``jax.random`` key instead)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        np.random.seed(SEED)
        torch.manual_seed(SEED)
        return fn(*args, **kwargs)

    return wrapper


def assert_allclose(actual, expected, rtol=1e-6, atol=1e-6):
    """``np.testing.assert_allclose`` on tensors on any device (bf16 read
    as f32), or on anything ``np.asarray`` takes."""

    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
        return np.asarray(a)

    np.testing.assert_allclose(host(actual), host(expected), rtol=rtol,
                               atol=atol)


def cycle_graph(num_nodes: int = 6):
    """Cycle-graph fixture: every node has exactly two neighbours
    ``(v±1) % n`` so expected outputs are hand-computable.

    Returns CSR ``(rowptr, col)`` as numpy int64.
    """
    n = num_nodes
    rowptr = np.arange(0, 2 * n + 1, 2, dtype=np.int64)
    col = np.empty(2 * n, dtype=np.int64)
    for v in range(n):
        col[2 * v] = (v - 1) % n
        col[2 * v + 1] = (v + 1) % n
    return rowptr, col


def uniform_graph(n: int, e: int):
    """``bench.py`` ``child_headline``'s graph (seed 0): row degrees
    uniform in ``[0, 2e/n)`` scaled to about ``e`` edges, uniform columns.
    Returns CSR ``(rowptr int64, col int32)``."""
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 2 * e // n, size=n)
    deg = (deg * (e / max(deg.sum(), 1))).astype(np.int64)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, n, size=int(rowptr[-1])).astype(np.int32)
    return rowptr, col


def powerlaw_graph(n: int, e: int):
    """``bench.py`` ``child_realistic``'s graph (seed 0): uniform rows,
    Zipf(1.2) columns. Returns CSR ``(rowptr, col)``, both int64."""
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, n + 1)**1.2
    p /= p.sum()
    row = rng.integers(0, n, e)
    col = rng.choice(n, e, p=p)
    order = np.argsort(row, kind='stable')
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=rowptr[1:])
    return rowptr, col[order].astype(np.int64)


# bench/bench_sharded_huge.py's graph: 2M nodes and 31M edges asked for
# (30,009,772 made at seed 0).
HUGE_NODES, HUGE_EDGES = 2_000_000, 31_000_000


def huge_graph(family: str = 'uniform', n: int = HUGE_NODES,
               e: int = HUGE_EDGES):
    """``bench/bench_sharded_huge.py``'s graph (seed 0): row degrees
    uniform in ``[0, 2e/n)`` scaled to about ``e`` edges, columns uniform
    (``family='uniform'``) or Zipf(1.2) (``'powerlaw'``: in-degree skew of
    the papers100M class). Returns CSR ``(rowptr, col)``, both int64."""
    if family not in ('uniform', 'powerlaw'):
        raise ValueError(f"family must be 'uniform' or 'powerlaw', got "
                         f'{family!r}')
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 2 * e // n, size=n)
    deg = (deg * (e / max(deg.sum(), 1))).astype(np.int64)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    e_actual = int(rowptr[-1])
    if family == 'powerlaw':
        p = 1.0 / np.arange(1, n + 1)**1.2
        p /= p.sum()
        col = rng.choice(n, size=e_actual, p=p).astype(np.int64)
    else:
        col = rng.integers(0, n, size=e_actual).astype(np.int64)
    return rowptr, col


def mag_graph(num_nodes=None, edges=None, skew: bool = True):
    """A heterogeneous graph of ogbn-mag's shape: ``bench/bench_hetero.py``'s
    generator, by default at the dataset's full node and edge counts
    (:data:`MAG_NODES`, :data:`MAG_EDGES`).

    Per relation, in the order of ``edges``: destinations uniform (sorted),
    sources Zipf(1.2) over the source type (``skew``, the real graph's
    popularity skew) or uniform; seed 0. Returns ``(num_nodes, rowptr_dict,
    col_dict)``: per relation a CSR over its destination type, int64.
    """
    num_nodes = dict(MAG_NODES if num_nodes is None else num_nodes)
    edges = MAG_EDGES if edges is None else edges
    rng = np.random.default_rng(0)
    rowptr_d, col_d = {}, {}
    for (s, r, d), e in edges.items():
        rows = np.sort(rng.integers(0, num_nodes[d], size=e))
        rowptr = np.zeros(num_nodes[d] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=num_nodes[d]), out=rowptr[1:])
        rowptr_d[(s, r, d)] = rowptr
        if skew:
            p = 1.0 / np.arange(1, num_nodes[s] + 1)**1.2
            p /= p.sum()
            col_d[(s, r, d)] = rng.choice(num_nodes[s], size=e, p=p)
        else:
            col_d[(s, r, d)] = rng.integers(0, num_nodes[s], size=e)
    return num_nodes, rowptr_d, col_d
