"""The port's host sampling (``pyg_lib_tpu_torch.sampler``: the C++ engine
of ``csrc/host`` through ``sampler/_cpp.py``, and the numpy
specification) against the JAX package's on the CPU: ``neighbor_sample``
(uniform, with replacement, weighted, disjoint, node- and edge-temporal,
undirected, CSC), ``hetero_neighbor_sample``, ``subgraph``,
``random_walk`` (uniform and p/q) and the padding of their outputs, each
under ``impl='numpy'`` and ``impl='cpp'``. The same inputs and seeds must
give equal outputs, bit for bit.
"""

import numpy as np
import pytest

from pyg_lib_tpu import sampler as jsampler
from pyg_lib_tpu.sampler import padding as jpadding
from pyg_lib_tpu_torch import sampler
from pyg_lib_tpu_torch.sampler import _cpp, padding

IMPLS = ('numpy', 'cpp')


def equal(a, b) -> bool:
    """``a`` and ``b`` equal to the bit, nested tuples, lists and dicts
    included (arrays also in dtype kind and shape)."""
    if isinstance(a, (tuple, list)):
        return (type(b) in (tuple, list) and len(a) == len(b)
                and all(equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is None and b is None
    if hasattr(a, '__dataclass_fields__'):
        return equal(vars(a), vars(b))
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype.kind == b.dtype.kind
            and np.array_equal(a, b))


def graph(seed, n=200, max_deg=14):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg, n)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    return rowptr, rng.integers(0, n, int(rowptr[-1])).astype(np.int64)


def _cases(rowptr, col, num_seeds, seed=5):
    """Every mode's options over the graph ``(rowptr, col)``, and the
    graph with ``num_seeds`` seeds."""
    rng = np.random.default_rng(seed)
    n, e = len(rowptr) - 1, len(col)
    seeds = rng.choice(n, num_seeds, replace=False)
    node_time = rng.integers(0, 50, n)
    edge_time = rng.integers(0, 50, e)
    seed_time = rng.integers(20, 50, num_seeds)
    return {
        'uniform': dict(),
        'replace': dict(replace=True),
        'weighted': dict(edge_weight=rng.random(e)),
        'weighted_replace': dict(edge_weight=rng.random(e), replace=True),
        'disjoint': dict(disjoint=True),
        'node_time': dict(node_time=node_time, disjoint=True),
        'node_time_last': dict(node_time=node_time, seed_time=seed_time,
                               disjoint=True, temporal_strategy='last'),
        'edge_time': dict(edge_time=edge_time, seed_time=seed_time,
                          disjoint=True),
        'undirected': dict(directed=False),
        'csc': dict(csc=True),
        'no_edge_id': dict(return_edge_id=False),
        'distributed': dict(distributed=True),
    }, (rowptr, col, seeds)


CASES, GRAPH = _cases(*graph(1), 16)
# About 30,000 nodes of up to 100 neighbours and 256 seeds: the engine's
# staged loop runs thousands of chunks a hop.
LARGE_CASES, LARGE_GRAPH = _cases(*graph(2, n=30000, max_deg=101), 256)


def sample(package, rowptr, col, seed, fanouts, kw, **more):
    """``package``'s ``neighbor_sample``, or its one-hop
    ``dist_neighbor_sample`` (the engine's distributed mode) for the
    ``'distributed'`` case."""
    if kw.get('distributed'):
        return package.dist_neighbor_sample(rowptr, col, seed, fanouts[0],
                                            **more)
    return package.neighbor_sample(rowptr, col, seed, fanouts, **kw, **more)


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('fanouts', [[4, 3], [-1, 2], [6], [15, 10, 5]])
def test_neighbor_sample_equals_the_jax_package(case, impl, fanouts):
    large = fanouts == [15, 10, 5]
    rowptr, col, seed = LARGE_GRAPH if large else GRAPH
    kw = (LARGE_CASES if large else CASES)[case]
    got = sample(sampler, rowptr, col, seed, fanouts, kw, rng=11, impl=impl)
    ref = sample(jsampler, rowptr, col, seed, fanouts, kw, rng=11, impl=impl)
    assert equal(got, ref)


def test_auto_is_the_engine_and_counts_its_calls():
    rowptr, col, seed = GRAPH
    before = dict(_cpp.calls)
    got = sampler.neighbor_sample(rowptr, col, seed, [3, 3], rng=4)
    ref = jsampler.neighbor_sample(rowptr, col, seed, [3, 3], rng=4,
                                   impl='cpp')
    assert equal(got, ref)
    assert _cpp.calls['neighbor_sample'] == before['neighbor_sample'] + 1
    sampler.neighbor_sample(rowptr, col, seed, [3, 3], rng=4, impl='numpy')
    assert _cpp.calls['neighbor_sample'] == before['neighbor_sample'] + 1
    # A Generator seeds the engine from one draw of it, as rng_seed_from
    # does in the JAX package.
    got = sampler.neighbor_sample(rowptr, col, seed, [3, 3],
                                  rng=np.random.default_rng(9))
    ref = jsampler.neighbor_sample(rowptr, col, seed, [3, 3],
                                   rng=np.random.default_rng(9), impl='cpp')
    assert equal(got, ref)
    with pytest.raises(ValueError, match='impl must be'):
        sampler.neighbor_sample(rowptr, col, seed, [3], impl='fast')


@pytest.mark.parametrize('rng', [0, 7, 2**40 + 3, 'generator'])
def test_rng_seed_from_equals_the_jax_package(rng):
    from pyg_lib_tpu.sampler import _cpp as jcpp
    make = ((lambda: np.random.default_rng(3)) if rng == 'generator' else
            (lambda: rng))
    assert _cpp.rng_seed_from(make()) == jcpp.rng_seed_from(make())


def test_neighbor_sample_refuses_what_the_jax_package_refuses():
    rowptr, col, seed = GRAPH
    bad = [dict(node_time=np.zeros(200, np.int64)),
           dict(node_time=np.zeros(200, np.int64),
                edge_time=np.zeros(len(col), np.int64), disjoint=True),
           dict(edge_time=np.zeros(len(col), np.int64), disjoint=True),
           dict(temporal_strategy='first'),
           dict(directed=False, disjoint=True)]
    for kw in bad:
        with pytest.raises(ValueError):
            sampler.neighbor_sample(rowptr, col, seed, [2], **kw)
        with pytest.raises(ValueError):
            jsampler.neighbor_sample(rowptr, col, seed, [2], **kw)
    with pytest.raises(IndexError):
        sampler.neighbor_sample(rowptr, col, np.array([500]), [2],
                                impl='cpp')


def _hetero(seed=2, csc=False):
    """Per-edge-type CSRs over the source type (over the destination type
    with ``csc``), edge weights, edge times and node times."""
    rng = np.random.default_rng(seed)
    sizes = {'paper': 120, 'author': 80, 'field': 15}
    rels = [('paper', 'cites', 'paper'), ('author', 'writes', 'paper'),
            ('paper', 'rev_writes', 'author'), ('paper', 'has', 'field')]
    rowptr_d, col_d, weight_d, time_d = {}, {}, {}, {}
    for s, r, d in rels:
        a, b = (d, s) if csc else (s, d)
        deg = rng.integers(0, 8, sizes[a])
        rp = np.zeros(sizes[a] + 1, np.int64)
        rp[1:] = np.cumsum(deg)
        rowptr_d[s, r, d] = rp
        col_d[s, r, d] = rng.integers(0, sizes[b], int(rp[-1]))
        weight_d[s, r, d] = rng.random(int(rp[-1]))
        time_d[s, r, d] = rng.integers(0, 40, int(rp[-1]))
    node_time = {t: rng.integers(0, 40, n) for t, n in sizes.items()}
    return rowptr_d, col_d, weight_d, time_d, node_time


H_ROWPTR, H_COL, H_WEIGHT, H_TIME, H_NODE_TIME = _hetero()
H_CSC = _hetero(csc=True)[:2]
H_SEEDS = {'paper': np.arange(0, 120, 9), 'author': np.array([3, 7, 50])}
H_CASES = {
    'uniform': dict(),
    'replace': dict(replace=True),
    'weighted': dict(edge_weight_dict=H_WEIGHT),
    'disjoint': dict(disjoint=True),
    'node_time': dict(node_time_dict=H_NODE_TIME, disjoint=True),
    'edge_time': dict(edge_time_dict=H_TIME, disjoint=True,
                      seed_time_dict={t: np.full(len(s), 30, np.int64)
                                      for t, s in H_SEEDS.items()}),
    'undirected': dict(directed=False),
    'csc': dict(csc=True),
}


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('case', sorted(H_CASES))
def test_hetero_neighbor_sample_equals_the_jax_package(case, impl):
    fanouts = {k: [3, 2] for k in H_ROWPTR}
    fanouts[('paper', 'has', 'field')] = [1]
    rowptr, col = H_CSC if case == 'csc' else (H_ROWPTR, H_COL)
    got = sampler.hetero_neighbor_sample(rowptr, col, H_SEEDS, fanouts,
                                         rng=5, impl=impl, **H_CASES[case])
    ref = jsampler.hetero_neighbor_sample(rowptr, col, H_SEEDS, fanouts,
                                          rng=5, impl=impl, **H_CASES[case])
    assert equal(got, ref)


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('return_edge_id', [True, False])
def test_subgraph_equals_the_jax_package(impl, return_edge_id):
    rowptr, col, _ = GRAPH
    nodes = np.random.default_rng(8).choice(200, 60, replace=False)
    got = sampler.subgraph(rowptr, col, nodes, return_edge_id, impl=impl)
    ref = jsampler.subgraph(rowptr, col, nodes, return_edge_id, impl=impl)
    assert equal(got, ref)


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('pq', [(1.0, 1.0), (1.0, 0.5), (4.0, 0.25),
                                (0.25, 2.0)])
def test_random_walk_equals_the_jax_package(impl, pq):
    rowptr, col = graph(3, n=150)
    seed = np.arange(0, 150, 3)
    got = sampler.random_walk(rowptr, col, seed, 12, p=pq[0], q=pq[1], rng=6,
                              impl=impl)
    ref = jsampler.random_walk(rowptr, col, seed, 12, p=pq[0], q=pq[1],
                               rng=6, impl=impl)
    assert got.shape == (50, 13) and equal(got, ref)


def test_random_walk_over_an_edgeless_graph_repeats_each_seed():
    rowptr = np.zeros(6, np.int64)
    col = np.zeros(0, np.int64)
    for impl in IMPLS:
        walks = sampler.random_walk(rowptr, col, np.arange(5), 4, rng=1,
                                    impl=impl)
        assert (walks == np.arange(5)[:, None]).all()


@pytest.mark.parametrize('disjoint', [False, True])
@pytest.mark.parametrize('budget', [(1200, 1500), (600, 700)])
def test_padded_batches_equal_the_jax_package(disjoint, budget):
    rowptr, col, seed = GRAPH
    out = sampler.neighbor_sample(rowptr, col, seed, [5, 4], rng=2,
                                  disjoint=disjoint)
    args = (out, *budget)
    ok = len(out[0]) <= budget[1] and len(out[2]) <= budget[0]
    if not ok:
        with pytest.raises(padding.BudgetExceeded):
            padding.pad_sample_output(*args, num_seeds=16,
                                      disjoint=disjoint)
        with pytest.raises(jpadding.BudgetExceeded):
            jpadding.pad_sample_output(*args, num_seeds=16,
                                       disjoint=disjoint)
        return
    got = padding.pad_sample_output(*args, num_seeds=16, disjoint=disjoint)
    ref = jpadding.pad_sample_output(*args, num_seeds=16, disjoint=disjoint)
    assert equal(got, ref)
    # Trailing pad edges sit past rowptr[-1] and point one past the nodes.
    assert got.rowptr[-1] == got.num_edges
    assert (got.row[got.num_edges:] == budget[0]).all()


def same_bytes(a, b) -> bool:
    """Two ``PaddedBatch``es equal byte for byte: every array of the same
    dtype and shape, every count equal."""
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, np.ndarray):
            if not (isinstance(w, np.ndarray) and v.dtype == w.dtype
                    and v.shape == w.shape and v.tobytes() == w.tobytes()):
                return False
        elif v != w or type(v) is not type(w):
            return False
    return True


# The directed modes, each with csc=True: the engine's padded hand-over.
PADDED_CASES = ('uniform', 'replace', 'weighted', 'weighted_replace',
                'disjoint', 'node_time', 'node_time_last', 'edge_time',
                'no_edge_id')


@pytest.mark.parametrize('case', PADDED_CASES)
@pytest.mark.parametrize('large', [False, True])
def test_the_engines_padded_batch_is_pad_sample_outputs(case, large):
    rowptr, col, seed = LARGE_GRAPH if large else GRAPH
    kw = dict((LARGE_CASES if large else CASES)[case], csc=True)
    fanouts = [15, 10, 5] if large else [5, 4]
    disjoint = kw.get('disjoint', False)
    before = _cpp.calls['neighbor_sample_padded']
    held = sampler.sample_for_padding(rowptr, col, seed, fanouts, rng=3,
                                      **kw)
    assert isinstance(held, _cpp.EngineSample)
    assert _cpp.calls['neighbor_sample_padded'] == before + 1
    out = sampler.neighbor_sample(rowptr, col, seed, fanouts, rng=3, **kw)
    assert equal(out, jsampler.neighbor_sample(rowptr, col, seed, fanouts,
                                               rng=3, impl='cpp', **kw))
    n, e = len(out[2]), len(out[0])
    assert (held.num_nodes, held.num_edges) == (n, e)
    assert (held.nodes_per_hop, held.edges_per_hop) == (out[4], out[5])
    # Too few node slots, then too few edge slots: BudgetExceeded as
    # pad_sample_output raises it, and the sample stays for the next.
    for budget in ((n - 1, e), (n, e - 1)):
        with pytest.raises(padding.BudgetExceeded) as got:
            held.pad(*budget, len(seed))
        with pytest.raises(padding.BudgetExceeded) as ref:
            padding.pad_sample_output(out, *budget, num_seeds=len(seed),
                                      disjoint=disjoint)
        assert str(got.value) == str(ref.value)
    for budget in ((n, e), (n + 40, e + 72)):
        if budget != (n, e):
            held = sampler.sample_for_padding(rowptr, col, seed, fanouts,
                                              rng=3, **kw)
        got = held.pad(*budget, len(seed))
        ref = padding.pad_sample_output(out, *budget, num_seeds=len(seed),
                                        disjoint=disjoint)
        assert same_bytes(got, ref)
        assert same_bytes(got, jpadding.pad_sample_output(
            out, *budget, num_seeds=len(seed), disjoint=disjoint))
        with pytest.raises(RuntimeError, match='padded or closed'):
            held.pad(*budget, len(seed))


@pytest.mark.parametrize('kw', [dict(), dict(csc=True, directed=False),
                                dict(csc=True, impl='numpy')])
def test_only_the_engines_csc_sample_is_held(kw):
    # Where the edges do not come in destination order, or numpy samples,
    # sample_for_padding is neighbor_sample.
    rowptr, col, seed = GRAPH
    got = sampler.sample_for_padding(rowptr, col, seed, [4, 3], rng=6, **kw)
    assert equal(got, sampler.neighbor_sample(rowptr, col, seed, [4, 3],
                                              rng=6, **kw))


def test_threads_that_sample_at_once_get_the_serial_batches():
    # More threads than cores, switching often, share the engine's pool
    # of call states: each batch must be the one sampled alone.
    import sys
    import threading

    rowptr, col, seed = LARGE_GRAPH
    kws = [dict(csc=True), dict(csc=True, disjoint=True), dict(),
           dict(disjoint=True, edge_weight=LARGE_CASES['weighted'][
               'edge_weight'])]
    budget = padding.budget_for(len(seed), [15, 10, 5])
    nb, workers = 32, 16

    def batch(i):
        kw = kws[i % len(kws)]
        out = sampler.sample_for_padding(rowptr, col, seed, [15, 10, 5],
                                         rng=100 + i, **kw)
        if isinstance(out, _cpp.EngineSample):
            return out.pad(*budget, len(seed))
        return padding.pad_sample_output(out, *budget, len(seed),
                                         disjoint=kw.get('disjoint', False))

    serial = [batch(i) for i in range(nb)]
    got = [None] * nb

    def work(k):
        for i in range(k, nb, workers):
            got[i] = batch(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k, ))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert all(same_bytes(a, b) for a, b in zip(got, serial))


@pytest.mark.parametrize('disjoint', [False, True])
def test_padded_hetero_batches_equal_the_jax_package(disjoint):
    fanouts = {k: [3, 2] for k in H_ROWPTR}
    out = sampler.hetero_neighbor_sample(H_ROWPTR, H_COL, H_SEEDS, fanouts,
                                         rng=3, disjoint=disjoint)
    budgets = {'paper': 512, 'author': 256, 'field': 128}
    got = padding.pad_hetero_sample_output(out, budgets, 2000,
                                           disjoint=disjoint)
    ref = jpadding.pad_hetero_sample_output(out, budgets, 2000,
                                            disjoint=disjoint)
    assert equal(got, ref)


@pytest.mark.parametrize('args', [(64, [25, 10], 1.0), (1024, [25, 10], 1.0),
                                  (8, [3, 0, 2], 1.5), (5, [], 1.0)])
def test_budgets_and_ladders_equal_the_jax_package(args):
    assert padding.budget_for(*args) == jpadding.budget_for(*args)
    worst = padding.budget_for(*args)
    for base in ((10, 10), (worst[0] // 3, worst[1] // 5), worst):
        assert (padding.bucket_ladder(*base, *worst) ==
                jpadding.bucket_ladder(*base, *worst))
    with pytest.raises(ValueError):
        padding.budget_for(4, [2, -1])
