"""The port's R-GCN (padded batch, per-relation plans, stacked and
range-sliced plans) and ``spmm_csr`` against the JAX package, on the CPU.

The graphs have ogbn-mag's four node types and four relations at a small
size (``pyg_lib_tpu_torch.testing.mag_graph``); weights come from the JAX
package's ``init_rgcn`` / ``init_rgcn_spmm`` through the port's
``*_params_from_jax``, features from ``np.random.default_rng``.

Tolerances: plan tables bit for bit; outputs and weight gradients f32
rtol 1e-5 / atol 1e-4, as for ``spmm`` (summation order of the
aggregations and of the 16- and 32-deep products only); the three
full-graph forms against each other the same; ``spmm_csr`` max/min values
exactly, sum/mean rtol 1e-5 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.models import gnn as jgnn
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.examples.train_rgcn_fullgraph_spmm import \
    main as train_example
from pyg_lib_tpu_torch.models import (RGCN, HeteroSpmmPlan, RGCNBatch,
                                      build_rgcn_graphs, build_rgcn_planned,
                                      init_rgcn_spmm, rgcn_forward,
                                      rgcn_forward_planned,
                                      rgcn_forward_spmm,
                                      rgcn_params_from_jax,
                                      rgcn_spmm_params_from_jax)
from pyg_lib_tpu_torch.ops.spmm import _GRAPH_CACHE
from pyg_lib_tpu_torch.testing import mag_graph
from test_torch_spmm import features, powerlaw_graph, uniform_graph

RTOL, ATOL = 1e-5, 1e-4
DIMS = [16, 32, 7]
NODES = {'paper': 700, 'author': 20000, 'institution': 30,
         'field_of_study': 200}
EDGES = {('paper', 'cites', 'paper'): 2000,
         ('author', 'writes', 'paper'): 2500,
         ('author', 'affiliated_with', 'institution'): 3000,
         ('paper', 'has_topic', 'field_of_study'): 4000}


def _graph(skew):
    # Uniform sources: dedup='auto' takes the chunked plan on some sides,
    # the dedup plan (some with a hot level) on others. Zipf sources:
    # hub columns, the dedup plan everywhere.
    return mag_graph(NODES, EDGES, skew=skew)


def _f32(tree):
    # The suite runs JAX in x64, where init_*'s zero biases are f64.
    return {'layers': [{k: np.asarray(v, np.float32) for k, v in l.items()}
                       for l in tree['layers']]}


def _x_dict(seed, num):
    return {t: features(seed + i, n, DIMS[0])
            for i, (t, n) in enumerate(num.items())}


def _plan_kinds(graphs):
    return [(type(g.fwd).__name__, getattr(g.fwd, 'num_hot', 0),
             type(g.bwd).__name__, getattr(g.bwd, 'num_hot', 0))
            for _, g in sorted(graphs.items())]


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _run_both(fwd_j, arg_j, fwd_t, arg_t, tree, x_np, cot_seed=40):
    """Outputs and weight gradients (of Σ out·cot over every type) of the
    JAX forward and the port's, compared."""
    cots = {t: np.random.default_rng(cot_seed + i).normal(
        size=(v.shape[0], DIMS[-1])).astype(np.float32)
        for i, (t, v) in enumerate(x_np.items())}
    x_j = {t: jnp.asarray(v) for t, v in x_np.items()}

    def loss_j(p):
        out = fwd_j(p, x_j, arg_j)
        return sum((out[t] * cots[t]).sum() for t in out), out

    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    params = rgcn_spmm_params_from_jax(tree, device='cpu')
    names = [(i, k) for i, layer in enumerate(params['layers'])
             for k in layer]
    leaves = [params['layers'][i][k].requires_grad_() for i, k in names]
    out_t = fwd_t(params, {t: torch.from_numpy(v) for t, v in x_np.items()},
                  arg_t)
    grads = torch.autograd.grad(
        sum((out_t[t] * torch.from_numpy(cots[t])).sum() for t in out_t),
        leaves)
    assert set(out_t) == set(out_j)
    for t in out_j:
        assert out_t[t].shape == out_j[t].shape
        _close(out_t[t], out_j[t])
    for (i, k), got in zip(names, grads):
        _close(got, g_j['layers'][i][k])
    return out_t


@pytest.mark.parametrize('rel_ptr_as', ['numpy', 'tensor'])
def test_rgcn_forward_matches_jax(rel_ptr_as):
    # The padded batch: edges grouped by relation (one empty), pad edges
    # with row == col == N past the last relation; relation ids from
    # rel_ptr, 1/c over (dst, relation) pairs.
    n, e_real, e_pad, num_rel = 300, 2500, 2600, 5
    rng = np.random.default_rng(7)
    sizes = rng.multinomial(e_real, np.ones(num_rel) / num_rel)
    sizes[2] = 0
    sizes[0] += e_real - sizes.sum()
    rel_ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    row = np.full(e_pad, n, np.int64)
    col = np.full(e_pad, n, np.int64)
    row[:e_real] = rng.integers(0, n, e_real)
    col[:e_real] = rng.integers(0, n, e_real)
    x = features(8, n, DIMS[0])
    cot = features(9, n, DIMS[-1])
    tree = _f32(jgnn.init_rgcn(jax.random.PRNGKey(3), DIMS, num_rel))

    def loss_j(p):
        out = jgnn.rgcn_forward(p, jnp.asarray(x), jnp.asarray(row),
                                jnp.asarray(col), jnp.asarray(rel_ptr))
        return (out * cot).sum(), out

    (_, ref), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    params = rgcn_params_from_jax(tree, device='cpu')
    names = [(i, k) for i, layer in enumerate(params['layers'])
             for k in layer]
    leaves = [params['layers'][i][k].requires_grad_() for i, k in names]
    ptr = rel_ptr if rel_ptr_as == 'numpy' else torch.from_numpy(rel_ptr)
    out = rgcn_forward(params, torch.from_numpy(x), torch.from_numpy(row),
                       torch.from_numpy(col), ptr)
    _close(out, ref)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for (i, k), got in zip(names, grads):
        _close(got, g_j['layers'][i][k])


@pytest.mark.parametrize('skew', [False, True])
@pytest.mark.parametrize('dedup', ['off', 'auto', 'on'])
def test_rgcn_spmm_matches_jax(dedup, skew):
    num, rowptr_d, col_d = _graph(skew)
    graphs_j = jgnn.build_rgcn_graphs(rowptr_d, col_d, num, dedup=dedup)
    graphs_t = build_rgcn_graphs(rowptr_d, col_d, num, dedup=dedup,
                                 device='cpu')
    assert _plan_kinds(graphs_t) == _plan_kinds(graphs_j)
    kinds = {k[0] for k in _plan_kinds(graphs_t)} | {
        k[2] for k in _plan_kinds(graphs_t)}
    if dedup == 'auto' and not skew:  # both plans, and a hot level
        assert kinds == {'SpmmPlan', 'DedupSpmmPlan'}
        assert any(k[3] for k in _plan_kinds(graphs_t))
    tree = _f32(jgnn.init_rgcn_spmm(jax.random.PRNGKey(1), DIMS,
                                    len(EDGES)))
    _run_both(jgnn.rgcn_forward_spmm, graphs_j, rgcn_forward_spmm, graphs_t,
              tree, _x_dict(10, num))


@pytest.mark.parametrize('skew', [False, True])
@pytest.mark.parametrize('chunk', [128, 512])
def test_stacked_plan_tables_equal_jax(chunk, skew):
    num, rowptr_d, col_d = _graph(skew)
    hj = jgnn.build_rgcn_planned(rowptr_d, col_d, num, chunk=chunk)
    ht = build_rgcn_planned(rowptr_d, col_d, num, chunk=chunk, device='cpu')
    assert isinstance(ht, HeteroSpmmPlan)
    assert ht.rel_order == hj.rel_order == tuple(sorted(EDGES))
    assert ht.src_ptr.dtype == hj.src_ptr.dtype
    np.testing.assert_array_equal(ht.src_ptr, hj.src_ptr)
    assert ht.num_nodes == hj.num_nodes
    assert list(ht.graphs) == list(hj.graphs) == list(ht.deginv)
    for t in hj.graphs:
        fj, ft = hj.graphs[t].fwd, ht.graphs[t].fwd
        for name in ('col_padded', 'chunk_tile', 'tile_ptr', 'edge_perm',
                     'row_padded', 'valid_mask'):
            np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                          np.asarray(getattr(fj, name)))
        assert ht.deginv[t].dtype == torch.float32
        np.testing.assert_array_equal(ht.deginv[t].numpy().view(np.int32),
                                      np.asarray(hj.deginv[t]).view(
                                          np.int32))


@pytest.mark.parametrize('form', ['stacked', 'range-sliced'])
@pytest.mark.parametrize('skew', [False, True])
def test_rgcn_planned_matches_jax(form, skew):
    num, rowptr_d, col_d = _graph(skew)
    kw = ({'chunk': 128} if form == 'stacked' else
          {'chunk': 'auto', 'range_sliced': True})
    hj = jgnn.build_rgcn_planned(rowptr_d, col_d, num, **kw)
    ht = build_rgcn_planned(rowptr_d, col_d, num, device='cpu', **kw)
    if form == 'range-sliced':
        for t in hj.graphs:
            plan = ht.graphs[t].fwd
            assert isinstance(plan, ops.FusedRangePlan)
            assert plan.weights is not None
            assert plan.chunk == hj.graphs[t].fwd.chunk
            for pj, pt in zip(hj.graphs[t].fwd.plans, plan.plans):
                np.testing.assert_array_equal(pt.col_padded.numpy(),
                                              np.asarray(pj.col_padded))
        assert not ht.deginv
    tree = _f32(jgnn.init_rgcn_spmm(jax.random.PRNGKey(2), DIMS,
                                    len(EDGES)))
    _run_both(jgnn.rgcn_forward_planned, hj, rgcn_forward_planned, ht, tree,
              _x_dict(20, num))


@pytest.mark.parametrize('skew', [False, True])
def test_three_forms_agree(skew):
    # rgcn_forward_planned is the per-relation model, stacked (as the JAX
    # package's docstring promises).
    num, rowptr_d, col_d = _graph(skew)
    params = init_rgcn_spmm(DIMS, len(EDGES),
                            torch.Generator().manual_seed(5), device='cpu')
    x = {t: torch.from_numpy(v) for t, v in _x_dict(30, num).items()}
    ref = rgcn_forward_spmm(params, x, build_rgcn_graphs(
        rowptr_d, col_d, num, device='cpu'))
    for kw in ({'chunk': 512}, {'chunk': 'auto', 'range_sliced': True}):
        out = rgcn_forward_planned(params, x, build_rgcn_planned(
            rowptr_d, col_d, num, device='cpu', **kw))
        for t in ref:
            np.testing.assert_allclose(out[t].numpy(), ref[t].numpy(),
                                       rtol=RTOL, atol=ATOL)


def test_stacked_plan_refuses_auto_chunk():
    num, rowptr_d, col_d = _graph(False)
    # The JAX package fails too: the string reaches its padded layout.
    with pytest.raises(TypeError):
        jgnn.build_rgcn_planned(rowptr_d, col_d, num, chunk='auto')
    with pytest.raises(ValueError, match='integer chunk'):
        build_rgcn_planned(rowptr_d, col_d, num, chunk='auto', device='cpu')


def test_rgcn_modules():
    num, rowptr_d, col_d = _graph(True)
    gen = torch.Generator().manual_seed(0)
    model = RGCN(DIMS, len(EDGES), generator=gen, device='cpu')
    same = RGCN(DIMS, len(EDGES), generator=torch.Generator().manual_seed(0),
                device='cpu')
    for a, b in zip(model.parameters(), same.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert model.w[0].shape == (len(EDGES), DIMS[0], DIMS[1])
    assert model.w_self[1].shape == (DIMS[1], DIMS[2])
    limit = (6.0 / (DIMS[0] + DIMS[1]))**0.5
    assert float(model.w[0].detach().abs().max()) <= limit
    x = {t: torch.from_numpy(v) for t, v in _x_dict(50, num).items()}
    graphs = build_rgcn_graphs(rowptr_d, col_d, num, device='cpu')
    hplan = build_rgcn_planned(rowptr_d, col_d, num, device='cpu')
    with torch.no_grad():
        a = model(x, graphs)
        b = model(x, hplan)
        ref = rgcn_forward_spmm(model.params(), x, graphs)
    for t in a:
        torch.testing.assert_close(a[t], ref[t], rtol=0, atol=0)
        np.testing.assert_allclose(b[t].numpy(), a[t].numpy(), rtol=RTOL,
                                   atol=ATOL)
    batch = RGCNBatch(DIMS, 3, generator=torch.Generator().manual_seed(1),
                      device='cpu')
    assert batch.w_rel[0].shape == (3, DIMS[0], DIMS[1])
    xb = torch.from_numpy(features(51, 40, DIMS[0]))
    row = torch.arange(30) % 40
    col = (torch.arange(30) * 7) % 40
    out = batch(xb, row, col, np.array([0, 10, 20, 30]))
    assert out.shape == (40, DIMS[-1]) and bool(torch.isfinite(out).all())


def test_example_loss_falls():
    # As tests/test_end_to_end.py holds the JAX package's hetero training.
    losses = train_example(device='cpu', epochs=30)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses


@pytest.mark.parametrize('reduce', ['sum', 'mean', 'max', 'min'])
@pytest.mark.parametrize('graph', ['uniform', 'powerlaw'])
def test_spmm_csr_matches_jax(graph, reduce):
    rowptr, col = (uniform_graph(60, 300, 4000) if graph == 'uniform' else
                   powerlaw_graph(61, 300, 4000))
    x = features(62, 300, 24)
    ref = np.asarray(jops.spmm_csr(jnp.asarray(x), rowptr, col, reduce))
    for rp, cl in ((rowptr, col),
                   (torch.from_numpy(rowptr), torch.from_numpy(col))):
        got = ops.spmm_csr(torch.from_numpy(x), rp, cl, reduce).numpy()
        if reduce in ('max', 'min'):
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_spmm_csr_cache():
    _GRAPH_CACHE.clear()
    rowptr, col = uniform_graph(63, 200, 2000)
    x = torch.from_numpy(features(64, 200, 8))
    ops.spmm_csr(x, rowptr, col)
    assert len(_GRAPH_CACHE) == 1
    (key, entry), = _GRAPH_CACHE.items()
    # A hit: the same numpy buffers, or tensors of the same content.
    ops.spmm_csr(x, rowptr, col)
    ops.spmm_csr(x, torch.from_numpy(rowptr), torch.from_numpy(col.copy()))
    ops.spmm_csr(x, torch.from_numpy(rowptr), torch.from_numpy(col.copy()))
    assert len(_GRAPH_CACHE) == 2 and _GRAPH_CACHE[key] is entry
    # A buffer changed in place: same key, new graph, the new answer.
    col[:50] = (col[:50] + 1) % 200
    got = ops.spmm_csr(x, rowptr, col)
    assert len(_GRAPH_CACHE) == 2 and _GRAPH_CACHE[key] is not entry
    ref = jops.spmm_csr(jnp.asarray(x.numpy()), rowptr, col)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    # Eviction at 8: the oldest graph goes first.
    first = next(iter(_GRAPH_CACHE))
    graphs = [uniform_graph(70 + i, 200, 1000) for i in range(7)]
    for rp, cl in graphs:
        ops.spmm_csr(x, rp, cl)
    assert len(_GRAPH_CACHE) == 8 and first not in _GRAPH_CACHE
    _GRAPH_CACHE.clear()
