"""The slice's models against the JAX package on the CPU: ``gcn_forward``
and ``sage_forward`` (mean and max) over a CSR batch, and the full-graph
GraphSAGE max-pool model over a planned graph.

Weights come from the JAX package's ``init_gcn`` / ``init_sage`` and reach
the port through ``gcn_params_from_jax`` / ``sage_params_from_jax``;
features from ``np.random.default_rng``. Tolerances: forwards within 1e-4
of the output's max |value| (two aggregations and two matmuls in another
order); gradients at f32 rtol 1e-5 / atol 1e-4 of the same sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.models import gnn as jgnn
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.models import (SAGE, gcn_forward, gcn_params_from_jax,
                                      sage_forward, sage_maxpool_forward_spmm,
                                      sage_params_from_jax)
from test_torch_spmm import ATOL, RTOL, _csr, features, powerlaw_graph

MODEL_RTOL = 1e-4  # of max |output|
DIMS = [32, 24, 5]


def _tree(init, seed, dims=DIMS):
    # The trees' biases follow the default float type, float64 under the
    # suite's x64 mode: hand both packages the same f32 arrays.
    tree = init(jax.random.PRNGKey(seed), dims)
    return {'layers': [{k: np.asarray(v, np.float32) for k, v in l.items()}
                       for l in tree['layers']]}


def _batch(seed, n, e, pad=6):
    """A CSR batch as the JAX package pads it: ``row`` sorted by
    destination, ``pad`` edges with ``row == n`` past ``rowptr[-1]``."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, e)
    dst[dst % 11 == 0] = 1  # rows with no edge
    rowptr, row = _csr(dst, rng.integers(0, n, e), n)
    return rowptr, np.concatenate([row, np.full(pad, n, np.int64)])


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=MODEL_RTOL * np.abs(ref).max())


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize('size', ['small', 'planned'])
def test_gcn_forward_matches_jax(size):
    n, e = (200, 1500) if size == 'small' else (9000, 70000)
    rowptr, row = _batch(60, n, e)
    tree = _tree(jgnn.init_gcn, 0)
    x = features(61, n, DIMS[0])
    ref = jgnn.gcn_forward(_jax_tree(tree), jnp.asarray(x),
                           jnp.asarray(rowptr), jnp.asarray(row))
    got = gcn_forward(gcn_params_from_jax(tree, device='cpu'),
                      torch.from_numpy(x), torch.from_numpy(rowptr),
                      torch.from_numpy(row))
    _close(got.numpy(), ref)


@pytest.mark.parametrize('aggr', ['mean', 'max'])
@pytest.mark.parametrize('size', ['small', 'planned'])
def test_sage_forward_matches_jax(aggr, size):
    # 'planned': 70,000 edges, past the planned segment_max_csr's 65,536
    # (the pad edges send it to the plain path: the batch ends exactly
    # at rowptr[-1] there).
    n, e = (200, 1500) if size == 'small' else (9000, 70000)
    rowptr, row = _batch(62, n, e, pad=6 if size == 'small' else 0)
    tree = _tree(jgnn.init_sage, 1)
    x = features(63, n, DIMS[0])
    ref = jgnn.sage_forward(_jax_tree(tree), jnp.asarray(x),
                            jnp.asarray(rowptr), jnp.asarray(row), aggr)
    got = sage_forward(sage_params_from_jax(tree, device='cpu'),
                       torch.from_numpy(x), torch.from_numpy(rowptr),
                       torch.from_numpy(row), aggr)
    _close(got.numpy(), ref)


@pytest.mark.parametrize('aggr', ['mean', 'max'])
def test_sage_forward_grads_match_jax(aggr):
    rowptr, row = _batch(64, 200, 1500)
    tree = _tree(jgnn.init_sage, 2)
    x = features(65, 200, DIMS[0])
    cot = features(66, 200, DIMS[-1])

    def loss_j(params, xx):
        return (jgnn.sage_forward(params, xx, jnp.asarray(rowptr),
                                  jnp.asarray(row), aggr) * cot).sum()

    gp, gx = jax.grad(loss_j, argnums=(0, 1))(_jax_tree(tree),
                                              jnp.asarray(x))
    params = sage_params_from_jax(tree, device='cpu')
    leaves = [l[k].requires_grad_() for l in params['layers']
              for k in ('w_self', 'w_nbr', 'b')]
    xt = torch.from_numpy(x).requires_grad_()
    loss = (sage_forward(params, xt, torch.from_numpy(rowptr),
                         torch.from_numpy(row), aggr) *
            torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, leaves + [xt])
    refs = [np.asarray(l[k]) for l in gp['layers']
            for k in ('w_self', 'w_nbr', 'b')] + [gx]
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def _maxpool_graphs(case):
    if case == 'powerlaw':
        rowptr, col = powerlaw_graph(67, 300, 4000)
    else:  # rows with no edge (whose JAX primal is -inf, see below)
        rowptr, row = _batch(68, 300, 3000, pad=0)
        col = row
    return (rowptr, jops.build_spmm_graph(rowptr, col, with_edge_maps=True),
            ops.build_spmm_graph(rowptr, col, with_edge_maps=True,
                                 device='cpu'))


@pytest.mark.parametrize('case', ['powerlaw', 'empty_rows'])
def test_sage_maxpool_forward_matches_jax(case):
    rowptr, graph_j, graph_t = _maxpool_graphs(case)
    tree = _tree(jgnn.init_sage, 3)
    x = features(69, 300, DIMS[0])
    # jax.vjp runs segment_max_padded's VJP forward, which gives an empty
    # row 0 as the port does; the plain JAX primal leaves it at -inf.
    ref, _ = jax.vjp(lambda p: jgnn.sage_maxpool_forward_spmm(
        p, jnp.asarray(x), graph_j), _jax_tree(tree))
    got = sage_maxpool_forward_spmm(sage_params_from_jax(tree, device='cpu'),
                                    torch.from_numpy(x), graph_t)
    _close(got.numpy(), ref)


def test_sage_maxpool_grads_match_jax():
    rowptr, graph_j, graph_t = _maxpool_graphs('powerlaw')
    tree = _tree(jgnn.init_sage, 4)
    x = features(70, 300, DIMS[0])
    labels = np.random.default_rng(71).integers(0, DIMS[-1], 300)

    def loss_j(params, xx):
        logits = jgnn.sage_maxpool_forward_spmm(params, xx, graph_j)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                    1).mean()

    gp, gx = jax.grad(loss_j, argnums=(0, 1))(_jax_tree(tree),
                                              jnp.asarray(x))
    params = sage_params_from_jax(tree, device='cpu')
    leaves = [l[k].requires_grad_() for l in params['layers']
              for k in ('w_self', 'w_nbr', 'b')]
    xt = torch.from_numpy(x).requires_grad_()
    loss = torch.nn.functional.cross_entropy(
        sage_maxpool_forward_spmm(params, xt, graph_t),
        torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves + [xt])
    refs = [np.asarray(l[k]) for l in gp['layers']
            for k in ('w_self', 'w_nbr', 'b')] + [gx]
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_sage_module_trains_on_cpu():
    rowptr, _, graph = _maxpool_graphs('powerlaw')
    model = SAGE(DIMS, generator=torch.Generator().manual_seed(0),
                 device='cpu')
    same = SAGE(DIMS, generator=torch.Generator().manual_seed(0),
                device='cpu')
    for a, b in zip(model.parameters(), same.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    limit = (6.0 / (DIMS[0] + DIMS[1]))**0.5
    assert float(model.w_nbr[0].detach().abs().max()) <= limit
    assert not torch.equal(model.w_self[0], model.w_nbr[0])
    x = torch.from_numpy(features(72, 300, DIMS[0]))
    labels = torch.from_numpy(
        np.random.default_rng(73).integers(0, DIMS[-1], 300))
    torch.testing.assert_close(
        model(x, graph), sage_maxpool_forward_spmm(model.params(), x, graph))
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x, graph), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_sage_forward_rejects_unknown_aggr():
    rowptr, row = _batch(74, 50, 200)
    params = sage_params_from_jax(_tree(jgnn.init_sage, 5), device='cpu')
    with pytest.raises(ValueError, match='Unknown aggr'):
        sage_forward(params, torch.zeros((50, DIMS[0])),
                     torch.from_numpy(rowptr), torch.from_numpy(row), 'sum')
