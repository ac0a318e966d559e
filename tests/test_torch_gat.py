"""The port's full-graph GAT against the JAX package's ``gat_forward_spmm``,
on the CPU.

Weights come from the JAX package's ``init_gat_spmm`` (or that tree with a
last layer of one head) and reach the port through
``gat_params_from_jax``; features come from ``np.random.default_rng``.
The JAX forward runs its softmax kernel K6 in the Pallas interpreter,
whose values are within 5e-5 relative of the port's
(``tests/test_torch_softmax.py``), so the tolerance is K6's rtol 5e-5
with atol 1e-4 for the sums and matmuls of a layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.models import gnn as jgnn
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.models import GAT, gat_forward_spmm, gat_params_from_jax
from test_torch_spmm import features, powerlaw_graph, uniform_graph

RTOL, ATOL = 5e-5, 1e-4
DIMS = [32, 16, 8]
HEADS = 4

GRAPHS = {
    'uniform': lambda: uniform_graph(30, 300, 4000),
    'powerlaw': lambda: powerlaw_graph(31, 300, 4000),
}


def _tree(seed, last_heads=HEADS):
    """``init_gat_spmm``'s tree as f32 numpy; ``last_heads`` re-cuts the
    last layer's attention vectors to that many heads."""
    tree = jgnn.init_gat_spmm(jax.random.PRNGKey(seed), DIMS, heads=HEADS)
    layers = [{k: np.asarray(v, np.float32) for k, v in layer.items()}
              for layer in tree['layers']]
    if last_heads != HEADS:
        last = layers[-1]
        width = last['w'].shape[1]
        rng = np.random.default_rng(seed)
        for k in ('a_src', 'a_dst'):
            last[k] = rng.normal(size=(last_heads, width // last_heads)
                                 ).astype(np.float32)
    return {'layers': layers}


def _graphs(name):
    rowptr, col = GRAPHS[name]()
    graph_j = jops.build_spmm_graph(rowptr, col, chunk=128,
                                    with_edge_maps=True)
    graph_t = ops.build_spmm_graph(rowptr, col, chunk=128,
                                   with_edge_maps=True, device='cpu')
    return graph_j, graph_t


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('last_heads', [HEADS, 1])
def test_gat_forward_matches_jax(graph, last_heads):
    graph_j, graph_t = _graphs(graph)
    tree = _tree(0, last_heads)
    x = features(32, 300, DIMS[0])
    ref = jgnn.gat_forward_spmm(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x), graph_j)
    got = gat_forward_spmm(gat_params_from_jax(tree, device='cpu'),
                           torch.from_numpy(x), graph_t)
    assert got.shape == (300, DIMS[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('last_heads', [HEADS, 1])
def test_gat_weight_grads_match_jax(graph, last_heads):
    # The backward runs K6's closed form (its row sums through K1's
    # msgs_padded entry) and segment_sum_padded's row broadcast.
    graph_j, graph_t = _graphs(graph)
    tree = _tree(1, last_heads)
    x = features(33, 300, DIMS[0])
    cot = features(34, 300, DIMS[-1])

    def loss_j(params):
        return (jgnn.gat_forward_spmm(params, jnp.asarray(x), graph_j) *
                cot).sum()

    gref = jax.grad(loss_j)(jax.tree.map(jnp.asarray, tree))
    params = gat_params_from_jax(tree, device='cpu')
    leaves = [p for layer in params['layers'] for p in layer.values()]
    for p in leaves:
        p.requires_grad_()
    loss = (gat_forward_spmm(params, torch.from_numpy(x), graph_t) *
            torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, leaves)
    refs = [np.asarray(layer[k]) for layer in gref['layers']
            for k in ('w', 'a_src', 'a_dst')]
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(ref).max()))


def test_gat_params_from_jax_keeps_shapes_and_values():
    tree = _tree(2, last_heads=1)
    params = gat_params_from_jax(tree, device='cpu')
    assert len(params['layers']) == len(DIMS) - 1
    for got, want in zip(params['layers'], tree['layers']):
        assert set(got) == {'w', 'a_src', 'a_dst'}
        for k in got:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert tuple(params['layers'][-1]['a_src'].shape) == (1, DIMS[-1])


def test_gat_module_trains_on_cpu():
    _, graph = _graphs('powerlaw')
    model = GAT(DIMS, heads=HEADS,
                generator=torch.Generator().manual_seed(0), device='cpu')
    same = GAT(DIMS, heads=HEADS,
               generator=torch.Generator().manual_seed(0), device='cpu')
    for a, b in zip(model.parameters(), same.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    shapes = [tuple(p.shape) for layer in model.params()['layers']
              for p in layer.values()]
    assert shapes == [(32, 16), (4, 4), (4, 4), (16, 8), (4, 2), (4, 2)]
    x = torch.from_numpy(features(35, 300, DIMS[0]))
    labels = torch.from_numpy(
        np.random.default_rng(36).integers(0, DIMS[-1], 300))
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x, graph), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_gat_heads_must_divide_every_width():
    with pytest.raises(ValueError, match='divisible'):
        GAT([32, 16, 7], heads=HEADS, device='cpu')
