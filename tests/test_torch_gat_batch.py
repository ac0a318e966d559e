"""The port's padded-batch GAT (``gat_forward``, ``GATBatch``,
``gat_batch_params_from_jax``) against the JAX package's ``gat_forward``,
on the CPU.

Batches come from ``pyg_lib_tpu.sampler`` (``neighbor_sample`` and
``pad_sample_output``) or from ``to_padded_csr`` of a seeded random graph;
weights from the JAX package's ``init_gat``, features and cotangents from
``np.random.default_rng``. Pad edges carry ``row == col == N`` and sit past
``rowptr[-1]``; in the sampled batches the last node has only pad
in-edges, so its softmax bucket holds only ``-inf`` logits. Outputs and
weight gradients must be NaN exactly where JAX's are, and otherwise
within f32 rtol 1e-4, atol 1e-5 (sums of a few edges, ``exp`` and two
matmuls a layer, in another order). ``chip_smoke.py``'s plain padded GAT
(``plain_gat_batch``, with and without the model's recorded leaky_relu
branches) is held against the port's model at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pyg_lib_tpu import sampler
from pyg_lib_tpu.models import gnn as jgnn
from pyg_lib_tpu.sampler.padding import to_padded_csr
from pyg_lib_tpu.testing import cycle_graph
from pyg_lib_tpu_torch.models import (GATBatch, gat_batch_params_from_jax,
                                      gat_forward)

RTOL, ATOL = 1e-4, 1e-5
DIMS = [16, 8, 7]
HEADS = 2
KEYS = ('w', 'att_src', 'att_dst', 'b')


def _sampled(max_nodes=None, extra_edges=0):
    rowptr, col = cycle_graph(32)
    out = sampler.neighbor_sample(rowptr, col, np.arange(0, 32, 4), [4, 4],
                                  rng=0)
    n, e = len(out[2]), len(out[0])
    return sampler.padding.pad_sample_output(
        out, max_nodes=max_nodes or n, max_edges=e + extra_edges,
        num_seeds=8)


def _batch(kind):
    """``(rowptr, row, col, n)`` as numpy; pad edges carry ``N``."""
    if kind == 'sampled':  # 64 node slots: node 63 is padding
        b = _sampled(max_nodes=64, extra_edges=40)
        return b.rowptr, b.row, b.col, 64
    if kind == 'tight':  # no pad node; pad edges join the last real node
        b = _sampled(extra_edges=9)
        return b.rowptr, b.row, b.col, len(b.node_mask)
    rng = np.random.default_rng(3)  # every node has in-edges
    n, e = 40, 200
    col = np.concatenate([np.arange(n), rng.integers(0, n, e - n)])
    row = rng.integers(0, n, e)
    rowptr, row_p, col_p, _ = to_padded_csr(row, col, n, n, e + 17)
    return rowptr, row_p, col_p, n


def _tree(seed, dims=DIMS):
    tree = jgnn.init_gat(jax.random.PRNGKey(seed), dims, heads=HEADS)
    return {'layers': [{k: np.asarray(layer[k], np.float32) for k in KEYS}
                       for layer in tree['layers']],
            'heads': tree['heads']}


def _allclose_nan(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('kind', ['sampled', 'tight', 'random'])
def test_gat_forward_and_weight_grads_match_jax(kind):
    rowptr, row, col, n = _batch(kind)
    assert (col[rowptr[-1]:] == n).all() and len(col) > rowptr[-1]
    if kind == 'sampled':
        assert rowptr[-1] == rowptr[-2]  # node N-1: pad in-edges only
    tree = _tree(0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, DIMS[0])).astype(np.float32)
    cot = rng.normal(size=(n, DIMS[-1])).astype(np.float32)
    batch_j = [jnp.asarray(a) for a in (rowptr, row, col)]
    batch_t = [torch.tensor(a) for a in (rowptr, row, col)]
    layers_j = jax.tree_util.tree_map(jnp.asarray, tree['layers'])

    def jforward(layers):
        return jgnn.gat_forward({'layers': layers, 'heads': HEADS},
                                jnp.asarray(x), *batch_j)

    ref = jforward(layers_j)
    grads_j = jax.grad(lambda p: (jforward(p) * jnp.asarray(cot)).sum())(
        layers_j)
    params = gat_batch_params_from_jax(tree, device='cpu')
    leaves = [layer[k] for layer in params['layers'] for k in KEYS]
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = gat_forward(params, torch.tensor(x), *batch_t)
    assert out.shape == (n, DIMS[-1])
    _allclose_nan(out.detach().numpy(), ref)
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum(), leaves)
    refs = [grads_j[i][k] for i in range(len(DIMS) - 1)
            for k in KEYS]
    for g, r in zip(grads, refs):
        _allclose_nan(g.numpy(), r)


def _smoke_inputs(kind, dims=DIMS):
    rowptr, row, col, n = _batch(kind)
    params = gat_batch_params_from_jax(_tree(2, dims), device='cpu')
    leaves = [layer[k] for layer in params['layers'] for k in KEYS]
    for leaf in leaves:
        leaf.requires_grad_(True)
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(n, DIMS[0])).astype(np.float32))
    cot = torch.tensor(rng.normal(size=(n, DIMS[-1])).astype(np.float32))
    batch = [torch.tensor(a) for a in (rowptr, row, col)]
    return params, leaves, x, cot, batch


@pytest.mark.parametrize('kind', ['sampled', 'tight', 'random'])
def test_chip_smoke_reference_follows_the_model(kind):
    # chip_smoke.py's plain padded GAT, with its own leaky_relu branches
    # and with those recorded on the model's forward (on one device the
    # same: none switches), gives the model's output and weight gradients.
    params, leaves, x, cot, batch = _smoke_inputs(kind)
    out, signs = chip_smoke.relu_signs(
        lambda: gat_forward(params, x, *batch))
    assert [tuple(s.shape) for s in signs] == [(len(batch[1]), HEADS)] * 2
    grads = torch.autograd.grad((out * cot).sum(), leaves)
    for given in (None, signs):
        ref, switched = chip_smoke.plain_gat_batch(params, x, *batch, given)
        assert switched == 0
        _allclose_nan(ref.detach().numpy(), out.detach().numpy())
        refs = torch.autograd.grad((ref * cot).sum(), leaves)
        for g, r in zip(grads, refs):
            _allclose_nan(g.numpy(), r.numpy())


def test_chip_smoke_reference_takes_the_given_branches():
    # One layer, every edge logit's branch flipped: each real edge's
    # counts as switched (pad edges' do not), and the output moves.
    params, _, x, _, batch = _smoke_inputs('random', DIMS[::2])
    with torch.no_grad():
        out, signs = chip_smoke.relu_signs(
            lambda: gat_forward(params, x, *batch))
        ref, switched = chip_smoke.plain_gat_batch(
            params, x, *batch, [~s for s in signs])
    real = int(batch[0][-1])
    assert switched == real * HEADS
    assert not torch.allclose(ref, out, rtol=RTOL, atol=ATOL)


def test_chip_smoke_relu_signs_record_and_replay():
    # chip_smoke.relu_signs records which inputs each torch.relu call kept
    # and, given such a record, makes each call take the recorded branch:
    # flipped, a call passes what relu would zero and zeros what it kept.
    x = torch.tensor([-1.0, 0.0, 2.0])
    _, signs = chip_smoke.relu_signs(lambda: torch.relu(x) + torch.relu(-x))
    assert [s.tolist() for s in signs] == [[False, False, True],
                                           [True, False, False]]
    flipped, _ = chip_smoke.relu_signs(lambda: torch.relu(x), [~signs[0]])
    assert flipped.tolist() == [-1.0, 0.0, 0.0]


def test_params_from_jax():
    tree = _tree(2)
    params = gat_batch_params_from_jax(tree, device='cpu')
    assert params['heads'] == HEADS
    for layer, ref in zip(params['layers'], tree['layers']):
        for k in KEYS:
            assert layer[k].dtype == torch.float32
            np.testing.assert_array_equal(layer[k].numpy(), ref[k])


def test_module_shapes_match_init_gat():
    model = GATBatch(DIMS, heads=HEADS,
                     generator=torch.Generator().manual_seed(0),
                     device='cpu')
    tree = _tree(0)
    for i, layer in enumerate(model.params()['layers']):
        for k in KEYS:
            assert tuple(layer[k].shape) == tree['layers'][i][k].shape
    assert (model.b[0] == 0).all() and model.params()['heads'] == HEADS


def test_module_trains_on_cpu():
    rowptr, row, col, n = _batch('sampled')
    model = GATBatch(DIMS, heads=HEADS,
                     generator=torch.Generator().manual_seed(1),
                     device='cpu')
    x = torch.tensor(np.random.default_rng(4).normal(
        size=(n, DIMS[0])).astype(np.float32))
    labels = torch.tensor(np.random.default_rng(5).integers(0, DIMS[-1], n))
    batch = [torch.tensor(a) for a in (rowptr, row, col)]
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x, *batch), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (lambda: GATBatch(DIMS, heads=HEADS),
                  lambda: gat_batch_params_from_jax(_tree(0))):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()
