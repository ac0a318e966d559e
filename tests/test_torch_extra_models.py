"""The port's GIN, EdgeConv, PointNet++ set abstraction and node2vec loss
against the JAX package's ``models.extra`` on the CPU, outputs and weight
gradients, through converted JAX weights; the port's op surface against
the JAX package's; and the point-cloud example.

Weights come from the JAX package's ``init_*`` (biases and ``eps`` set to
non-zero values from a seed) and reach the port through
``*_params_from_jax``; inputs from ``np.random.default_rng``. Tolerance:
1e-4 of max |JAX value| for each output and each gradient (f32 matmuls
and sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import models as jmodels
from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import models, ops
from pyg_lib_tpu_torch.examples import train_pointcloud

MODEL_RTOL = 1e-4  # of max |JAX value|


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=MODEL_RTOL * max(np.abs(ref).max(), 1e-6))


def _f32_tree(tree, seed):
    """The tree as f32 numpy arrays, every zero array replaced by small
    values from ``seed`` (so biases and ``eps`` matter)."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        if not a.any():
            a = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree.map(leaf, tree)


def _leaves(tree):
    """Leaves of a port tree, each made a leaf that requires grad."""
    leaves = jax.tree.leaves(tree, is_leaf=lambda t: isinstance(
        t, torch.Tensor))
    for t in leaves:
        t.requires_grad_()
    return leaves


def _check(jax_fn, tree, port_fn, port_tree, cot):
    """Output and weight gradients of ``port_fn(port_tree)`` against
    ``jax_fn(tree)``, the gradients those of ``Σ out · cot``."""
    ref = jax_fn(jax.tree.map(jnp.asarray, tree))
    rgrads = jax.tree.leaves(jax.grad(lambda t: jnp.sum(jax_fn(t) * cot))(
        jax.tree.map(jnp.asarray, tree)))
    leaves = _leaves(port_tree)
    out = port_fn(port_tree)
    _close(out, ref)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    assert len(grads) == len(rgrads)
    for g, r in zip(grads, rgrads):
        _close(g, r)


def _batch(seed, n, e, pad):
    """A CSR batch as the JAX package pads it: ``row`` sorted by
    destination, ``pad`` edges with ``row == n`` past ``rowptr[-1]``."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e))
    dst[dst % 13 == 0] = 0  # rows with no edge
    dst.sort()
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=rowptr[1:])
    row = np.concatenate([rng.integers(0, n, e), np.full(pad, n)])
    return rowptr, row


@pytest.mark.parametrize('pad', [0, 5])
def test_gin_matches_jax(pad):
    n, dims = 120, [16, 32, 24, 3]
    rowptr, row = _batch(0, n, 900, pad)
    x = np.random.default_rng(1).normal(size=(n, dims[0])).astype(np.float32)
    tree = _f32_tree(jmodels.init_gin(jax.random.key(0), dims), 2)
    cot = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    _check(lambda t: jmodels.gin_forward(t, jnp.asarray(x),
                                         jnp.asarray(rowptr),
                                         jnp.asarray(row)),
           tree, lambda t: models.gin_forward(
               t, torch.from_numpy(x), torch.from_numpy(rowptr),
               torch.from_numpy(row)),
           models.gin_params_from_jax(tree, device='cpu'), cot)


def test_gin_module_and_eps():
    n = 40
    rowptr, row = _batch(4, n, 200, 0)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n, 8)).astype(np.float32))
    gin = models.GIN([8, 8, 4], generator=torch.Generator().manual_seed(0),
                     device='cpu')
    out0 = gin(x, torch.from_numpy(rowptr), torch.from_numpy(row))
    assert out0.shape == (n, 4)
    assert torch.equal(out0, models.gin_forward(
        gin.params(), x, torch.from_numpy(rowptr), torch.from_numpy(row)))
    with torch.no_grad():
        gin.params()['layers'][0]['eps'].fill_(1.0)
    out1 = gin(x, torch.from_numpy(rowptr), torch.from_numpy(row))
    assert float((out1 - out0).detach().abs().max()) > 1e-3
    (grad, ) = torch.autograd.grad(out1.sum(),
                                   gin.params()['layers'][0]['eps'])
    assert torch.isfinite(grad)


@pytest.mark.parametrize('dups', [False, True])
def test_edgeconv_matches_jax(dups):
    n, k, dims = 64, 8, [3, 16, 32]
    pts = np.random.default_rng(6).normal(size=(n, 3)).astype(np.float32)
    if dups:  # duplicate points: ties in the max's gradient
        pts[1::2] = pts[::2]
    idx = np.array(jops.knn(jnp.asarray(pts), jnp.asarray(pts), k=k))
    assert np.array_equal(
        ops.knn(torch.from_numpy(pts), torch.from_numpy(pts), k=k).numpy(),
        idx)
    tree = _f32_tree(jmodels.init_edgeconv(jax.random.key(2), dims), 7)
    cot = np.random.default_rng(8).normal(size=(n, 32)).astype(np.float32)
    _check(lambda t: jmodels.edgeconv_forward(t, jnp.asarray(pts),
                                              jnp.asarray(idx), k),
           tree, lambda t: models.edgeconv_forward(
               t, torch.from_numpy(pts), torch.from_numpy(idx), k),
           models.edgeconv_params_from_jax(tree, device='cpu'), cot)
    conv = models.EdgeConv(dims, device='cpu')
    assert conv(torch.from_numpy(pts), torch.from_numpy(idx),
                k).shape == (n, 32)


def _grouping(pos, ratio, r, cap):
    """The JAX package's SA grouping: fps centroids, radius pairs as a CSR
    over the centroids."""
    cidx = np.array(jops.fps(jnp.asarray(pos), jnp.asarray(
        np.array([0, pos.shape[0]])), ratio, random_start=False))
    q, col = np.array(jops.radius(jnp.asarray(pos), jnp.asarray(pos[cidx]),
                                    r, max_num_neighbors=cap))
    rowptr = np.zeros(cidx.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(q, minlength=cidx.shape[0]), out=rowptr[1:])
    return cidx, rowptr, col


@pytest.mark.parametrize('with_feat', [False, True])
@pytest.mark.parametrize('empty_group', [False, True])
def test_pointnet_sa_matches_jax(with_feat, empty_group):
    rng = np.random.default_rng(9)
    n = 128
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    cidx, rowptr, col = _grouping(pos, 0.25, 1.5, 16)
    got_idx = ops.fps(torch.from_numpy(pos), torch.tensor([0, n]), 0.25,
                      random_start=False)
    np.testing.assert_array_equal(got_idx.numpy(), cidx)
    if empty_group:  # centroid 1's group moved to centroid 0
        rowptr[1] = rowptr[2]
    feat = rng.normal(size=(n, 5)).astype(np.float32) if with_feat else None
    tree = _f32_tree(jmodels.init_pointnet_sa(
        jax.random.key(3), 5 if with_feat else 0, [16, 32]), 10)
    m = cidx.shape[0]
    cot = rng.normal(size=(m, 32)).astype(np.float32)

    def jfn(t):
        return jmodels.pointnet_sa_forward(
            t, jnp.asarray(pos), None if feat is None else jnp.asarray(feat),
            jnp.asarray(cidx), jnp.asarray(rowptr), jnp.asarray(col))[1]

    def tfn(t):
        return models.pointnet_sa_forward(
            t, torch.from_numpy(pos),
            None if feat is None else torch.from_numpy(feat),
            torch.from_numpy(cidx), torch.from_numpy(rowptr),
            torch.from_numpy(col))[1]

    _check(jfn, tree, tfn,
           models.pointnet_sa_params_from_jax(tree, device='cpu'), cot)
    new_pos, _ = models.PointNetSA(5 if with_feat else 0, [16, 32],
                                   device='cpu')(
        torch.from_numpy(pos), None if feat is None else
        torch.from_numpy(feat), torch.from_numpy(cidx),
        torch.from_numpy(rowptr), torch.from_numpy(col))
    np.testing.assert_array_equal(new_pos.numpy(), pos[cidx])


def test_node2vec_loss_matches_jax():
    rng = np.random.default_rng(11)
    n, dim = 60, 16
    tree = _f32_tree(jmodels.init_node2vec(jax.random.key(4), n, dim), 12)
    walks = rng.integers(0, n, (32, 7))
    neg = rng.integers(0, n, (32, 5))
    for window in (1, 2, 3):
        ref = jmodels.node2vec_loss(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(walks), jnp.asarray(neg),
                                    window)
        rgrad = jax.grad(lambda t: jmodels.node2vec_loss(
            t, jnp.asarray(walks), jnp.asarray(neg), window))(
                jax.tree.map(jnp.asarray, tree))['emb']
        params = models.node2vec_params_from_jax(tree, device='cpu')
        params['emb'].requires_grad_()
        loss = models.node2vec_loss(params, torch.from_numpy(walks),
                                    torch.from_numpy(neg), window)
        _close(loss, ref)
        (grad, ) = torch.autograd.grad(loss, params['emb'])
        _close(grad, rgrad)
    emb = models.init_node2vec(n, dim, torch.Generator().manual_seed(0),
                               device='cpu')['emb']
    assert emb.shape == (n, dim) and float(emb.std()) < 0.5


def test_port_ops_cover_the_jax_package():
    assert set(jops.__all__) <= set(ops.__all__)


def test_train_pointcloud_example_runs_on_the_cpu():
    acc = train_pointcloud.main(steps=4, k=4, n_pts=32, verbose=False,
                                device='cpu')
    assert 0.0 <= acc <= 1.0
