"""The port's ``spline_basis`` and ``spline_weighting`` against the JAX
package's on the CPU, values and gradients.

Inputs come from ``np.random.default_rng``. Tolerance: f32, 1e-5 of the
output's (or the gradient's) max |value| (the same products and sums, the
weighting's in another order: one matrix product and a gather of blocks
in place of the JAX einsum); weight indices equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import ops

TOL = 1e-5  # of max |JAX value|


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1e-30))


def _inputs(seed, e, d, m_in, m_out, ks):
    rng = np.random.default_rng(seed)
    pseudo = rng.uniform(0.01, 0.98, size=(e, d)).astype(np.float32)
    x = rng.normal(size=(e, m_in)).astype(np.float32)
    weight = rng.normal(size=(int(np.prod(ks)), m_in, m_out)).astype(
        np.float32)
    return pseudo, x, weight


@pytest.mark.parametrize('degree', [1, 2, 3])
@pytest.mark.parametrize('open_spline', [1, 0])
def test_spline_basis_matches_jax(degree, open_spline):
    pseudo, _, _ = _inputs(0, 40, 3, 1, 1, [5, 4, 3])
    pseudo[0] = [0.0, 0.5, 0.999]  # a point on a knot and near the end
    ks = np.array([5, 4, 3])
    iso = np.full(3, open_spline)
    rb, rwi = jops.spline_basis(jnp.asarray(pseudo), jnp.asarray(ks),
                                jnp.asarray(iso), degree)
    basis, wi = ops.spline_basis(torch.from_numpy(pseudo),
                                 torch.from_numpy(ks), torch.from_numpy(iso),
                                 degree)
    _close(basis, rb)
    assert wi.dtype == torch.int64
    np.testing.assert_array_equal(wi.numpy(), np.asarray(rwi))


@pytest.mark.parametrize('degree', [1, 2, 3])
@pytest.mark.parametrize('open_spline', [1, 0])
def test_spline_weighting_and_grads_match_jax(degree, open_spline):
    ks = np.array([5, 5])
    iso = np.full(2, open_spline)
    pseudo, x, weight = _inputs(1 + degree, 30, 2, 6, 4, ks)
    cot = np.random.default_rng(9).normal(size=(30, 4)).astype(np.float32)

    def jf(p, xx, w):
        basis, wi = jops.spline_basis(p, jnp.asarray(ks), jnp.asarray(iso),
                                      degree)
        return jops.spline_weighting(xx, w, basis, wi)

    ref = jf(jnp.asarray(pseudo), jnp.asarray(x), jnp.asarray(weight))
    rgrads = jax.grad(lambda *a: jnp.sum(jf(*a) * cot), argnums=(0, 1, 2))(
        jnp.asarray(pseudo), jnp.asarray(x), jnp.asarray(weight))
    tp, tx, tw = (torch.from_numpy(a).requires_grad_()
                  for a in (pseudo, x, weight))
    basis, wi = ops.spline_basis(tp, torch.from_numpy(ks),
                                 torch.from_numpy(iso), degree)
    out = ops.spline_weighting(tx, tw, basis, wi)
    _close(out, ref)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                (tp, tx, tw))
    for g, r in zip(grads, rgrads):
        _close(g, r)


def test_spline_weighting_basis_grad_matches_jax():
    rng = np.random.default_rng(4)
    e, s, m_in, m_out, k = 12, 4, 6, 5, 20
    x = rng.normal(size=(e, m_in)).astype(np.float32)
    weight = rng.normal(size=(k, m_in, m_out)).astype(np.float32)
    basis = rng.uniform(size=(e, s)).astype(np.float32)
    wi = rng.integers(0, k, size=(e, s))
    wi[0] = 3  # one edge reads the same weight S times
    ref = jops.spline_weighting(jnp.asarray(x), jnp.asarray(weight),
                                jnp.asarray(basis), jnp.asarray(wi))
    rgrad = jax.grad(lambda b: jnp.sum(jops.spline_weighting(
        jnp.asarray(x), jnp.asarray(weight), b, jnp.asarray(wi))**2))(
            jnp.asarray(basis))
    tb = torch.from_numpy(basis).requires_grad_()
    out = ops.spline_weighting(torch.from_numpy(x), torch.from_numpy(weight),
                               tb, torch.from_numpy(wi))
    _close(out, ref)
    (grad, ) = torch.autograd.grad((out**2).sum(), tb)
    _close(grad, rgrad)


def test_spline_basis_degree_error():
    with pytest.raises(ValueError, match='degree 4'):
        ops.spline_basis(torch.zeros((2, 1)), torch.tensor([3]),
                         torch.tensor([1]), 4)
