"""The port's scatter composites (``scatter_softmax``,
``scatter_log_softmax``, ``scatter_std``, ``scatter_logsumexp``) against
the JAX package, on the CPU.

Inputs come from ``np.random.default_rng``; the special cases hold empty
buckets, ``-inf`` entries, buckets of ``-inf`` only and ``NaN``.
Tolerances: f32 rtol 1e-5, atol 1e-6 for values and gradients (the order
of the additions, and ``exp``/``log`` a few ulps apart), with NaN exactly
where JAX has NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import ops

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (8, 5, 3)
DIM_SIZE = 6  # buckets 4 and 5 get nothing

NAMES = ['scatter_softmax', 'scatter_log_softmax', 'scatter_std',
         'scatter_logsumexp']


def _call(pkg, name, src, index, dim, out=None, dim_size=DIM_SIZE):
    fn = getattr(pkg, name)
    if name in ('scatter_softmax', 'scatter_log_softmax'):
        return fn(src, index, dim, dim_size=dim_size)
    return fn(src, index, dim, out=out, dim_size=dim_size)


def _index(seed, dim, kind):
    rng = np.random.default_rng(seed)
    if kind == '1d':
        return rng.integers(0, 4, SHAPE[dim])
    return rng.integers(0, 4, SHAPE)


def _compare(name, src, index, dim, out=None, seed=0):
    """Values and the gradient of ``Σ result * cot`` against JAX."""
    ref = _call(jops, name, jnp.asarray(src), jnp.asarray(index), dim,
                None if out is None else jnp.asarray(out))
    src_t = torch.tensor(src, requires_grad=True)
    got = _call(ops, name, src_t, torch.tensor(index), dim,
                None if out is None else torch.tensor(out))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    cot = np.random.default_rng(seed).normal(size=ref.shape).astype(
        np.float32)
    gj = jax.grad(lambda s: (_call(
        jops, name, s, jnp.asarray(index), dim,
        None if out is None else jnp.asarray(out)) *
        jnp.asarray(cot)).sum())(jnp.asarray(src))
    (gt, ) = torch.autograd.grad((got * torch.tensor(cot)).sum(), src_t)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('dim', [-1, 0, 1])
@pytest.mark.parametrize('kind', ['1d', 'elementwise'])
def test_composites_and_grads_match_jax(name, dim, kind):
    seed = NAMES.index(name) * 10 + dim + 1
    src = np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)
    _compare(name, src, _index(seed + 50, dim, kind), dim, seed=seed)


@pytest.mark.parametrize('name', ['scatter_std', 'scatter_logsumexp'])
def test_out_matches_jax(name):
    rng = np.random.default_rng(3)
    src = rng.normal(size=(10, 4)).astype(np.float32)
    out = rng.normal(size=(DIM_SIZE, 4)).astype(np.float32)
    _compare(name, src, rng.integers(0, 4, 10), 0, out, seed=4)


def test_std_biased_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.normal(size=(12, 3)).astype(np.float32)
    index = rng.integers(0, 5, 12)
    ref = jops.scatter_std(jnp.asarray(src), jnp.asarray(index), 0,
                           dim_size=7, unbiased=False)
    got = ops.scatter_std(torch.tensor(src), torch.tensor(index), 0,
                          dim_size=7, unbiased=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('name', NAMES)
def test_minus_inf_and_empty_buckets_match_jax(name):
    # Bucket 0 holds -inf beside finite values, bucket 1 only -inf,
    # bucket 2 a single element, bucket 3 a NaN; buckets 4 and 5 are empty.
    src = np.array([[-np.inf, 1.0], [0.5, -np.inf], [2.0, 3.0],
                    [-np.inf, -np.inf], [-np.inf, -np.inf], [4.0, -1.0],
                    [np.nan, 1.0], [0.0, 2.0]], np.float32)
    index = np.array([0, 0, 0, 1, 1, 2, 3, 3])
    ref = np.asarray(_call(jops, name, jnp.asarray(src), jnp.asarray(index),
                           0))
    src_t = torch.tensor(src, requires_grad=True)
    got_t = _call(ops, name, src_t, torch.tensor(index), 0)
    got = got_t.detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # The gradients, NaN where JAX's are, through the finite outputs.
    keep = np.isfinite(ref)
    gj = np.asarray(jax.grad(lambda s: jnp.where(
        jnp.asarray(keep), _call(jops, name, s, jnp.asarray(index), 0),
        0.0).sum())(jnp.asarray(src)))
    (gt, ) = torch.autograd.grad(
        torch.where(torch.tensor(keep), got_t, 0.0).sum(), src_t)
    np.testing.assert_array_equal(np.isnan(gt.numpy()), np.isnan(gj))
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=ATOL)
    if name == 'scatter_logsumexp':  # non-finite results map to 0
        assert np.isfinite(got).all()
        out = np.full((DIM_SIZE, 2), 7.0, np.float32)
        ref = jops.scatter_logsumexp(jnp.asarray(src), jnp.asarray(index), 0,
                                     out=jnp.asarray(out))
        got = ops.scatter_logsumexp(torch.tensor(src), torch.tensor(index), 0,
                                    out=torch.tensor(out))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
        assert (got.numpy()[4:] == 7.0).all()


@pytest.mark.parametrize('name', NAMES)
def test_integer_src_is_refused(name):
    with pytest.raises(ValueError, match='floating-point'):
        _call(ops, name, torch.ones(4, dtype=torch.long),
              torch.zeros(4, dtype=torch.long), 0)
