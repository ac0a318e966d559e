"""The port's sampled binary ops and ``index_sort`` against the JAX
package's on the CPU.

Inputs come from ``np.random.default_rng``. The sampled ops gather and
combine elementwise, so values are equal bit for bit; their gradients (the
gathers' transposes, added in another order) within f32 rtol 1e-6.
``index_sort`` returns the same values and permutation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import ops

NAMES = ['sampled_add', 'sampled_sub', 'sampled_mul', 'sampled_div']


def _inputs(seed):
    rng = np.random.default_rng(seed)
    left = rng.normal(size=(30, 4)).astype(np.float32)
    right = (rng.normal(size=(25, 4)) + 2.0).astype(np.float32)
    return (left, right, rng.integers(0, 30, size=40),
            rng.integers(0, 25, size=40))


@pytest.mark.parametrize('name', NAMES)
def test_sampled_ops_match_jax(name):
    left, right, li, ri = _inputs(3)
    jop, op = getattr(jops, name), getattr(ops, name)
    ref = jop(jnp.asarray(left), jnp.asarray(right), jnp.asarray(li),
              jnp.asarray(ri))
    got = op(torch.from_numpy(left), torch.from_numpy(right),
             torch.from_numpy(li), torch.from_numpy(ri))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # No index: elementwise over equal lengths; one index: the other side
    # broadcast as it is.
    np.testing.assert_array_equal(
        op(torch.from_numpy(left[:25]), torch.from_numpy(right)).numpy(),
        np.asarray(jop(jnp.asarray(left[:25]), jnp.asarray(right))))
    np.testing.assert_array_equal(
        op(torch.from_numpy(left), torch.from_numpy(right[:1]),
           torch.from_numpy(li)).numpy(),
        np.asarray(jop(jnp.asarray(left), jnp.asarray(right[:1]),
                       jnp.asarray(li))))


@pytest.mark.parametrize('name', NAMES)
def test_sampled_op_grads_match_jax(name):
    left, right, li, ri = _inputs(4)
    cot = np.random.default_rng(5).normal(size=(40, 4)).astype(np.float32)
    jop, op = getattr(jops, name), getattr(ops, name)
    rgrads = jax.grad(lambda a, b: jnp.sum(jop(a, b, jnp.asarray(li),
                                               jnp.asarray(ri)) * cot),
                      argnums=(0, 1))(jnp.asarray(left), jnp.asarray(right))
    tl, tr = (torch.from_numpy(a).requires_grad_() for a in (left, right))
    out = op(tl, tr, torch.from_numpy(li), torch.from_numpy(ri))
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                (tl, tr))
    for g, r in zip(grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_index_sort_matches_jax():
    rng = np.random.default_rng(4)
    for x in (rng.integers(0, 1000, size=500), np.array([5, 3, 5, 3, 5]),
              np.zeros(0, np.int64), rng.integers(0, 4, size=300)):
        rv, rp = jops.index_sort(jnp.asarray(x), max_value=1000)
        values, perm = ops.index_sort(torch.from_numpy(x), max_value=1000)
        assert perm.dtype == torch.int64
        np.testing.assert_array_equal(values.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(rp))


def test_index_sort_rejects_2d():
    with pytest.raises(ValueError, match='1-D'):
        ops.index_sort(torch.zeros((2, 3), dtype=torch.int64))
