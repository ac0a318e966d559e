"""The port's ``segment_matmul`` and ``grouped_matmul`` against the JAX
package's (``ragged_dot`` on the CPU), mirroring ``tests/test_matmul.py``'s
cases, one parametrised test per behaviour.

Inputs come from ``np.random.default_rng`` as f32 arrays and go through
both packages. Tolerance: rtol 1e-5 / atol 1e-5, for the summation order
of f32 products at most 32 deep; padding rows are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import ops

RTOL, ATOL = 1e-5, 1e-5

# (rows, K, M, ptr): test_matmul.py's shapes, an empty segment, trailing
# padding rows, a leading empty segment, and every segment empty.
CASES = {
    'two segments': (8, 16, 32, [0, 5, 8]),
    'empty segment': (6, 4, 5, [0, 2, 2, 6]),
    'padding rows': (10, 8, 4, [0, 4, 8]),
    'empty and padding': (10, 4, 4, [0, 4, 4, 8]),
    'leading empty': (7, 3, 4, [0, 0, 4, 7]),
    'all empty': (3, 4, 2, [0, 0, 0]),
}


def _inputs(case, seed, bias=False):
    n, k, m, ptr = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k)).astype(np.float32)
    w = rng.normal(size=(len(ptr) - 1, k, m)).astype(np.float32)
    b = rng.normal(size=(len(ptr) - 1, m)).astype(np.float32)
    return x, np.asarray(ptr, np.int64), w, (b if bias else None)


def _jax(x, ptr, w, b):
    return np.asarray(jops.segment_matmul(
        jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(w),
        None if b is None else jnp.asarray(b)))


@pytest.mark.parametrize('ptr_as', ['numpy', 'tensor', 'list'])
@pytest.mark.parametrize('case', list(CASES))
def test_segment_matmul_matches_jax(case, ptr_as):
    x, ptr, w, _ = _inputs(case, 0)
    p = {'numpy': ptr, 'tensor': torch.from_numpy(ptr),
         'list': ptr.tolist()}[ptr_as]
    got = ops.segment_matmul(torch.from_numpy(x), p, torch.from_numpy(w))
    ref = _jax(x, ptr, w, None)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[ptr[-1]:], 0.0)


@pytest.mark.parametrize('case', list(CASES))
def test_segment_matmul_bias_matches_jax(case):
    # Trailing padding rows get no bias: they stay zero.
    x, ptr, w, b = _inputs(case, 1, bias=True)
    got = ops.segment_matmul(torch.from_numpy(x), ptr, torch.from_numpy(w),
                             torch.from_numpy(b))
    ref = _jax(x, ptr, w, b)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[ptr[-1]:], 0.0)


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('case', list(CASES))
def test_segment_matmul_grads_match_jax(case, bias):
    # grad_inputs = g @ otherᵀ per segment (0 on padding rows),
    # grad_other[s] = inputs[s]ᵀ @ g[s] (0 for an empty segment), and the
    # bias gradient the segment's column sums.
    x, ptr, w, b = _inputs(case, 2, bias=bias)
    cot = np.random.default_rng(3).normal(
        size=(x.shape[0], w.shape[2])).astype(np.float32)

    def loss_j(xj, wj, bj):
        return (jops.segment_matmul(xj, jnp.asarray(ptr), wj, bj) *
                cot).sum()

    args = [jnp.asarray(x), jnp.asarray(w)] + (
        [jnp.asarray(b)] if bias else [None])
    refs = jax.grad(loss_j, argnums=(0, 1, 2) if bias else (0, 1))(*args)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in ([x, w, b] if bias else [x, w])]
    out = ops.segment_matmul(leaves[0], ptr, leaves[1],
                             leaves[2] if bias else None)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(grads[0].numpy()[ptr[-1]:], 0.0)
    for s in np.nonzero(np.diff(ptr) == 0)[0]:
        np.testing.assert_array_equal(grads[1].numpy()[s], 0.0)


# (input shapes, other shapes): test_matmul.py's same-shape and mixed
# groups (the same-shape route goes through one segment_matmul), a group
# of 0 rows, and one group.
GROUPS = {
    'same shapes': ([(5, 16), (3, 16)], [(16, 32), (16, 32)]),
    'mixed shapes': ([(5, 16), (3, 32)], [(16, 32), (32, 64)]),
    'empty group': ([(4, 6), (0, 6), (7, 6)], [(6, 5)] * 3),
    'one group': ([(4, 6)], [(6, 5)]),
}


@pytest.mark.parametrize('biases', [False, True])
@pytest.mark.parametrize('groups', list(GROUPS))
def test_grouped_matmul_matches_jax(groups, biases):
    rng = np.random.default_rng(4)
    xs_s, ws_s = GROUPS[groups]
    xs = [rng.normal(size=s).astype(np.float32) for s in xs_s]
    ws = [rng.normal(size=s).astype(np.float32) for s in ws_s]
    bs = ([rng.normal(size=(s[1], )).astype(np.float32) for s in ws_s]
          if biases else None)
    refs = jops.grouped_matmul([jnp.asarray(a) for a in xs],
                               [jnp.asarray(a) for a in ws],
                               None if bs is None else
                               [jnp.asarray(a) for a in bs])
    leaves = [torch.from_numpy(a).requires_grad_() for a in xs + ws]
    outs = ops.grouped_matmul(leaves[:len(xs)], leaves[len(xs):],
                              None if bs is None else
                              [torch.from_numpy(a) for a in bs])
    assert len(outs) == len(refs)
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
    # Gradients against the plain per-group products.
    grads = torch.autograd.grad(sum(o.sum() for o in outs), leaves)
    for x, w, gx, gw in zip(xs, ws, grads[:len(xs)], grads[len(xs):]):
        ones = np.ones((x.shape[0], w.shape[1]), np.float32)
        np.testing.assert_allclose(gx.numpy(), ones @ w.T, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(gw.numpy(), x.T @ ones, rtol=RTOL,
                                   atol=ATOL)


def test_matmul_refuses_bad_shapes():
    x = torch.zeros((6, 4))
    with pytest.raises(ValueError, match='other must be'):
        ops.segment_matmul(x, [0, 3, 6], torch.zeros((3, 4, 2)))
    with pytest.raises(ValueError, match='covers 7 rows'):
        ops.segment_matmul(x, [0, 3, 7], torch.zeros((2, 4, 2)))
    with pytest.raises(ValueError, match='non-decreasing'):
        ops.segment_matmul(x, [0, 4, 3], torch.zeros((2, 4, 2)))
    with pytest.raises(ValueError, match='equal length'):
        ops.grouped_matmul([x], [])
