"""The port's sorted-COO family (``segment_*_coo``, ``segment_coo``,
``gather_coo``) against the JAX package, on the CPU.

Inputs come from ``np.random.default_rng``: each batch row of the index is
sorted and leaves some buckets empty. Tolerances: sum and mean in f32
rtol 1e-5, atol 1e-6 (the order of the additions only); min, max and
``gather_coo`` exactly, argindices included; gradients rtol 1e-5, atol
1e-6 (exactly for min and max, whose cotangents go to one winner each).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import ops

# The module, which the package's segment_coo function shadows.
tcoo = importlib.import_module('pyg_lib_tpu_torch.ops.segment_coo')

RTOL, ATOL = 1e-5, 1e-6
N = 6  # buckets
E = 9  # elements along the reduction axis

# (src shape, index shape): the reduction axis is index.dim() - 1.
LAYOUTS = {
    '1d': ((E, 4), (E, )),  # the CSR route
    '1d-3d-src': ((E, 2, 3), (E, )),  # the scatter route
    '1d-1d-src': ((E, ), (E, )),
    'batched': ((2, 3, E, 4), (2, 3, E)),
    'broadcast': ((2, E, 4), (1, E)),  # index broadcast over the batch
    'batched-no-feature': ((3, E), (3, E)),
}


def _fns(reduce):
    return ({'sum': jops.segment_sum_coo, 'mean': jops.segment_mean_coo,
             'min': jops.segment_min_coo, 'max': jops.segment_max_coo}[reduce],
            {'sum': ops.segment_sum_coo, 'mean': ops.segment_mean_coo,
             'min': ops.segment_min_coo, 'max': ops.segment_max_coo}[reduce])


def _case(layout, seed):
    rng = np.random.default_rng(seed)
    src_shape, idx_shape = LAYOUTS[layout]
    src = rng.normal(size=src_shape).astype(np.float32)
    # Buckets 0 and 3 stay empty; each row sorted.
    index = np.sort(rng.choice(np.array([1, 2, 4, 5]), idx_shape), axis=-1)
    return src, index


def _out_shape(src_shape, index):
    d = index.ndim - 1
    return src_shape[:d] + (N, ) + src_shape[d + 1:]


@pytest.mark.parametrize('reduce', ['sum', 'mean', 'min', 'max'])
@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('with_out', [False, True])
def test_segment_coo_and_grad_match_jax(reduce, layout, with_out):
    src, index = _case(layout, len(layout) + 5 * with_out)
    jfn, tfn = _fns(reduce)
    rng = np.random.default_rng(9)
    out = (rng.normal(size=_out_shape(src.shape, index)).astype(np.float32)
           if with_out else None)
    ref = jfn(jnp.asarray(src), jnp.asarray(index),
              None if out is None else jnp.asarray(out), N)
    src_t = torch.tensor(src, requires_grad=True)
    got = tfn(src_t, torch.tensor(index),
              None if out is None else torch.tensor(out), N)
    cot = rng.normal(size=_out_shape(src.shape, index)).astype(np.float32)
    minmax = reduce in ('min', 'max')
    if minmax:
        np.testing.assert_array_equal(got[0].detach().numpy(),
                                      np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        vals = got[0]
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
        vals = got
    assert vals.shape == _out_shape(src.shape, index)

    def jloss(s):
        r = jfn(s, jnp.asarray(index),
                None if out is None else jnp.asarray(out), N)
        return ((r[0] if minmax else r) * jnp.asarray(cot)).sum()

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(src)))
    (gt, ) = torch.autograd.grad((vals * torch.tensor(cot)).sum(), src_t)
    if minmax:
        np.testing.assert_array_equal(gt.numpy(), gj)
    else:
        np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('reduce', ['sum', 'mean', 'min', 'max'])
def test_inferred_dim_size(reduce):
    src, index = _case('1d', 3)
    jfn, tfn = _fns(reduce)
    ref = jfn(jnp.asarray(src), jnp.asarray(index))
    got = tfn(torch.tensor(src), torch.tensor(index))
    ref = ref[0] if reduce in ('min', 'max') else ref
    got = got[0] if reduce in ('min', 'max') else got
    assert got.shape == ref.shape == (int(index.max()) + 1, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_sum_and_mean_go_through_the_csr_ops(monkeypatch):
    src, index = _case('batched', 4)
    seen = []

    def spy(name, fn):
        def call(s, indptr, *args):
            seen.append((name, tuple(s.shape), indptr.tolist()))
            return fn(s, indptr, *args)
        return call

    monkeypatch.setattr(tcoo, 'segment_sum_csr',
                        spy('sum', tcoo.segment_sum_csr))
    monkeypatch.setattr(tcoo, 'segment_mean_csr',
                        spy('mean', tcoo.segment_mean_csr))
    ops.segment_sum_coo(torch.tensor(src), torch.tensor(index), dim_size=N)
    ops.segment_mean_coo(torch.tensor(src), torch.tensor(index), dim_size=N)
    flat = (index.reshape(6, E) + np.arange(6)[:, None] * N).reshape(-1)
    indptr = np.searchsorted(flat, np.arange(6 * N + 1)).tolist()
    assert seen == [('sum', (6 * E, 4), indptr), ('mean', (6 * E, 4), indptr)]


def test_mean_out_rule():
    # A non-empty bucket is overwritten with the mean; an empty one keeps
    # out (unlike CSR mean, whose out is dropped).
    src = torch.tensor([[1.0], [3.0], [5.0]])
    index = torch.tensor([0, 0, 2])
    out = torch.full((3, 1), 9.0)
    np.testing.assert_array_equal(
        ops.segment_mean_coo(src, index, out)[:, 0].numpy(), [2.0, 9.0, 5.0])


@pytest.mark.parametrize('layout', ['1d', 'batched', 'broadcast',
                                    'batched-no-feature'])
@pytest.mark.parametrize('with_out', [False, True])
def test_gather_coo_matches_jax(layout, with_out):
    src_shape, idx_shape = LAYOUTS[layout]
    d = len(idx_shape) - 1
    table_shape = src_shape[:d] + (N, ) + src_shape[d + 1:]
    rng = np.random.default_rng(len(layout))
    table = rng.normal(size=table_shape).astype(np.float32)
    index = np.sort(rng.integers(0, N, idx_shape), axis=-1)
    out = np.zeros(src_shape, np.float64) if with_out else None
    ref = jops.gather_coo(jnp.asarray(table), jnp.asarray(index),
                          None if out is None else jnp.asarray(out))
    got = ops.gather_coo(torch.tensor(table), torch.tensor(index),
                         None if out is None else torch.tensor(out))
    assert got.shape == ref.shape
    assert got.dtype == (torch.float64 if with_out else torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize('reduce', ['sum', 'add', 'mean', 'min', 'max'])
def test_dispatcher_matches_jax(reduce):
    src, index = _case('batched', 6)
    ref = jops.segment_coo(jnp.asarray(src), jnp.asarray(index), dim_size=N,
                           reduce=reduce)
    got = ops.segment_coo(torch.tensor(src), torch.tensor(index), dim_size=N,
                          reduce=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_errors():
    with pytest.raises(ValueError, match='Unknown reduce'):
        ops.segment_coo(torch.ones(3), torch.zeros(3, dtype=torch.long),
                        reduce='mul')
    with pytest.raises(ValueError, match='must be >= index.ndim'):
        ops.segment_sum_coo(torch.ones(3), torch.zeros((1, 3),
                                                       dtype=torch.long))
