"""The port's scatter family (``scatter_{sum,mul,mean,min,max}``,
``scatter``) and its index helpers against the JAX package, on the CPU.

Inputs come from ``np.random.default_rng`` and go through both packages
as numpy arrays. Indices hold negative ids (wrapped as Python indices) and,
where ``dim_size`` is given, ids at or past it (dropped). Tolerances:

* sum, mean and mul in f32: rtol 1e-5, atol 1e-6, for the order of the
  additions and products only; integer dtypes exactly;
* min and max: values and argindices exactly;
* gradients: rtol 1e-5, atol 1e-6; min and max send each cotangent to
  the argindex winner only, so on ties they must equal JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu import utils as jutils
from pyg_lib_tpu_torch import ops, utils

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (7, 6, 3)
DIM_SIZE = 5
REDUCES = ['sum', 'mul', 'mean', 'min', 'max']


def _data(seed, values, shape=SHAPE, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if values == 'ties':  # few distinct values, zeros among them
        return rng.integers(-2, 3, shape).astype(dtype)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-9, 10, shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def _index(seed, shape, dim, kind, lo=-2, hi=DIM_SIZE + 2):
    rng = np.random.default_rng(seed + 100)
    if kind == '1d':
        return rng.integers(lo, hi, shape[dim])
    return rng.integers(lo, hi, shape)


def _jax_fn(reduce):
    return {'sum': jops.scatter_sum, 'mul': jops.scatter_mul,
            'mean': jops.scatter_mean, 'min': jops.scatter_min,
            'max': jops.scatter_max}[reduce]


def _torch_fn(reduce):
    return {'sum': ops.scatter_sum, 'mul': ops.scatter_mul,
            'mean': ops.scatter_mean, 'min': ops.scatter_min,
            'max': ops.scatter_max}[reduce]


def _assert_values(reduce, got, ref):
    if reduce in ('min', 'max'):
        np.testing.assert_array_equal(got[0].detach().numpy(),
                                      np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    elif np.issubdtype(np.asarray(ref).dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('reduce', REDUCES)
@pytest.mark.parametrize('dim', [-1, 0, 1])
@pytest.mark.parametrize('kind', ['1d', 'elementwise'])
@pytest.mark.parametrize('values', ['normal', 'ties'])
@pytest.mark.parametrize('with_out', [False, True])
def test_scatter_and_grad_match_jax(reduce, dim, kind, values, with_out):
    seed = REDUCES.index(reduce) * 7 + dim + 3
    src = _data(seed, values)
    index = _index(seed, SHAPE, dim, kind)
    out_shape = list(SHAPE)
    out_shape[dim] = DIM_SIZE
    out = _data(seed + 1, 'normal', tuple(out_shape)) if with_out else None
    jfn, tfn = _jax_fn(reduce), _torch_fn(reduce)
    kwargs_j = dict(dim=dim, dim_size=DIM_SIZE,
                    out=None if out is None else jnp.asarray(out))
    kwargs_t = dict(dim=dim, dim_size=DIM_SIZE,
                    out=None if out is None else torch.tensor(out))
    ref = jfn(jnp.asarray(src), jnp.asarray(index), **kwargs_j)
    src_t = torch.tensor(src, requires_grad=True)
    got = tfn(src_t, torch.tensor(index), **kwargs_t)
    _assert_values(reduce, got, ref)

    cot = _data(seed + 2, 'normal', tuple(out_shape))

    def jloss(s):
        r = jfn(s, jnp.asarray(index), **kwargs_j)
        return ((r[0] if reduce in ('min', 'max') else r) *
                jnp.asarray(cot)).sum()

    gj = jax.grad(jloss)(jnp.asarray(src))
    vals = got[0] if reduce in ('min', 'max') else got
    (gt, ) = torch.autograd.grad((vals * torch.tensor(cot)).sum(), src_t)
    if reduce in ('min', 'max', 'sum'):  # one term per element
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    else:
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize('reduce', REDUCES)
@pytest.mark.parametrize('dtype', [np.int32, np.int64])
@pytest.mark.parametrize('kind', ['1d', 'elementwise'])
def test_integer_dtypes_match_jax(reduce, dtype, kind):
    src = _data(11, 'normal', (9, 4), dtype)
    index = _index(11, (9, 4), 0, kind)
    ref = _jax_fn(reduce)(jnp.asarray(src), jnp.asarray(index), 0,
                          dim_size=DIM_SIZE)
    got = _torch_fn(reduce)(torch.tensor(src), torch.tensor(index), 0,
                            dim_size=DIM_SIZE)
    _assert_values(reduce, got, ref)
    vals = got[0] if reduce in ('min', 'max') else got
    assert vals.dtype == torch.from_numpy(src).dtype


@pytest.mark.parametrize('reduce', REDUCES)
def test_inferred_dim_size_and_1d_src(reduce):
    src = _data(12, 'normal', (10, ))
    index = np.random.default_rng(13).integers(0, 4, 10)
    ref = _jax_fn(reduce)(jnp.asarray(src), jnp.asarray(index))
    got = _torch_fn(reduce)(torch.tensor(src), torch.tensor(index))
    _assert_values(reduce, got, ref)
    assert (got[0] if reduce in ('min', 'max') else got).shape == (4, )


def test_out_of_range_ids_are_dropped():
    src = torch.arange(1.0, 7.0)[:, None]
    index = torch.tensor([0, -1, 2, 5, -4, 1])  # -1 wraps to 2; 5, -4 drop
    np.testing.assert_array_equal(
        ops.scatter_sum(src, index, 0, dim_size=3)[:, 0].numpy(),
        [1.0, 6.0, 5.0])
    vals, arg = ops.scatter_max(src, index, 0, dim_size=3)
    np.testing.assert_array_equal(vals[:, 0].numpy(), [1.0, 6.0, 3.0])
    np.testing.assert_array_equal(arg[:, 0].numpy(), [0, 5, 2])
    np.testing.assert_array_equal(
        ops.scatter_mean(src, index, 0, dim_size=3)[:, 0].numpy(),
        [1.0, 6.0, 2.5])
    np.testing.assert_array_equal(
        ops.scatter_mul(src, index, 0, dim_size=3)[:, 0].numpy(),
        [1.0, 6.0, 6.0])


def test_minmax_gradient_goes_to_the_first_winner_only():
    # Every bucket ties: torch's own scatter_reduce('amax') backward would
    # split the cotangent among the tied elements.
    src = np.array([[1.0, 2.0], [1.0, 2.0], [0.0, 2.0], [3.0, 3.0],
                    [3.0, -1.0]], np.float32)
    index = np.array([0, 0, 0, 1, 1])
    for is_min in (False, True):
        jfn = jops.scatter_min if is_min else jops.scatter_max
        tfn = ops.scatter_min if is_min else ops.scatter_max
        gj = jax.grad(lambda s: jfn(s, jnp.asarray(index), 0)[0].sum())(
            jnp.asarray(src))
        st = torch.tensor(src, requires_grad=True)
        vals, arg = tfn(st, torch.tensor(index), 0)
        (gt, ) = torch.autograd.grad(vals.sum(), st)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        assert float(gt.sum()) == vals.numel()  # one winner each
        expect = [[0, 0], [3, 3]] if not is_min else [[2, 0], [3, 4]]
        np.testing.assert_array_equal(arg.numpy(), expect)


def test_min_out_wins_sentinel_and_grad():
    src = torch.tensor([5.0, 7.0], requires_grad=True)
    index = torch.tensor([0, 0])
    vals, arg = ops.scatter_min(src, index, 0, out=torch.tensor([1.0]))
    assert vals.tolist() == [1.0] and arg.tolist() == [2]  # the sentinel
    (g, ) = torch.autograd.grad(vals.sum(), src)
    np.testing.assert_array_equal(g.numpy(), [0.0, 0.0])
    vals, arg = ops.scatter_min(src, index, 0, out=torch.tensor([9.0]))
    assert vals.tolist() == [5.0] and arg.tolist() == [0]
    (g, ) = torch.autograd.grad(vals.sum(), src)
    np.testing.assert_array_equal(g.numpy(), [1.0, 0.0])


def test_mul_gradient_is_zero_at_a_zero_entry():
    src = np.array([[2.0], [0.0], [3.0], [4.0]], np.float32)
    index = np.array([0, 0, 0, 1])
    gj = jax.grad(lambda s: jops.scatter_mul(s, jnp.asarray(index), 0)
                  .sum())(jnp.asarray(src))
    st = torch.tensor(src, requires_grad=True)
    (gt, ) = torch.autograd.grad(
        ops.scatter_mul(st, torch.tensor(index), 0).sum(), st)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(gt[:, 0].numpy(), [0.0, 0.0, 0.0, 1.0])


def test_mean_integer_with_out_floor_divides():
    src = torch.tensor([-4, -7], dtype=torch.int32)
    idx = torch.tensor([0, 0])
    r = ops.scatter_mean(src, idx, 0, out=torch.tensor([-4],
                                                       dtype=torch.int32))
    assert r.dtype == torch.int32 and r.tolist() == [-8]
    assert ops.scatter_mean(src, idx, 0, dim_size=1).tolist() == [-6]


def test_mean_elementwise_counts_per_column():
    src = torch.ones((2, 2))
    index = torch.tensor([[0, 0], [0, 1]])
    np.testing.assert_allclose(
        ops.scatter_mean(src, index, 0, dim_size=2).numpy(),
        [[1.0, 1.0], [0.0, 1.0]])


@pytest.mark.parametrize('reduce', ['sum', 'add', 'mul', 'mean', 'min',
                                    'max'])
def test_dispatcher_matches_jax(reduce):
    src = _data(14, 'normal', (10, 4))
    index = np.random.default_rng(15).integers(0, 6, 10)
    ref = jops.scatter(jnp.asarray(src), jnp.asarray(index), 0, dim_size=6,
                       reduce=reduce)
    got = ops.scatter(torch.tensor(src), torch.tensor(index), 0, dim_size=6,
                      reduce=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_errors():
    with pytest.raises(ValueError, match='Unknown reduce'):
        ops.scatter(torch.ones(3), torch.zeros(3, dtype=torch.long),
                    reduce='prod')
    with pytest.raises(ValueError, match='out of range'):
        ops.scatter_sum(torch.ones(3), torch.zeros(3, dtype=torch.long),
                        dim=1)


def test_index_helpers_match_jax():
    for dim, ndim in ((-1, 3), (0, 2), (2, 3)):
        assert utils.canonicalize_dim(dim, ndim) == \
            jutils.canonicalize_dim(dim, ndim)
    idx = np.array([3, 0, 7])
    assert utils.infer_dim_size(torch.tensor(idx), None) == \
        jutils.infer_dim_size(jnp.asarray(idx), None) == 8
    assert utils.infer_dim_size(torch.zeros(0, dtype=torch.long), None) == 0
    assert utils.infer_dim_size(torch.tensor(idx), 5) == 5
    got = utils.broadcast_index(torch.tensor(idx), (2, 3, 4), 1)
    ref = jutils.broadcast_index(jnp.asarray(idx), (2, 3, 4), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
