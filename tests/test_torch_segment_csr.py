"""The port's CSR segment family, K3's and K4's plain versions and the plan
cache against the JAX package, on the CPU.

Inputs come from ``np.random.default_rng`` and go through both packages.
Tolerances:

* min/max values bit for bit and argindices equal;
* sums, means and every gradient: f32 rtol 1e-5 / atol 1e-4, for the
  summation order only; integer dtypes exactly;
* the plain K3 against the Pallas K3 run in the interpreter: 2e-3, the
  JAX package's own tolerance for that kernel, which sums through bf16
  hi/lo products;
* the plain K4 against the Pallas K4 in the interpreter: bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu import utils as jutils
from pyg_lib_tpu.ops.pallas import plan_cache as jcache
from pyg_lib_tpu.ops.pallas import segment_csr_kernel as jk3
from pyg_lib_tpu.ops.pallas import segment_minmax_kernel as jk4
from pyg_lib_tpu.ops.pallas import spmm_chunked as jchunked
from pyg_lib_tpu_torch import ops, utils
from pyg_lib_tpu_torch.ops.kernels import plan_cache
from test_torch_spmm import ATOL, KERNEL_TOL, RTOL, np_of

# The module, not the function of the same name that ops exports.
tseg = importlib.import_module('pyg_lib_tpu_torch.ops.segment_csr')

REDUCES = ['sum', 'add', 'mean', 'min', 'max']


def _indptr(seed, n, maxdeg, gap=0):
    deg = np.random.default_rng(seed).integers(0, maxdeg, n)
    deg[::5] = 0  # empty rows
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    return ptr + gap


def _src(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


# (indptr, number of src positions): plain, a leading gap of 3, and 11
# trailing pad positions past indptr[-1].
LAYOUTS = {
    'plain': lambda: (_indptr(0, 200, 9), 0),
    'gap': lambda: (_indptr(1, 200, 9, gap=3), 0),
    'pad': lambda: (_indptr(2, 200, 9), 11),
}


def _case(layout, feat=(47, ), dtype=np.float32, seed=3):
    ptr, extra = LAYOUTS[layout]()
    return _src(seed, (int(ptr[-1]) + extra, ) + feat, dtype), ptr


def _check_pair(got, ref, exact):
    ref = np.asarray(ref)
    got = np_of(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _same_result(name, src, ptr, reduce=None, **kw):
    fn_j, fn_t = getattr(jops, name), getattr(ops, name)
    args_j = (jnp.asarray(src), ptr)
    args_t = (torch.from_numpy(src), torch.from_numpy(ptr))
    if reduce is not None:
        kw = dict(kw, reduce=reduce)
    kw_j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    kw_t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    ref, got = fn_j(*args_j, **kw_j), fn_t(*args_t, **kw_t)
    exact = (name in ('segment_min_csr', 'segment_max_csr', 'gather_csr')
             or reduce in ('min', 'max')
             or not np.issubdtype(src.dtype, np.floating))
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _check_pair(g, r, exact)
    else:
        _check_pair(got, ref, exact)


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('name', ['segment_sum_csr', 'segment_add_csr',
                                  'segment_mean_csr', 'segment_min_csr',
                                  'segment_max_csr'])
@pytest.mark.parametrize('dtype', [np.float32, np.int32])
def test_segment_ops_match_jax(layout, name, dtype):
    src, ptr = _case(layout, dtype=dtype)
    _same_result(name, src, ptr)


@pytest.mark.parametrize('feat', [(), (128, ), (3, 5)])
@pytest.mark.parametrize('reduce', REDUCES)
def test_segment_csr_ranks_match_jax(feat, reduce):
    src, ptr = _case('pad', feat=feat, seed=4)
    _same_result('segment_csr', src, ptr, reduce=reduce)


def test_segment_csr_rejects_unknown_reduce():
    src, ptr = _case('plain')
    with pytest.raises(ValueError, match='Unknown reduce'):
        ops.segment_csr(torch.from_numpy(src), ptr, reduce='prod')
    with pytest.raises(ValueError, match='non-decreasing'):
        ops.segment_sum_csr(torch.from_numpy(src), ptr[::-1].copy())


BATCHED = {
    # [2, R+1] over [2, E, F], each slice with its own gap and pad.
    'two': (np.array([[0, 3, 3, 7, 12], [1, 2, 6, 6, 9]], np.int64),
            (2, 14, 6)),
    # [1, R+1] broadcast over three slices.
    'broadcast': (np.array([[0, 4, 4, 9]], np.int64), (3, 10, 4)),
    # three leading dims.
    'lead3': (np.broadcast_to(np.array([0, 2, 5, 5, 8], np.int64),
                              (2, 2, 5)).copy(), (2, 2, 8, 3)),
}


@pytest.mark.parametrize('case', list(BATCHED))
@pytest.mark.parametrize('reduce', REDUCES)
@pytest.mark.parametrize('dtype', [np.float32, np.int64])
def test_batched_indptr_matches_jax(case, reduce, dtype):
    ptr, shape = BATCHED[case]
    src = _src(5, shape, dtype)
    _same_result('segment_csr', src, ptr, reduce=reduce)
    if reduce in ('min', 'max'):
        _same_result(f'segment_{reduce}_csr', src, ptr)


@pytest.mark.parametrize('case', ['plain', 'gap', 'pad'])
@pytest.mark.parametrize('name', ['segment_sum_csr', 'segment_mean_csr',
                                  'segment_min_csr', 'segment_max_csr'])
def test_out_contracts_match_jax(case, name):
    src, ptr = _case(case, feat=(6, ), seed=6)
    base = _src(7, (ptr.shape[0] - 1, 6))
    _same_result(name, src, ptr, out=base)


@pytest.mark.parametrize('name', ['segment_sum_csr', 'segment_min_csr',
                                  'segment_max_csr'])
def test_batched_out_contracts_match_jax(name):
    ptr = np.array([[0, 2, 2, 5], [0, 4, 5, 5]], np.int64)
    src = _src(8, (2, 6, 3))
    base = _src(9, (2, 3, 3))
    _same_result(name, src, ptr, out=base)


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('with_out', [False, True])
def test_gather_csr_matches_jax(layout, with_out):
    ptr, extra = LAYOUTS[layout]()
    src = _src(10, (ptr.shape[0] - 1, 5))
    kw = {}
    if with_out:
        kw['out'] = _src(11, (int(ptr[-1]) + extra, 5))
    elif extra:
        kw['out_size'] = int(ptr[-1]) + extra
    _same_result('gather_csr', src, ptr, **kw)


@pytest.mark.parametrize('with_out', [False, True])
def test_gather_csr_batched_matches_jax(with_out):
    ptr = np.array([[0, 3, 6], [0, 2, 4]], np.int64)  # unequal totals
    src = _src(12, (2, 2, 4))
    kw = {'out': _src(13, (2, 6, 4))} if with_out else {}
    _same_result('gather_csr', src, ptr, **kw)


def _grads(name, src, ptr, cot, **kw):
    """(JAX gradient, port gradient) of ``Σ cot * name(src, ptr)``."""
    def first(r):
        return r[0] if isinstance(r, tuple) else r

    gref = jax.grad(lambda s: (first(getattr(jops, name)(s, ptr, **kw)) *
                               cot).sum())(jnp.asarray(src))
    xt = torch.from_numpy(src).requires_grad_()
    out = first(getattr(ops, name)(xt, torch.from_numpy(ptr), **kw))
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    return np.asarray(gref), grad.numpy()


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('name', ['segment_sum_csr', 'segment_mean_csr',
                                  'segment_min_csr', 'segment_max_csr'])
def test_gradients_match_jax(layout, name):
    src, ptr = _case(layout, feat=(7, ), seed=14)
    cot = _src(15, (ptr.shape[0] - 1, 7))
    gref, grad = _grads(name, src, ptr, cot)
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('name', ['segment_sum_csr', 'segment_mean_csr',
                                  'segment_min_csr', 'segment_max_csr'])
def test_batched_gradients_match_jax(name):
    ptr = np.array([[0, 3, 3, 7], [1, 2, 6, 7]], np.int64)
    src = _src(16, (2, 8, 3))
    cot = _src(17, (2, 3, 3))
    gref, grad = _grads(name, src, ptr, cot)
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


def test_gather_csr_gradient_matches_jax():
    ptr, _ = LAYOUTS['gap']()
    src = _src(18, (ptr.shape[0] - 1, 4))
    cot = _src(19, (int(ptr[-1]), 4))
    gref, grad = _grads('gather_csr', src, ptr, cot)
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


# -- the planned K4 path ------------------------------------------------------


def _big_case(seed):
    """Past the planned path's 65,536 edges, with empty rows."""
    ptr = _indptr(seed, 12000, 18)
    return _src(seed + 1, (int(ptr[-1]), 4)), ptr


@pytest.mark.parametrize('is_min', [False, True])
def test_planned_minmax_called_directly_matches_jax(is_min):
    src, ptr = _case('gap', feat=(9, ), seed=20)
    ptr = ptr - ptr[0]  # the planned path covers every position
    src = src[:int(ptr[-1])]
    name = 'segment_min_csr' if is_min else 'segment_max_csr'
    ref = getattr(jops, name)(jnp.asarray(src), ptr)
    xt = torch.from_numpy(src).requires_grad_()
    ptr_t = torch.from_numpy(ptr)
    vals, arg = tseg._planned_minmax(xt, ptr, ptr_t, is_min)
    _check_pair(vals.detach(), ref[0], exact=True)
    _check_pair(arg, ref[1], exact=True)
    cot = _src(21, vals.shape)
    gref, _ = _grads(name, src, ptr, cot)
    (grad, ) = torch.autograd.grad((vals * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_allclose(grad.numpy(), gref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('name', ['segment_min_csr', 'segment_max_csr'])
def test_planned_path_is_taken_and_matches_jax(name, monkeypatch):
    src, ptr = _big_case(22)
    assert src.shape[0] >= tseg._MINMAX_PLANNED_MIN_EDGES
    calls = []
    real = tseg._planned_minmax
    monkeypatch.setattr(tseg, '_planned_minmax',
                        lambda *a: calls.append(1) or real(*a))
    _same_result(name, src, ptr)
    assert calls == [1]
    # Trailing pad positions keep the plain path.
    padded = np.concatenate([src, src[:3]])
    _same_result(name, padded, ptr)
    assert calls == [1]


def test_plan_cache_keys():
    ptr, _ = LAYOUTS['plain']()
    plan = plan_cache.plan_for_ptr(ptr, device='cpu')
    assert plan_cache.plan_for_ptr(ptr, device='cpu') is plan
    ptr_np = np.asarray(ptr)
    assert plan_cache.plan_key(ptr, ptr_np) == jcache.plan_key(ptr, ptr_np)
    t = torch.from_numpy(ptr.copy())
    assert plan_cache.plan_key(t, ptr_np) == jcache.plan_key(
        jnp.asarray(ptr), ptr_np)
    # A tensor of the same contents hits; a buffer changed in place is
    # rebuilt.
    assert plan_cache.plan_for_ptr(t, device='cpu') is plan_cache.plan_for_ptr(
        t.clone(), device='cpu')
    ptr[-1] += 1
    assert plan_cache.plan_for_ptr(ptr, device='cpu') is not plan
    ref = jcache.plan_for_ptr(ptr)
    got = plan_cache.plan_for_ptr(ptr, device='cpu')
    for name in ('col_padded', 'tile_ptr', 'edge_perm', 'edge_pos',
                 'row_padded', 'valid_mask'):
        np.testing.assert_array_equal(np_of(getattr(got, name)),
                                      np.asarray(getattr(ref, name)))


# -- kernels: plain versions against the Pallas kernels -----------------------


@pytest.mark.parametrize('layout', ['plain', 'gap', 'pad'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plain_k3_matches_pallas_kernel(layout, dtype):
    src, ptr = _case(layout, feat=(128, ), seed=23)
    x = torch.from_numpy(src).to(dtype)
    ref = jk3.segment_sum_csr_pallas(
        jnp.asarray(np_of(x), dtype=jnp.bfloat16 if dtype == torch.bfloat16
                    else jnp.float32), jnp.asarray(ptr), True)
    got = ops.segment_sum_csr_kernel(x, torch.from_numpy(ptr))
    assert got.dtype == dtype
    np.testing.assert_allclose(np_of(got), np.asarray(ref, np.float32),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)


def _neg_inf_case():
    """The JAX package's case: row 0 fills chunk 0; row 1's edges live in
    chunk 1 only and are -inf and below the old -3e38 floor."""
    ptr = np.array([0, 128, 132], np.int64)
    x = np.zeros((256, 128), np.float32)
    x[:128] = 1.0
    x[128:132] = -np.inf
    x[129, :] = -3.3e38
    return ptr, x


@pytest.mark.parametrize('values', ['normal', 'ties', 'neg_inf'])
def test_plain_k4_matches_pallas_kernel(values):
    ptr, x = _neg_inf_case() if values == 'neg_inf' else (
        _indptr(24, 300, 12), None)
    zeros = np.zeros(int(ptr[-1]), np.int64)
    plan_j = jchunked.build_spmm_plan(ptr, zeros, chunk=128)
    plan_t = ops.build_spmm_plan(ptr, zeros, chunk=128, device='cpu')
    e_pad = plan_t.col_padded.shape[0]
    if values == 'normal':
        x = _src(26, (e_pad, 128))
    elif values == 'ties':
        rng = np.random.default_rng(27)
        x = rng.choice(np.float32([-2.0, -0.0, 0.0, 1.0, -np.inf]),
                       size=(e_pad, 128))
    ref = jk4.segment_max_planned_exact(jnp.asarray(x), plan_j,
                                        interpret=True)
    got = ops.segment_max_kernel(torch.from_numpy(x), plan_t)
    # Bits, so that -0.0 and +0.0 are told apart.
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  np.asarray(ref[0]).view(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize('mode', ['col_padded', 'edge_perm'])
def test_plain_k4_gather_modes_match_the_padded_slab(mode):
    # K4 reading src through an index equals K4 on the gathered slab.
    rowptr = _indptr(28, 300, 12)
    col = np.random.default_rng(29).integers(0, 300, int(rowptr[-1]))
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device='cpu')
    idx = getattr(plan, mode)
    src = torch.from_numpy(_src(30, (300 if mode == 'col_padded'
                                     else col.shape[0], 16)))
    for negate in (False, True):
        got = ops.segment_max_kernel(src, plan, idx, negate)
        ref = ops.segment_max_kernel(src[idx.long()], plan, None, negate)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_helpers_match_jax():
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.int32, jnp.int32),
                          (torch.int64, jnp.int64)):
        assert utils.min_identity(dtype).item() == jutils.min_identity(
            jdtype).item()
        assert utils.max_identity(dtype).item() == jutils.max_identity(
            jdtype).item()
    for ptr, n in ((np.array([2, 2, 5, 9], np.int64), 12),
                   (np.array([0, 0, 0], np.int64), 4),
                   (np.array([0, 3, 3, 7], np.int64), 7)):
        ref = jutils.indptr_to_index(jnp.asarray(ptr), n)
        got = utils.indptr_to_index(torch.from_numpy(ptr), n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
