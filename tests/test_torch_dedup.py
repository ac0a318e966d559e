"""The port's dedup plan and the plain versions of K2/K2h against the JAX
package, on the CPU.

Tolerances: plans bit for bit; the plain K2/K2h against the Pallas kernels
run in the interpreter at 2e-3, the JAX package's own tolerance for its
kernel tests (the interpreter runs the kernels' bf16 hi/lo arithmetic);
``spmm`` through a hot plan against the JAX package's CPU path at f32
rtol 1e-5 / atol 1e-4 (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.ops.pallas import spmm_dedup as jdedup
from pyg_lib_tpu_torch import ops
from test_torch_spmm import (ATOL, KERNEL_TOL, RTOL, _csr, features, np_of,
                             powerlaw_graph, uniform_graph)


def _weights(seed, e):
    return np.random.default_rng(seed).normal(size=e).astype(np.float32)


def _bf16_hot_graph():
    # Row 0 takes 200 copies of edge (0, 5): a hot count in (127, 256]
    # stores hot_w as bf16.
    rowptr, col = powerlaw_graph(13, 2100, 12000)
    row = np.repeat(np.arange(2100), np.diff(rowptr))
    return _csr(np.concatenate([row, np.zeros(200, np.int64)]),
                np.concatenate([col, np.full(200, 5)]), 2100)


# (graph builder, build_dedup_plan kwargs)
PLANS = {
    'uniform': (lambda: uniform_graph(0, 300, 4000), dict(ec=256)),
    'powerlaw': (lambda: powerlaw_graph(1, 300, 4000), dict(ec=256)),
    'powerlaw_uc64': (lambda: powerlaw_graph(1, 300, 4000),
                      dict(ec=128, uc=64)),
    'weighted': (lambda: powerlaw_graph(2, 260, 3000),
                 dict(ec=128, uc=64, weights=True)),
    'hot8': (lambda: powerlaw_graph(3, 300, 4000), dict(ec=256, hot=8)),
    'hot8_weighted': (lambda: powerlaw_graph(3, 300, 4000),
                      dict(ec=256, hot=8, weights=True)),
    'hot_auto': (lambda: powerlaw_graph(4, 2100, 12000), dict(ec=512)),
    'hot_bf16': (_bf16_hot_graph, dict(ec=512)),
}


def _plans(name):
    make, kw = PLANS[name]
    kw = dict(kw)
    rowptr, col = make()
    if kw.pop('weights', False):
        kw['edge_weight'] = _weights(5, col.shape[0])
    return (rowptr, col, jdedup.build_dedup_plan(rowptr, col, **kw),
            ops.build_dedup_plan(rowptr, col, device='cpu', **kw))


@pytest.mark.parametrize('name', list(PLANS))
def test_plan_bit_exact(name):
    rowptr, col, ref, got = _plans(name)
    for field in ('uniq_cols', 'edge_meta', 'chunk_tile', 'hot_cols'):
        a, b = getattr(ref, field), getattr(got, field)
        if a is None:
            assert b is None, field
            continue
        a, b = np.asarray(a), np_of(b)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    if ref.hot_w is None:
        assert got.hot_w is None
    else:
        assert str(ref.hot_w.dtype) == str(got.hot_w.dtype).replace(
            'torch.', '')
        np.testing.assert_array_equal(
            np.asarray(ref.hot_w.astype(jnp.float32)), np_of(got.hot_w))
    for field in ('num_rows', 'num_edges', 'ec', 'uc', 'weighted',
                  'num_hot', 'num_chunks'):
        assert getattr(ref, field) == getattr(got, field), field
    for ec in (128, 512):
        assert ops.estimate_dedup(rowptr, col, ec=ec) == \
            jdedup.estimate_dedup(rowptr, col, ec=ec)


def test_hot_levels_present():
    # The plans above reach every hot_w storage type.
    dtypes = {name: _plans(name)[3].hot_w for name in
              ('hot8', 'hot8_weighted', 'hot_auto', 'hot_bf16')}
    assert dtypes['hot8'].dtype == torch.int8
    assert dtypes['hot8_weighted'].dtype == torch.float32
    assert dtypes['hot_auto'].dtype == torch.int8
    assert dtypes['hot_bf16'].dtype == torch.bfloat16


@pytest.mark.parametrize('name', ['powerlaw_uc64', 'weighted', 'hot8',
                                  'hot8_weighted'])
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_plain_k2_matches_pallas_kernel(name, precision):
    rowptr, col, plan_j, plan_t = _plans(name)
    n = rowptr.shape[0] - 1
    x = features(6, n, 128)
    ref = jdedup.dedup_plan_apply(jnp.asarray(x), plan_j, interpret=True,
                                  precision=precision)
    got = ops.dedup_plan_apply(torch.from_numpy(x), plan_t,
                               precision=precision)
    if plan_t.weighted and precision is not None:
        # In bf16 and int8 mode the Pallas kernels round the per-(row,
        # column) weight sums to bf16 before the MXU product
        # (``_wmat_dot``); the port, like the JAX package's XLA path,
        # keeps them in f32. Allow that rounding: 2^-8 of Σ|w·x|.
        meta = plan_t.edge_meta.clone()
        meta[:, 2, :] = meta[:, 2, :].view(torch.float32).abs().view(
            torch.int32)
        abs_plan = plan_t._replace(
            edge_meta=meta,
            hot_w=None if plan_t.hot_w is None else plan_t.hot_w.abs())
        mag = ops.dedup_plan_apply(torch.from_numpy(np.abs(x)), abs_plan)
        bound = 2.0**-8 * mag.numpy() + KERNEL_TOL
        assert (np.abs(got.numpy() - np.asarray(ref)) <= bound).all()
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_spmm_through_hot_plans_matches_jax(precision):
    # 2,100 rows = 17 tiles: 'auto' builds a hot level on the forward
    # side; edge weights force dedup plans with f32 hot_w on both sides.
    rowptr, col = powerlaw_graph(4, 2100, 12000)
    w = _weights(7, col.shape[0])
    x = features(8, 2100, 16)
    cot = features(9, 2100, 16)
    for kw in (dict(dedup='auto'), dict(dedup='on', edge_weight=w)):
        graph_j = jops.build_spmm_graph(rowptr, col, **kw)
        graph_t = ops.build_spmm_graph(rowptr, col, device='cpu', **kw)
        assert graph_t.fwd.num_hot == graph_j.fwd.num_hot > 0
        ref = jops.spmm(jnp.asarray(x), graph_j, 'sum', precision)
        gref = jax.grad(lambda v: (jops.spmm(v, graph_j, 'sum', precision) *
                                   cot).sum())(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        out = ops.spmm(xt, graph_t, 'sum', precision)
        (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                       xt)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad.numpy(), np.asarray(gref),
                                   rtol=RTOL, atol=ATOL)


def test_weighted_graph_matches_numpy():
    rowptr, col = powerlaw_graph(10, 400, 5000)
    w = _weights(11, col.shape[0])
    x = features(12, 400, 8)
    graph = ops.build_spmm_graph(rowptr, col, dedup='auto', edge_weight=w,
                                 device='cpu')
    rows = np.repeat(np.arange(400), np.diff(rowptr))
    ref = np.zeros((400, 8))
    np.add.at(ref, rows, x[col].astype(np.float64) * w[:, None])
    out = ops.spmm(torch.from_numpy(x), graph)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
