"""The port's row-split plans (``build_spmm_graph_sharded``), the plan
padding functions and ``spmm_sharded`` against the JAX package, on the
CPU.

Inputs come from ``np.random.default_rng`` and go through both packages.
Tolerances:

* plans, padded plans and the split plans' arrays: bit for bit;
* padding against no padding, on the same plain version: equal (the pad
  chunks and hot columns add nothing; f32 sums of zero terms);
* ``spmm_sharded`` sum and mean and their gradients against the JAX
  package's CPU path: f32 rtol 1e-5 / atol 1e-4, for the summation order
  only (bf16 and int8 read the same rounded or quantised rows in both);
* max and min: values bit for bit, gradients (winner-only, summed over
  the splits) within the same rtol/atol.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.ops.pallas import spmm_dedup as jdedup
from pyg_lib_tpu.ops.pallas import spmm_dedup_minmax as jmm
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.ops.kernels import spmm_dedup as tdedup
from pyg_lib_tpu_torch.ops.kernels import spmm_dedup_minmax as tmm
from test_torch_spmm import (ATOL, RTOL, _csr, features, powerlaw_graph,
                             uniform_graph)

# The module, not the ``spmm`` function the package exports by that name.
tspmm = importlib.import_module('pyg_lib_tpu_torch.ops.spmm')

ARRAYS = {
    'SpmmPlan': ('col_padded', 'chunk_tile', 'tile_ptr', 'tile_shift'),
    'DedupSpmmPlan': ('uniq_cols', 'edge_meta', 'chunk_tile', 'hot_cols',
                      'hot_w'),
    'DedupMinmaxPlan': ('uniq_cols', 'edge_meta', 'chunk_tile'),
}
SCALARS = {
    'SpmmPlan': ('num_rows', 'num_edges', 'chunk'),
    'DedupSpmmPlan': ('num_rows', 'num_edges', 'ec', 'uc', 'weighted'),
    'DedupMinmaxPlan': ('num_rows', 'num_edges', 'ec', 'uc', 'scan_len'),
}


def _same_array(ref, got, name):
    ref = np.asarray(ref)
    if got.dtype == torch.bfloat16:
        assert ref.dtype.name == 'bfloat16', name
        ref, got = ref.astype(np.float32), got.float().numpy()
    else:
        got = got.numpy()
        assert ref.dtype == got.dtype, name
    assert ref.shape == got.shape, name
    np.testing.assert_array_equal(ref, got, err_msg=name)


def _same_plan(ref, got):
    kind = type(ref).__name__
    assert type(got).__name__ == kind
    if kind == 'RangeSpmmPlan':
        assert got.bounds == ref.bounds
        assert (got.num_rows, got.num_edges) == (ref.num_rows, ref.num_edges)
        assert len(got.plans) == len(ref.plans)
        for a, b in zip(ref.plans, got.plans):
            _same_plan(a, b)
        return
    for name in ARRAYS[kind]:
        a, b = getattr(ref, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _same_array(a, b, name)
    for name in SCALARS[kind]:
        assert getattr(got, name) == getattr(ref, name), name


def _same_graph(ref, got):
    assert (got.num_rows, got.num_cols) == (ref.num_rows, ref.num_cols)
    _same_array(ref.deg, got.deg, 'deg')
    for side in ('fwd', 'bwd', 'mm'):
        a, b = getattr(ref, side), getattr(got, side)
        assert (a is None) == (b is None), side
        if a is not None:
            assert len(a) == len(b), side
            for pa, pb in zip(a, b):
                _same_plan(pa, pb)


def _hot_graph():
    """Three splits of 2,176 rows (17 tiles each) whose dedup plans get hot
    levels of other widths and types: split 0 Zipf(1.3) columns and row 5
    naming column 0 200 times more (counts past 127: bf16), split 1
    Zipf(1.3) columns (int8), split 2 every column at most once (no hot
    level)."""
    rng = np.random.default_rng(31)
    npd = 2176
    n = 3 * npd
    deg = np.concatenate([rng.integers(2, 10, 2 * npd),
                          rng.integers(0, 3, npd)])
    rows = np.repeat(np.arange(n), deg)
    p = 1.0 / np.arange(1, n + 1)**1.3
    p /= p.sum()
    col = rng.choice(n, rows.size, p=p)
    last = rows >= 2 * npd
    col[last] = rng.permutation(n)[:int(last.sum())]
    rows = np.concatenate([rows, np.full(200, 5)])
    col = np.concatenate([col, np.zeros(200, np.int64)])
    return _csr(rows, col, n)


GRAPHS = {
    'uniform': lambda: uniform_graph(0, 300, 4000),
    'powerlaw': lambda: powerlaw_graph(1, 300, 4000),
}
PLAIN_CASES = {
    'chunk': dict(chunk=256),
    'auto': dict(chunk='auto'),
    'range': dict(chunk=128, range_split=3),
    'range_auto': dict(chunk='auto', range_split=4),
    'minmax': dict(chunk=128, minmax='on'),
    'minmax_auto': dict(chunk=128, minmax='auto'),
}


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('splits', [1, 3, 4])
@pytest.mark.parametrize('case', list(PLAIN_CASES))
def test_sharded_plans_bit_exact(graph, splits, case):
    rowptr, col = GRAPHS[graph]()
    kw = PLAIN_CASES[case]
    ref = jops.build_spmm_graph_sharded(rowptr, col, splits, **kw)
    got = ops.build_spmm_graph_sharded(rowptr, col, splits, device='cpu',
                                       **kw)
    _same_graph(ref, got)
    # One chunk count a side (and a range), as the JAX package's contract.
    for side in (got.fwd, got.bwd):
        plans = [q for p in side for q in getattr(p, 'plans', [p])]
        assert len({p.num_chunks for p in plans}) == 1


def test_sharded_rectangular_plans_bit_exact():
    rng = np.random.default_rng(9)
    rowptr, col = _csr(rng.integers(0, 150, 2500), rng.integers(0, 400, 2500),
                       150)
    for kw in (dict(chunk=128), dict(chunk=128, range_split=2)):
        ref = jops.build_spmm_graph_sharded(rowptr, col, 3, num_cols=400,
                                            **kw)
        got = ops.build_spmm_graph_sharded(rowptr, col, 3, num_cols=400,
                                           device='cpu', **kw)
        _same_graph(ref, got)


@pytest.mark.parametrize('dedup,minmax', [('on', 'off'), ('on', 'on'),
                                          ('auto', 'auto')])
def test_sharded_dedup_plans_bit_exact(dedup, minmax):
    rowptr, col = _hot_graph()
    ref = jops.build_spmm_graph_sharded(rowptr, col, 3, dedup=dedup,
                                        minmax=minmax)
    got = ops.build_spmm_graph_sharded(rowptr, col, 3, dedup=dedup,
                                       minmax=minmax, device='cpu')
    _same_graph(ref, got)
    assert all(isinstance(p, ops.DedupSpmmPlan) for p in got.fwd)
    # The splits' own hot levels differ in width and type (one has none),
    # so the padding above lifted and cast them to one.
    subs = tspmm._split_csrs(rowptr, col, rowptr.shape[0] - 1, 3)
    own = [tdedup.build_dedup_plan(rp, cl, ec=512, uc=got.fwd[0].uc,
                                   hot_budget_bytes=(1 << 30) // 3,
                                   device='cpu') for rp, cl in subs]
    assert [p.num_hot > 0 for p in own] == [True, True, False]
    assert own[0].hot_w.dtype == torch.bfloat16
    assert own[1].hot_w.dtype == torch.int8
    assert own[0].num_hot != own[1].num_hot
    assert {p.hot_w.dtype for p in got.fwd} == {torch.bfloat16}
    assert len({(p.num_chunks, p.uc, p.num_hot) for p in got.fwd}) == 1
    if minmax != 'off':
        assert all(isinstance(p, ops.DedupMinmaxPlan) for p in got.mm)
        assert len({(p.num_chunks, p.scan_len) for p in got.mm}) == 1


def test_sharded_builder_refuses_bad_options():
    rowptr, col = GRAPHS['uniform']()
    for kw, match in ((dict(dedup='sometimes'), 'dedup must be'),
                      (dict(minmax='yes'), 'minmax must be'),
                      (dict(dedup='on', range_split=2), 'range_split'),
                      (dict(minmax='auto', range_split=2), 'range_split')):
        with pytest.raises(ValueError, match=match):
            jops.build_spmm_graph_sharded(rowptr, col, 2, **kw)
        with pytest.raises(ValueError, match=match):
            ops.build_spmm_graph_sharded(rowptr, col, 2, device='cpu', **kw)


def test_pad_plan_and_pad_hot_bit_exact_and_no_op():
    rowptr, col = powerlaw_graph(39, 300, 4000, alpha=1.3)
    x = torch.from_numpy(features(40, 300, 32))
    plan_j = jdedup.build_dedup_plan(rowptr, col, ec=128, hot=16,
                                     hot_thresh=2)
    plan_t = tdedup.build_dedup_plan(rowptr, col, ec=128, hot=16,
                                     hot_thresh=2, device='cpu')
    _same_plan(plan_j, plan_t)
    extra = plan_t.num_chunks + 3
    padded_j = jdedup.pad_hot(jdedup.pad_plan(plan_j, extra), 40)
    padded_t = tdedup.pad_hot(tdedup.pad_plan(plan_t, extra), 40)
    _same_plan(padded_j, padded_t)
    assert padded_t.num_hot == 40 and padded_t.num_chunks == extra
    # Padding to fewer chunks or the same hot width leaves the plan.
    assert tdedup.pad_plan(plan_t, 1) is plan_t
    assert tdedup.pad_hot(plan_t, plan_t.num_hot) is plan_t
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        _same_plan(jdedup.pad_hot(padded_j, 48, dtype=jdtype),
                   tdedup.pad_hot(padded_t, 48, dtype=dtype))
    want = tdedup.dedup_sum_plain(x, plan_t)
    assert torch.equal(tdedup.dedup_sum_plain(x, padded_t), want)
    assert torch.equal(tdedup.dedup_sum_plain(
        x, tdedup.pad_hot(padded_t, 48, dtype=torch.float32)), want)
    # A plan with no hot level gets an all-zero one, int8 unless told.
    bare_j = jdedup.build_dedup_plan(rowptr, col, ec=128, hot='off')
    bare_t = tdedup.build_dedup_plan(rowptr, col, ec=128, hot='off',
                                     device='cpu')
    for dtype, jdtype in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        lifted = tdedup.pad_hot(bare_t, 16, dtype=dtype)
        _same_plan(jdedup.pad_hot(bare_j, 16, dtype=jdtype), lifted)
        assert lifted.hot_w.dtype == (dtype or torch.int8)
        assert torch.equal(tdedup.dedup_sum_plain(x, lifted),
                           tdedup.dedup_sum_plain(x, bare_t))
    with pytest.raises(ValueError, match='shrink'):
        jdedup.pad_hot(padded_j, 8)
    with pytest.raises(ValueError, match='shrink'):
        tdedup.pad_hot(padded_t, 8)


@pytest.mark.parametrize('weighted', [False, True])
def test_build_dedup_plan_pad_to_chunks_bit_exact(weighted):
    rowptr, col = powerlaw_graph(41, 300, 4000)
    w = (np.random.default_rng(42).normal(size=col.shape[0]).astype(
        np.float32) if weighted else None)
    x = torch.from_numpy(features(43, 300, 16))
    base = tdedup.build_dedup_plan(rowptr, col, ec=128, edge_weight=w,
                                   device='cpu')
    for pad in (0, base.num_chunks + 7):
        ref = jdedup.build_dedup_plan(rowptr, col, ec=128, edge_weight=w,
                                      pad_to_chunks=pad)
        got = tdedup.build_dedup_plan(rowptr, col, ec=128, edge_weight=w,
                                      pad_to_chunks=pad, device='cpu')
        _same_plan(ref, got)
        assert got.num_chunks == max(pad, base.num_chunks)
        _same_plan(ref, tdedup.pad_plan(base, pad))
        assert torch.equal(tdedup.dedup_sum_plain(x, got),
                           tdedup.dedup_sum_plain(x, base))


def test_pad_minmax_plan_bit_exact_and_no_op():
    rowptr, col = powerlaw_graph(44, 300, 4000)
    x = torch.from_numpy(features(45, 300, 16))
    plan_j = jmm.build_dedup_minmax_plan(rowptr, col, ec=128, uc=64)
    plan_t = tmm.build_dedup_minmax_plan(rowptr, col, ec=128, uc=64,
                                         device='cpu')
    _same_plan(plan_j, plan_t)
    for chunks, scan in ((plan_t.num_chunks + 5, None),
                         (plan_t.num_chunks, 4 * plan_t.scan_len),
                         (plan_t.num_chunks + 2, 1)):
        ref = jmm.pad_minmax_plan(plan_j, chunks, scan_len=scan)
        got = tmm.pad_minmax_plan(plan_t, chunks, scan_len=scan)
        _same_plan(ref, got)
        assert got.scan_len == max(plan_t.scan_len, scan or 0)
        for negate in (False, True):
            a = tmm.dedup_minmax_plain(x, plan_t, negate)
            b = tmm.dedup_minmax_plain(x, got, negate)
            assert all(torch.equal(u, v) for u, v in zip(a, b))
    # The pad chunks, on the last tile, go through K5's units as well.
    padded = tmm.pad_minmax_plan(plan_t, plan_t.num_chunks + 20)
    a = tmm.dedup_minmax_split(x, plan_t)
    b = tmm.dedup_minmax_split(x, padded)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _value_and_grad(spmm, x, graph, reduce, precision, cot):
    if isinstance(x, np.ndarray):
        import jax

        xj = jnp.asarray(x)
        out = spmm(xj, graph, reduce=reduce, precision=precision)
        grad = jax.grad(lambda v: (spmm(v, graph, reduce=reduce,
                                        precision=precision) * cot).sum())(xj)
        return np.asarray(out), np.asarray(grad)
    out = spmm(x, graph, reduce=reduce, precision=precision)
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), x)
    return out.detach().numpy(), grad.numpy()


@pytest.mark.parametrize('splits', [1, 3, 4])
@pytest.mark.parametrize('reduce', ['sum', 'mean', 'max', 'min'])
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_spmm_sharded_and_grad_match_jax(splits, reduce, precision):
    rowptr, col = GRAPHS['powerlaw']()
    x = features(46, 300, 32)
    cot = features(47, 300, 32)
    graph_j = jops.build_spmm_graph_sharded(rowptr, col, splits, chunk=128)
    graph_t = ops.build_spmm_graph_sharded(rowptr, col, splits, chunk=128,
                                           device='cpu')
    ref, gref = _value_and_grad(jops.spmm_sharded, x, graph_j, reduce,
                                precision, cot)
    out, grad = _value_and_grad(ops.spmm_sharded,
                                torch.from_numpy(x).requires_grad_(),
                                graph_t, reduce, precision, cot)
    assert out.dtype == np.float32 and out.shape == ref.shape
    if reduce in ('max', 'min'):
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('case', ['range', 'dedup', 'dedup_minmax'])
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_spmm_sharded_other_plans_match_jax(case, precision):
    if case == 'range':
        rowptr, col = GRAPHS['powerlaw']()
        kw = dict(chunk='auto', range_split=3)
    else:
        rowptr, col = _hot_graph()
        kw = dict(dedup='on', minmax='on' if case == 'dedup_minmax' else
                  'off')
    n = rowptr.shape[0] - 1
    x = features(48, n, 24)
    cot = features(49, n, 24)
    graph_j = jops.build_spmm_graph_sharded(rowptr, col, 3, **kw)
    graph_t = ops.build_spmm_graph_sharded(rowptr, col, 3, device='cpu',
                                           **kw)
    reduces = ['sum', 'mean'] + (['max', 'min'] if case == 'dedup_minmax'
                                 and precision is None else [])
    for reduce in reduces:
        ref, gref = _value_and_grad(jops.spmm_sharded, x, graph_j, reduce,
                                    precision, cot)
        out, grad = _value_and_grad(ops.spmm_sharded,
                                    torch.from_numpy(x).requires_grad_(),
                                    graph_t, reduce, precision, cot)
        if reduce in ('max', 'min'):
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


def test_spmm_sharded_refuses_what_the_jax_package_refuses():
    rowptr, col = GRAPHS['uniform']()
    x = features(50, 300, 8)
    graph = ops.build_spmm_graph_sharded(rowptr, col, 2, device='cpu')
    for kw, match in ((dict(reduce='prod'), 'reduce must be'),
                      (dict(precision='fp8'), 'precision must be')):
        with pytest.raises(ValueError, match=match):
            jops.spmm_sharded(jnp.asarray(x), jops.build_spmm_graph_sharded(
                rowptr, col, 2), **kw)
        with pytest.raises(ValueError, match=match):
            ops.spmm_sharded(torch.from_numpy(x), graph, **kw)
    # Range and dedup split plans carry no max/min schedule of their own.
    for kw in (dict(range_split=2), dict(dedup='on')):
        g_j = jops.build_spmm_graph_sharded(rowptr, col, 2, **kw)
        g_t = ops.build_spmm_graph_sharded(rowptr, col, 2, device='cpu',
                                           **kw)
        with pytest.raises(ValueError, match='minmax'):
            jops.spmm_sharded(jnp.asarray(x), g_j, reduce='max')
        with pytest.raises(ValueError, match='minmax'):
            ops.spmm_sharded(torch.from_numpy(x), g_t, reduce='max')
    # The port's kernels index x unchecked: its shape and device are.
    with pytest.raises(ValueError, match=r'x must be \[300, F\]'):
        ops.spmm_sharded(torch.zeros((299, 8)), graph)
    with pytest.raises(ValueError, match='is on'):
        ops.spmm_sharded(torch.zeros((300, 8), device='meta'), graph)


def test_sharded_builder_puts_plans_on_the_card_by_default(monkeypatch):
    # With no card the default device, the card, makes the builder raise
    # where a device='cpu' build succeeds.
    rowptr, col = GRAPHS['uniform']()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        ops.build_spmm_graph_sharded(rowptr, col, 2)
    graph = ops.build_spmm_graph_sharded(rowptr, col, 2, device='cpu')
    assert graph.deg.device.type == 'cpu'
    assert all(p.col_padded.device.type == 'cpu' for p in graph.fwd)
