"""The tables K2 and K2h read in place of the plan's dense ones, on the
CPU: the row list of ``hot_w``'s non-zeros (``hot_list``) and each
chunk's edges sorted by row (``cold_edges``), against the plan and the
JAX package.

Tolerances: the tables hold the plan's entries exactly (counts and f32
weight sums are exact in f32). A sum over them and the plan's plain sum
add the same f32 terms in another order, so they agree within
``1e-5 * Σ|terms| + 1e-5`` elementwise, the bound K2 is held to on the
card. ``dedup_sum_plain`` against the JAX package's CPU
``dedup_plan_apply`` (its XLA path) at f32 rtol 1e-5 / atol 1e-4,
summation order only.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu.ops.pallas import spmm_dedup as jdedup
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.ops.kernels import spmm_dedup as tdedup
from test_torch_dedup import _bf16_hot_graph, _weights
from test_torch_spmm import ATOL, RTOL, features, powerlaw_graph

# (graph builder, build_dedup_plan kwargs, hot_w storage type)
HOT_PLANS = {
    'int8': (lambda: powerlaw_graph(4, 2100, 12000), dict(ec=512),
             torch.int8),
    'bf16': (_bf16_hot_graph, dict(ec=512), torch.bfloat16),
    'f32_weighted': (lambda: powerlaw_graph(3, 300, 4000),
                     dict(ec=256, hot=8, weights=True), torch.float32),
}


def _hot_plans(kind):
    make, kw, dtype = HOT_PLANS[kind]
    kw = dict(kw)
    rowptr, col = make()
    if kw.pop('weights', False):
        kw['edge_weight'] = _weights(5, col.shape[0])
    plan = ops.build_dedup_plan(rowptr, col, device='cpu', **kw)
    assert plan.num_hot > 0 and plan.hot_w.dtype == dtype
    return rowptr, col, kw, plan


def _dense_of(hl, plan):
    """``hot_w`` rebuilt in f32 from the list."""
    rows = torch.repeat_interleave(
        torch.arange(plan.hot_w.shape[0]), (hl.ptr[1:] - hl.ptr[:-1]).long())
    h = torch.searchsorted(plan.hot_cols, hl.src)
    dense = torch.zeros(plan.hot_w.shape, dtype=torch.float32)
    dense[rows, h] = hl.val
    return dense, rows, h


@pytest.mark.parametrize('kind', list(HOT_PLANS))
def test_hot_list_holds_the_non_zeros(kind):
    _, _, _, plan = _hot_plans(kind)
    hl = tdedup.hot_list(plan)
    nnz = int(torch.count_nonzero(plan.hot_w))
    assert hl.ptr.dtype == hl.src.dtype == torch.int32
    assert hl.val.dtype == torch.float32
    assert hl.ptr.shape == (plan.hot_w.shape[0] + 1, )
    assert hl.src.shape == hl.val.shape == (nnz, )
    assert int(hl.ptr[0]) == 0 and int(hl.ptr[-1]) == nnz
    assert bool((hl.val != 0).all())
    dense, rows, h = _dense_of(hl, plan)
    # Every entry names a hot column, once per row, in column order.
    assert torch.equal(plan.hot_cols[h], hl.src)
    same_row = rows[1:] == rows[:-1]
    assert bool((h[1:][same_row] > h[:-1][same_row]).all())
    assert torch.equal(dense, plan.hot_w.float())


@pytest.mark.parametrize('kind', list(HOT_PLANS))
def test_hot_list_sum_matches_dense_product(kind):
    rowptr, _, _, plan = _hot_plans(kind)
    x = torch.from_numpy(features(6, rowptr.shape[0] - 1, 24))
    hl = tdedup.hot_list(plan)
    rows = torch.repeat_interleave(
        torch.arange(plan.hot_w.shape[0]), (hl.ptr[1:] - hl.ptr[:-1]).long())
    got = torch.zeros((plan.hot_w.shape[0], 24)).index_add_(
        0, rows, hl.val[:, None] * x[hl.src.long()])
    ref = plan.hot_w.float() @ x[plan.hot_cols.long()]
    mag = plan.hot_w.float().abs() @ x[plan.hot_cols.long()].abs()
    assert bool(((got - ref).abs() <= 1e-5 * mag + 1e-5).all())


@pytest.mark.parametrize('kind', list(HOT_PLANS))
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_plain_hot_sum_matches_jax_cpu_path(kind, precision):
    rowptr, col, kw, plan_t = _hot_plans(kind)
    plan_j = jdedup.build_dedup_plan(rowptr, col, **kw)
    x = features(7, rowptr.shape[0] - 1, 32)
    ref = jdedup.dedup_plan_apply(jnp.asarray(x), plan_j,
                                  precision=precision)
    got = ops.dedup_plan_apply(torch.from_numpy(x), plan_t,
                               precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_hot_list_is_cached_per_hot_w():
    _, _, _, plan = _hot_plans('int8')
    hl = tdedup.hot_list(plan)
    assert tdedup.hot_list(plan) is hl
    # Another plan tuple over the same tensors shares the entry.
    assert tdedup.hot_list(plan._replace(num_edges=0)) is hl


def test_hot_list_follows_a_replaced_hot_w():
    _, _, _, plan = _hot_plans('int8')
    hl = tdedup.hot_list(plan)
    w2 = plan.hot_w.clone()
    w2[w2 != 0] = 3
    w2[7, 1] = 5
    replaced = plan._replace(hot_w=w2)
    hl2 = tdedup.hot_list(replaced)
    assert hl2 is not hl
    assert torch.equal(_dense_of(hl2, replaced)[0], w2.float())
    # The old plan still gets its own list.
    assert tdedup.hot_list(plan) is hl
    cols2 = plan.hot_cols.clone()
    other = plan._replace(hot_cols=cols2)
    assert tdedup.hot_list(other) is not hl


def test_hot_list_follows_an_in_place_change():
    _, _, _, plan = _hot_plans('bf16')
    plan = plan._replace(hot_w=plan.hot_w.clone())
    hl = tdedup.hot_list(plan)
    zero = torch.nonzero(plan.hot_w == 0)[0]
    plan.hot_w[zero[0], zero[1]] = 9
    hl2 = tdedup.hot_list(plan)
    assert hl2 is not hl and hl2.val.numel() == hl.val.numel() + 1
    assert torch.equal(_dense_of(hl2, plan)[0], plan.hot_w.float())
    plan.hot_w.zero_()
    assert tdedup.hot_list(plan).val.numel() == 0


def test_derived_tables_go_with_their_sources():
    _, _, _, plan = _hot_plans('f32_weighted')
    plan = plan._replace(hot_w=plan.hot_w.clone(),
                         edge_meta=plan.edge_meta.clone())
    tdedup.hot_list(plan)
    tdedup.cold_edges(plan)
    ids = {id(plan.hot_w), id(plan.edge_meta)}
    assert sum(bool(ids & set(k[1:])) for k in tdedup._derived) == 2
    del plan
    gc.collect()
    assert not any(ids & set(k[1:]) for k in tdedup._derived)


def _cold_plans(kind):
    if kind in HOT_PLANS:
        return _hot_plans(kind)[3]
    rowptr, col = powerlaw_graph(1, 300, 4000)
    if kind == 'hub_tiles':  # the transpose: a tile of many chunks
        row = np.repeat(np.arange(300), np.diff(rowptr))
        order = np.argsort(col, kind='stable')
        rowptr = np.zeros(301, np.int64)
        np.cumsum(np.bincount(col, minlength=300), out=rowptr[1:])
        col = row[order]
    return ops.build_dedup_plan(rowptr, col, ec=128, uc=64, hot='off',
                                device='cpu')


COLD_KINDS = ['plain', 'hub_tiles', 'int8', 'f32_weighted']


@pytest.mark.parametrize('kind', COLD_KINDS)
def test_cold_edges_hold_each_chunks_edges_by_row(kind):
    plan = _cold_plans(kind)
    ce = tdedup.cold_edges(plan)
    meta = plan.edge_meta
    assert ce.ptr.dtype == ce.code.dtype == torch.int32
    assert ce.ptr.shape == (plan.num_chunks + 1, )
    assert (ce.w is not None) == plan.weighted
    for c in range(plan.num_chunks):
        lo, hi = int(ce.ptr[c]), int(ce.ptr[c + 1])
        code = ce.code[lo:hi]
        rows, lids = code & 127, code >> 7
        assert bool((rows[1:] >= rows[:-1]).all())  # sorted by row
        # The edges name unique ids 0 .. num_uniq - 1, each at least once.
        assert torch.equal(torch.unique(lids),
                           torch.arange(int(ce.num_uniq[c])))
        valid = meta[c, 0] >= 0
        want = torch.stack([meta[c, 0][valid], meta[c, 1][valid],
                            meta[c, 2][valid]], 1)
        got = torch.stack([rows, lids, torch.zeros_like(rows) if ce.w is None
                           else ce.w[lo:hi].view(torch.int32)], 1)
        # The same edges: a stable sort by row keeps the column order.
        order = torch.sort(want[:, 0], stable=True).indices
        assert torch.equal(got, want[order])


@pytest.mark.parametrize('kind', COLD_KINDS)
def test_sum_over_derived_tables_matches_plain(kind):
    plan = _cold_plans(kind)
    x = torch.from_numpy(features(9, plan.num_rows, 16))
    ce = tdedup.cold_edges(plan)
    chunk = torch.repeat_interleave(torch.arange(plan.num_chunks),
                                    (ce.ptr[1:] - ce.ptr[:-1]).long())
    rows = plan.chunk_tile[chunk].long() * 128 + (ce.code & 127).long()
    src = plan.uniq_cols[chunk * plan.uc + (ce.code >> 7).long()].long()
    w = torch.ones(src.shape[0]) if ce.w is None else ce.w
    got = torch.zeros((plan.num_rows + 128, 16)).index_add_(
        0, rows, w[:, None] * x[src])
    if plan.num_hot:
        hl = tdedup.hot_list(plan)
        hrows = torch.repeat_interleave(
            torch.arange(hl.ptr.shape[0] - 1),
            (hl.ptr[1:] - hl.ptr[:-1]).long())
        got.index_add_(0, hrows, hl.val[:, None] * x[hl.src.long()])
    got = got[:plan.num_rows]
    ref = ops.dedup_sum_plain(x, plan)
    abs_plan = plan
    if plan.weighted:
        meta = plan.edge_meta.clone()
        meta[:, 2, :] = meta[:, 2, :].view(torch.float32).abs().view(
            torch.int32)
        abs_plan = plan._replace(
            edge_meta=meta,
            hot_w=None if plan.hot_w is None else plan.hot_w.abs())
    mag = ops.dedup_sum_plain(x.abs(), abs_plan)
    assert bool(((got - ref).abs() <= 1e-5 * mag + 1e-5).all())


def test_cold_edges_follow_the_plan():
    plan = _cold_plans('plain')
    ce = tdedup.cold_edges(plan)
    assert tdedup.cold_edges(plan) is ce
    meta = plan.edge_meta.clone()
    replaced = plan._replace(edge_meta=meta)
    ce2 = tdedup.cold_edges(replaced)
    assert ce2 is not ce and torch.equal(ce2.code, ce.code)
    meta[0, 0, 0] = -1  # drop an edge in place
    ce3 = tdedup.cold_edges(replaced)
    assert ce3 is not ce2 and ce3.code.numel() == ce.code.numel() - 1


def test_tables_of_inference_tensors_are_cached():
    # A plan built under inference mode has no version counters: its
    # tables are cached on the tensor objects alone.
    with torch.inference_mode():
        _, _, _, plan = _hot_plans('int8')
    assert plan.hot_w.is_inference() and plan.edge_meta.is_inference()
    hl = tdedup.hot_list(plan)
    ce = tdedup.cold_edges(plan)
    assert tdedup.hot_list(plan) is hl and tdedup.cold_edges(plan) is ce
    assert torch.equal(_dense_of(hl, plan)[0], plan.hot_w.float())
    with torch.inference_mode():
        w2 = plan.hot_w.clone()
        w2[w2 != 0] = 4
    replaced = plan._replace(hot_w=w2)
    hl2 = tdedup.hot_list(replaced)
    assert hl2 is not hl and bool((hl2.val == 4).all())
    assert tdedup.hot_list(replaced) is hl2


@pytest.mark.parametrize('uc,weighted,dtype,fits', [
    (64, False, torch.float32, True),
    (1024, False, torch.float32, True),
    (1496, False, torch.float32, True),
    (1504, False, torch.float32, False),
    (1504, False, torch.bfloat16, True),
    (1496, True, torch.float32, False),
    (2048, False, torch.int8, True),
])
def test_cold_pass_fits_shared_memory(uc, weighted, dtype, fits):
    rowptr, col = powerlaw_graph(1, 300, 4000)
    plan = ops.build_dedup_plan(
        rowptr, col, ec=uc, uc=uc, hot='off', device='cpu',
        edge_weight=_weights(2, col.shape[0]) if weighted else None)
    assert plan.uc == plan.ec == uc
    assert tdedup.cold_pass_fits(plan, dtype) is fits
    # The CPU path has no such limit.
    x = torch.from_numpy(features(3, 300, 8))
    assert torch.isfinite(ops.dedup_sum(x, plan)).all()
