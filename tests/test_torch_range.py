"""The port's range-split plans (``RangeSpmmPlan``, ``FusedRangePlan``),
K7's plain version and ``spmm`` over them against the JAX package, on
the CPU.

Inputs come from ``np.random.default_rng`` and go through both packages.
Tolerances:

* plans: bit for bit;
* K7's plain version against the Pallas kernel run in the interpreter:
  2e-3, the JAX package's own tolerance for its kernel tests (the
  interpreter runs the bf16 hi/lo ``split_dot``); in bf16 on a weighted
  plan the TPU kernel also rounds each weighted row to bf16, so 2**-8 of
  Σ|w·x| more;
* ``spmm`` and its gradient against the JAX package's CPU path: f32
  rtol 1e-5 / atol 1e-4 (summation order only).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.ops.pallas import spmm_chunked as jchunked
from pyg_lib_tpu.ops.pallas import spmm_range_fused as jfused
from pyg_lib_tpu_torch import ops
from test_torch_spmm import (ATOL, KERNEL_TOL, RTOL, _csr, features, np_of,
                             powerlaw_graph, uniform_graph)

# The modules, not the ``spmm`` functions the packages export by that name.
jspmm = importlib.import_module('pyg_lib_tpu.ops.spmm')
tspmm = importlib.import_module('pyg_lib_tpu_torch.ops.spmm')
PLAN_FIELDS = ('col_padded', 'chunk_tile', 'tile_ptr', 'tile_shift')
MAP_FIELDS = ('edge_perm', 'edge_pos', 'row_padded', 'valid_mask')


def _same_plan(ref, got, fields=PLAN_FIELDS):
    for name in fields:
        a, b = np.asarray(getattr(ref, name)), np_of(getattr(got, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.num_rows, got.num_edges, got.chunk) == (
        ref.num_rows, ref.num_edges, ref.chunk)


def _split_graph():
    # Rows < 150 draw from [0, 100), the rest from [200, 300): the middle
    # range is edgeless, and each range is empty in half the tiles.
    rng = np.random.default_rng(21)
    n = 300
    deg = rng.multinomial(2000, np.ones(n) / n)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = np.where(np.repeat(np.arange(n), deg) < 150,
                   rng.integers(0, 100, size=2000),
                   rng.integers(200, 300, size=2000)).astype(np.int64)
    return rowptr, col


GRAPHS = {
    'uniform': lambda: uniform_graph(0, 300, 4000),
    'powerlaw': lambda: powerlaw_graph(1, 300, 4000),
    'split': _split_graph,
    'empty': lambda: (np.zeros(301, np.int64), np.zeros(0, np.int64)),
}


@pytest.mark.parametrize('graph', ['uniform', 'powerlaw', 'split'])
@pytest.mark.parametrize('maps', [False, True])
def test_pad_to_chunks_plan_bit_exact(graph, maps):
    rowptr, col = GRAPHS[graph]()
    fields = PLAN_FIELDS + (MAP_FIELDS if maps else ())
    base = jchunked.build_spmm_plan(rowptr, col, chunk=128)
    for pad in (0, base.num_chunks + 5):
        ref = jchunked.build_spmm_plan(rowptr, col, chunk=128,
                                       with_edge_maps=maps,
                                       pad_to_chunks=pad)
        got = ops.build_spmm_plan(rowptr, col, chunk=128,
                                  with_edge_maps=maps, pad_to_chunks=pad,
                                  device='cpu')
        _same_plan(ref, got, fields)


@pytest.mark.parametrize('graph', ['uniform', 'powerlaw', 'split'])
def test_empty_tile_plan_bit_exact(graph):
    rowptr, col = GRAPHS[graph]()
    ref = jchunked.build_spmm_plan(rowptr, col, chunk=128,
                                   allow_empty_tiles=True,
                                   with_edge_maps=True)
    got = ops.build_spmm_plan(rowptr, col, chunk=128, allow_empty_tiles=True,
                              with_edge_maps=True, device='cpu')
    _same_plan(ref, got, PLAN_FIELDS + MAP_FIELDS)


@pytest.mark.parametrize('graph', ['uniform', 'powerlaw', 'split'])
@pytest.mark.parametrize('s', [2, 3, 4])
@pytest.mark.parametrize('chunk', [128, 'auto'])
def test_range_plan_bit_exact(graph, s, chunk):
    rowptr, col = GRAPHS[graph]()
    ref = jspmm._build_range_plan(rowptr, col, 300, s, chunk)
    got = tspmm._build_range_plan(rowptr, col, 300, s, chunk, device='cpu')
    assert got.bounds == ref.bounds and len(got.plans) == len(ref.plans)
    assert (got.num_rows, got.num_edges) == (ref.num_rows, ref.num_edges)
    for a, b in zip(ref.plans, got.plans):
        _same_plan(a, b)


def _fused_pair(rowptr, col, num_cols, s, chunk=128, **kw):
    ref = jfused.build_fused_range_plan(rowptr, col, num_cols, s, chunk=chunk,
                                        **kw)
    got = ops.build_fused_range_plan(rowptr, col, num_cols, s, chunk=chunk,
                                     device='cpu', **kw)
    return ref, got


def _weights(seed, e):
    return np.random.default_rng(seed).normal(size=e).astype(np.float32)


FUSED_CASES = {
    'S1': lambda rp, cl: dict(s=1),
    'S2': lambda rp, cl: dict(s=2),
    'S4_auto': lambda rp, cl: dict(s=4, chunk='auto'),
    'bounds': lambda rp, cl: dict(s=1, bounds=[(0, 70), (70, 71),
                                               (71, 300)]),
    'weighted': lambda rp, cl: dict(s=3, edge_weight=_weights(2, len(cl))),
}


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('case', list(FUSED_CASES))
def test_fused_range_plan_bit_exact(graph, case):
    rowptr, col = GRAPHS[graph]()
    kw = FUSED_CASES[case](rowptr, col)
    s = kw.pop('s')
    ref, got = _fused_pair(rowptr, col, 300, s, **kw)
    assert got.bounds == ref.bounds and len(got.plans) == len(ref.plans)
    assert (got.num_rows, got.num_edges, got.chunk) == (
        ref.num_rows, ref.num_edges, ref.chunk)
    for name in ('step_tile', 'blocks', 'posb', 'tile_ptrs'):
        a, b = np.asarray(getattr(ref, name)), np_of(getattr(got, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(ref.plans, got.plans):
        _same_plan(a, b)
    assert (ref.weights is None) == (got.weights is None)
    for a, b in zip(ref.weights or (), got.weights or ()):
        np.testing.assert_array_equal(np.asarray(a), np_of(b))
    # The port's concatenation, which K7 reads, is the same per-range data.
    base = np_of(got.slot_base)
    for r, ((lo, _), p) in enumerate(zip(got.bounds, got.plans)):
        e_pad = p.col_padded.shape[0]
        cols = np_of(got.cat_cols)[base[r]:base[r] + e_pad]
        valid = np.zeros(e_pad, bool)
        slot, _ = ops.kernels.spmm_chunked._padded_rows(p.tile_ptr)
        valid[slot.numpy()] = True
        np.testing.assert_array_equal(cols[valid],
                                      np_of(p.col_padded)[valid] + lo)
        if got.weights is not None:
            np.testing.assert_array_equal(
                np_of(got.cat_weights)[base[r]:base[r] + e_pad],
                np_of(got.weights[r]))


def test_fused_range_plan_is_compact():
    rowptr, col = _split_graph()
    _, plan = _fused_pair(rowptr, col, 300, 3)
    assert len(plan.plans) == 2  # the edgeless middle range is dropped
    assert 2 not in np_of(plan.plans[0].chunk_tile)  # tiles with no chunk
    assert 0 not in np_of(plan.plans[1].chunk_tile)
    ptr = np_of(plan.plans[0].tile_ptr)[2, 0, :129]
    assert (ptr == ptr[0]).all()  # ... give their rows empty slot ranges


# int8 is refused on weighted plans (test_weighted_int8_is_refused).
@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('precision,weighted', [
    (None, False), ('bf16', False), ('int8', False), (None, True),
    ('bf16', True)])
def test_plain_k7_matches_pallas_kernel(graph, precision, weighted):
    rowptr, col = GRAPHS[graph]()
    kw = dict(edge_weight=_weights(3, len(col))) if weighted else {}
    plan_j, plan_t = _fused_pair(rowptr, col, 300, 3, **kw)
    x = features(4, 300, 128)
    ref = np.asarray(jfused.fused_range_apply(jnp.asarray(x), plan_j,
                                              precision=precision,
                                              interpret=True))
    got = ops.fused_range_apply(torch.from_numpy(x), plan_t,
                                precision=precision)
    assert got.shape == (300, 128) and got.dtype == torch.float32
    tol = KERNEL_TOL * (1 + np.abs(ref))
    if weighted and precision == 'bf16':
        absw = plan_t._replace(
            weights=tuple(w.abs() for w in plan_t.weights))
        tol = tol + 2.0**-8 * ops.fused_range_plain(
            torch.from_numpy(np.abs(x)), absw).numpy()
    assert np.all(np.abs(got.numpy() - ref) <= tol)


def test_weighted_int8_is_refused():
    rowptr, col = GRAPHS['uniform']()
    _, plan = _fused_pair(rowptr, col, 300, 2,
                          edge_weight=_weights(5, len(col)))
    with pytest.raises(ValueError, match='int8'):
        ops.fused_range_apply(torch.zeros((300, 8)), plan, precision='int8')


def _grad_pair(x, graph_j, graph_t, reduce, precision, cot):
    ref, vjp = jax.vjp(lambda v: jops.spmm(v, graph_j, reduce, precision),
                       jnp.asarray(x))
    (gref, ) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out = ops.spmm(xt, graph_t, reduce, precision)
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    return (np.asarray(ref), out.detach().numpy(), np.asarray(gref),
            grad.numpy())


@pytest.mark.parametrize('s', [2, 3, 4])
@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_range_spmm_and_grad_match_jax(s, fused, precision):
    rowptr, col = GRAPHS['powerlaw']()
    x = features(6, 300, 32)
    cot = features(7, 300, 32)
    kw = dict(chunk=128, range_split=s, range_fused=fused)
    graph_j = jops.build_spmm_graph(rowptr, col, **kw)
    graph_t = ops.build_spmm_graph(rowptr, col, device='cpu', **kw)
    kind = ops.FusedRangePlan if fused else ops.RangeSpmmPlan
    assert isinstance(graph_t.fwd, kind) and isinstance(graph_t.bwd, kind)
    assert type(graph_j.fwd).__name__ == kind.__name__
    for reduce in ('sum', 'mean'):
        ref, out, gref, grad = _grad_pair(x, graph_j, graph_t, reduce,
                                          precision, cot)
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('fused', [False, True])
def test_range_spmm_rectangular_and_auto_chunk(fused):
    rng = np.random.default_rng(10)
    rowptr, col = _csr(rng.integers(0, 90, 2500), rng.integers(0, 310, 2500),
                       90)
    x = features(11, 310, 16)
    cot = features(12, 90, 16)
    kw = dict(chunk='auto', num_cols=310, range_split=3, range_fused=fused)
    graph_j = jops.build_spmm_graph(rowptr, col, **kw)
    graph_t = ops.build_spmm_graph(rowptr, col, device='cpu', **kw)
    ref, out, gref, grad = _grad_pair(x, graph_j, graph_t, 'sum', None, cot)
    assert out.shape == (90, 16) and grad.shape == (310, 16)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('bounds_t', [None, [(0, 120), (120, 300)]])
@pytest.mark.parametrize('precision', [None, 'bf16'])
def test_weighted_fused_graph_and_grad_match_jax(bounds_t, precision):
    rowptr, col = GRAPHS['powerlaw']()
    w = _weights(13, len(col))
    bounds = [(0, 50), (50, 200), (200, 300)]
    graph_j = jops.build_weighted_fused_graph(rowptr, col, 300, bounds, w,
                                              chunk=128, bounds_t=bounds_t)
    graph_t = ops.build_weighted_fused_graph(rowptr, col, 300, bounds, w,
                                             chunk=128, bounds_t=bounds_t,
                                             device='cpu')
    assert graph_t.fwd.bounds == graph_j.fwd.bounds
    assert graph_t.bwd.bounds == graph_j.bwd.bounds
    x = features(14, 300, 24)
    cot = features(15, 300, 24)
    ref, out, gref, grad = _grad_pair(x, graph_j, graph_t, 'sum', precision,
                                      cot)
    if precision is None:
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)
    else:
        # The JAX package's path off the TPU reads f32 rows on a weighted
        # plan; the port reads bf16 ones: 2**-8 of Σ|w·x|.
        absw = np.abs(w)
        rows = np.repeat(np.arange(300), np.diff(rowptr))
        mag = np.zeros((300, 24), np.float32)
        np.add.at(mag, rows, absw[:, None] * np.abs(x)[col])
        assert np.all(np.abs(out - ref) <= 2.0**-8 * mag + ATOL)
    # Against the weighted sum itself.
    dense = np.zeros((300, 300), np.float32)
    np.add.at(dense, (np.repeat(np.arange(300), np.diff(rowptr)), col), w)
    if precision is None:
        np.testing.assert_allclose(out, dense @ x, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad, dense.T @ cot, rtol=RTOL, atol=ATOL)


def test_range_graph_options_and_refusals():
    rowptr, col = GRAPHS['uniform']()
    with pytest.raises(ValueError, match='incompatible'):
        ops.build_spmm_graph(rowptr, col, range_split=2, with_edge_maps=True,
                             device='cpu')
    with pytest.raises(ValueError, match='incompatible'):
        ops.build_spmm_graph(rowptr, col, range_split=2, dedup='on',
                             device='cpu')
    graph = ops.build_spmm_graph(rowptr, col, range_split=2, device='cpu')
    with pytest.raises(ValueError, match='single-plan'):
        ops.spmm(torch.zeros((300, 8)), graph, reduce='max')
    # range_fused without a split keeps the single plan, as in JAX.
    single = ops.build_spmm_graph(rowptr, col, range_fused=True,
                                  device='cpu')
    assert isinstance(single.fwd, ops.SpmmPlan)
    # minmax on a range graph gets a plan of its own (fwd is no single
    # plan), of the type the JAX package picks.
    mm = ops.build_spmm_graph(rowptr, col, range_split=2, minmax='auto',
                              device='cpu')
    mm_j = jops.build_spmm_graph(rowptr, col, range_split=2, minmax='auto')
    assert mm.mm is not None
    assert type(mm.mm).__name__ == type(mm_j.mm).__name__
    x = features(16, 300, 8)
    np.testing.assert_array_equal(
        ops.spmm(torch.from_numpy(x), mm, reduce='max').numpy(),
        np.asarray(jops.spmm(jnp.asarray(x), mm_j, reduce='max')))
    with pytest.raises(ValueError, match='bounds'):
        ops.build_fused_range_plan(rowptr, col, 300, 1,
                                   bounds=[(0, 100), (150, 300)],
                                   device='cpu')


def _hub_graph():
    # Geometric degrees (a third of the rows empty), row 7 of 5,000 edges
    # and the last row, in a partial tile, of 700.
    rng = np.random.default_rng(23)
    deg = rng.geometric(0.1, 300) - 1
    deg[rng.random(300) < 0.33] = 0
    deg[7], deg[299] = 5000, 700
    rowptr = np.zeros(301, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    return rowptr, rng.integers(0, 300, int(rowptr[-1])).astype(np.int64)


def _runs(plan, row):
    """Row ``row``'s slot run in each range: ``[(lo, hi), ...]`` in the
    concatenated slots."""
    tp, base = plan.tile_ptrs.long(), plan.slot_base.long()
    t, r = divmod(row, 128)
    return [(int(base[s] + tp[t, s, r]), int(base[s] + tp[t, s, r + 1]))
            for s in range(base.shape[0])]


def _k7_schedule(xm, plan, cut, long_len):
    """K7's schedule with PyTorch: a row without a run of more than
    ``long_len`` slots as the plain version sums it; a row with one as
    the sum of its other runs plus the sum, in order, of its pieces'
    sums."""
    w = (plan.cat_weights if plan.cat_weights is not None else
         torch.ones(plan.cat_cols.shape[0]))
    terms = xm[plan.cat_cols.long()].float() * w[:, None]
    out = ops.fused_range_plain(xm, plan)
    for row, first, count in cut.rows.tolist():
        acc = torch.zeros(xm.shape[1])
        for lo, hi in _runs(plan, row):
            if hi - lo <= long_len:
                acc = acc + terms[lo:hi].sum(0)
        pieces = torch.zeros(xm.shape[1])
        for _, lo, hi in cut.pieces[first:first + count].tolist():
            pieces = pieces + terms[lo:hi].sum(0)
        out[row] = acc + pieces
    return out


@pytest.mark.parametrize('long_len', [1, 64, 512])
@pytest.mark.parametrize('case', ['S1', 'S2', 'weighted'])
def test_k7_pieces_cut_long_rows_and_match_pallas_kernel(monkeypatch,
                                                         long_len, case):
    from pyg_lib_tpu_torch.ops.kernels import spmm_range_fused as k7_mod

    rowptr, col = _hub_graph()
    kw = FUSED_CASES[case](rowptr, col)
    plan_j, plan_t = _fused_pair(rowptr, col, 300, **kw)
    monkeypatch.setattr(k7_mod, 'K7_LONG', long_len)
    cut = k7_mod.k7_pieces(plan_t)
    # Every row with a run of more than K7_LONG slots in one range, and
    # no other, is listed; its pieces hold those runs' slots in range and
    # slot order, at most K7_LONG each.
    runs = [_runs(plan_t, row) for row in range(300)]
    long_rows = [row for row in range(300)
                 if any(hi - lo > long_len for lo, hi in runs[row])]
    assert cut.rows[:, 0].tolist() == long_rows
    assert cut.rows[:, 1].tolist() == np.concatenate(
        [[0], np.cumsum(cut.rows[:, 2].numpy())[:-1]]).tolist()
    assert int(cut.rows[:, 2].sum()) == cut.pieces.shape[0]
    for row, first, count in cut.rows.tolist():
        want = [p for lo, hi in runs[row] if hi - lo > long_len
                for p in range(lo, hi)]
        got = []
        for q_row, lo, hi in cut.pieces[first:first + count].tolist():
            assert q_row == row and 0 < hi - lo <= long_len
            got += range(lo, hi)
        assert got == want
    assert k7_mod.k7_pieces(plan_t) is cut  # cached per plan
    # The schedule's sums against the Pallas kernel in the interpreter.
    x = features(5, 300, 16)
    ref = np.asarray(jfused.fused_range_apply(jnp.asarray(x), plan_j,
                                              interpret=True))
    got = _k7_schedule(torch.from_numpy(x), plan_t, cut, long_len).numpy()
    assert np.all(np.abs(got - ref) <= KERNEL_TOL * (1 + np.abs(ref)))
