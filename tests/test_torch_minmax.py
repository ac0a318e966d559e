"""The port's exact max/min against the JAX package, on the CPU: the chunked
plan's edge maps, the min/max plans of ``build_spmm_graph(minmax=...)``,
``spmm(reduce='max'/'min')``, ``segment_{max,min}_padded`` and K5's
plain version.

Inputs come from ``np.random.default_rng`` and go through both packages.
Tolerances: plans bit for bit; max/min values bit for bit (``-0.0`` and
``+0.0`` told apart where the JAX path is the Pallas kernel), with equal
winner positions; gradients at f32 rtol 1e-5 / atol 1e-4, since a source
row that wins several rows sums their cotangents in another order. Ties
between edges are compared against the JAX path of the same plan kind:
the chunked plan keeps the first edge, the dedup plan the least column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.ops.pallas import spmm_chunked as jchunked
from pyg_lib_tpu.ops.pallas import spmm_dedup_minmax as jdm
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.testing import cycle_graph
from test_torch_spmm import (ATOL, RTOL, _csr, features, np_of,
                             powerlaw_graph, uniform_graph)

GRAPHS = {
    'uniform': lambda: uniform_graph(40, 300, 4000),
    'powerlaw': lambda: powerlaw_graph(41, 300, 5000),
    'ragged': lambda: _csr(
        np.minimum(np.random.default_rng(42).geometric(0.02, 3000) - 1, 259),
        np.random.default_rng(43).integers(0, 260, 3000), 260),
    # Rows 128..255 hold no edge: a whole empty tile.
    'empty_tile': lambda: _csr(
        np.concatenate([np.arange(100).repeat(3), np.arange(300, 384)
                        .repeat(2)]),
        np.random.default_rng(44).integers(0, 384, 468), 384),
    'no_edges': lambda: (np.zeros(201, np.int64), np.zeros(0, np.int64)),
    'cycle': lambda: cycle_graph(9),
}


def _bits(a):
    a = np_of(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_plans_equal(got, ref, names):
    for name in names:
        a, b = np.asarray(getattr(ref, name)), np_of(getattr(got, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('chunk', [128, 'auto'])
def test_edge_maps_bit_exact(graph, chunk):
    rowptr, col = GRAPHS[graph]()
    ref = jchunked.build_spmm_plan(rowptr, col, chunk=chunk,
                                   with_edge_maps=True)
    got = ops.build_spmm_plan(rowptr, col, chunk=chunk, with_edge_maps=True,
                              device='cpu')
    _assert_plans_equal(got, ref, ('col_padded', 'tile_ptr', 'edge_perm',
                                   'edge_pos', 'row_padded', 'valid_mask'))
    plain = ops.build_spmm_plan(rowptr, col, chunk=chunk, device='cpu')
    assert plain.edge_perm is None and plain.valid_mask is None


# A dedup sum plan needs edges: 'no_edges' goes with dedup='off' only.
@pytest.mark.parametrize('graph,dedup', [(g, d) for g in GRAPHS
                                         for d in ('off', 'on')
                                         if g != 'no_edges' or d == 'off'])
@pytest.mark.parametrize('minmax', ['off', 'auto', 'on'])
def test_minmax_plans_bit_exact(graph, minmax, dedup):
    rowptr, col = GRAPHS[graph]()
    ref = jops.build_spmm_graph(rowptr, col, minmax=minmax, dedup=dedup)
    got = ops.build_spmm_graph(rowptr, col, minmax=minmax, dedup=dedup,
                               device='cpu')
    assert type(got.mm).__name__ == type(ref.mm).__name__
    if isinstance(ref.mm, jdm.DedupMinmaxPlan):
        _assert_plans_equal(got.mm, ref.mm,
                            ('uniq_cols', 'edge_meta', 'chunk_tile'))
        for k in ('num_rows', 'num_edges', 'ec', 'uc', 'scan_len'):
            assert getattr(got.mm, k) == getattr(ref.mm, k), k
    elif ref.mm is not None:
        _assert_plans_equal(got.mm, ref.mm, ('col_padded', 'tile_ptr',
                                             'chunk_tile'))


def test_dedup_pairs_and_config_match_jax():
    for graph in ('powerlaw', 'ragged', 'uniform'):
        rowptr, col = GRAPHS[graph]()
        rp_j, cl_j = jdm.dedup_pairs(rowptr, col)
        rp_t, cl_t = ops.dedup_pairs(rowptr, col)
        np.testing.assert_array_equal(rp_t, rp_j)
        np.testing.assert_array_equal(cl_t, cl_j)
        assert ops.estimate_minmax_config(rp_t, cl_t) == \
            jdm.estimate_minmax_config(rp_j, cl_j)


def _spmm_pair(graph_j, graph_t, x, reduce, cot):
    ref = jops.spmm(jnp.asarray(x), graph_j, reduce)
    gref = jax.grad(lambda v: (jops.spmm(v, graph_j, reduce) * cot).sum())(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = ops.spmm(xt, graph_t, reduce)
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    return np.asarray(ref), out.detach(), np.asarray(gref), grad.numpy()


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('minmax', ['off', 'auto', 'on'])
@pytest.mark.parametrize('reduce', ['max', 'min'])
@pytest.mark.parametrize('f', [47, 128])
def test_spmm_minmax_and_grad_match_jax(graph, minmax, reduce, f):
    rowptr, col = GRAPHS[graph]()
    n = rowptr.shape[0] - 1
    x = features(45, n, f)
    cot = features(46, n, f)
    graph_j = jops.build_spmm_graph(rowptr, col, minmax=minmax)
    graph_t = ops.build_spmm_graph(rowptr, col, minmax=minmax, device='cpu')
    ref, out, gref, grad = _spmm_pair(graph_j, graph_t, x, reduce, cot)
    assert out.dtype == torch.float32 and out.shape == (n, f)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('reduce', ['max', 'min'])
def test_spmm_minmax_on_a_dedup_graph(reduce):
    # dedup='on' with minmax='auto' where the dedup min/max plan would not
    # pay (300 rows over 20,000 columns: hardly a column repeats in a
    # tile): the min/max schedule is a chunked plan of its own.
    rng = np.random.default_rng(55)
    rowptr, col = _csr(rng.integers(0, 300, 4800),
                       rng.integers(0, 20000, 4800), 300)
    x, cot = features(47, 20000, 16), features(48, 300, 16)
    kw = dict(dedup='on', minmax='auto', num_cols=20000)
    graph_j = jops.build_spmm_graph(rowptr, col, **kw)
    graph_t = ops.build_spmm_graph(rowptr, col, device='cpu', **kw)
    assert isinstance(graph_t.mm, ops.SpmmPlan)
    ref, out, gref, grad = _spmm_pair(graph_j, graph_t, x, reduce, cot)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)
    no_mm = ops.build_spmm_graph(rowptr, col, dedup='on', num_cols=20000,
                                 device='cpu')
    with pytest.raises(ValueError, match="minmax='auto'/'on'"):
        ops.spmm(torch.from_numpy(x), no_mm, reduce)


@pytest.mark.parametrize('graph', ['ragged', 'empty_tile', 'powerlaw'])
@pytest.mark.parametrize('name', ['segment_max_padded',
                                  'segment_min_padded'])
def test_segment_padded_and_grad_match_jax(graph, name):
    rowptr, col = GRAPHS[graph]()
    plan_j = jchunked.build_spmm_plan(rowptr, col, chunk=128,
                                      with_edge_maps=True)
    plan_t = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                                 device='cpu')
    e_pad = plan_t.col_padded.shape[0]
    x = features(49, e_pad, 24)
    cot = features(50, plan_t.num_rows, 24)
    fn_j, fn_t = getattr(jops, name), getattr(ops, name)
    # The JAX package's VJP forward gives an empty row 0, as the port
    # does; its plain primal leaves such a row at -inf (ROADMAP Queue 3).
    ref, vjp = jax.vjp(lambda v: fn_j(v, plan_j), jnp.asarray(x))
    (gref, ) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out = fn_t(xt, plan_t)
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_array_equal(_bits(out.detach()), _bits(ref))
    primal = np.asarray(fn_j(jnp.asarray(x), plan_j))
    empty = np.diff(rowptr) == 0
    assert empty.any() == (graph != 'powerlaw')
    np.testing.assert_array_equal(_bits(primal[~empty]),
                                  _bits(np.asarray(ref)[~empty]))
    assert np.isinf(primal[empty]).all()
    np.testing.assert_allclose(grad.numpy(), np.asarray(gref), rtol=RTOL,
                               atol=ATOL)


def _tie_values(seed, n, f):
    rng = np.random.default_rng(seed)
    v = rng.choice(np.float32([-2.0, -0.0, 0.0, 1.0, -np.inf]), size=(n, f))
    v[::7] = -np.inf  # rows of -inf only
    return v


def test_neg_inf_rows_match_jax():
    # Every edge of some rows reads an all -inf source row.
    rowptr, col = GRAPHS['ragged']()
    x = features(51, 260, 8)
    x[col[:40]] = -np.inf
    for minmax in ('off', 'on'):
        graph_j = jops.build_spmm_graph(rowptr, col, minmax=minmax)
        graph_t = ops.build_spmm_graph(rowptr, col, minmax=minmax,
                                       device='cpu')
        for reduce in ('max', 'min'):
            ref = jops.spmm(jnp.asarray(x), graph_j, reduce)
            out = ops.spmm(torch.from_numpy(x), graph_t, reduce)
            np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert np.isneginf(np.asarray(ref)).any()


@pytest.mark.parametrize('values', ['normal', 'ties'])
def test_plain_k5_matches_pallas_kernel(values):
    # The JAX package's own interpreter case: 260 nodes, Zipf(1.3).
    rng = np.random.default_rng(4)
    row = rng.integers(0, 260, 2000)
    p = 1.0 / np.arange(1, 261)**1.3
    rowptr, col = _csr(row, rng.choice(260, 2000, p=p / p.sum()), 260)
    plan_j = jdm.build_dedup_minmax_plan(rowptr, col, ec=128, uc=32)
    plan_t = ops.build_dedup_minmax_plan(rowptr, col, ec=128, uc=32,
                                         device='cpu')
    x = (features(52, 260, 128) if values == 'normal' else
         _tie_values(53, 260, 128))
    for negate in (True, False):
        xi = -x if negate else x
        ref = jdm.dedup_minmax_apply(jnp.asarray(xi), plan_j, interpret=True)
        got = ops.dedup_minmax(torch.from_numpy(x), plan_t, negate)
        np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    # Any float dtype is read as f32.
    got = ops.dedup_minmax_apply(torch.from_numpy(x).double(), plan_t)
    np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))


def test_minmax_options_refused():
    rowptr, col = GRAPHS['uniform']()
    with pytest.raises(ValueError, match='minmax must be'):
        ops.build_spmm_graph(rowptr, col, minmax='sometimes', device='cpu')
    with pytest.raises(ValueError, match='with_edge_maps'):
        ops.build_spmm_graph(rowptr, col, dedup='on', with_edge_maps=True,
                             device='cpu')
    # 2**21 rows of 8 distinct columns reach 2**24 unique slots.
    n_big = 1 << 21
    big_rp = np.arange(n_big + 1, dtype=np.int64) * 8
    big_cl = (np.repeat(np.arange(n_big, dtype=np.int64), 8) +
              np.tile(np.arange(8, dtype=np.int64), n_big)) % n_big
    with pytest.raises(ValueError, match='too large'):
        ops.build_dedup_minmax_plan(big_rp, big_cl, ec=8, uc=8,
                                    _pre_deduped=True, device='cpu')


def test_cpu_wrappers_do_not_count_launches():
    rowptr, col = GRAPHS['powerlaw']()
    x = torch.from_numpy(features(54, 300, 8))
    counts = (ops.segment_max_kernel.launches, ops.dedup_minmax.launches,
              ops.segment_sum_csr_kernel.launches)
    for minmax in ('off', 'on'):
        graph = ops.build_spmm_graph(rowptr, col, minmax=minmax,
                                     device='cpu')
        ops.spmm(x, graph, 'max')
    ops.segment_sum_csr(x, torch.arange(0, 301))
    assert (ops.segment_max_kernel.launches, ops.dedup_minmax.launches,
            ops.segment_sum_csr_kernel.launches) == counts


def _k5_case(values):
    """The inputs of test_plain_k5_matches_pallas_kernel, and values of
    -0.0 and +0.0 alone (every row's maximum is a zero: its sign is that
    of the least slot's) or with ±inf."""
    rng = np.random.default_rng(4)
    row = rng.integers(0, 260, 2000)
    p = 1.0 / np.arange(1, 261)**1.3
    rowptr, col = _csr(row, rng.choice(260, 2000, p=p / p.sum()), 260)
    if values == 'normal':
        x = features(52, 260, 128)
    elif values == 'ties':
        x = _tie_values(53, 260, 128)
    elif values == 'zeros':
        x = np.where(np.random.default_rng(56).random((260, 128)) < 0.5,
                     np.float32(-0.0), np.float32(0.0))
    else:  # 'inf'
        x = np.random.default_rng(57).choice(
            np.float32([np.inf, -np.inf, 1.0, -1.0]), size=(260, 128))
    return rowptr, col, x


@pytest.mark.parametrize('values', ['normal', 'ties', 'zeros', 'inf'])
@pytest.mark.parametrize('seg', [1, 3, 'default'])
def test_k5_schedule_matches_pallas_kernel(values, seg):
    # K5's schedule (units of at most `seg` chunks a tile, the least slot
    # among each row's maxima with its own bits, the units' ordered merge)
    # against the interpreted _dedup_minmax_tpu, bit for bit.
    from pyg_lib_tpu_torch.ops.kernels import spmm_dedup_minmax as tdm
    rowptr, col, x = _k5_case(values)
    plan_j = jdm.build_dedup_minmax_plan(rowptr, col, ec=128, uc=32)
    plan_t = ops.build_dedup_minmax_plan(rowptr, col, ec=128, uc=32,
                                         device='cpu')
    seg = tdm.K5_SEG if seg == 'default' else seg
    cut = tdm.k5_units(plan_t, seg)
    tiles = plan_t.chunk_tile.numpy()
    assert (cut.num_parts > 0) == (np.bincount(tiles).max() > seg)
    for negate in (True, False):
        xi = -x if negate else x
        ref = jdm.dedup_minmax_apply(jnp.asarray(xi), plan_j, interpret=True)
        got = tdm.dedup_minmax_split(torch.from_numpy(x), plan_t, negate,
                                     seg)
        np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    if values == 'zeros':  # winners of both signs, each its slot's own
        win = _bits(got[0])[np.asarray(ref[1]) < tdm.POS_NONE]
        assert (win == 0).any() and (win == np.int32(-2**31)).any()


def test_k5_tables_need_slot_order_within_a_row():
    # K5 takes the first of equal values as it walks a row's edges: the
    # plan gives them in increasing slot, and the derived tables refuse a
    # chunk that does not.
    from pyg_lib_tpu_torch.ops.kernels import spmm_dedup_minmax as tdm
    rowptr, col, _ = _k5_case('normal')
    plan = ops.build_dedup_minmax_plan(rowptr, col, ec=128, uc=32,
                                       device='cpu')
    cut = tdm.k5_units(plan)
    meta = plan.edge_meta.numpy()
    real = meta[:, 0, :] < 128
    np.testing.assert_array_equal(cut.chunks.numpy()[:, 0], real.sum(1))
    np.testing.assert_array_equal(
        cut.chunks.numpy()[:, 1],
        np.where(real, meta[:, 1, :], -1).max(1) + 1)
    # a chunk whose first row has two edges
    c = int(np.nonzero(real[:, 1] & (meta[:, 0, 0] == meta[:, 0, 1]))[0][0])
    bad = plan.edge_meta.clone()
    bad[c, 1, [0, 1]] = bad[c, 1, [1, 0]]
    with pytest.raises(ValueError, match='slot order'):
        tdm.k5_units(plan._replace(edge_meta=bad))


@pytest.mark.parametrize('seg', [1, 2, 8])
def test_k5_units_cover_every_tile_in_order(seg):
    from pyg_lib_tpu_torch.ops.kernels import spmm_dedup_minmax as tdm
    rowptr, col = GRAPHS['powerlaw']()
    t_rp, t_cl = _csr(col, np.repeat(np.arange(300), np.diff(rowptr)), 300)
    plan = ops.build_dedup_minmax_plan(t_rp, t_cl, ec=128, uc=32,
                                       device='cpu')
    cut = tdm.k5_units(plan, seg)
    units = cut.units.numpy()
    counts = np.bincount(plan.chunk_tile.numpy(),
                         minlength=-(-plan.num_rows // 128))
    # Every chunk once, in order; a tile of more than `seg` chunks cut into
    # units of `seg`, each with its own partial, merged by one entry.
    np.testing.assert_array_equal(units[1:, 1], units[:-1, 2])
    assert units[0, 1] == 0 and units[-1, 2] == plan.num_chunks
    assert (units[:, 2] - units[:, 1] <= seg).all()
    np.testing.assert_array_equal(np.bincount(units[:, 0]),
                                  np.maximum(-(-counts // seg), 1))
    cut_tiles = np.nonzero(counts > seg)[0]
    assert cut.num_parts == int((units[:, 3] >= 0).sum())
    np.testing.assert_array_equal(cut.merges.numpy()[:, 0], cut_tiles)
    assert (units[units[:, 3] < 0, 0] == np.setdiff1d(
        np.arange(counts.shape[0]), cut_tiles)).all()
    if seg == 1:
        assert len(cut_tiles) > 0
    x = torch.from_numpy(features(58, 300, 16))
    got = tdm.dedup_minmax_split(x, plan, False, seg)
    ref = ops.dedup_minmax_plain(x, plan)
    np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
