"""K4s's plain version, its piece schedule and the port's
``fused_scatter_reduce`` against the JAX package, on the CPU.

Inputs come from ``np.random.default_rng`` and go through both packages.
Tolerances:

* values and winner positions of the max/min pass: bit for bit;
* K4s's sums against the Pallas kernel run in the interpreter: rtol 1e-3,
  atol 1e-4, the JAX package's own tolerance for its fused path
  (``tests/test_op_matrix.py``), because the interpreter runs the
  kernel's bf16 hi/lo ``split_dot`` arithmetic; against the XLA fallback
  and between the port's schedules, ``1e-5 * Σ|terms| + 1e-5`` (the order
  of the additions only);
* ``fused_scatter_reduce``: against JAX's fused path rtol 1e-3, atol 1e-4
  (its sums come from the same fallback as above in this process, but the
  tolerance is its own test's); min and max exactly; gradients rtol 1e-4,
  atol 1e-4 as in the JAX package's test, and exactly where each is one
  term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyg_lib_tpu.ops.scatter_reduce as jsr
from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.ops.pallas import segment_minmax_kernel as jmk
from pyg_lib_tpu.ops.pallas import spmm_chunked as jchunked
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.ops import scatter_reduce as tsr
from pyg_lib_tpu_torch.ops.kernels import segment_minmax as tmk
from test_torch_spmm import _csr

SUM_RTOL, SUM_ATOL = 1e-5, 1e-5
KERNEL_RTOL, KERNEL_ATOL = 1e-3, 1e-4
LISTS = [['sum', 'max'], ['mean', 'min'], ['sum', 'mean', 'min', 'max']]


def _ragged(seed=0, n=300, e=3000):
    """Geometric row degrees: empty rows, a few long ones, a partial last
    tile."""
    rng = np.random.default_rng(seed)
    return _csr(np.minimum(rng.geometric(0.02, e) - 1, n - 1),
                rng.integers(0, n, e), n)


def _hub():
    """Row 7 of 1,300 edges: cut into three pieces of ``K4_LONG``."""
    rng = np.random.default_rng(1)
    deg = rng.integers(0, 6, 200)
    deg[7] = 1300
    rowptr = np.zeros(201, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    return rowptr, rng.integers(0, 200, int(rowptr[-1]))


def _values(kind, rows, f, seed):
    rng = np.random.default_rng(seed)
    if kind == 'ties':  # repeated values, both zeros, -inf
        v = rng.choice(np.array([-2.0, -0.0, 0.0, 1.0, -np.inf],
                                np.float32), (rows, f))
        v[::7] = -np.inf
        return v
    return rng.normal(size=(rows, f)).astype(np.float32)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _plans(rowptr, col, chunk=128):
    return (jchunked.build_spmm_plan(rowptr, col, chunk=chunk,
                                     with_edge_maps=True),
            ops.build_spmm_plan(rowptr, col, chunk=chunk,
                                with_edge_maps=True, device='cpu'))


def _sum_bound(src, plan, idx, negate=False):
    """``SUM_RTOL * Σ|terms| + SUM_ATOL`` of each row's sum."""
    return SUM_RTOL * tmk.segment_max_plain(src.abs(), plan, idx,
                                            with_sum=True)[2] + SUM_ATOL


@pytest.mark.parametrize('values', ['normal', 'ties'])
@pytest.mark.parametrize('negate', [False, True])
@pytest.mark.parametrize('f', [1, 47])
def test_plain_k4s_matches_pallas_kernel(values, negate, f):
    jplan, tplan = _plans(*_ragged())
    e_pad = tplan.col_padded.shape[0]
    x = _values(values, e_pad, f, f + 3 * negate)
    xj = -jnp.asarray(x) if negate else jnp.asarray(x)
    ref = jmk._minmax_padded(xj, jplan.chunk_tile, jplan.tile_ptr,
                             jplan.num_rows, jplan.chunk, True, True)
    got = tmk.segment_max_plain(torch.tensor(x), tplan, None, negate,
                                with_sum=True)
    np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    if values == 'normal':
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    else:
        # The interpreted kernel's bf16 hi/lo split turns -inf into NaN
        # for every row of its chunk (ROADMAP Queue 3); the sums are held
        # against the XLA fallback, which keeps -inf.
        xla = np.asarray(jmk._minmax_padded_xla(
            xj, jplan.chunk_tile, jplan.tile_ptr, jplan.num_rows,
            jplan.chunk, with_sum=True)[2])
        assert np.isnan(np.asarray(ref[2])).any()
        np.testing.assert_array_equal(got[2].numpy(), xla)
    # The sum-less K4's values and positions are the same, bit for bit.
    plain = tmk.segment_max_plain(torch.tensor(x), tplan, None, negate)
    np.testing.assert_array_equal(_bits(got[0]), _bits(plain[0]))
    np.testing.assert_array_equal(got[1].numpy(), plain[1].numpy())


@pytest.mark.parametrize('graph', ['ragged', 'hub'])
@pytest.mark.parametrize('negate', [False, True])
def test_plain_k4s_matches_xla_fallback_through_edge_perm(graph, negate):
    rowptr, col = _ragged() if graph == 'ragged' else _hub()
    jplan, tplan = _plans(rowptr, col)
    x = _values('normal', col.shape[0], 8, 5)
    xp = jnp.take(jnp.asarray(x), jplan.edge_perm, axis=0)
    ref = jmk._minmax_padded_xla(-xp if negate else xp, jplan.chunk_tile,
                                 jplan.tile_ptr, jplan.num_rows, jplan.chunk,
                                 with_sum=True)
    xt = torch.tensor(x)
    got = tmk.segment_max_plain(xt, tplan, tplan.edge_perm, negate,
                                with_sum=True)
    empty = np.asarray(ref[1]) == tmk.POS_NONE
    assert empty.any() and not empty.all()
    np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    bound = _sum_bound(xt, tplan, tplan.edge_perm).numpy()
    assert (np.abs(got[2].numpy() - np.asarray(ref[2])) <= bound).all()
    assert (got[2].numpy()[empty] == 0).all()


@pytest.mark.parametrize('graph', ['ragged', 'hub'])
@pytest.mark.parametrize('values', ['normal', 'ties'])
@pytest.mark.parametrize('mode', ['padded', 'edge_perm'])
def test_k4s_piece_schedule_matches_plain(graph, values, mode):
    rowptr, col = _ragged() if graph == 'ragged' else _hub()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device='cpu')
    if graph == 'hub':
        assert tmk.k4_pieces(plan).rows.shape[0] == 1
    idx = None if mode == 'padded' else plan.edge_perm
    rows = plan.col_padded.shape[0] if idx is None else col.shape[0]
    src = torch.tensor(_values(values, rows, 5, 9))
    for negate in (False, True):
        got = tmk.segment_max_split(src, plan, idx, negate, with_sum=True)
        ref = tmk.segment_max_plain(src, plan, idx, negate, with_sum=True)
        np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
        finite = torch.isfinite(ref[2])
        assert torch.equal(got[2][~finite], ref[2][~finite])
        bound = _sum_bound(src.masked_fill(~torch.isfinite(src), 0), plan,
                           idx)
        assert bool(((got[2] - ref[2]).abs()[finite] <= bound[finite]).all())
        two = tmk.segment_max_split(src, plan, idx, negate)
        assert len(two) == 2 and torch.equal(two[1], got[1])


def test_cpu_wrapper_runs_plain_k4s_without_counting():
    plan = ops.build_spmm_plan(*_ragged(), chunk=128, with_edge_maps=True,
                               device='cpu')
    src = torch.tensor(_values('normal', plan.col_padded.shape[0], 3, 2))
    before = (ops.segment_max_kernel.launches,
              ops.segment_max_kernel.sum_launches)
    got = ops.segment_max_kernel(src, plan, with_sum=True)
    ref = tmk.segment_max_plain(src, plan, with_sum=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (ops.segment_max_kernel.launches,
            ops.segment_max_kernel.sum_launches) == before


def _fused_case(tail=False, gaps=False, seed=0, n_rows=600, f=128,
                dim_size=40):
    rng = np.random.default_rng(seed)
    ids = np.arange(dim_size)
    if gaps:  # every third bucket empty
        ids = ids[ids % 3 != 1]
    idx = np.sort(rng.choice(ids, n_rows))
    if tail:  # ids past dim_size: dropped forward, NaN gradient in JAX
        idx[-5:] = dim_size + np.arange(5)
    return idx, rng.normal(size=(n_rows, f)).astype(np.float32), dim_size


@pytest.mark.parametrize('reduces', LISTS, ids='-'.join)
@pytest.mark.parametrize('case', ['plain', 'gaps', 'tail'])
def test_fused_path_matches_jax(reduces, case):
    idx, x, dim_size = _fused_case(tail=case == 'tail', gaps=case == 'gaps')
    jf = jsr._fused(idx, dim_size, tuple(reduces))
    ref = np.asarray(jf(jnp.asarray(x)))
    tf = tsr._fused(idx, dim_size, tuple(reduces))
    xt = torch.tensor(x, requires_grad=True)
    out = tf(xt)
    assert out.shape == (dim_size, len(reduces) * x.shape[1])
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=KERNEL_RTOL,
                               atol=KERNEL_ATOL)
    f = x.shape[1]
    for bi, r in enumerate(reduces):  # min and max bit for bit
        if r in ('min', 'max'):
            blk = slice(bi * f, (bi + 1) * f)
            np.testing.assert_array_equal(_bits(out.detach()[:, blk]),
                                          _bits(ref[:, blk]))
    cot = np.random.default_rng(7).normal(size=ref.shape).astype(np.float32)
    gj = jax.grad(lambda a: (jf(a) * jnp.asarray(cot)).sum())(
        jnp.asarray(x))
    (gt, ) = torch.autograd.grad((out * torch.tensor(cot)).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4)
    if case == 'tail' and 'sum' in reduces:
        assert np.isnan(gt.numpy()[-5:]).all()
    # The port's fused path against its own composite.
    comp = ops.fused_scatter_reduce(xt.detach(), torch.tensor(idx), dim_size,
                                    reduces)
    np.testing.assert_allclose(out.detach().numpy(), comp.numpy(),
                               rtol=SUM_RTOL, atol=SUM_ATOL)


def test_fused_cache_checks_each_hit():
    idx, _, dim_size = _fused_case(seed=3)
    a = tsr._fused(idx, dim_size, ('sum', 'max'))
    assert tsr._fused(idx.copy(), dim_size, ('sum', 'max')) is a
    assert tsr._fused(idx, dim_size, ('max', 'sum')) is not a
    other = idx.copy()
    other[-1] = dim_size - 1 if idx[-1] != dim_size - 1 else 0
    other.sort()
    assert tsr._fused(other, dim_size, ('sum', 'max')) is not a
    for seed in range(10):  # at most 8 entries
        i, _, d = _fused_case(seed=seed + 10)
        tsr._fused(i, d, ('sum', ))
    assert len(tsr._FUSED_CACHE) <= 8


@pytest.mark.parametrize('reduces', LISTS + [['max'], ['min', 'min']],
                         ids='-'.join)
def test_composite_matches_jax(reduces):
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 30, 200)  # unsorted
    x = rng.normal(size=(200, 6)).astype(np.float32)
    ref = jops.fused_scatter_reduce(jnp.asarray(x), jnp.asarray(idx), 33,
                                    reduces)
    xt = torch.tensor(x, requires_grad=True)
    out = ops.fused_scatter_reduce(xt, idx, 33, reduces)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=SUM_RTOL, atol=SUM_ATOL)
    gj = jax.grad(lambda a: (jops.fused_scatter_reduce(
        a, jnp.asarray(idx), 33, reduces)**2).sum())(jnp.asarray(x))
    (gt, ) = torch.autograd.grad((out**2).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4)


def test_routing_gate(monkeypatch):
    rows = tsr._FUSED_MIN_ROWS
    x = torch.zeros((1, 128)).expand(rows, 128)
    idx = np.repeat(np.arange(rows // 4), 4)
    assert not tsr._use_fused(x, idx)  # a CPU tensor: the composite
    monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda t: True))
    assert tsr._use_fused(x, idx)
    assert tsr._use_fused(x, list(idx)) and tsr._use_fused(x, tuple(idx))
    assert tsr._use_fused(x, torch.tensor(idx))  # a CPU index is a host one
    for bad_x, bad_idx in (
            (x.double(), idx),  # not f32
            (torch.zeros((1, 130)).expand(rows, 130), idx),  # F % 128
            (x[:-4], idx[:-4]),  # too few rows
            (x, idx[:-1]),  # the index is not as long as the rows
            (x, idx[::-1].copy()),  # not sorted
            (torch.zeros((1, 1, 128)).expand(rows, 1, 128), idx)):  # 3-D
        assert not tsr._use_fused(bad_x, bad_idx)


def test_validation_errors():
    x = torch.ones((6, 4))
    idx = torch.tensor([0, 0, 1, 1, 2, 2])
    with pytest.raises(ValueError, match='2-D inputs, 1-D index'):
        ops.fused_scatter_reduce(x[None], idx, 3, ['sum'])
    with pytest.raises(ValueError, match='2-D inputs, 1-D index'):
        ops.fused_scatter_reduce(x, idx[None], 3, ['sum'])
    with pytest.raises(ValueError, match='floating'):
        ops.fused_scatter_reduce(x.long(), idx, 3, ['sum'])
    with pytest.raises(ValueError, match='at most 4'):
        ops.fused_scatter_reduce(x, idx, 3, ['sum'] * 5)
    with pytest.raises(ValueError, match='Unknown reduction'):
        ops.fused_scatter_reduce(x, idx, 3, ['prod'])
