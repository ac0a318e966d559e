"""The port's attention primitives against the JAX package, on the CPU:
K6's plain version, ``segment_softmax_padded``, ``segment_sum_padded``,
``sddmm`` and ``softmax_csr``, with their gradients.

Inputs come from ``np.random.default_rng`` and go through both packages.
Tolerances:

* K6's plain version against the Pallas kernel run in the interpreter:
  rtol 5e-5 / atol 1e-7 in f32. Measured: at most 1.5e-5 relative (at
  the shapes below). The interpreter runs the kernel's arithmetic: a row
  max rounded to bf16 (which cancels between numerator and denominator)
  and row sums through the bf16 hi/lo ``split_dot``, about 2**-16 of
  each sum. In bf16 one bf16 step more, at most 2**-7 of the value;
* everything else against the JAX package's CPU path: f32 rtol 1e-5 /
  atol 1e-4, as for ``spmm`` (summation order only), except where the
  JAX side runs the K6 interpreter (then K6's tolerance above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyg_lib_tpu_torch.ops.softmax as tsoftmax
from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.ops.pallas import spmm_chunked as jchunked
from pyg_lib_tpu.ops.pallas.segment_softmax_kernel import (
    segment_softmax_planned as jax_k6)
from pyg_lib_tpu_torch import ops
from test_torch_spmm import ATOL, RTOL, features, np_of

K6_RTOL, K6_ATOL = 5e-5, 1e-7
BF16_STEP = 2.0**-7  # one bf16 step: two near values may round apart


def _csr(seed, n, e):
    rng = np.random.default_rng(seed)
    deg = rng.multinomial(e, np.ones(n) / n)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    return rowptr, rng.integers(0, n, size=e).astype(np.int64)


def _plans(rowptr, col, chunk=256):
    return (jchunked.build_spmm_plan(rowptr, col, chunk=chunk,
                                     with_edge_maps=True),
            ops.build_spmm_plan(rowptr, col, chunk=chunk,
                                with_edge_maps=True, device='cpu'))


def _ref_softmax(src, rowptr):
    ref = np.zeros_like(src)
    for r in range(len(rowptr) - 1):
        lo, hi = rowptr[r], rowptr[r + 1]
        if hi > lo:
            ex = np.exp(src[lo:hi] - src[lo:hi].max(0))
            ref[lo:hi] = ex / ex.sum(0)
    return ref


# The JAX package's own shapes (tests/test_segment_softmax_planned.py),
# then an attention layer's widths: 1 and 4 heads.
SHAPES = [(300, 5000, 128), (64, 300, 128), (1, 7, 128), (100, 0, 128),
          (300, 5000, 1), (300, 5000, 4)]


@pytest.mark.parametrize('n,e,f', SHAPES)
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_plain_k6_matches_pallas_kernel(n, e, f, dtype):
    rowptr, col = _csr(0, n, e)
    plan_j, plan_t = _plans(rowptr, col)
    e_pad = plan_t.col_padded.shape[0]
    src = (np.random.default_rng(1).normal(size=(e, f)) * 5).astype(
        np.float32)
    xp = src[np.asarray(plan_j.edge_perm)] if e else np.zeros((e_pad, f),
                                                              np.float32)
    xj, xt = jnp.asarray(xp), torch.from_numpy(xp)
    if dtype == 'bf16':
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    ref = np.asarray(jax_k6(xj, plan_j, interpret=True).astype(jnp.float32))
    got = ops.segment_softmax_plain(xt, plan_t)
    assert got.shape == (e_pad, f) and got.dtype == xt.dtype
    got = np_of(got)
    valid = np.asarray(plan_j.valid_mask)
    assert not got[~valid].any()  # pad slots are 0
    tol = K6_RTOL * np.abs(ref) + K6_ATOL
    if dtype == 'bf16':
        tol = tol + BF16_STEP * np.abs(ref)
    assert np.all(np.abs(got - ref) <= tol)
    if e:  # and against numpy on the same (rounded) inputs
        used = np_of(xt)[np.asarray(plan_t.edge_pos)]
        np.testing.assert_allclose(got[np.asarray(plan_t.edge_pos)],
                                   _ref_softmax(used, rowptr),
                                   rtol=2e-3 if dtype == 'f32' else 1e-2,
                                   atol=1e-6)


def test_plain_k6_extreme_rows():
    # Rows far above and far below the rest must neither overflow nor
    # underflow (the JAX package's test_planned_softmax_extreme_values).
    rng = np.random.default_rng(1)
    n, e, f = 16, 256, 128
    rowptr = np.arange(n + 1, dtype=np.int64) * (e // n)
    src = rng.normal(size=(e, f)).astype(np.float32)
    src[:16] += 200.0
    src[16:32] -= 200.0
    plan_j, plan_t = _plans(rowptr, np.zeros(e, np.int64))
    xp = src[np.asarray(plan_j.edge_perm)]
    ref = np.asarray(jax_k6(jnp.asarray(xp), plan_j, interpret=True))
    got = ops.segment_softmax_plain(torch.from_numpy(xp), plan_t).numpy()
    assert np.all(np.abs(got - ref) <= K6_RTOL * np.abs(ref) + K6_ATOL)
    out = got[np.asarray(plan_t.edge_pos)]
    np.testing.assert_allclose(out, _ref_softmax(src, rowptr), rtol=1e-5,
                               atol=1e-7)
    for r in range(n):
        np.testing.assert_allclose(out[rowptr[r]:rowptr[r + 1]].sum(0), 1.0,
                                   rtol=1e-5)


@pytest.mark.parametrize('f', [1, 4, 47])
def test_plain_k6_index_mode_is_the_padded_mode_unpermuted(f):
    rowptr, col = _csr(2, 200, 3000)
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device='cpu')
    src = torch.from_numpy(features(3, 3000, f))
    padded = ops.segment_softmax_plain(src[plan.edge_perm.long()], plan)
    direct = ops.segment_softmax_plain(src, plan, plan.edge_perm)
    assert direct.shape == src.shape
    torch.testing.assert_close(direct, padded[plan.edge_pos.long()], rtol=0,
                               atol=0)


def test_minus_inf_rows_follow_the_composite():
    # -inf at a row's first slot: the TPU kernel (interpreted) turns whole
    # chunk columns into NaN there; the port follows the XLA composite,
    # which gives 0 beside a finite maximum and NaN for a row of -inf.
    rowptr = np.array([0, 3, 6, 10, 12], np.int64)
    src = features(4, 12, 4)
    src[3, 0] = -np.inf  # first slot of row 1
    src[7, 1] = -np.inf  # inside row 2
    src[10:12, 2] = -np.inf  # a row of -inf in column 2
    ref = np.asarray(jops.softmax_csr(jnp.asarray(src), jnp.asarray(rowptr)))
    assert np.isnan(ref[10:12, 2]).all() and ref[3, 0] == 0.0
    plan = ops.build_spmm_plan(rowptr, np.zeros(12, np.int64), chunk=128,
                               with_edge_maps=True, device='cpu')
    t_src = torch.from_numpy(src)
    padded = ops.segment_softmax_plain(t_src[plan.edge_perm.long()], plan)
    for got in (padded[plan.edge_pos.long()],
                ops.segment_softmax_plain(t_src, plan, plan.edge_perm),
                ops.softmax_csr(t_src, torch.from_numpy(rowptr))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL,
                                   equal_nan=True)


def _padded_case(seed, f):
    rowptr, col = _csr(seed, 150, 2000)
    rowptr[40:60] = rowptr[40]  # a run of empty rows
    col = col[:rowptr[-1]]
    graph_j = jops.build_spmm_graph(rowptr, col, chunk=128,
                                    with_edge_maps=True)
    graph_t = ops.build_spmm_graph(rowptr, col, chunk=128,
                                   with_edge_maps=True, device='cpu')
    e_pad = graph_t.fwd.col_padded.shape[0]
    return graph_j, graph_t, features(seed + 1, e_pad, f)


@pytest.mark.parametrize('f', [4, 32])
def test_segment_softmax_padded_and_grad_match_jax(f):
    graph_j, graph_t, xp = _padded_case(5, f)
    cot = features(7, xp.shape[0], f)
    ref, vjp = jax.vjp(lambda a: jops.segment_softmax_padded(a, graph_j.fwd),
                       jnp.asarray(xp))
    (gref, ) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(xp).requires_grad_()
    out = ops.segment_softmax_padded(xt, graph_t.fwd)
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    ref, gref = np.asarray(ref), np.asarray(gref)
    assert np.all(np.abs(out.detach().numpy() - ref) <=
                  K6_RTOL * np.abs(ref) + K6_ATOL)
    # out * (g - Σ out·g): K6's relative error times |g| ~ 1.
    np.testing.assert_allclose(grad.numpy(), gref, rtol=K6_RTOL, atol=1e-5)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_segment_sum_padded_and_grad_match_jax(dtype):
    graph_j, graph_t, xp = _padded_case(8, 24)
    cot = features(9, graph_t.fwd.num_rows, 24)
    xj = jnp.asarray(xp)
    xt = torch.from_numpy(xp)
    if dtype == 'bf16':
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    ref, vjp = jax.vjp(lambda a: jops.segment_sum_padded(a, graph_j.fwd), xj)
    (gref, ) = vjp(jnp.asarray(cot))
    xt.requires_grad_()
    out = ops.segment_sum_padded(xt, graph_t.fwd)
    assert out.dtype == torch.float32
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    # The JAX package's cotangent keeps f32 values for a bf16 input; the
    # port rounds it to the input's type.
    assert grad.dtype == xt.dtype
    np.testing.assert_allclose(np_of(grad),
                               np.asarray(gref.astype(jnp.float32)),
                               rtol=0 if dtype == 'f32' else 2.0**-8, atol=0)
    assert not np_of(grad)[~np.asarray(graph_j.fwd.valid_mask)].any()


def test_sddmm_and_grad_match_jax():
    graph_j, graph_t, _ = _padded_case(10, 1)
    n = graph_t.fwd.num_rows
    x, y = features(11, n, 16), features(12, n, 16)
    cot = features(13, graph_t.fwd.num_edges, 1)[:, 0]
    ref, vjp = jax.vjp(lambda a, b: jops.sddmm(a, b, graph_j),
                       jnp.asarray(x), jnp.asarray(y))
    grefs = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    out = ops.sddmm(xt, yt, graph_t)
    assert out.shape == (graph_t.fwd.num_edges, )
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                (xt, yt))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    for got, want in zip(grads, grefs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_padded_primitives_need_edge_maps():
    rowptr, col = _csr(14, 50, 300)
    graph = ops.build_spmm_graph(rowptr, col, chunk=128, device='cpu')
    x = torch.zeros((graph.fwd.col_padded.shape[0], 4))
    for fn in (ops.segment_sum_padded, ops.segment_softmax_padded):
        with pytest.raises(ValueError, match='with_edge_maps'):
            fn(x, graph.fwd)
    with pytest.raises(ValueError, match='with_edge_maps'):
        ops.sddmm(x[:50], x[:50], graph)


def _softmax_pair(src, rowptr, dim, cot):
    ref, vjp = jax.vjp(lambda a: jops.softmax_csr(a, jnp.asarray(rowptr),
                                                  dim), jnp.asarray(src))
    (gref, ) = vjp(jnp.asarray(cot))
    st = torch.from_numpy(src).requires_grad_()
    out = ops.softmax_csr(st, torch.from_numpy(rowptr), dim)
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), st)
    return np.asarray(ref), out.detach().numpy(), np.asarray(gref), \
        grad.numpy()


@pytest.mark.parametrize('case', ['dim0', 'dim1', 'trailing_pad',
                                  'leading_gap', 'empty_groups'])
def test_softmax_csr_and_grad_match_jax(case):
    rowptr, _ = _csr(15, 40, 500)
    e = int(rowptr[-1])
    shape, dim = (e, 6), 0
    if case == 'dim1':
        shape, dim = (3, e, 5), 1
    elif case == 'trailing_pad':
        shape = (e + 9, 6)  # 9 positions past ptr[-1]
    elif case == 'leading_gap':
        rowptr = rowptr + 5
        shape = (e + 5, 6)
    elif case == 'empty_groups':
        rowptr[10:20] = rowptr[10]
        shape = (e, 6)
    src = features(16, int(np.prod(shape)), 1).reshape(shape)
    cot = features(17, int(np.prod(shape)), 1).reshape(shape)
    ref, out, gref, grad = _softmax_pair(src, rowptr, dim, cot)
    assert out.shape == shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


def test_softmax_csr_planned_path_matches_jax(monkeypatch):
    # The planned path (K6 through edge_perm; its plain version here)
    # forced at a small size, against the JAX composite.
    monkeypatch.setattr(tsoftmax, '_PLANNED_MIN_EDGES', 8)
    taken = []
    real = tsoftmax.segment_softmax_planned
    monkeypatch.setattr(tsoftmax, 'segment_softmax_planned',
                        lambda *a: taken.append(1) or real(*a))
    rowptr, _ = _csr(18, 300, 4000)
    rowptr[100:130] = rowptr[100]
    for f in (1, 4, 47):
        src = features(19 + f, 4000, f)
        cot = features(20 + f, 4000, f)
        ref, out, gref, grad = _softmax_pair(src, rowptr, 0, cot)
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)
    assert len(taken) == 3
    # Trailing pad, a leading gap, dim 1 and 3-D src keep the composite.
    src = torch.zeros((4005, 4))
    assert tsoftmax._planned_ptr(src, rowptr, 0) is None
    assert tsoftmax._planned_ptr(src[:4000], rowptr + 5, 0) is None
    assert tsoftmax._planned_ptr(src[:4000], rowptr, 1) is None
    assert tsoftmax._planned_ptr(src[:4000, None], rowptr, 0) is None
    assert tsoftmax._planned_ptr(src[:4000], rowptr, 0) is not None


def test_softmax_csr_rejects_bad_dim():
    with pytest.raises(ValueError, match='dim'):
        ops.softmax_csr(torch.zeros((5, 2)), torch.tensor([0, 5]), dim=2)


def _hub_case(seed=21):
    """190 short rows (a third empty) and row 90 of 2,500 edges: longer
    than several of K6's stretches at every stretch tested."""
    rng = np.random.default_rng(seed)
    deg = rng.geometric(0.15, 190) - 1
    deg[rng.random(190) < 0.33] = 0
    deg[90] = 2500
    rowptr = np.zeros(191, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    return rowptr, rng.integers(0, 190, int(rowptr[-1])).astype(np.int64)


STRETCHES = [32, 96, 256]


def _split_tol(plan_t, ref):
    """K6's tolerance, with the interpreter's relative term."""
    n = np.zeros(ref.shape[0], np.float32)
    lo = np.asarray(plan_t.tile_ptr[:, 0, :129]).astype(np.int64)
    for t in range(lo.shape[0]):
        for r in range(128):
            n[lo[t, r]:lo[t, r + 1]] = lo[t, r + 1] - lo[t, r]
    return (K6_RTOL + n[:, None] * 2.0**-23) * np.abs(ref) + K6_ATOL


@pytest.mark.parametrize('f', [1, 4, 47])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_k6_schedule_matches_jax_on_hub_rows(f, dtype):
    # K6's schedule (stretches of slots, groups of 32, rows cut by
    # stretch ends merged in order) against the interpreted Pallas kernel,
    # in the padded mode and through edge_perm.
    from pyg_lib_tpu_torch.ops.kernels import segment_softmax as tk6
    rowptr, col = _hub_case()
    plan_j, plan_t = _plans(rowptr, col, chunk=128)
    e = col.shape[0]
    src = (np.random.default_rng(22).normal(size=(e, f)) * 5).astype(
        np.float32)
    xp = src[np.asarray(plan_j.edge_perm)]
    xj, xt, st = jnp.asarray(xp), torch.from_numpy(xp), torch.from_numpy(src)
    if dtype == 'bf16':
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
        st = st.to(torch.bfloat16)
    ref = np.asarray(jax_k6(xj, plan_j, interpret=True).astype(jnp.float32))
    tol = _split_tol(plan_t, ref)
    if dtype == 'bf16':
        tol = tol + BF16_STEP * np.abs(ref)
    pos = np.asarray(plan_t.edge_pos)
    for stretch in STRETCHES:
        cut = tk6.k6_cut(plan_t, stretch).numpy()
        assert cut.shape[0] > 0 and (cut[:, 2] - cut[:, 1]).max() >= 3
        got = tk6.segment_softmax_split(xt, plan_t, None, stretch)
        assert got.dtype == xt.dtype
        got = np_of(got)
        assert not np.isnan(got).any() and not got[
            ~np.asarray(plan_j.valid_mask)].any()
        assert np.all(np.abs(got - ref) <= tol)
        direct = np_of(tk6.segment_softmax_split(st, plan_t,
                                                 plan_t.edge_perm, stretch))
        assert np.all(np.abs(direct - ref[pos]) <= tol[pos])


@pytest.mark.parametrize('stretch', STRETCHES)
def test_k6_schedule_minus_inf_rows_follow_the_composite(stretch):
    # -inf in the hub row and in short rows, a row of -inf in column 2:
    # NaN exactly where the JAX composite has it, 0 beside a finite max.
    from pyg_lib_tpu_torch.ops.kernels import segment_softmax as tk6
    rowptr, col = _hub_case(23)
    e = col.shape[0]
    src = features(24, e, 4)
    src[::7, 0] = -np.inf
    hub = slice(rowptr[90], rowptr[91])
    src[hub, 1] = -np.inf
    src[rowptr[90] + 1300, 1] = 0.5  # the hub row's only finite value
    short = int(np.nonzero(np.diff(rowptr) >= 2)[0][0])
    src[rowptr[short]:rowptr[short + 1], 2] = -np.inf
    ref = np.asarray(jops.softmax_csr(jnp.asarray(src), jnp.asarray(rowptr)))
    assert np.isnan(ref).any()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device='cpu')
    got = tk6.segment_softmax_split(torch.from_numpy(src), plan,
                                    plan.edge_perm, stretch).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                               equal_nan=True)
    assert got[rowptr[90] + 1300, 1] == 1.0


@pytest.mark.parametrize('stretch', STRETCHES)
def test_k6_tables(stretch):
    from pyg_lib_tpu_torch.ops.kernels import segment_softmax as tk6
    rowptr, col = _hub_case()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device='cpu')
    rows = tk6.k6_rows(plan).numpy()
    deg = np.diff(rowptr)
    # The non-empty rows' bounds, in slot order, as the plan's edge_pos
    # places their edges.
    assert rows.shape == (2, int((deg > 0).sum()))
    pos = np.asarray(plan.edge_pos)
    starts = pos[rowptr[:-1][deg > 0]]
    np.testing.assert_array_equal(rows[0], starts)
    np.testing.assert_array_equal(rows[1] - rows[0], deg[deg > 0])
    assert (rows[0, 1:] >= rows[1, :-1]).all()
    cut = tk6.k6_cut(plan, stretch).numpy()
    crosses = rows[0] // stretch != (rows[1] - 1) // stretch
    np.testing.assert_array_equal(cut[:, 0], np.nonzero(crosses)[0])
    np.testing.assert_array_equal(cut[:, 1], rows[0, crosses] // stretch)
    np.testing.assert_array_equal(cut[:, 2],
                                  (rows[1, crosses] - 1) // stretch)
    assert tk6.k6_stretch(10**6, 132) % 32 == 0
    assert tk6.k6_stretch(100, 132) == tk6.K6_MIN_STRETCH
    with pytest.raises(ValueError, match='multiple of 32'):
        tk6.segment_softmax_split(torch.zeros((rows[1, -1], 1)), plan,
                                  None, 48)
