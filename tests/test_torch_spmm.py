"""The port's chunked plan, K1's plain version and ``spmm`` against the
JAX package, on the CPU.

Inputs come from ``np.random.default_rng`` as explicit f32/int64 arrays
and go through both packages. Tolerances:

* plans: bit for bit;
* the plain K1 against the Pallas kernel run in the interpreter: 2e-3,
  the JAX package's own tolerance for its kernel tests, because the
  interpreter runs the kernel's bf16 hi/lo ``split_dot`` arithmetic;
* ``spmm`` and its gradient against the JAX package's CPU path: f32
  rtol 1e-5 / atol 1e-4, for the summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.ops.pallas import spmm_chunked as jchunked
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.ops.kernels import spmm_chunked as tchunked
from pyg_lib_tpu_torch.testing import cycle_graph

RTOL, ATOL = 1e-5, 1e-4
KERNEL_TOL = 2e-3


def _csr(row, col, n):
    order = np.argsort(row, kind='stable')
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=rowptr[1:])
    return rowptr, col[order].astype(np.int64)


def uniform_graph(seed, n, e):
    rng = np.random.default_rng(seed)
    return _csr(rng.integers(0, n, e), rng.integers(0, n, e), n)


def powerlaw_graph(seed, n, e, alpha=1.2):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n + 1)**alpha
    p /= p.sum()
    return _csr(rng.integers(0, n, e), rng.choice(n, size=e, p=p), n)


def features(seed, n, f):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(
        np.float32)


def np_of(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a)


GRAPHS = {
    'uniform': lambda: uniform_graph(0, 300, 4000),
    'powerlaw': lambda: powerlaw_graph(1, 300, 4000),
    'skewed_rows': lambda: _csr(
        np.minimum(np.random.default_rng(2).geometric(0.02, 3000) - 1, 259),
        np.random.default_rng(3).integers(0, 260, 3000), 260),
    'cycle': lambda: cycle_graph(7),
}


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('chunk', [128, 256, 'auto'])
def test_plan_bit_exact(graph, chunk):
    rowptr, col = GRAPHS[graph]()
    ref = jchunked.build_spmm_plan(rowptr, col, chunk=chunk)
    got = ops.build_spmm_plan(rowptr, col, chunk=chunk, device='cpu')
    for name in ('col_padded', 'chunk_tile', 'tile_ptr', 'tile_shift'):
        a, b = np.asarray(getattr(ref, name)), np_of(getattr(got, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.num_rows, got.num_edges, got.chunk) == (
        ref.num_rows, ref.num_edges, ref.chunk)
    assert ops.auto_chunk(rowptr) == jchunked.auto_chunk(rowptr)


def test_quantize_columns_bit_exact():
    x = features(4, 200, 40)
    x[:, 3] = 0.0  # an all-zero column gets scale 1
    x[0, 5] = 2.5 * np.abs(x[:, 5]).max()  # ties and a dominant entry
    xq_j, s_j = jchunked.quantize_columns(jnp.asarray(x))
    xq_t, s_t = ops.quantize_columns(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(s_j), s_t.numpy())
    np.testing.assert_array_equal(np.asarray(xq_j), xq_t.numpy())
    assert xq_t.dtype == torch.int8


@pytest.mark.parametrize('graph', ['uniform', 'powerlaw'])
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_plain_k1_matches_pallas_kernel(graph, precision):
    rowptr, col = GRAPHS[graph]()
    x = features(5, 300, 128)
    plan_j = jchunked.build_spmm_plan(rowptr, col, chunk=128)
    plan_t = ops.build_spmm_plan(rowptr, col, chunk=128, device='cpu')
    ref = jchunked.spmm_plan_apply(jnp.asarray(x), plan_j, interpret=True,
                                   precision=precision)
    got = ops.spmm_plan_apply(torch.from_numpy(x), plan_t,
                              precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_plain_k1_reduction_matches_pallas_kernel():
    # The reduction alone, on the padded message slab the kernel reads.
    rowptr, col = GRAPHS['powerlaw']()
    plan_j = jchunked.build_spmm_plan(rowptr, col, chunk=256)
    plan_t = ops.build_spmm_plan(rowptr, col, chunk=256, device='cpu')
    e_pad = plan_t.col_padded.shape[0]
    msgs = features(6, e_pad, 64)
    ref = jchunked.segment_sum_chunked(jnp.asarray(msgs), plan_j,
                                       interpret=True)
    got = tchunked.segment_sum_chunked_plain(torch.from_numpy(msgs), plan_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)


def _grad_pair(x, graph_j, graph_t, reduce, precision, cot):
    ref = jops.spmm(jnp.asarray(x), graph_j, reduce, precision)
    gref = jax.grad(lambda v: (jops.spmm(v, graph_j, reduce, precision) *
                               cot).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = ops.spmm(xt, graph_t, reduce, precision)
    (grad, ) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    return np.asarray(ref), out.detach().numpy(), np.asarray(gref), \
        grad.numpy()


@pytest.mark.parametrize('dedup', ['off', 'on', 'auto'])
@pytest.mark.parametrize('reduce', ['sum', 'mean'])
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_spmm_and_grad_match_jax(dedup, reduce, precision):
    rowptr, col = GRAPHS['powerlaw']()
    x = features(7, 300, 32)
    cot = features(8, 300, 32)
    graph_j = jops.build_spmm_graph(rowptr, col, dedup=dedup)
    graph_t = ops.build_spmm_graph(rowptr, col, dedup=dedup, device='cpu')
    assert type(graph_t.fwd).__name__ == type(graph_j.fwd).__name__
    assert type(graph_t.bwd).__name__ == type(graph_j.bwd).__name__
    ref, out, gref, grad = _grad_pair(x, graph_j, graph_t, reduce,
                                      precision, cot)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


def test_spmm_rectangular_and_auto_chunk():
    # A bipartite adjacency: 150 destination rows over 400 source nodes.
    rng = np.random.default_rng(9)
    rowptr, col = _csr(rng.integers(0, 150, 2500),
                       rng.integers(0, 400, 2500), 150)
    x = features(10, 400, 24)
    cot = features(11, 150, 24)
    graph_j = jops.build_spmm_graph(rowptr, col, chunk='auto', num_cols=400)
    graph_t = ops.build_spmm_graph(rowptr, col, chunk='auto', num_cols=400,
                                   device='cpu')
    ref, out, gref, grad = _grad_pair(x, graph_j, graph_t, 'sum', None, cot)
    assert grad.shape == (400, 24)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, gref, rtol=RTOL, atol=ATOL)


def test_cycle_graph_hand_computed():
    rowptr, col = cycle_graph(6)
    x = torch.arange(6, dtype=torch.float32)[:, None]
    graph = ops.build_spmm_graph(rowptr, col, device='cpu')
    out = ops.spmm(x, graph, reduce='mean')[:, 0]
    expect = [((v - 1) % 6 + (v + 1) % 6) / 2 for v in range(6)]
    np.testing.assert_array_equal(out.numpy(), np.float32(expect))


def test_cpu_wrappers_do_not_count_launches():
    rowptr, col = GRAPHS['uniform']()
    graph = ops.build_spmm_graph(rowptr, col, device='cpu')
    before = ops.spmm_chunked.launches
    ops.spmm(torch.from_numpy(features(12, 300, 8)), graph)
    assert ops.spmm_chunked.launches == before


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


def _k1_schedule(x, plan, cut):
    """K1's schedule with PyTorch: a row that is not cut as the plain
    version sums it; a cut row as the sum, in order, of its pieces'
    sums."""
    terms = x[plan.col_padded.long()].float()
    out = ops.spmm_chunked_plain(x, plan)
    for row, first, count in cut.rows.tolist():
        acc = torch.zeros(x.shape[1])
        for _, lo, hi in cut.pieces[first:first + count].tolist():
            acc = acc + terms[lo:hi].sum(0)
        out[row] = acc
    return out


@pytest.mark.parametrize('long_len', [1, 64, 512])
@pytest.mark.parametrize('graph', ['hub', 'powerlaw_transpose'])
def test_k1_pieces_cut_long_rows_and_match_pallas_kernel(monkeypatch,
                                                         long_len, graph):
    if graph == 'hub':
        rowptr, col = _hub_graph()
    else:  # the transpose of a Zipf graph: hub rows of hundreds of edges
        rp, cl = GRAPHS['powerlaw']()
        rowptr, col = _csr(cl, np.repeat(np.arange(300), np.diff(rp)), 300)
    plan_j = jchunked.build_spmm_plan(rowptr, col, chunk=128)
    plan_t = ops.build_spmm_plan(rowptr, col, chunk=128, device='cpu')
    monkeypatch.setattr(tchunked, 'K1_LONG', long_len)
    cut = tchunked.k1_pieces(plan_t)
    # Every row of more than K1_LONG slots, and no other, is listed; its
    # pieces hold its slots in order, at most K1_LONG each.
    bounds = plan_t.tile_ptr[:, 0, :].long()
    runs = [(int(bounds[r // 128, r % 128]), int(bounds[r // 128,
                                                        r % 128 + 1]))
            for r in range(300)]
    long_rows = [r for r, (lo, hi) in enumerate(runs) if hi - lo > long_len]
    assert long_rows and len(long_rows) < 300
    assert cut.rows[:, 0].tolist() == long_rows
    assert cut.rows[:, 1].tolist() == np.concatenate(
        [[0], np.cumsum(cut.rows[:, 2].numpy())[:-1]]).tolist()
    assert int(cut.rows[:, 2].sum()) == cut.pieces.shape[0]
    for row, first, count in cut.rows.tolist():
        got = []
        for q_row, lo, hi in cut.pieces[first:first + count].tolist():
            assert q_row == row and 0 < hi - lo <= long_len
            got += range(lo, hi)
        assert got == list(range(*runs[row]))
    assert tchunked.k1_pieces(plan_t) is cut  # cached per plan
    # The schedule's sums against the Pallas kernel in the interpreter.
    x = features(5, 300, 16)
    ref = np.asarray(jchunked.spmm_plan_apply(jnp.asarray(x), plan_j,
                                              interpret=True))
    got = _k1_schedule(torch.from_numpy(x), plan_t, cut).numpy()
    assert np.all(np.abs(got - ref) <= KERNEL_TOL * (1 + np.abs(ref)))
