"""``gather_rows``: the padded-batch models' row gather
``x[row.clamp(max=N-1)]``, whose backward on the card is a stable sort of
the source rows and a merge-path segment sum read through the sort's
permutation (``csrc/gather_rows.cu``).

On the CPU: the card's schedule (``gather_rows_backward_split``: the sort,
then K3's stretches and in-order partials) against autograd's gradient of
the indexing, and the op and its callers (``sage_forward``,
``gcn_forward``) against the indexing bit for bit in PyTorch's
deterministic mode, since the CPU keeps PyTorch's backward. On the card
(marker ``cuda``, skipped without one): the kernel against the same
gradient, and bit for bit against itself; an ``x`` of any rank through
it, another dtype refused, a second derivative refused.
The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_rows.py

Inputs come from ``np.random.default_rng``; every cotangent is random,
the pad entries' included. Tolerance against the f64 gradient: the
schedule and the kernel add the same f32 terms in another order, so
``|got - ref| <= 1e-5 * Σ|terms| + 1e-5``, and a bf16 result, rounded
once, one bf16 step more (``2**-8 * |ref|``).
"""

import numpy as np
import pytest
import torch

from pyg_lib_tpu_torch import profiling, sampler
from pyg_lib_tpu_torch.models import gnn
from pyg_lib_tpu_torch.ops.kernels import gather_rows as gr

SUM_RTOL, SUM_ATOL = 1e-5, 1e-5
KINDS = ['no_pads', 'pads20', 'hub', 'empty_rows', 'all_pad']


def _rows(kind):
    """``(row, n)``: ``row`` of ``x``'s ``n`` rows, ``row == n`` a pad
    entry. ``hub``: one row read by 12,000 entries; ``empty_rows``: two
    thirds of the rows read by none, some entries negative (counted from
    the end, as indexing counts them)."""
    rng = np.random.default_rng(KINDS.index(kind))
    n, e = 300, 3000
    row = rng.integers(0, n, e)
    if kind == 'pads20':
        row[rng.random(e) < 0.2] = n
    elif kind == 'hub':
        row = np.concatenate([row, np.full(12000, 137)])
        row = row[rng.permutation(len(row))]
        row[rng.random(len(row)) < 0.1] = n
    elif kind == 'empty_rows':
        row = rng.integers(0, n // 3, e) * 3
        row[rng.random(e) < 0.1] -= n
    elif kind == 'all_pad':
        row[:] = n
    return torch.tensor(row), n


def _case(kind, f, dtype, device='cpu'):
    """``(x, row, g)``: ``x [n, f]`` and the cotangent ``g [E, f]`` in
    ``dtype``."""
    row, n = _rows(kind)
    rng = np.random.default_rng(f)
    x = torch.tensor(rng.normal(size=(n, f)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(len(row), f)), dtype=torch.float32)
    return (x.to(dtype).to(device), row.to(device), g.to(dtype).to(device))


def _reference(x, row, g):
    """Autograd's gradient of ``x[row.clamp(max=N-1)]`` in f64, and the
    same of ``|g|`` (``Σ|terms|``), on the CPU."""
    xd = x.detach().cpu().double().requires_grad_()
    idx = row.cpu().clamp(max=x.shape[0] - 1)
    ref, = torch.autograd.grad(xd[idx], xd, g.cpu().double())
    mag, = torch.autograd.grad(xd[idx], xd, g.cpu().double().abs())
    return ref, mag


def _within(got, ref, mag):
    tol = SUM_RTOL * mag + SUM_ATOL
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * ref.abs()
    return bool(((got.cpu().double() - ref).abs() <= tol).all())


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('f', [1, 47, 100, 256])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('units', [1, 7, 64])
def test_split_schedule_matches_the_gradient(kind, f, dtype, units):
    x, row, g = _case(kind, f, dtype)
    n = x.shape[0]
    idx = row.clamp(max=n - 1)
    got = gr.gather_rows_backward_split(g, idx, n, units)
    assert got.dtype == dtype and got.shape == x.shape
    assert _within(got, *_reference(x, row, g))
    assert torch.equal(got, gr.gather_rows_backward_split(g, idx, n, units))


@pytest.mark.parametrize('kind', KINDS)
def test_sorted_segments_group_each_row_in_entry_order(kind):
    row, n = _rows(kind)
    idx = row.clamp(max=n - 1)
    perm, indptr = gr.sorted_segments(idx, n)
    assert indptr.dtype == torch.int64 and indptr.shape == (n + 1,)
    assert int(indptr[0]) == 0 and int(indptr[-1]) == len(row)
    rows = idx.remainder(n)
    for r in range(0, n, 7):
        seg = perm[indptr[r]:indptr[r + 1]]
        assert torch.equal(seg, torch.nonzero(rows == r).flatten())


@pytest.fixture
def deterministic():
    """PyTorch's CPU backward of ``x[idx]`` adds f32 rows with atomics on
    several threads from 32,768 elements on, in an order that changes from
    run to run; its deterministic mode adds them in entry order."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_the_op_on_the_cpu_is_the_indexing_bit_for_bit(deterministic, kind,
                                                       dtype):
    x, row, g = _case(kind, 47, dtype)
    ref_x = x.clone().requires_grad_()
    ref = ref_x[row.clamp(max=x.shape[0] - 1)]
    ref.backward(g)
    grads = []
    for _ in range(2):
        xg = x.clone().requires_grad_()
        out = gr.gather_rows(xg, row)
        assert torch.equal(out, ref)
        out.backward(g)
        grads.append(xg.grad)
    assert torch.equal(grads[0], ref_x.grad)
    assert torch.equal(grads[0], grads[1])


def test_an_x_without_gradient_is_plain_indexing():
    x, row, _ = _case('pads20', 5, torch.float32)
    before = gr.gather_rows_backward.launches
    out = gr.gather_rows(x, row)
    assert not out.requires_grad and out.grad_fn is None
    assert torch.equal(out, x[row.clamp(max=x.shape[0] - 1)])
    with torch.no_grad():
        assert gr.gather_rows(x.requires_grad_(), row).grad_fn is None
    assert gr.gather_rows_backward.launches == before


class _Ctx:
    """What the card's backward reads of autograd's context."""

    def __init__(self, idx, shape):
        self.saved_tensors, self.shape = (idx, ), torch.Size(shape)


@pytest.mark.parametrize('shape', [(40, ), (40, 3, 5)])
def test_the_card_backward_views_x_as_rows_once_differentiable(shape):
    # _sorted_backward is the card's backward; on CPU tensors the
    # gather_rows_backward it calls is the plain one, so its view of x as
    # [N, -1] and its refusal of a second derivative run here.
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=gen, requires_grad=True)
    row = torch.randint(0, shape[0] + 1, (90, ), generator=gen)
    out = gr.gather_rows(x, row)
    g = torch.randn(out.shape, generator=gen, requires_grad=True)
    want, = torch.autograd.grad(out, x, g, create_graph=True)
    assert want.requires_grad  # the CPU's plain backward keeps its graph
    ctx = _Ctx(row.clamp(max=shape[0] - 1), shape)
    got = gr._sorted_backward(ctx, g.detach())
    assert got.shape == x.shape and torch.equal(got, want.detach())
    twice = gr._sorted_backward(ctx, g)
    with pytest.raises(RuntimeError, match='differentiate twice'):
        twice.sum().backward()


def _padded_batch():
    """A padded batch of a seeded random graph as the loader pads it:
    ``(rowptr, row, num_nodes)``, with node slots and trailing pad edges
    (``row`` = the node slots) past ``rowptr[-1]``."""
    rng = np.random.default_rng(3)
    n, deg = 2000, 12
    rowptr = np.arange(0, n * deg + 1, deg, dtype=np.int64)
    col = rng.integers(0, n, n * deg).astype(np.int64)
    out = sampler.neighbor_sample(rowptr, col, np.arange(0, n, 40), [10, 5],
                                  rng=5)
    b = sampler.padding.pad_sample_output(out, 2048, 4096, num_seeds=50)
    assert b.num_edges < 4096 and b.num_nodes < 2048
    return (torch.tensor(b.rowptr), torch.tensor(b.row), len(b.node_id))


def _old_gather(x, row):
    return x[row.clamp(max=x.shape[0] - 1)]


@pytest.mark.parametrize('model', ['sage', 'gcn'])
def test_callers_parameter_gradients_are_unchanged(deterministic,
                                                   monkeypatch, model):
    rowptr, row, slots = _padded_batch()
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((slots, 16), generator=gen)
    init = gnn.init_sage if model == 'sage' else gnn.init_gcn
    fwd = gnn.sage_forward if model == 'sage' else gnn.gcn_forward
    params = init([16, 12, 4], torch.Generator().manual_seed(2), 'cpu')
    leaves = [t.requires_grad_() for layer in params['layers']
              for t in layer.values()]
    cot = torch.randn((slots, 4), generator=gen)

    def grads():
        out = fwd(params, x, rowptr, row)
        return torch.autograd.grad(out, leaves, cot)

    new = grads()
    monkeypatch.setattr(gnn, '_gather_src', _old_gather)
    old = grads()
    assert all(torch.equal(a, b) for a, b in zip(new, old))


# -- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('f', [1, 47, 100, 256])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_matches_the_gradient_on_the_card(dev, kind, f, dtype):
    x, row, g = _case(kind, f, dtype, dev)
    n = x.shape[0]
    idx = row.clamp(max=n - 1)
    before = gr.gather_rows_backward.launches
    got = gr.gather_rows_backward(g, idx, n)
    again = gr.gather_rows_backward(g, idx, n)
    torch.cuda.synchronize()
    assert gr.gather_rows_backward.launches == before + 2
    assert got.dtype == dtype and got.shape == x.shape
    assert _within(got, *_reference(x, row, g))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_the_op_takes_the_sorted_path_on_the_card(dev, monkeypatch):
    x, row, g = _case('hub', 256, torch.float32, dev)
    xg = x.clone().requires_grad_()
    before = gr.gather_rows_backward.launches
    profiling.clear_spans()
    # The backward runs on autograd's device thread, which recording()
    # does not reach: every span records for the test's length instead.
    monkeypatch.setattr(profiling.span, 'always', True)
    gr.gather_rows(xg, row).backward(g)
    torch.cuda.synchronize()
    assert gr.gather_rows_backward.launches == before + 1
    sp = [s for s in profiling.spans() if s.name == 'ops.gather.backward']
    assert [s.attrs for s in sp] == [{'path': 'sorted',
                                      'edge_slots': row.numel(),
                                      'rows': x.shape[0]}]
    assert _within(xg.grad, *_reference(x, row, g))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(300, ), (300, 4, 6)])
def test_any_rank_takes_the_sorted_path_on_the_card(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(shape, generator=gen, device=dev, requires_grad=True)
    row = torch.randint(0, shape[0] + 1, (5000, ), generator=gen,
                        device=dev)
    out = gr.gather_rows(x, row)
    g = torch.randn(out.shape, generator=gen, device=dev)
    before = gr.gather_rows_backward.launches
    out.backward(g)
    torch.cuda.synchronize()
    assert gr.gather_rows_backward.launches == before + 1
    flat = x.detach().reshape(shape[0], -1)
    got = x.grad.reshape(shape[0], -1)
    assert _within(got, *_reference(flat, row, g.reshape(len(row), -1)))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float16])
def test_a_dtype_the_kernel_does_not_take_raises_on_the_card(dev, dtype):
    x, row, g = _case('pads20', 8, torch.float32, dev)
    xg = x.to(dtype).requires_grad_()
    with pytest.raises(ValueError, match='f32/bf16'):
        gr.gather_rows(xg, row).backward(g.to(dtype))


@pytest.mark.cuda
def test_a_second_derivative_raises_on_the_card(dev):
    x, row, g = _case('hub', 16, torch.float32, dev)
    xg = x.clone().requires_grad_()
    gg = g.clone().requires_grad_()
    grad, = torch.autograd.grad(gr.gather_rows(xg, row), xg, gg,
                                create_graph=True)
    with pytest.raises(RuntimeError, match='differentiate twice'):
        grad.sum().backward()
