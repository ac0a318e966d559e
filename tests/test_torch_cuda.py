"""The port's CUDA kernels K1, K2 and K2h against their plain versions, on
the card.

Every test here needs an NVIDIA card with ``nvcc`` (marker ``cuda``) and
skips without one. The file imports nothing of JAX, so it also runs where
only the port is installed; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: a kernel and its plain version add the same f32 terms in
another order (K2 with shared-memory atomics, in an order that changes
from run to run), so ``|kernel - plain| <= 1e-5 * Σ|terms| + 1e-5``
elementwise, with ``Σ|terms|`` the plain version's sum of absolute values.
"""

import functools

import numpy as np
import pytest
import torch

from pyg_lib_tpu_torch import ops

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda')


def _csr(row, col, n):
    order = np.argsort(row, kind='stable')
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=rowptr[1:])
    return rowptr, col[order].astype(np.int64)


def _powerlaw(seed, n, e):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n + 1)**1.2
    p /= p.sum()
    return _csr(rng.integers(0, n, e), rng.choice(n, size=e, p=p), n)


# 1,000 rows end in a partial tile; the geometric degrees leave many rows
# empty and give a few long ones. 3,000 rows are 24 tiles, enough for a
# hot level under hot='auto'.
GRAPHS = {
    'ragged': lambda: _csr(
        np.minimum(np.random.default_rng(0).geometric(0.01, 12000) - 1, 999),
        np.random.default_rng(1).integers(0, 1000, 12000), 1000),
    'powerlaw': lambda: _powerlaw(2, 3000, 40000),
    'empty': lambda: (np.zeros(201, np.int64), np.zeros(0, np.int64)),
}


@functools.lru_cache(maxsize=None)
def _plan(kind, device):
    if kind.startswith('k1_'):
        rowptr, col = GRAPHS[kind[3:]]()
        return ops.build_spmm_plan(rowptr, col, chunk=128, device=device)
    graph = 'empty' if kind == 'empty' else 'powerlaw'
    rowptr, col = GRAPHS[graph]()
    w = np.random.default_rng(3).normal(size=col.shape[0]).astype(
        np.float32)
    kw = {
        'plain': dict(ec=256, hot='off'),
        'uc64': dict(ec=128, uc=64, hot='off'),
        'weighted': dict(ec=256, hot='off', edge_weight=w),
        'hot_int8': dict(ec=256),
        'hot_bf16': dict(ec=256),
        'hot_f32_weighted': dict(ec=512, edge_weight=w),
        'empty': dict(ec=128),
    }[kind]
    plan = ops.build_dedup_plan(rowptr, col, device=device, **kw)
    if kind.startswith('hot'):
        want = {'hot_int8': torch.int8, 'hot_bf16': torch.int8,
                'hot_f32_weighted': torch.float32}[kind]
        assert plan.num_hot > 0 and plan.hot_w.dtype == want
    if kind == 'hot_bf16':
        plan = plan._replace(hot_w=plan.hot_w.to(torch.bfloat16))
    return plan


def _abs_plan(plan):
    """The plan with |weights|: its plain sum over |x| is Σ|terms|."""
    if not isinstance(plan, ops.DedupSpmmPlan) or not plan.weighted:
        return plan
    meta = plan.edge_meta.clone()
    meta[:, 2, :] = meta[:, 2, :].view(torch.float32).abs().view(torch.int32)
    hot_w = None if plan.hot_w is None else plan.hot_w.abs()
    return plan._replace(edge_meta=meta, hot_w=hot_w)


def _inputs(n, f, mode, device):
    gen = torch.Generator(device=device).manual_seed(f)
    x = torch.randn((n, f), generator=gen, device=device)
    if mode == 'int8':
        return ops.quantize_columns(x)
    return (x.to(torch.bfloat16) if mode == 'bf16' else x), None


def _check(kernel, plain, xm, plan, scale):
    got = kernel(xm, plan, scale)
    torch.cuda.synchronize()
    ref = plain(xm, plan, scale)
    mag = plain(xm.abs(), _abs_plan(plan),
                None if scale is None else scale.abs())
    assert got.shape == ref.shape == (plan.num_rows, xm.shape[1])
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= RTOL * mag + ATOL).all())


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('f', [1, 47, 300])
@pytest.mark.parametrize('mode', ['f32', 'bf16', 'int8'])
def test_k1_matches_plain(dev, graph, f, mode):
    plan = _plan(f'k1_{graph}', dev)
    xm, scale = _inputs(plan.num_rows, f, mode, dev)
    _check(ops.spmm_chunked, ops.spmm_chunked_plain, xm, plan, scale)


@pytest.mark.parametrize('kind', ['plain', 'uc64', 'weighted', 'hot_int8',
                                  'hot_bf16', 'hot_f32_weighted', 'empty'])
@pytest.mark.parametrize('f', [1, 47, 300])
@pytest.mark.parametrize('mode', ['f32', 'bf16', 'int8'])
def test_k2_matches_plain(dev, kind, f, mode):
    plan = _plan(kind, dev)
    xm, scale = _inputs(plan.num_rows, f, mode, dev)
    _check(ops.dedup_sum, ops.dedup_sum_plain, xm, plan, scale)


@pytest.mark.parametrize('dedup', ['off', 'auto', 'on'])
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_spmm_and_grad_match_cpu(dev, dedup, precision):
    rowptr, col = GRAPHS['powerlaw']()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3000, 40)).astype(np.float32)
    cot = rng.normal(size=(3000, 40)).astype(np.float32)
    outs = []
    for device in ('cpu', dev):
        graph = ops.build_spmm_graph(rowptr, col, dedup=dedup, device=device)
        xt = torch.tensor(x, device=device, requires_grad=True)
        out = ops.spmm(xt, graph, 'mean', precision)
        (grad, ) = torch.autograd.grad(
            (out * torch.tensor(cot, device=device)).sum(), xt)
        outs.append((out.detach().cpu(), grad.cpu()))
    # Row means of at most a few hundred terms of size ~1 (the int8 and
    # bf16 inputs are rounded identically on both devices).
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-4)


def _counts():
    return (ops.spmm_chunked.launches, ops.dedup_sum.launches,
            ops.dedup_sum.hot_launches)


def test_launches_are_counted(dev):
    # At 24 tiles both sides of the power-law graph get a hot level.
    rowptr, col = GRAPHS['powerlaw']()
    g_plain = ops.build_spmm_graph(rowptr, col, device=dev)
    g_hot = ops.build_spmm_graph(rowptr, col, dedup='on', device=dev)
    assert g_hot.fwd.num_hot > 0 and g_hot.bwd.num_hot > 0
    x = torch.randn((3000, 16), device=dev, requires_grad=True)
    for graph, want in ((g_plain, (2, 0, 0)), (g_hot, (0, 0, 2))):
        before = _counts()
        ops.spmm(x, graph).sum().backward()
        assert tuple(a - b for a, b in zip(_counts(), before)) == want
    before = _counts()
    ops.dedup_plan_apply(x.detach(), _plan('plain', dev))
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 1, 0)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rowptr, col = GRAPHS['ragged']()
    plan = _plan('k1_ragged', dev)
    dplan = _plan('plain', dev)
    x = torch.randn((1000, 8), device=dev)
    with pytest.raises(ValueError, match='f32/bf16/int8'):
        ops.spmm_chunked(x.double(), plan)
    with pytest.raises(ValueError, match='contiguous'):
        ops.spmm_chunked(torch.randn((8, 1000), device=dev).t(), plan)
    with pytest.raises(ValueError, match='col_padded'):
        ops.spmm_chunked(x, ops.build_spmm_plan(rowptr, col, chunk=128,
                                                device='cpu'))
    with pytest.raises(ValueError, match='scale'):
        ops.dedup_sum(torch.zeros((3000, 8), dtype=torch.int8, device=dev),
                      dplan, torch.ones(7, device=dev))
    graph = ops.build_spmm_graph(rowptr, col, device='cpu')
    with pytest.raises(ValueError, match='is on'):
        ops.spmm(x, graph)
