"""The port's CUDA kernels K1 (and its ``msgs_padded`` entry), K2, K2h, K3,
K4 (and its row-sum form K4s), K5, K6, K7 and F1 against their plain
versions, on the card, and the paths of the scatter family,
``fused_scatter_reduce``, the padded-batch GAT, ``segment_matmul``,
rectangular dedup ``spmm``, the R-GCN (padded batch and the three
full-graph forms), ``knn``, ``radius``, ``nearest`` and the spline ops
against the CPU; and the distribution layer's halo aggregations and
``collective_feature_fetch`` on the card, in one rank over NCCL and in two
ranks over gloo.

Every test here needs an NVIDIA card with ``nvcc`` (marker ``cuda``) and
skips without one. The file imports nothing of JAX, so it also runs where
only the port is installed; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: a kernel and its plain version add the same f32 terms in
another order (K2 with shared-memory atomics, in an order that changes
from run to run), so ``|kernel - plain| <= 1e-5 * Σ|terms| + 1e-5``
elementwise, with ``Σ|terms|`` the plain version's sum of absolute values.
K3 in bf16 rounds that sum to bf16 once, so one bf16 step of the result,
``2**-8 * |plain|``, is added there. K4 and K5 are exact: values and
positions equal bit for bit (``-0.0`` and ``+0.0`` told apart); K4s's
values and positions are those of K4 bit for bit, and its sums are within
the sum bound (equal where the plain sum is infinite). K7 adds
``w·x`` with a fused multiply-add where its plain version rounds the
product first, inside the same bound. K6 and its plain version compute
each value as ``exp(x - max) / Σ``: the exponentials differ by a few f32
ulps and the sums of a row of ``n`` slots, added in another order, by at
most ``n·2**-24`` of the sum each, so
``|kernel - plain| <= (1e-5 + n·2**-23)·|plain| + 1e-7`` (plus one bf16
step, ``2**-7·|plain|``, in bf16), and NaN exactly where the plain
version has NaN.
"""

import functools

import numpy as np
import pytest
import torch

from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.ops.kernels.segment_softmax import k6_stretch
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup_minmax import K5_SEG

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
    if kind == 'hub_tiles':
        # The transpose of a power-law graph: its hub rows give one tile
        # hundreds of chunks, which the kernel's chunk ranges split at
        # many points.
        rowptr, col = _csr(col, np.repeat(np.arange(3000), np.diff(rowptr)),
                           3000)
    w = np.random.default_rng(3).normal(size=col.shape[0]).astype(
        np.float32)
    kw = {
        'plain': dict(ec=256, hot='off'),
        'uc64': dict(ec=128, uc=64, hot='off'),
        'hub_tiles': dict(ec=128, uc=64, hot='off'),
        'weighted': dict(ec=256, hot='off', edge_weight=w),
        'hot_int8': dict(ec=256),
        'hot_bf16': dict(ec=256),
        'hot_replaced': dict(ec=256),
        'hot_f32_weighted': dict(ec=512, edge_weight=w),
        'hot_inference': dict(ec=256),
        # f32 x leaves room for one slab of 1024 unique rows, not two.
        'one_slab': dict(ec=1024, uc=1024, hot='off'),
        'empty': dict(ec=128),
    }[kind]
    if kind == 'hot_inference':  # no version counters to key the cache on
        with torch.inference_mode():
            plan = ops.build_dedup_plan(rowptr, col, device=device, **kw)
    else:
        plan = ops.build_dedup_plan(rowptr, col, device=device, **kw)
    if kind.startswith('hot'):
        want = {'hot_int8': torch.int8, 'hot_bf16': torch.int8,
                'hot_replaced': torch.int8, 'hot_inference': torch.int8,
                'hot_f32_weighted': torch.float32}[kind]
        assert plan.num_hot > 0 and plan.hot_w.dtype == want
    if kind == 'hub_tiles':
        assert np.bincount(plan.chunk_tile.cpu().numpy()).max() >= 100
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


@pytest.mark.parametrize('kind', ['plain', 'uc64', 'hub_tiles', 'weighted',
                                  'hot_int8', 'hot_bf16', 'hot_replaced',
                                  'hot_f32_weighted', 'hot_inference',
                                  'one_slab', 'empty'])
@pytest.mark.parametrize('f', [1, 47, 300, 600])
@pytest.mark.parametrize('mode', ['f32', 'bf16', 'int8'])
def test_k2_matches_plain(dev, kind, f, mode):
    plan = _plan(kind, dev)
    xm, scale = _inputs(plan.num_rows, f, mode, dev)
    if kind == 'hot_replaced':
        # K2h caches the row list of hot_w's non-zeros: it must follow a
        # hot_w given by _replace after a first call, and one changed in
        # place.
        plan = plan._replace(hot_w=plan.hot_w.clone())
        ops.dedup_sum(xm, plan, scale)
        plan = plan._replace(hot_w=plan.hot_w.roll(37, 0))
        _check(ops.dedup_sum, ops.dedup_sum_plain, xm, plan, scale)
        plan.hot_w[plan.hot_w == 1] = 2
        plan.hot_w[:5] = 1
    if kind == 'hot_inference':
        _check(ops.dedup_sum, ops.dedup_sum_plain, xm, plan, scale)
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
    rp_p, cl_p = GRAPHS['powerlaw']()
    wide = ops.build_dedup_plan(rp_p, cl_p, ec=1504, uc=1504, hot='off',
                                device=dev)
    with pytest.raises(ValueError, match='shared memory'):
        ops.dedup_sum(torch.zeros((3000, 8), device=dev), wide)
    graph = ops.build_spmm_graph(rowptr, col, device='cpu')
    with pytest.raises(ValueError, match='is on'):
        ops.spmm(x, graph)


# -- K3, K4, K5 ---------------------------------------------------------------


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.equal(_bits(g).cpu(), _bits(r).cpu())


def _tie_values(n, f, seed, device):
    """Values with many ties, both zeros and -inf (some rows all -inf)."""
    rng = np.random.default_rng(seed)
    v = rng.choice(np.float32([-2.0, -0.0, 0.0, 1.0, -np.inf]), size=(n, f))
    v[::7] = -np.inf
    return torch.tensor(v, device=device)


def _values(kind, n, f, seed, device):
    if kind == 'ties':
        return _tie_values(n, f, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, f), generator=gen, device=device)


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('f', [1, 47, 300])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('bounds', ['full', 'gap_and_pad'])
def test_k3_matches_plain(dev, graph, f, dtype, bounds):
    rowptr, _ = GRAPHS[graph]()
    e = int(rowptr[-1])
    if bounds == 'gap_and_pad':  # 5 leading positions and 9 trailing ones
        rowptr, e = rowptr + 5, e + 14
    ptr = torch.tensor(rowptr, device=dev)
    gen = torch.Generator(device=dev).manual_seed(f)
    src = torch.randn((e, f), generator=gen, device=dev).to(dtype)
    got = ops.segment_sum_csr_kernel(src, ptr)
    torch.cuda.synchronize()
    ref = ops.segment_sum_csr_plain(src, ptr)
    mag = ops.segment_sum_csr_plain(src.abs().float(), ptr)
    assert got.shape == ref.shape == (rowptr.shape[0] - 1, f)
    assert got.dtype == dtype
    tol = RTOL * mag + ATOL
    if dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * ref.float().abs()
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


def _k4_case(mode, graph, dev):
    rowptr, col = GRAPHS[graph]()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device=dev)
    n = plan.num_rows
    if mode == 'padded':
        return plan, plan.col_padded.shape[0], None
    if mode == 'col_padded':
        return plan, n, plan.col_padded
    return plan, max(col.shape[0], 1), plan.edge_perm


@pytest.mark.parametrize('mode', ['padded', 'col_padded', 'edge_perm'])
@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('f', [1, 47, 300])
@pytest.mark.parametrize('values', ['normal', 'ties'])
@pytest.mark.parametrize('negate', [False, True])
def test_k4_matches_plain(dev, mode, graph, f, values, negate):
    plan, rows, idx = _k4_case(mode, graph, dev)
    src = _values(values, rows, f, f, dev)
    got = ops.segment_max_kernel(src, plan, idx, negate)
    torch.cuda.synchronize()
    _assert_same(got, ops.segment_max_plain(src, plan, idx, negate))


def _hub_csr():
    """2,000 short rows (a third of them empty) and row 700 of 120,000
    edges: K3's warps share the hub row, K4's block splits it."""
    rng = np.random.default_rng(5)
    deg = rng.geometric(0.1, 2000) - 1
    deg[rng.random(2000) < 0.33] = 0
    deg[700] = 120_000
    rowptr = np.zeros(2001, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    return rowptr, rng.integers(0, 2000, int(rowptr[-1]))


def _unaligned(shape, seed, device, values='normal'):
    """A contiguous view one element into its storage: not 16-byte
    aligned, so the kernels take their scalar branch."""
    v = _values(values, shape[0] + 1, shape[1], seed, device)
    return v.reshape(-1)[1:1 + shape[0] * shape[1]].view(shape)


@pytest.mark.parametrize('case', ['hub', 'unaligned'])
@pytest.mark.parametrize('f', [1, 3, 47, 600])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k3_hub_rows_and_alignment(dev, case, f, dtype):
    rowptr, _ = _hub_csr() if case == 'hub' else GRAPHS['ragged']()
    rowptr = rowptr + 3  # a leading gap, and 5 trailing positions
    e = int(rowptr[-1]) + 5
    ptr = torch.tensor(rowptr, device=dev)
    gen = torch.Generator(device=dev).manual_seed(f)
    if case == 'unaligned':  # one element into its storage
        big = torch.randn(e * f + 1, generator=gen, device=dev).to(dtype)
        src = big[1:].view(e, f)
        assert src.data_ptr() % 16 != 0
    else:
        src = torch.randn((e, f), generator=gen, device=dev).to(dtype)
    got = ops.segment_sum_csr_kernel(src, ptr)
    torch.cuda.synchronize()
    ref = ops.segment_sum_csr_plain(src, ptr)
    mag = ops.segment_sum_csr_plain(src.abs().float(), ptr)
    assert got.dtype == dtype and got.shape == ref.shape
    tol = RTOL * mag + ATOL
    if dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * ref.float().abs()
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.parametrize('graph', ['uniform', 'hub'])
def test_k3_same_bits_on_two_calls(dev, graph):
    if graph == 'hub':
        rowptr, _ = _hub_csr()
    else:  # 20,000 rows of 0 to 31 edges
        deg = np.random.default_rng(6).integers(0, 32, 20_000)
        rowptr = np.zeros(20_001, np.int64)
        np.cumsum(deg, out=rowptr[1:])
    ptr = torch.tensor(rowptr, device=dev)
    src = torch.randn((int(rowptr[-1]), 512), device=dev)
    a = ops.segment_sum_csr_kernel(src, ptr)
    b = ops.segment_sum_csr_kernel(src, ptr)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize('case', ['hub', 'unaligned'])
@pytest.mark.parametrize('mode', ['padded', 'col_padded', 'edge_perm'])
@pytest.mark.parametrize('f', [1, 3, 47, 600])
@pytest.mark.parametrize('values', ['normal', 'ties'])
def test_k4_hub_rows_and_alignment(dev, case, mode, f, values):
    # Ties: -inf rows, both zeros and repeated values; the hub CSR and the
    # ragged graph both hold empty rows.
    rowptr, col = _hub_csr() if case == 'hub' else GRAPHS['ragged']()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device=dev)
    rows, idx = {'padded': (plan.col_padded.shape[0], None),
                 'col_padded': (plan.num_rows, plan.col_padded),
                 'edge_perm': (col.shape[0], plan.edge_perm)}[mode]
    if case == 'unaligned':
        src = _unaligned((rows, f), f, dev, values)
        assert src.data_ptr() % 16 != 0
    else:
        src = _values(values, rows, f, f, dev)
    for negate in (False, True):
        got = ops.segment_max_kernel(src, plan, idx, negate)
        torch.cuda.synchronize()
        _assert_same(got, ops.segment_max_plain(src, plan, idx, negate))


@functools.lru_cache(maxsize=None)
def _k5_plan(kind, device):
    if kind == 'empty':
        rowptr, col = GRAPHS['empty']()
    else:
        rowptr, col = GRAPHS['powerlaw']()
    if kind == 'hub_tiles':
        # The transpose of a power-law graph: its hub rows give tiles of
        # many chunks, shared by several blocks.
        rowptr, col = _csr(col, np.repeat(np.arange(3000),
                                          np.diff(rowptr)), 3000)
    ec, uc = {'hub_tiles': (128, 64), 'plain': (256, 96),
              'empty': (128, 64)}[kind]
    plan = ops.build_dedup_minmax_plan(rowptr, col, ec=ec, uc=uc,
                                       device=device)
    if kind == 'hub_tiles':
        # Tiles of more than K5_SEG chunks: cut into units, merged after.
        tiles = plan.chunk_tile.cpu().numpy()
        assert np.bincount(tiles).max() > K5_SEG
    return plan


@pytest.mark.parametrize('kind', ['plain', 'hub_tiles', 'empty'])
@pytest.mark.parametrize('f', [1, 47, 300])
@pytest.mark.parametrize('values', ['normal', 'ties'])
@pytest.mark.parametrize('negate', [False, True])
def test_k5_matches_plain(dev, kind, f, values, negate):
    plan = _k5_plan(kind, dev)
    x = _values(values, 3000 if kind != 'empty' else 200, f, f, dev)
    got = ops.dedup_minmax(x, plan, negate)
    torch.cuda.synchronize()
    _assert_same(got, ops.dedup_minmax_plain(x, plan, negate))


def _k5_values(kind, n, f, device):
    """Both zeros at different slots in either order (-0.0 on even or on
    odd columns, so a row's least winning slot may hold either), or
    values of ±inf and ±1."""
    rng = np.random.default_rng(f)
    if kind == 'inf':
        v = rng.choice(np.float32([np.inf, -np.inf, 1.0, -1.0]), size=(n, f))
    else:
        neg = (np.arange(n) % 2 == 0) == (kind == 'even_neg')
        v = np.where(neg[:, None], np.float32(-0.0), np.float32(0.0))
        v = np.broadcast_to(v, (n, f)).copy()
    return torch.tensor(v, device=device)


@pytest.mark.parametrize('kind', ['plain', 'hub_tiles'])
@pytest.mark.parametrize('values', ['even_neg', 'odd_neg', 'inf'])
@pytest.mark.parametrize('negate', [False, True])
def test_k5_zero_sign_ties_and_inf(dev, kind, values, negate):
    plan = _k5_plan(kind, dev)
    x = _k5_values(values, 3000, 47, dev)
    got = ops.dedup_minmax(x, plan, negate)
    torch.cuda.synchronize()
    ref = ops.dedup_minmax_plain(x, plan, negate)
    _assert_same(got, ref)
    if values != 'inf':  # winners of both signs
        win = _bits(got[0])[got[1] < 1 << 30]
        assert bool((win == 0).any()) and bool((win == -2**31).any())


@pytest.mark.parametrize('kind', ['plain', 'hub_tiles'])
@pytest.mark.parametrize('f', [47, 128, 512])
@pytest.mark.parametrize('where', ['aligned', 'unaligned'])
def test_k5_branches_and_same_bits(dev, kind, f, where):
    # F=128 and 512 aligned take the float4 slab; an x one element into
    # its storage (or F=47) the scalar one. Two calls give the same bits.
    plan = _k5_plan(kind, dev)
    if where == 'unaligned':
        x = _unaligned((3000, f), f, dev, 'ties')
        assert x.data_ptr() % 16 != 0
    else:
        x = _values('ties', 3000, f, f, dev)
    for negate in (False, True):
        got = ops.dedup_minmax(x, plan, negate)
        again = ops.dedup_minmax(x, plan, negate)
        torch.cuda.synchronize()
        _assert_same(got, ops.dedup_minmax_plain(x, plan, negate))
        _assert_same(again, got)


@pytest.mark.parametrize('minmax', ['off', 'on'])
@pytest.mark.parametrize('reduce', ['max', 'min'])
def test_spmm_minmax_and_grad_match_cpu(dev, minmax, reduce):
    rowptr, col = GRAPHS['powerlaw']()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3000, 40)).astype(np.float32)
    cot = rng.normal(size=(3000, 40)).astype(np.float32)
    outs = []
    for device in ('cpu', dev):
        graph = ops.build_spmm_graph(rowptr, col, minmax=minmax,
                                     device=device)
        xt = torch.tensor(x, device=device, requires_grad=True)
        out = ops.spmm(xt, graph, reduce)
        grads = [torch.autograd.grad(
            (out * torch.tensor(c, device=device)).sum(), xt,
            retain_graph=True)[0].cpu() for c in (cot, np.abs(cot))]
        outs.append((out.detach().cpu(), *grads))
    # Exact values; each gradient entry sums the same winners' cotangents
    # in another order, so Σ|terms| is the winners' sum of |cotangent|.
    assert torch.equal(_bits(outs[0][0]), _bits(outs[1][0]))
    mag = outs[0][2]
    assert bool(((outs[1][1] - outs[0][1]).abs() <= RTOL * mag + ATOL).all())


def test_new_kernel_launches_are_counted(dev):
    rowptr, col = GRAPHS['powerlaw']()
    x = torch.randn((3000, 16), device=dev)
    # 10,000 rows of 7: past the planned min/max path's 65,536 edges.
    ptr = torch.arange(0, 70001, 7, device=dev)
    src = torch.randn((70000, 16), device=dev)

    def count():
        return (ops.segment_sum_csr_kernel.launches,
                ops.segment_max_kernel.launches, ops.dedup_minmax.launches)

    cases = [
        (lambda: ops.spmm(x, ops.build_spmm_graph(rowptr, col, device=dev),
                          'max'), (0, 1, 0)),
        (lambda: ops.spmm(x, ops.build_spmm_graph(rowptr, col, minmax='on',
                                                  device=dev), 'min'),
         (0, 0, 1)),
        (lambda: ops.segment_mean_csr(src, ptr), (1, 0, 0)),
        (lambda: ops.segment_max_csr(src, ptr), (0, 1, 0)),
        (lambda: ops.segment_max_csr(src[:60000], ptr[:8572]), (0, 0, 0)),
    ]
    for run, want in cases:
        before = count()
        run()
        assert tuple(a - b for a, b in zip(count(), before)) == want


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    plan, _, _ = _k4_case('col_padded', 'ragged', dev)
    mplan = _k5_plan('plain', dev)
    x = torch.randn((1000, 8), device=dev)
    with pytest.raises(ValueError, match='f32/bf16'):
        ops.segment_sum_csr_kernel(x.double(), torch.zeros(3, device=dev,
                                                           dtype=torch.long))
    with pytest.raises(ValueError, match='float32'):
        ops.segment_max_kernel(x.to(torch.bfloat16), plan, plan.col_padded)
    with pytest.raises(ValueError, match='idx'):
        ops.segment_max_kernel(x, plan, plan.col_padded.long())
    with pytest.raises(ValueError, match='padded src'):
        ops.segment_max_kernel(x[:10], plan)
    with pytest.raises(ValueError, match='contiguous'):
        ops.dedup_minmax(torch.randn((8, 3000), device=dev).t(), mplan)


# -- K6, K1's msgs_padded entry, K7 -------------------------------------------


def _k6_check(got, ref, plan):
    """K6 against its plain version within the bound of the docstring."""
    slot, row = ops.kernels.spmm_chunked._padded_rows(plan.tile_ptr)
    slot, row = slot.cpu(), row.cpu()
    if got.shape[0] != plan.col_padded.shape[0]:  # index mode
        slot = plan.edge_perm.cpu()[slot].long()
    counts = torch.bincount(row, minlength=max(plan.num_rows, 1))
    n = torch.zeros(ref.shape[0])
    n[slot] = counts[row].float()
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float().cpu(), ref.float().cpu()
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    mag = ref.abs().masked_fill(nan, 0.0)
    tol = (1e-5 + n[:, None] * 2.0**-23 + (2.0**-7 if bf16 else 0.0)) * mag
    err = (got - ref).abs().masked_fill(nan, 0.0)
    return bool((err <= tol + 1e-7).all())


def _k6_row_sum_err(got, plan):
    """The largest |sum - 1| over an f32 K6 output's rows, each summed in
    f64 over its slots (rows of no slot and NaN columns left out). A hub
    row's stretch partial dropped or counted twice moves the row's sum by
    that stretch's share, which the per-element bound of n * 2**-23 lets
    through on a long row."""
    slot, row = ops.kernels.spmm_chunked._padded_rows(plan.tile_ptr)
    if got.shape[0] != plan.col_padded.shape[0]:  # index mode
        slot = plan.edge_perm[slot].long()
    sums = torch.zeros((plan.num_rows, got.shape[1]), dtype=torch.float64,
                       device=got.device).index_add_(0, row,
                                                     got[slot].double())
    full = torch.bincount(row, minlength=plan.num_rows) > 0
    return float((sums[full] - 1.0).abs().nan_to_num(0.0).max())


def _k6_values(rows, f, seed, device, dtype):
    gen = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((rows, f), generator=gen, device=device) * 4
    v[::13] += 80.0  # rows far above and far below the rest
    v[5::17] -= 80.0
    v[3::11, 0] = float('-inf')
    return v.to(dtype)


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('f', [1, 4, 47, 512])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', ['padded', 'edge_perm'])
def test_k6_matches_plain(dev, graph, f, dtype, mode):
    rowptr, col = GRAPHS[graph]()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device=dev)
    idx = None if mode == 'padded' else plan.edge_perm
    rows = plan.col_padded.shape[0] if idx is None else max(col.shape[0], 1)
    src = _k6_values(rows, f, f, dev, dtype)
    got = ops.segment_softmax_planned(src, plan, idx)
    torch.cuda.synchronize()
    ref = ops.segment_softmax_plain(src, plan, idx)
    assert got.shape == ref.shape and got.dtype == dtype
    if idx is None:
        pads = ~plan.valid_mask
        assert not bool(got[pads].float().abs().sum())
    assert _k6_check(got, ref, plan)


@pytest.mark.parametrize('mode', ['padded', 'edge_perm'])
@pytest.mark.parametrize('f', [4, 512])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k6_hub_rows(dev, mode, f, dtype):
    # Row 700 of 120,000 edges spans many of K6's stretches: no warp walks
    # more than one stretch of it, and the partials merge in order.
    rowptr, col = _hub_csr()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device=dev)
    e_pad = plan.col_padded.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 120_000 > 8 * k6_stretch(e_pad, sms)
    idx = None if mode == 'padded' else plan.edge_perm
    rows = e_pad if idx is None else col.shape[0]
    src = _k6_values(rows, f, f, dev, dtype)
    got = ops.segment_softmax_planned(src, plan, idx)
    again = ops.segment_softmax_planned(src, plan, idx)
    torch.cuda.synchronize()
    ref = ops.segment_softmax_plain(src, plan, idx)
    assert got.shape == ref.shape and got.dtype == dtype
    if idx is None:
        assert not bool(got[~plan.valid_mask].float().abs().sum())
    assert _k6_check(got, ref, plan)
    if dtype == torch.float32:  # bf16's rounding moves a sum by up to 2^-9
        assert _k6_row_sum_err(got, plan) <= 1e-5
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('f', [1, 47, 300])
@pytest.mark.parametrize('mode', ['f32', 'bf16', 'int8'])
def test_k1_msgs_entry_matches_plain(dev, graph, f, mode):
    plan = _plan(f'k1_{graph}', dev)
    xm, _ = _inputs(plan.col_padded.shape[0], f, mode, dev)
    got = ops.segment_sum_chunked(xm, plan)
    torch.cuda.synchronize()
    ref = ops.segment_sum_chunked_plain(xm, plan)
    mag = ops.segment_sum_chunked_plain(xm.abs(), plan)
    assert got.shape == ref.shape == (plan.num_rows, f)
    assert bool(((got - ref).abs() <= RTOL * mag + ATOL).all())


def _k7_plan(kind, device):
    if kind == 'empty':
        rowptr, col = GRAPHS['empty']()
        return ops.build_fused_range_plan(rowptr, col, 200, 4, chunk=128,
                                          device=device), 200
    rowptr, col = GRAPHS['powerlaw']()
    w = np.random.default_rng(6).normal(size=col.shape[0]).astype(np.float32)
    if kind == 'skewed':  # ranges 0 and 3 only, each empty in half the tiles
        row = np.repeat(np.arange(3000), np.diff(rowptr))
        col = np.where(row < 1500, col % 700, 2300 + col % 700)
    kw = {'S1': dict(range_split=1), 'S2': dict(range_split=2),
          'S4': dict(range_split=4), 'skewed': dict(range_split=4),
          'bounds': dict(range_split=1, bounds=[(0, 7), (7, 1500),
                                                (1500, 3000)]),
          'weighted': dict(range_split=3, edge_weight=w)}[kind]
    s = kw.pop('range_split')
    return ops.build_fused_range_plan(rowptr, col, 3000, s, chunk=128,
                                      device=device, **kw), 3000


@pytest.mark.parametrize('kind', ['S1', 'S2', 'S4', 'skewed', 'bounds',
                                  'weighted', 'empty'])
@pytest.mark.parametrize('f', [1, 47, 300])
@pytest.mark.parametrize('mode', ['f32', 'bf16', 'int8'])
def test_k7_matches_plain(dev, kind, f, mode):
    plan, n = _k7_plan(kind, dev)
    if kind == 'weighted' and mode == 'int8':
        with pytest.raises(ValueError, match='int8'):
            ops.fused_range_sum(torch.zeros((n, f), dtype=torch.int8,
                                            device=dev), plan)
        return
    xm, scale = _inputs(n, f, mode, dev)
    got = ops.fused_range_sum(xm, plan, scale)
    torch.cuda.synchronize()
    ref = ops.fused_range_plain(xm, plan, scale)
    absw = plan if plan.weights is None else plan._replace(
        weights=tuple(w.abs() for w in plan.weights))
    mag = ops.fused_range_plain(xm.abs(), absw,
                                None if scale is None else scale.abs())
    assert got.shape == ref.shape == (plan.num_rows, f)
    assert bool(((got - ref).abs() <= RTOL * mag + ATOL).all())


# K1's two entries and K7 (S = 1, 2, 4; with and without weights) on the
# hub CSR, in f32, bf16 and int8 (with its column scale where the kernel
# takes one; weighted K7 refuses int8): from an aligned x, F = 512 takes
# the vector branch in every type and F = 600 in f32 and bf16; every
# other case takes the scalar one.
SUM_ENTRIES = ['K1', 'K1m'] + [f'K7 S={s}{w}' for s in (1, 2, 4)
                               for w in ('', ' weighted')]


@functools.lru_cache(maxsize=None)
def _hub_sum_plan(entry, device):
    rowptr, col = _hub_csr()
    if entry in ('K1', 'K1m'):
        return ops.build_spmm_plan(rowptr, col, chunk=128, device=device)
    w = None
    if entry.endswith('weighted'):
        w = np.random.default_rng(9).normal(size=col.shape[0]).astype(
            np.float32)
    return ops.build_fused_range_plan(rowptr, col, 2000, int(entry[5]),
                                      chunk=128, edge_weight=w,
                                      device=device)


def _one_element_in(t):
    """A copy of ``t`` one element into a fresh storage: not 16-byte
    aligned, so K1 and K7 take their scalar branch."""
    out = t.new_empty(t.numel() + 1)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.parametrize('entry', SUM_ENTRIES)
@pytest.mark.parametrize('f', [1, 3, 47, 512, 600])
@pytest.mark.parametrize('mode', ['f32', 'bf16', 'int8'])
def test_k1_k7_hub_rows_and_alignment(dev, entry, f, mode):
    if mode == 'int8' and entry.endswith('weighted'):
        with pytest.raises(ValueError, match='int8'):
            ops.fused_range_sum(torch.zeros((2000, f), dtype=torch.int8,
                                            device=dev),
                                _hub_sum_plan(entry, dev))
        return
    plan = _hub_sum_plan(entry, dev)
    rows = plan.col_padded.shape[0] if entry == 'K1m' else 2000
    if entry == 'K1m':
        def kernel(xm, sc):
            return ops.segment_sum_chunked(xm, plan)

        def plain(xm, p, sc):
            return ops.segment_sum_chunked_plain(xm, p)
    elif entry == 'K1':
        def kernel(xm, sc):
            return ops.spmm_chunked(xm, plan, sc)

        plain = ops.spmm_chunked_plain
    else:
        def kernel(xm, sc):
            return ops.fused_range_sum(xm, plan, sc)

        plain = ops.fused_range_plain
    xm, scale = _inputs(rows, f, mode, dev)
    if entry == 'K1m':
        scale = None
    absp = plan
    if getattr(plan, 'weights', None) is not None:
        absp = plan._replace(weights=tuple(w.abs() for w in plan.weights))
    ref = plain(xm, plan, scale)
    mag = plain(xm.abs(), absp, None if scale is None else scale.abs())
    srcs = (xm, _one_element_in(xm))
    assert srcs[1].data_ptr() % 16 != 0
    outs = []
    for src in srcs:
        got = kernel(src, scale)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (plan.num_rows, f)
        assert bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() <= RTOL * mag + ATOL).all())
        outs.append(got)
    # The vector and the scalar branch add the same terms in the same order.
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


# K7 with its rows cut at several lengths: every row of slots (1), the
# hub CSR's longer rows (37, 512: the default), and none (a warp walks
# each whole row). Pieces and the merge launch must give the plain sum,
# the same bits from both branches and one launch a call.
@pytest.mark.parametrize('long_len', [1, 37, 512, 1 << 30])
@pytest.mark.parametrize('entry', ['K7 S=2', 'K7 S=4 weighted'])
@pytest.mark.parametrize('f', [3, 512])
def test_k7_long_rows_cut_at_any_length(dev, monkeypatch, long_len, entry,
                                        f):
    from pyg_lib_tpu_torch.ops.kernels import spmm_range_fused as k7_mod

    monkeypatch.setattr(k7_mod, 'K7_LONG', long_len)
    plan = _hub_sum_plan(entry, dev)
    cut = k7_mod.k7_pieces(plan)
    assert (cut.rows.shape[0] > 0) == (long_len < 120_000)
    xm, _ = _inputs(2000, f, 'f32', dev)
    absp = plan
    if plan.weights is not None:
        absp = plan._replace(weights=tuple(w.abs() for w in plan.weights))
    ref = ops.fused_range_plain(xm, plan)
    mag = ops.fused_range_plain(xm.abs(), absp)
    outs = []
    for src in (xm, _one_element_in(xm)):
        before = ops.fused_range_sum.launches
        got = ops.fused_range_sum(src, plan)
        torch.cuda.synchronize()
        assert ops.fused_range_sum.launches == before + 1
        assert bool(((got - ref).abs() <= RTOL * mag + ATOL).all())
        outs.append(got)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    assert torch.equal(outs[0].view(torch.int32),
                       ops.fused_range_sum(xm, plan).view(torch.int32))


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('precision', [None, 'bf16', 'int8'])
def test_range_spmm_and_grad_match_cpu(dev, fused, precision):
    rowptr, col = GRAPHS['powerlaw']()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3000, 40)).astype(np.float32)
    cot = rng.normal(size=(3000, 40)).astype(np.float32)
    outs = []
    for device in ('cpu', dev):
        graph = ops.build_spmm_graph(rowptr, col, chunk='auto', range_split=4,
                                     range_fused=fused, device=device)
        xt = torch.tensor(x, device=device, requires_grad=True)
        out = ops.spmm(xt, graph, 'mean', precision)
        (grad, ) = torch.autograd.grad(
            (out * torch.tensor(cot, device=device)).sum(), xt)
        outs.append((out.detach().cpu(), grad.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-4)


def test_attention_and_range_launches_are_counted(dev):
    from pyg_lib_tpu_torch.models import GAT

    rowptr, col = GRAPHS['powerlaw']()
    graph = ops.build_spmm_graph(rowptr, col, with_edge_maps=True,
                                 device=dev)
    model = GAT([16, 8, 4], heads=4,
                generator=torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((3000, 16), device=dev)

    def count():
        return (ops.segment_softmax_planned.launches,
                ops.segment_sum_chunked.launches, ops.spmm_chunked.launches,
                ops.fused_range_sum.launches)

    before = count()
    model(x, graph).sum().backward()
    # Forward: K6 and K1-msgs per layer; backward: K1-msgs for the softmax
    # row sums per layer.
    assert tuple(a - b for a, b in zip(count(), before)) == (2, 4, 0, 0)
    fused = ops.build_spmm_graph(rowptr, col, range_split=4, range_fused=True,
                                 device=dev)
    xs = torch.randn((3000, 16), device=dev, requires_grad=True)
    before = count()
    ops.spmm(xs, fused).sum().backward()
    assert tuple(a - b for a, b in zip(count(), before)) == (0, 0, 0, 2)
    split = ops.build_spmm_graph(rowptr, col, range_split=4, device=dev)
    before = count()
    ops.spmm(xs, split).sum().backward()
    assert tuple(a - b for a, b in zip(count(), before)) == (0, 0, 8, 0)
    before = count()
    ptr = torch.arange(0, 70001, 7, device=dev)
    ops.softmax_csr(torch.randn((70000, 4), device=dev), ptr)
    assert tuple(a - b for a, b in zip(count(), before)) == (1, 0, 0, 0)


@pytest.mark.parametrize('graph', ['ragged', 'powerlaw'])
def test_gat_forward_and_grads_match_cpu(dev, graph):
    from pyg_lib_tpu_torch.models import GAT

    rowptr, col = GRAPHS[graph]()
    n = rowptr.shape[0] - 1
    x = np.random.default_rng(8).normal(size=(n, 32)).astype(np.float32)
    outs = []
    for device in ('cpu', dev):
        g = ops.build_spmm_graph(rowptr, col, with_edge_maps=True,
                                 device=device)
        model = GAT([32, 16, 8], heads=4,
                    generator=torch.Generator().manual_seed(1), device=device)
        out = model(torch.tensor(x, device=device), g)
        grads = torch.autograd.grad(out.square().sum(),
                                    list(model.parameters()))
        outs.append([out.detach().cpu()] + [t.cpu() for t in grads])
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(a.abs().max())))


def test_attention_and_range_wrappers_refuse(dev):
    rowptr, col = GRAPHS['ragged']()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device=dev)
    e_pad = plan.col_padded.shape[0]
    with pytest.raises(ValueError, match='f32/bf16'):
        ops.segment_softmax_planned(torch.zeros((e_pad, 4), device=dev,
                                                dtype=torch.float64), plan)
    with pytest.raises(ValueError, match='E_pad'):
        ops.segment_softmax_planned(torch.zeros((e_pad - 1, 4), device=dev),
                                    plan)
    with pytest.raises(ValueError, match='index'):
        ops.segment_softmax_planned(torch.zeros((12000, 4), device=dev), plan,
                                    plan.edge_perm.long())
    with pytest.raises(ValueError, match='msgs_padded'):
        ops.segment_sum_chunked(torch.zeros((e_pad - 1, 4), device=dev), plan)
    fplan, n = _k7_plan('S2', dev)
    with pytest.raises(ValueError, match='rows'):
        ops.fused_range_sum(torch.zeros((n - 1, 4), device=dev), fplan)
    with pytest.raises(ValueError, match='contiguous'):
        ops.fused_range_sum(torch.zeros((4, n), device=dev).t(), fplan)


# -- K4s, the fused multi-reduction, the COO sums and the padded GAT -----------


def _assert_k4s(src, plan, idx, negate):
    got = ops.segment_max_kernel(src, plan, idx, negate, with_sum=True)
    sumless = ops.segment_max_kernel(src, plan, idx, negate)
    torch.cuda.synchronize()
    ref = ops.segment_max_plain(src, plan, idx, negate, with_sum=True)
    _assert_same(got[:2], sumless)
    _assert_same(got[:2], ref[:2])
    finite = torch.isfinite(ref[2])
    assert torch.equal(got[2][~finite], ref[2][~finite])
    mag = ops.segment_max_plain(src.abs().nan_to_num(posinf=0.0), plan, idx,
                                with_sum=True)[2]
    err = (got[2] - ref[2]).abs()[finite]
    assert bool((err <= RTOL * mag[finite] + ATOL).all())


@pytest.mark.parametrize('mode', ['padded', 'col_padded', 'edge_perm'])
@pytest.mark.parametrize('graph', list(GRAPHS))
@pytest.mark.parametrize('f', [1, 47, 300])
@pytest.mark.parametrize('values', ['normal', 'ties'])
@pytest.mark.parametrize('negate', [False, True])
def test_k4s_matches_k4_and_plain(dev, mode, graph, f, values, negate):
    plan, rows, idx = _k4_case(mode, graph, dev)
    _assert_k4s(_values(values, rows, f, f, dev), plan, idx, negate)


@pytest.mark.parametrize('case', ['hub', 'unaligned'])
@pytest.mark.parametrize('mode', ['padded', 'col_padded', 'edge_perm'])
@pytest.mark.parametrize('f', [1, 3, 47, 600])
@pytest.mark.parametrize('values', ['normal', 'ties'])
def test_k4s_hub_rows_and_alignment(dev, case, mode, f, values):
    rowptr, col = _hub_csr() if case == 'hub' else GRAPHS['ragged']()
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device=dev)
    rows, idx = {'padded': (plan.col_padded.shape[0], None),
                 'col_padded': (plan.num_rows, plan.col_padded),
                 'edge_perm': (col.shape[0], plan.edge_perm)}[mode]
    if case == 'unaligned':
        src = _unaligned((rows, f), f, dev, values)
        assert src.data_ptr() % 16 != 0
    else:
        src = _values(values, rows, f, f, dev)
    for negate in (False, True):
        _assert_k4s(src, plan, idx, negate)


# 70,000 rows of 128 features into 9,000 buckets, a few of them empty:
# past the fused path's 65,536 rows.
def _fused_inputs(device):
    rng = np.random.default_rng(11)
    idx = np.sort(rng.integers(0, 9000, 70000))
    idx[idx == 17] = 18  # bucket 17 empty
    x = torch.tensor(rng.normal(size=(70000, 128)).astype(np.float32),
                     device=device)
    return idx, x


@pytest.mark.parametrize('reduces', [['sum', 'mean', 'min', 'max'],
                                     ['mean', 'min'], ['max']],
                         ids='-'.join)
def test_fused_scatter_reduce_launches_and_matches_cpu(dev, reduces):
    idx, x = _fused_inputs(dev)
    xs = x.clone().requires_grad_(True)
    cot = torch.randn((9000, 128 * len(reduces)), device=dev)
    before = (ops.segment_max_kernel.launches,
              ops.segment_max_kernel.sum_launches)
    out = ops.fused_scatter_reduce(xs, idx, 9000, reduces)
    (grad, ) = torch.autograd.grad((out * cot).sum(), xs)
    torch.cuda.synchronize()
    got = (ops.segment_max_kernel.launches - before[0],
           ops.segment_max_kernel.sum_launches - before[1])
    want = {4: (1, 1), 2: (0, 1), 1: (1, 0)}[len(reduces)]
    assert got == want
    xc = x.cpu().requires_grad_(True)
    ref = ops.fused_scatter_reduce(xc, torch.tensor(idx), 9000, reduces)
    (gref, ) = torch.autograd.grad((ref * cot.cpu()).sum(), xc)
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=1e-5,
                               atol=1e-5)
    f = x.shape[1]
    for bi, r in enumerate(reduces):
        if r in ('min', 'max'):
            blk = slice(bi * f, (bi + 1) * f)
            assert torch.equal(_bits(out.detach()[:, blk].cpu()),
                               _bits(ref.detach()[:, blk]))
    torch.testing.assert_close(grad.cpu(), gref, rtol=1e-5, atol=1e-5)


def test_fused_gate_on_the_card(dev):
    idx, x = _fused_inputs(dev)
    before = ops.segment_max_kernel.sum_launches
    # A CUDA index, a feature width that is not a multiple of 128, or too
    # few rows take the composite.
    ops.fused_scatter_reduce(x, torch.tensor(idx, device=dev), 9000,
                             ['sum', 'max'])
    ops.fused_scatter_reduce(x[:, :100].contiguous(), idx, 9000,
                             ['sum', 'max'])
    ops.fused_scatter_reduce(x[:60000], idx[:60000], 9000, ['sum', 'max'])
    torch.cuda.synchronize()
    assert ops.segment_max_kernel.sum_launches == before


@pytest.mark.parametrize('reduce', ['sum', 'mean', 'min', 'max'])
def test_segment_coo_matches_cpu(dev, reduce):
    rng = np.random.default_rng(12)
    index = np.sort(rng.integers(0, 500, 6000))
    src = rng.normal(size=(6000, 64)).astype(np.float32)
    before = ops.segment_sum_csr_kernel.launches
    got = ops.segment_coo(torch.tensor(src, device=dev),
                          torch.tensor(index, device=dev), dim_size=520,
                          reduce=reduce)
    torch.cuda.synchronize()
    launched = ops.segment_sum_csr_kernel.launches - before
    assert launched == (1 if reduce in ('sum', 'mean') else 0)
    ref = ops.segment_coo(torch.tensor(src), torch.tensor(index),
                          dim_size=520, reduce=reduce)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)


def test_gat_batch_forward_and_grads_match_cpu(dev):
    from pyg_lib_tpu_torch.models import GATBatch

    rng = np.random.default_rng(13)
    n, e, max_e = 3000, 40000, 45000
    dst = np.sort(rng.integers(0, n - 1, e))  # node n-1: pad in-edges only
    row = np.full(max_e, n, np.int64)
    col = np.full(max_e, n, np.int64)
    row[:e], col[:e] = rng.integers(0, n, e), dst
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=rowptr[1:])
    x = rng.normal(size=(n, 32)).astype(np.float32)
    outs = []
    for device in ('cpu', dev):
        model = GATBatch([32, 16, 7], heads=4,
                         generator=torch.Generator().manual_seed(2),
                         device=device)
        batch = [torch.tensor(a, device=device) for a in (rowptr, row, col)]
        before = ops.segment_sum_csr_kernel.launches
        out = model(torch.tensor(x, device=device), *batch)
        grads = torch.autograd.grad(out.square().sum(),
                                    list(model.parameters()))
        if device != 'cpu':
            torch.cuda.synchronize()
            assert ops.segment_sum_csr_kernel.launches - before == 2
        outs.append([out.detach().cpu()] + [t.cpu() for t in grads])
    for a, b in zip(*outs):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(b, a, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(a.abs().max())))


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('ptr_on', ['host', 'card'])
def test_segment_matmul_matches_cpu(dev, ptr_on, bias):
    # An empty segment and trailing padding rows; ptr on the host (no
    # read-back) or on the card (one read-back). TF32 stays off, as the
    # port leaves it to the caller.
    rng = np.random.default_rng(14)
    ptr = np.array([0, 700, 700, 1900, 3000], np.int64)
    x = rng.normal(size=(3100, 128)).astype(np.float32)
    w = rng.normal(size=(4, 128, 349)).astype(np.float32)
    b = rng.normal(size=(4, 349)).astype(np.float32) if bias else None
    cot = rng.normal(size=(3100, 349)).astype(np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = []
    try:
        for device in ('cpu', dev):
            leaves = [torch.tensor(a, device=device, requires_grad=True)
                      for a in ([x, w, b] if bias else [x, w])]
            p = (torch.tensor(ptr, device=device) if ptr_on == 'card'
                 and device != 'cpu' else ptr)
            out = ops.segment_matmul(leaves[0], p, leaves[1],
                                     leaves[2] if bias else None)
            grads = torch.autograd.grad(
                (out * torch.tensor(cot, device=device)).sum(), leaves)
            outs.append([out.detach().cpu()] + [t.cpu() for t in grads])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(outs[1][0][3000:], torch.zeros((100, 349)))
    assert torch.equal(outs[1][2][1], torch.zeros((128, 349)))
    for a, c in zip(*outs):
        torch.testing.assert_close(c, a, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(a.abs().max())))


def test_rgcn_forward_matches_cpu(dev):
    from pyg_lib_tpu_torch.models import RGCNBatch

    rng = np.random.default_rng(15)
    n, e, e_pad = 3000, 40000, 41000
    sizes = np.array([15000, 0, 20000, 5000])
    rel_ptr = np.concatenate([[0], np.cumsum(sizes)])
    row = np.full(e_pad, n, np.int64)
    col = np.full(e_pad, n, np.int64)
    row[:e], col[:e] = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    outs = []
    for device in ('cpu', dev):
        model = RGCNBatch([32, 16, 7], 4,
                          generator=torch.Generator().manual_seed(3),
                          device=device)
        out = model(torch.tensor(x, device=device),
                    torch.tensor(row, device=device),
                    torch.tensor(col, device=device), rel_ptr)
        grads = torch.autograd.grad(out.square().sum(),
                                    list(model.parameters()))
        outs.append([out.detach().cpu()] + [t.cpu() for t in grads])
    for a, c in zip(*outs):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(c, a, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(a.abs().max())))


@pytest.mark.parametrize('dedup', ['auto', 'on'])
@pytest.mark.parametrize('side', ['tall', 'wide'])
def test_rectangular_dedup_spmm_matches_cpu(dev, side, dedup):
    # A rectangular graph, as an R-GCN relation gives: 2,000 destination
    # rows over 30,000 Zipf(1.2) sources ('wide') or 30,000 rows over 2,000
    # sources ('tall', whose transpose has hub rows); forward and backward,
    # each side on the plan dedup= gives it, against the CPU within the
    # sum tolerance (Σ|terms| from |x| and |cot| on the CPU).
    rng = np.random.default_rng(16)
    n_dst, n_src = (2000, 30000) if side == 'wide' else (30000, 2000)
    e = 60000
    p = 1.0 / np.arange(1, n_src + 1)**1.2
    rowptr, col = _csr(rng.integers(0, n_dst, e),
                       rng.choice(n_src, e, p=p / p.sum()), n_dst)
    x = rng.normal(size=(n_src, 40)).astype(np.float32)
    cot = rng.normal(size=(n_dst, 40)).astype(np.float32)

    def run(graph, device, xv, cv):
        xt = torch.tensor(xv, device=device, requires_grad=True)
        out = ops.spmm(xt, graph, 'mean')
        (grad, ) = torch.autograd.grad(
            (out * torch.tensor(cv, device=device)).sum(), xt)
        return out.detach().cpu(), grad.cpu()

    outs, kinds = [], []
    for device in ('cpu', dev):
        graph = ops.build_spmm_graph(rowptr, col, num_cols=n_src,
                                     dedup=dedup, device=device)
        kinds.append((type(graph.fwd), type(graph.bwd)))
        before = (ops.dedup_sum.launches + ops.dedup_sum.hot_launches,
                  ops.spmm_chunked.launches)
        outs.append(run(graph, device, x, cot))
        if device != 'cpu':
            torch.cuda.synchronize()
            n_dedup = sum(isinstance(p, ops.DedupSpmmPlan)
                          for p in (graph.fwd, graph.bwd))
            assert (ops.dedup_sum.launches + ops.dedup_sum.hot_launches -
                    before[0], ops.spmm_chunked.launches - before[1]) == (
                        n_dedup, 2 - n_dedup)
        else:
            mags = run(graph, device, np.abs(x), np.abs(cot))
    assert kinds[0] == kinds[1]
    if dedup == 'on':
        assert kinds[1] == (ops.DedupSpmmPlan, ops.DedupSpmmPlan)
    for a, c, mag in zip(*outs, mags):
        assert bool(((c - a).abs() <= RTOL * mag + ATOL).all())


@pytest.mark.parametrize('form', ['per-relation', 'stacked', 'range-sliced'])
def test_rgcn_forms_match_cpu(dev, form):
    from pyg_lib_tpu_torch.models import (RGCN, build_rgcn_graphs,
                                          build_rgcn_planned)
    from pyg_lib_tpu_torch.testing import mag_graph

    num, rowptr_d, col_d = mag_graph(
        {'paper': 3000, 'author': 5000, 'institution': 40,
         'field_of_study': 300},
        {('paper', 'cites', 'paper'): 20000,
         ('author', 'writes', 'paper'): 26000,
         ('author', 'affiliated_with', 'institution'): 4000,
         ('paper', 'has_topic', 'field_of_study'): 28000})
    rng = np.random.default_rng(17)
    x = {t: rng.normal(size=(n, 32)).astype(np.float32)
         for t, n in num.items()}
    outs = []
    for device in ('cpu', dev):
        if form == 'per-relation':
            plans = build_rgcn_graphs(rowptr_d, col_d, num, device=device)
        else:
            plans = build_rgcn_planned(
                rowptr_d, col_d, num, device=device,
                **({'chunk': 512} if form == 'stacked' else
                   {'chunk': 'auto', 'range_sliced': True}))
        model = RGCN([32, 16, 7], 4,
                     generator=torch.Generator().manual_seed(4),
                     device=device)
        out = model({t: torch.tensor(v, device=device)
                     for t, v in x.items()}, plans)
        grads = torch.autograd.grad(
            sum(v.square().sum() for v in out.values()),
            list(model.parameters()))
        outs.append([out[t].detach().cpu() for t in sorted(out)] +
                    [t.cpu() for t in grads])
    for a, c in zip(*outs):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(c, a, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(a.abs().max())))


# K1 and K1m on the 120,000-edge hub row, its rows of more than K1_LONG
# slots cut into pieces at lengths of 1, 37 and 512, and at none (a warp
# walks each whole row). Pieces and the merge must give the plain sum, the
# same bits from both branches, one launch a call and a piece launch only
# where a row is cut; a row that is not cut keeps the bits of the walk
# with no cut.
@pytest.mark.parametrize('long_len', [1, 37, 512, 1 << 30])
@pytest.mark.parametrize('entry', ['K1', 'K1m'])
@pytest.mark.parametrize('f', [3, 128, 512])
def test_k1_long_rows_cut_at_any_length(dev, monkeypatch, long_len, entry,
                                        f):
    from pyg_lib_tpu_torch.ops.kernels import spmm_chunked as k1_mod

    plan = _hub_sum_plan('K1', dev)
    rows = plan.col_padded.shape[0] if entry == 'K1m' else 2000
    xm, _ = _inputs(rows, f, 'f32', dev)
    if entry == 'K1m':
        run, plain, counter = (ops.segment_sum_chunked,
                               ops.segment_sum_chunked_plain,
                               ops.segment_sum_chunked)
    else:
        run, plain, counter = (ops.spmm_chunked, ops.spmm_chunked_plain,
                               ops.spmm_chunked)
    monkeypatch.setattr(k1_mod, 'K1_LONG', 1 << 30)
    whole = run(xm, plan)
    monkeypatch.setattr(k1_mod, 'K1_LONG', long_len)
    cut = k1_mod.k1_pieces(plan)
    assert (cut.rows.shape[0] > 0) == (long_len < 120_000)
    ref = plain(xm, plan)
    mag = plain(xm.abs(), plan)
    outs = []
    for src in (xm, _one_element_in(xm)):
        before = (counter.launches, counter.piece_launches)
        got = run(src, plan)
        torch.cuda.synchronize()
        assert (counter.launches, counter.piece_launches) == (
            before[0] + 1, before[1] + int(cut.rows.shape[0] > 0))
        assert bool(((got - ref).abs() <= RTOL * mag + ATOL).all())
        outs.append(got)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    kept = torch.ones(plan.num_rows, dtype=torch.bool, device=dev)
    kept[cut.rows[:, 0].long()] = False
    assert torch.equal(outs[0][kept].view(torch.int32),
                       whole[kept].view(torch.int32))


# K1 with rows cut in every type: bf16 and int8 (with its column scale)
# at the hub row, against the plain version.
@pytest.mark.parametrize('mode', ['bf16', 'int8'])
@pytest.mark.parametrize('f', [47, 512])
def test_k1_long_rows_cut_in_every_type(dev, mode, f):
    plan = _hub_sum_plan('K1', dev)
    xm, scale = _inputs(2000, f, mode, dev)
    before = ops.spmm_chunked.piece_launches
    got = ops.spmm_chunked(xm, plan, scale)
    torch.cuda.synchronize()
    assert ops.spmm_chunked.piece_launches == before + 1
    ref = ops.spmm_chunked_plain(xm, plan, scale)
    xa = xm.abs() if mode != 'int8' else xm.abs().to(torch.int8)
    mag = ops.spmm_chunked_plain(xa, plan, scale)
    assert bool(((got - ref).abs() <= RTOL * mag + ATOL).all())


# A K2h launch over a hot level of pads only: a split without hot columns
# lifted by pad_hot to its siblings' width, whose row list is empty.
@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16,
                                   torch.float32])
def test_k2h_over_an_all_pad_hot_level(dev, dtype):
    from pyg_lib_tpu_torch.ops.kernels.spmm_dedup import (hot_list, pad_hot,
                                                          pad_plan)

    rowptr, col = GRAPHS['powerlaw']()
    bare = ops.build_dedup_plan(rowptr, col, ec=256, hot='off', device=dev)
    lifted = pad_hot(pad_plan(bare, bare.num_chunks + 9), 64, dtype=dtype)
    assert lifted.num_hot == 64 and hot_list(lifted).src.numel() == 0
    x = torch.randn((3000, 47), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    before = ops.dedup_sum.hot_launches
    got = ops.dedup_sum(x, lifted)
    torch.cuda.synchronize()
    assert ops.dedup_sum.hot_launches == before + 1
    ref = ops.dedup_sum_plain(x, bare)
    mag = ops.dedup_sum_plain(x.abs(), bare)
    assert bool(((got - ref).abs() <= RTOL * mag + ATOL).all())


# A small sharded graph on the card against the same graph on the CPU
# (the plain versions): plain split plans, column ranges, dedup splits
# with padded hot levels and min/max plans; sum and mean in every
# precision, max and min exact with their gradients. The transpose's hub
# rows (thousands of terms, K1's pieces) sum in other orders: each sum
# within 1e-5 * Σ|terms| + 1e-5, Σ|terms| from |x| and |cot| on the CPU.
@pytest.mark.parametrize('kind', ['plain', 'range', 'dedup'])
def test_spmm_sharded_matches_cpu(dev, kind):
    rowptr, col = GRAPHS['powerlaw']()
    kw = {'plain': dict(chunk=128),
          'range': dict(chunk='auto', range_split=3),
          'dedup': dict(dedup='on', minmax='on')}[kind]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3000, 40)).astype(np.float32)
    cot = rng.normal(size=(3000, 40)).astype(np.float32)
    cases = [(r, p) for r in ('sum', 'mean') for p in (None, 'bf16', 'int8')]
    if kind != 'range':
        cases += [('max', None), ('min', None)]
    graphs = {device: ops.build_spmm_graph_sharded(rowptr, col, 3,
                                                   device=device, **kw)
              for device in ('cpu', dev)}
    for reduce, precision in cases:
        outs = []
        for device, graph in graphs.items():
            xt = torch.tensor(x, device=device, requires_grad=True)
            out = ops.spmm_sharded(xt, graph, reduce, precision)
            (grad, ) = torch.autograd.grad(
                (out * torch.tensor(cot, device=device)).sum(), xt)
            outs.append((out.detach().cpu(), grad.cpu()))
        (a, ga), (b, gb) = outs
        # Σ|terms|: the sums over |x| and |cot|; for max/min the winners'
        # |cot|.
        exact = reduce in ('max', 'min')
        xa = torch.tensor(x if exact else np.abs(x), requires_grad=True)
        mag = ops.spmm_sharded(xa, graphs['cpu'], reduce)
        (gmag, ) = torch.autograd.grad(
            (mag * torch.tensor(np.abs(cot))).sum(), xa)
        if exact:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert bool(((b - a).abs() <= RTOL * mag + ATOL).all())
        assert bool(((gb - ga).abs() <= RTOL * gmag + ATOL).all())


# F1 (csrc/fps.cu) against its plain version: the same arithmetic in the
# same order, so the same indices exactly, in one launch a call. Clouds of
# 1 and 2 points, of 1,000 (distances in registers), 20,000 and 100,000
# (in the global scratch), duplicate points (equal maxima, the lowest
# index wins), all points equal (every distance 0), ratio 1 and a batch
# with empty clouds.
@pytest.mark.parametrize('case', ['1', '2', '1000', '20000', '100000',
                                  'duplicates', 'all equal', 'ratio 1',
                                  'batch', 'D=1'])
def test_f1_matches_plain(dev, case):
    rng = np.random.default_rng(21)
    ratio, d = 0.5, 3
    if case.isdigit():
        n = int(case)
        ptr, ratio = [0, n], (0.05 if n == 100000 else 0.5)
    elif case == 'duplicates':
        n, ptr = 3000, [0, 1000, 3000]
    elif case == 'all equal':
        n, ptr = 700, [0, 700]
    elif case == 'ratio 1':
        n, ptr, ratio = 1500, [0, 600, 1500], 1.0
    elif case == 'batch':
        n, ptr = 40 * 700, [0, 0] + [700 * (i + 1) for i in range(40)] + [
            28000]
    else:
        n, ptr, d = 5000, [0, 2000, 5000], 1
    pts = rng.normal(size=(n, d)).astype(np.float32)
    if case == 'duplicates':
        pts = np.repeat(pts[::3], 3, axis=0)[:n]
    elif case == 'all equal':
        pts[:] = 0.25
    src = torch.tensor(pts, device=dev)
    before = ops.fps_kernel.launches
    got = ops.fps(src, ptr, ratio, seed=3)
    torch.cuda.synchronize()
    assert ops.fps_kernel.launches == before + 1
    ref = ops.fps(src.cpu(), ptr, ratio, seed=3)
    assert got.device == src.device and got.dtype == torch.int32
    assert torch.equal(got.cpu(), ref)


def test_f1_refuses_what_it_does_not_take(dev):
    pts = torch.zeros((10, 3), device=dev)
    with pytest.raises(ValueError, match='float32'):
        ops.fps_kernel(pts.double(), np.array([[0, 10, 5, 0]]))
    with pytest.raises(ValueError, match='start < n'):
        ops.fps_kernel(pts, np.array([[0, 10, 5, 10]]))
    with pytest.raises(ValueError, match='inside pos'):
        ops.fps_kernel(pts, np.array([[5, 10, 5, 0]]))
    with pytest.raises(ValueError, match='contiguous'):
        ops.fps_kernel(torch.zeros((3, 10), device=dev).t(),
                       np.array([[0, 10, 5, 0]]))


# knn, radius and nearest compute each distance with the same f32
# operations in the same order on the card and on the CPU, so their pairs
# are equal; spline_weighting's product and sums run in another order
# (within 1e-5 of max |CPU value|).
def test_geometry_ops_match_cpu(dev):
    rng = np.random.default_rng(22)
    x = rng.normal(size=(3000, 3)).astype(np.float32)
    y = rng.normal(size=(500, 3)).astype(np.float32)
    ptr_x, ptr_y = [0, 1000, 1000, 3000], [0, 200, 250, 500]
    xs, ys = torch.tensor(x), torch.tensor(y)
    xd, yd = xs.to(dev), ys.to(dev)
    for cosine in (False, True):
        got = ops.knn(xd, yd, 16, ptr_x, ptr_y, cosine=cosine)
        assert got.device == xd.device
        assert torch.equal(got.cpu(), ops.knn(xs, ys, 16, ptr_x, ptr_y,
                                              cosine=cosine))
    for ignore in (False, True):
        got = ops.radius(xd, xd, 0.3, ptr_x, ptr_x, 32,
                         ignore_same_index=ignore)
        assert torch.equal(got.cpu(), ops.radius(xs, xs, 0.3, ptr_x, ptr_x,
                                                 32, ignore_same_index=ignore))
    assert torch.equal(ops.nearest(xd, yd, ptr_x, ptr_y).cpu(),
                       ops.nearest(xs, ys, ptr_x, ptr_y))


def test_spline_weighting_matches_cpu(dev):
    rng = np.random.default_rng(23)
    e, m_in, m_out = 5000, 32, 32
    pseudo = torch.tensor(rng.random((e, 3)).astype(np.float32))
    ks, iso = torch.tensor([5, 5, 5]), torch.tensor([1, 1, 1])
    basis, wi = ops.spline_basis(pseudo, ks, iso, 1)
    got = ops.spline_basis(pseudo.to(dev), ks.to(dev), iso.to(dev), 1)
    assert torch.equal(got[1].cpu(), wi)
    assert float((got[0].cpu() - basis).abs().max()) <= 1e-5 * float(
        basis.abs().max())
    x = torch.tensor(rng.normal(size=(e, m_in)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(125, m_in, m_out)).astype(np.float32))
    ref = ops.spline_weighting(x, w, basis, wi)
    got = ops.spline_weighting(x.to(dev), w.to(dev), basis.to(dev),
                               wi.to(dev)).cpu()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# -- the host layer on the card -----------------------------------------------


def test_device_hash_map_on_the_card_equals_the_cpu(dev):
    from pyg_lib_tpu_torch.classes import DeviceHashMap

    keys = np.random.default_rng(0).choice(10**9, 5000, replace=False)
    queries = np.concatenate([keys[::3], np.arange(-5, 2000)])
    got = DeviceHashMap(keys, device=dev).get(torch.tensor(queries,
                                                            device=dev))
    ref = DeviceHashMap(keys, device='cpu').get(torch.tensor(queries))
    assert got.device.type == 'cuda' and torch.equal(got.cpu(), ref)
    empty = DeviceHashMap(np.zeros(0, np.int64), device=dev).get([1, 2])
    assert empty.tolist() == [-1, -1]


@pytest.mark.parametrize('kind', ['homogeneous', 'hetero'])
def test_loader_batches_on_the_card_equal_the_host_batches(dev, kind):
    from pyg_lib_tpu_torch.loader import HeteroNeighborLoader, NeighborLoader

    rng = np.random.default_rng(1)
    if kind == 'homogeneous':
        rowptr, col = GRAPHS['ragged']()
        x = rng.normal(size=(1000, 24)).astype(np.float32)
        y = rng.integers(0, 7, 1000)
        make = lambda device: NeighborLoader(
            rowptr, col, x, y, np.arange(0, 1000, 2), 64, [6, 4], rng=3,
            device=device, lookahead=3)
    else:
        sizes = {'a': 700, 'b': 400}
        rels = [('a', 'r', 'a'), ('b', 's', 'a'), ('a', 't', 'b')]
        rowptr_d, col_d = {}, {}
        for s, r, d in rels:
            rp = np.zeros(sizes[s] + 1, np.int64)
            rp[1:] = np.cumsum(rng.integers(0, 9, sizes[s]))
            rowptr_d[s, r, d] = rp
            col_d[s, r, d] = rng.integers(0, sizes[d], int(rp[-1]))
        x_d = {t: rng.normal(size=(n, 16)).astype(np.float32)
               for t, n in sizes.items()}
        y_d = {'a': rng.integers(0, 5, 700)}
        make = lambda device: HeteroNeighborLoader(
            rowptr_d, col_d, x_d, y_d, 'a',
            np.arange(0, 700, 3), 32, {k: [4, 3] for k in rels},
            {'a': 2048, 'b': 1024}, 6000, rng=2, device=device)
    card, host = make(dev), make('cpu')
    got = [b for _ in range(2) for b in card]
    ref = [b for _ in range(2) for b in host]
    assert len(got) == len(ref) > 2
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k, v in r.items():
            if isinstance(v, torch.Tensor):
                assert g[k].device.type == 'cuda'
                assert torch.equal(g[k].cpu(), v), k
            else:
                assert g[k] == v, k
    start, done = card.timings[0]['h2d']
    done.synchronize()
    assert start.elapsed_time(done) >= 0.0


@pytest.mark.parametrize('f', [47, 602])
def test_k3_on_a_padded_batch_with_trailing_pad_edges(dev, f):
    from pyg_lib_tpu_torch import sampler

    rowptr, col = GRAPHS['ragged']()
    out = sampler.neighbor_sample(rowptr, col, np.arange(0, 1000, 9),
                                  [10, 5], rng=4)
    b = sampler.padding.pad_sample_output(out, 4096, 8192, num_seeds=112)
    assert b.num_edges < 8192  # trailing pad edges past rowptr[-1]
    ptr = torch.tensor(b.rowptr, device=dev)
    gen = torch.Generator(device=dev).manual_seed(f)
    src = torch.randn((8192, f), generator=gen, device=dev,
                      requires_grad=True)
    got = ops.segment_mean_csr(src, ptr)
    torch.cuda.synchronize()
    ref = ops.segment_sum_csr_plain(src.detach(), ptr) / (
        ptr[1:] - ptr[:-1]).clamp(min=1)[:, None]
    mag = ops.segment_sum_csr_plain(src.detach().abs(), ptr) / (
        ptr[1:] - ptr[:-1]).clamp(min=1)[:, None]
    assert bool(((got.detach() - ref).abs() <= RTOL * mag + ATOL).all())
    # The backward (gather_csr of the cotangent) gives the pad rows zero.
    got.backward(torch.ones_like(got))
    assert bool((src.grad[b.num_edges:] == 0).all())
    assert bool((src.grad[:b.num_edges] > 0).all())


@pytest.mark.parametrize('reorder', ['on', 'auto'])
@pytest.mark.parametrize('reduce', ['sum', 'mean', 'max'])
def test_reordered_spmm_on_the_card_equals_the_cpu(dev, reorder, reduce):
    # Values and gradients within the sum bound of the module docstring,
    # Σ|terms| from the CPU: |x| through the graph for the values, the
    # gradient of the output against |cot| for the gradients. Max values
    # are exact.
    rowptr, col = _powerlaw(5, 3000, 40000)
    x = np.random.default_rng(6).normal(size=(3000, 47)).astype(np.float32)
    cot = np.random.default_rng(7).normal(size=(3000, 47)).astype(
        np.float32)
    outs = []
    for device in (dev, 'cpu'):
        g = ops.build_spmm_graph(rowptr, col, reorder=reorder,
                                 dedup='auto' if reduce != 'max' else 'off',
                                 device=device)
        xt = torch.tensor(x, device=device, requires_grad=True)
        out = ops.spmm(xt, g, reduce=reduce)
        (out * torch.tensor(cot, device=device)).sum().backward()
        outs.append((out.detach().cpu(), xt.grad.cpu(), g.perm is None))
    (o1, g1, p1), (o2, g2, p2) = outs
    assert p1 == p2
    xc = torch.tensor(x, requires_grad=True)
    out = ops.spmm(xc, g, reduce=reduce)
    (out * torch.tensor(cot).abs()).sum().backward()
    mag_grad = xc.grad
    if reduce == 'max':
        assert torch.equal(o1, o2)
    else:
        mag = ops.spmm(torch.tensor(x).abs(), g, reduce=reduce)
        assert bool(((o1 - o2).abs() <= RTOL * mag + ATOL).all())
    assert bool(((g1 - g2).abs() <= RTOL * mag_grad + ATOL).all())


def _dist_rank(rank, world, rowptr, col, x, cot, ids):
    """Both halo aggregations (values and gradients with respect to this
    rank's rows) and ``collective_feature_fetch`` on the card, in one rank
    of ``world``; with K3's launches in this rank."""
    from pyg_lib_tpu_torch import parallel, partition
    from pyg_lib_tpu_torch.sampler.dist_service import \
        collective_feature_fetch

    dev = torch.device('cuda')
    mesh = parallel.make_mesh((world, ), ('data', ), device='cuda')
    part = partition.mesh_edge_partition(rowptr, col, world)
    bpart = partition.mesh_edge_partition_blocked(rowptr, col, world)
    npd = part.nodes_per_device
    mine = slice(rank * npd, (rank + 1) * npd)
    ops.segment_sum_csr_kernel.launches = 0
    out = {}
    for name, fn, tables in (
            ('halo', parallel.halo_exchange_aggregate,
             (part.src_ids[rank], part.rowptr[rank])),
            ('ring', parallel.ring_halo_aggregate,
             (bpart.rowptr_blk[rank], bpart.src_blk[rank]))):
        xr = torch.from_numpy(x[mine]).to(dev).requires_grad_()
        agg = fn(mesh, xr, *(torch.from_numpy(t).to(dev) for t in tables))
        (agg * torch.from_numpy(cot[mine]).to(dev)).sum().backward()
        out[name] = agg.detach().cpu().numpy()
        out[name + '_grad'] = xr.grad.cpu().numpy()
    out['k3'] = ops.segment_sum_csr_kernel.launches
    out['fetch'] = collective_feature_fetch(
        mesh, torch.from_numpy(x[mine]).to(dev),
        torch.from_numpy(ids).to(dev)).cpu().numpy()
    return out


@pytest.mark.parametrize('world,backend', [(1, 'nccl'), (2, 'gloo')])
def test_halo_ring_and_fetch_on_the_card(dev, world, backend):
    """World size 1 over NCCL (the collectives on the card) and 2 ranks
    over gloo (through pinned host memory), against the one-process
    plain sums in f64, within the sum bound."""
    from pyg_lib_tpu_torch import parallel

    n, e, f = 3001, 40000, 128  # 3,001 nodes: pad rows on the last rank
    rowptr, col = _csr(
        np.random.default_rng(3).integers(0, n, e),
        np.random.default_rng(4).integers(0, n, e), n)
    n_pad = -(-n // world) * world
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n_pad, f)).astype(np.float32)
    cot = rng.normal(size=(n_pad, f)).astype(np.float32)
    ids = rng.integers(0, n, 500)
    ranks = parallel.spawn(_dist_rank, world, backend, rowptr, col, x, cot,
                           ids)
    dst = np.repeat(np.arange(n), np.diff(rowptr))
    ref = np.zeros((n_pad, f))
    mag = np.zeros((n_pad, f))
    np.add.at(ref, dst, x[col].astype(np.float64))
    np.add.at(mag, dst, np.abs(x[col]).astype(np.float64))
    gref = np.zeros((n_pad, f))
    gmag = np.zeros((n_pad, f))
    np.add.at(gref, col, cot[dst].astype(np.float64))
    np.add.at(gmag, col, np.abs(cot[dst]).astype(np.float64))
    for name in ('halo', 'ring'):
        got = np.concatenate([r[name] for r in ranks])
        grad = np.concatenate([r[name + '_grad'] for r in ranks])
        assert (np.abs(got - ref) <= RTOL * mag + ATOL).all(), name
        assert (np.abs(grad - gref) <= RTOL * gmag + ATOL).all(), name
    for r in ranks:
        assert r['k3'] >= 2  # the halo sum and each ring block's
        np.testing.assert_array_equal(r['fetch'], x[ids])
