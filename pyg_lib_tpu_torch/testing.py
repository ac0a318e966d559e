"""Test fixtures (counterpart of ``pyg_lib_tpu.testing``), the synthetic
graphs the card's checks and timings run on, and the contract those checks
hold a kernel to against its plain version."""

import functools
import time

import numpy as np
import torch

__all__ = ['GCN_RTOL', 'HUGE_EDGES', 'HUGE_NODES', 'K6_ATOL', 'K6_RTOL',
           'K6_SUM_TOL', 'MAG_EDGES', 'MAG_NODES', 'PAIR_RTOL', 'SEED',
           'SUM_ATOL', 'SUM_BOUND', 'SUM_RTOL', 'abs_plan', 'assert_allclose',
           'bits', 'check_exact', 'check_plan', 'check_softmax', 'check_sum',
           'cuda_ms', 'cycle_graph', 'huge_graph', 'mag_graph',
           'one_element_in', 'powerlaw_graph', 'uniform_graph', 'withSeed']

# The reference's seed (pyg_lib/testing.py:15-21).
SEED = 12345

# ogbn-mag's published node and edge counts (OGB, full size), with the
# relations named as in the dataset.
MAG_NODES = {'paper': 736_389, 'author': 1_134_649, 'institution': 8_740,
             'field_of_study': 59_965}
MAG_EDGES = {('paper', 'cites', 'paper'): 5_416_271,
             ('author', 'writes', 'paper'): 7_145_660,
             ('author', 'affiliated_with', 'institution'): 1_043_998,
             ('paper', 'has_topic', 'field_of_study'): 7_505_078}


def withSeed(fn):
    """Runs ``fn`` with numpy's global generator and torch's default
    generator seeded with :data:`SEED` (the JAX package injects a
    ``jax.random`` key instead)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        np.random.seed(SEED)
        torch.manual_seed(SEED)
        return fn(*args, **kwargs)

    return wrapper


def assert_allclose(actual, expected, rtol=1e-6, atol=1e-6):
    """``np.testing.assert_allclose`` on tensors on any device (bf16 read
    as f32), or on anything ``np.asarray`` takes."""

    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
        return np.asarray(a)

    np.testing.assert_allclose(host(actual), host(expected), rtol=rtol,
                               atol=atol)


def cycle_graph(num_nodes: int = 6):
    """Cycle-graph fixture: every node has exactly two neighbours
    ``(v±1) % n`` so expected outputs are hand-computable.

    Returns CSR ``(rowptr, col)`` as numpy int64.
    """
    n = num_nodes
    rowptr = np.arange(0, 2 * n + 1, 2, dtype=np.int64)
    col = np.empty(2 * n, dtype=np.int64)
    for v in range(n):
        col[2 * v] = (v - 1) % n
        col[2 * v + 1] = (v + 1) % n
    return rowptr, col


def uniform_graph(n: int, e: int):
    """``bench.py`` ``child_headline``'s graph (seed 0): row degrees
    uniform in ``[0, 2e/n)`` scaled to about ``e`` edges, uniform columns.
    Returns CSR ``(rowptr int64, col int32)``."""
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 2 * e // n, size=n)
    deg = (deg * (e / max(deg.sum(), 1))).astype(np.int64)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, n, size=int(rowptr[-1])).astype(np.int32)
    return rowptr, col


def powerlaw_graph(n: int, e: int):
    """``bench.py`` ``child_realistic``'s graph (seed 0): uniform rows,
    Zipf(1.2) columns. Returns CSR ``(rowptr, col)``, both int64."""
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, n + 1)**1.2
    p /= p.sum()
    row = rng.integers(0, n, e)
    col = rng.choice(n, e, p=p)
    order = np.argsort(row, kind='stable')
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=rowptr[1:])
    return rowptr, col[order].astype(np.int64)


# bench/bench_sharded_huge.py's graph: 2M nodes and 31M edges asked for
# (30,009,772 made at seed 0).
HUGE_NODES, HUGE_EDGES = 2_000_000, 31_000_000


def huge_graph(family: str = 'uniform', n: int = HUGE_NODES,
               e: int = HUGE_EDGES):
    """``bench/bench_sharded_huge.py``'s graph (seed 0): row degrees
    uniform in ``[0, 2e/n)`` scaled to about ``e`` edges, columns uniform
    (``family='uniform'``) or Zipf(1.2) (``'powerlaw'``: in-degree skew of
    the papers100M class). Returns CSR ``(rowptr, col)``, both int64."""
    if family not in ('uniform', 'powerlaw'):
        raise ValueError(f"family must be 'uniform' or 'powerlaw', got "
                         f'{family!r}')
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 2 * e // n, size=n)
    deg = (deg * (e / max(deg.sum(), 1))).astype(np.int64)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    e_actual = int(rowptr[-1])
    if family == 'powerlaw':
        p = 1.0 / np.arange(1, n + 1)**1.2
        p /= p.sum()
        col = rng.choice(n, size=e_actual, p=p).astype(np.int64)
    else:
        col = rng.integers(0, n, size=e_actual).astype(np.int64)
    return rowptr, col


def mag_graph(num_nodes=None, edges=None, skew: bool = True):
    """A heterogeneous graph of ogbn-mag's shape: ``bench/bench_hetero.py``'s
    generator, by default at the dataset's full node and edge counts
    (:data:`MAG_NODES`, :data:`MAG_EDGES`).

    Per relation, in the order of ``edges``: destinations uniform (sorted),
    sources Zipf(1.2) over the source type (``skew``, the real graph's
    popularity skew) or uniform; seed 0. Returns ``(num_nodes, rowptr_dict,
    col_dict)``: per relation a CSR over its destination type, int64.
    """
    num_nodes = dict(MAG_NODES if num_nodes is None else num_nodes)
    edges = MAG_EDGES if edges is None else edges
    rng = np.random.default_rng(0)
    rowptr_d, col_d = {}, {}
    for (s, r, d), e in edges.items():
        rows = np.sort(rng.integers(0, num_nodes[d], size=e))
        rowptr = np.zeros(num_nodes[d] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=num_nodes[d]), out=rowptr[1:])
        rowptr_d[(s, r, d)] = rowptr
        if skew:
            p = 1.0 / np.arange(1, num_nodes[s] + 1)**1.2
            p /= p.sum()
            col_d[(s, r, d)] = rng.choice(num_nodes[s], size=e, p=p)
        else:
            col_d[(s, r, d)] = rng.integers(0, num_nodes[s], size=e)
    return num_nodes, rowptr_d, col_d


# -- a kernel against its plain version ---------------------------------------
# A kernel and its plain version sum the same f32 terms in another order:
# |kernel - plain| <= SUM_RTOL * Σ|terms| + SUM_ATOL, elementwise. A bf16
# result adds one bf16 step, 2**-8 of its size. K4 and K5 are exact.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-5
SUM_BOUND = f'{SUM_RTOL:g} * sum|terms| + {SUM_ATOL:g}'
# K6 and its plain version: exponentials a few f32 ulps apart, and each
# row's sum of n terms in another order, at most n * 2**-24 of it apart in
# each: |kernel - plain| <= (K6_RTOL + n * 2**-23) |plain| + K6_ATOL (a
# bf16 result adds one bf16 step, 2**-7 |plain|), NaN where the plain has
# NaN.
K6_RTOL, K6_ATOL = 1e-5, 1e-7
# An f32 K6 row sums to 1 within this: its outputs' f32 rounding adds at
# most 2**-24, and the kernel's sum is a few dozen f32 additions deep (a
# stretch's groups, then its partials 32 lanes wide), a few 1e-6 at most.
# A hub row's stretch partial dropped or counted twice moves the whole row
# by that stretch's share of its sum (1/469 on an 810,552-edge row), which
# the per-element bound above, n * 2**-23 = 9.7% there, would let through.
K6_SUM_TOL = 1e-5
# A model's output and weight gradients pass several such sums and
# matmuls: within GCN_RTOL of max|plain output| (or of max|plain
# gradient|).
GCN_RTOL = 1e-4
# A knn, radius or nearest pair may differ between the card and the CPU
# only where its f64 distance lies within this of the k-th distance or r².
PAIR_RTOL = 1e-6


def bits(t):
    """Tensor to compare bit for bit (-0.0 and +0.0 told apart)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def one_element_in(t):
    """A copy of the contiguous ``t`` one element into a fresh storage: not
    16-byte aligned, so the kernels take their scalar branch."""
    return t.new_empty(t.numel() + 1)[1:].view(t.shape).copy_(t)


def check_sum(label, got, ref, mag, bf16=False, extra=0.0, depth=None):
    """``got``, a kernel's output, against ``ref``, its plain version's,
    within the sum bound of ``mag``, the sum of the terms' magnitudes
    (Σ|terms|), elementwise and subtracted in f64:
    ``|got - ref| <= SUM_RTOL * mag + SUM_ATOL``, plus one bf16 step of
    the result (``2**-8 |ref|``) with ``bf16``, plus ``extra``, plus
    ``depth[:, None] * 2**-24 * mag`` where ``depth`` gives each row's
    addition depth; tensors or arrays, compared on ``got``'s device. ``got``
    must be finite and of ``ref``'s shape. Returns the largest error;
    raises ``AssertionError`` naming ``label`` and the worst element
    otherwise."""
    got, ref, mag = (torch.as_tensor(t).detach() for t in (got, ref, mag))
    ref, mag = ref.to(got.device), mag.to(got.device)
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f'{label}: {tuple(got.shape)} against '
                             f'{tuple(ref.shape)}, or not finite')
    err = (got.double() - ref.double()).abs()
    e = float(err.max()) if err.numel() else 0.0
    tol = SUM_RTOL * mag.double() + SUM_ATOL + extra
    if bf16:
        tol = tol + 2.0**-8 * ref.double().abs()
    if depth is not None:
        tol = tol + 2.0**-24 * depth.double()[:, None] * mag.double()
    over = err - tol
    if err.numel() and float(over.max()) > 0:
        at = tuple(int(i) for i in np.unravel_index(int(over.argmax()),
                                                    err.shape))
        raise AssertionError(
            f'{label} disagrees with its plain version: max_abs_err {e}; '
            f'worst at {at}: got {float(got[at]):.9g}, plain '
            f'{float(ref[at]):.9g}, sum|terms| {float(mag[at]):.9g}, '
            f'tolerance {float(tol[at]):.9g}')
    return e


def abs_plan(plan):
    """``plan`` with |weights|: its plain sum over |x| is Σ|terms|."""
    from pyg_lib_tpu_torch import ops

    if isinstance(plan, ops.FusedRangePlan):
        if plan.weights is None:
            return plan
        return plan._replace(weights=tuple(w.abs() for w in plan.weights))
    if not isinstance(plan, ops.DedupSpmmPlan) or not plan.weighted:
        return plan
    meta = plan.edge_meta.clone()
    meta[:, 2, :] = meta[:, 2, :].view(torch.float32).abs().view(torch.int32)
    hot_w = None if plan.hot_w is None else plan.hot_w.abs()
    return plan._replace(edge_meta=meta, hot_w=hot_w)


def check_plan(label, kernel, plain, xm, plan, scale=None):
    """``kernel(xm, plan, scale)``, an f32 sum (K1, K2/K2h, K7), against
    ``plain`` on the same arguments by :func:`check_sum`, Σ|terms| being
    ``plain`` over ``|xm|``, :func:`abs_plan` and ``|scale|``. Returns
    the largest error."""
    got = kernel(xm, plan, scale)
    if got.dtype != torch.float32:
        raise AssertionError(f'{label}: a {got.dtype} result')
    return check_sum(label, got, plain(xm, plan, scale), plain(
        xm.abs(), abs_plan(plan), None if scale is None else scale.abs()))


def check_exact(label, got, ref):
    """Each tensor of ``got`` (K4's or K5's values and positions) equal to
    ``ref``'s bit for bit, in shape and dtype; raises ``AssertionError``
    naming ``label`` otherwise."""
    for g, r in zip(got, ref, strict=True):
        if (g.shape != r.shape or g.dtype != r.dtype
                or not torch.equal(bits(g), bits(r).to(g.device))):
            raise AssertionError(f'{label} differs from its plain version')


def check_softmax(label, got, ref, plan, idx=None):
    """K6's output ``got`` against its plain version's ``ref`` over
    ``plan`` (through ``idx``, or over the padded slots): of its dtype
    and shape, NaN exactly where ``ref`` has NaN,
    ``|got - ref| <= (K6_RTOL + n * 2**-23) |ref| + K6_ATOL`` with ``n``
    the slot's row length (plus ``2**-7 |ref|`` in bf16), pad slots 0,
    and, in f32, each row's sum (in f64, rows of no slot and NaN columns
    left out) within ``K6_SUM_TOL`` of 1. Returns the largest error and
    the largest ``|row sum - 1|``; raises ``AssertionError`` naming
    ``label`` otherwise."""
    from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import _padded_rows

    slot, row = _padded_rows(plan.tile_ptr)
    at = slot if idx is None else idx[slot].long()
    counts = torch.bincount(row, minlength=plan.num_rows)
    n = torch.zeros(ref.shape[0], device=ref.device)
    n[at] = counts[row].float()
    nan = torch.isnan(ref.float())
    err = (got.float() - ref.float()).abs().masked_fill(nan, 0.0)
    e = float(err.max()) if err.numel() else 0.0
    rtol = K6_RTOL + n[:, None] * 2.0**-23
    if got.dtype == torch.bfloat16:
        rtol = rtol + 2.0**-7
    row_sum = 0.0
    if got.dtype == torch.float32 and got.numel():
        sums = torch.zeros((plan.num_rows, got.shape[1]), dtype=torch.float64,
                           device=got.device).index_add_(0, row,
                                                         got[at].double())
        dev = (sums[counts > 0] - 1.0).abs().nan_to_num(0.0)
        row_sum = float(dev.max()) if dev.numel() else 0.0
    if (got.shape != ref.shape or got.dtype != ref.dtype
            or not torch.equal(torch.isnan(got.float()), nan)
            or bool((err > rtol * ref.float().abs().masked_fill(nan, 0.0)
                     + K6_ATOL).any()) or row_sum > K6_SUM_TOL
            or (idx is None and bool(got[~plan.valid_mask].float().abs()
                                     .sum()))):
        raise AssertionError(f'{label} disagrees with its plain version: '
                             f'max_abs_err {e}, row sum off by {row_sum}')
    return e, row_sum


def cuda_ms(fn, iters=10, warmup=2, warm_s=0.1):
    """Mean ms per call of ``fn`` on the card, by CUDA events, after at
    least ``warmup`` calls and ``warm_s`` seconds of calls: a function
    timed first after a pause (host work, ``empty_cache``) read 3-7% slow
    over 20 calls on the H100. ``warmup=0, warm_s=0`` times the first
    call."""
    t0 = time.perf_counter()
    done = 0
    while done < warmup or time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
        done += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
