"""Planned SpMM — the fused full-graph message-passing aggregation.

Port of ``pyg_lib_tpu/ops/spmm.py`` (sum/add/mean over the chunked, the
deduplicated and the range-split plans, max/min over the chunked and the
dedup min/max plans, and the padded-space primitives of attention layers).
:func:`build_spmm_graph` builds the forward plan and the plan of the
transposed graph on the host once per graph; :func:`spmm` runs them. The
sum's gradient is the same kernel over the transpose plan,
d/dx (A @ x) = Aᵀ @ g; the max/min gradient goes to each row's winning
source row only.
"""

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from pyg_lib_tpu_torch.ops.kernels.plan_cache import _host, plan_key
from pyg_lib_tpu_torch.ops.kernels.segment_minmax import (POS_NONE,
                                                          segment_max_kernel)
from pyg_lib_tpu_torch.ops.kernels.segment_softmax import (
    segment_softmax_planned)
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (TR, SpmmPlan,
                                                        auto_chunk,
                                                        build_spmm_plan,
                                                        segment_sum_chunked,
                                                        spmm_plan_apply)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup import (DedupSpmmPlan,
                                                      build_dedup_plan,
                                                      dedup_plan_apply,
                                                      estimate_dedup)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup_minmax import (
    DedupMinmaxPlan, build_dedup_minmax_plan, dedup_minmax, dedup_pairs,
    estimate_minmax_config)
from pyg_lib_tpu_torch.ops.kernels.spmm_range_fused import (
    FusedRangePlan, _column_range_csrs, _equal_ranges, build_fused_range_plan,
    fused_range_apply)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['RangeSpmmPlan', 'SpmmGraph', 'build_spmm_graph',
           'build_weighted_fused_graph', 'sddmm', 'segment_max_padded',
           'segment_min_padded', 'segment_softmax_padded',
           'segment_sum_padded', 'spmm', 'spmm_csr']


class RangeSpmmPlan(NamedTuple):
    """Column-range-partitioned schedule: one chunked plan per source-node
    range ``[lo, hi)`` over the edges whose column falls in it (columns
    rebased, every range padded to one chunk count); applying it sums the
    per-range K1 results over ``x[lo:hi]``. The JAX package splits so
    that each gather reads a smaller table on the TPU; the port keeps it
    for parity (``range_fused=True`` gives the one-pass K7 plan)."""
    plans: tuple  # per-range SpmmPlan, cols rebased to the range
    bounds: tuple  # ((lo, hi), ...) source-node ranges
    num_rows: int
    num_edges: int


Plan = Union[SpmmPlan, DedupSpmmPlan, RangeSpmmPlan, FusedRangePlan]


class SpmmGraph(NamedTuple):
    """Forward and transpose plans for one CSR graph, plus row degrees.

    ``mm`` (``build_spmm_graph(minmax=...)``) is a schedule of its own
    for ``reduce='max'/'min'`` over the pair-deduped edges: a
    ``DedupMinmaxPlan``, or a plain ``SpmmPlan`` where tile-scope reuse
    would not pay and ``fwd`` cannot serve."""
    fwd: Plan
    bwd: Plan  # plan over the transposed graph (for grad_x)
    deg: torch.Tensor  # [num_rows] f32 row degrees (for reduce='mean')
    mm: Optional[Union[SpmmPlan, DedupMinmaxPlan]] = None


def _transpose_csr(rowptr, col, num_cols, return_order: bool = False):
    """Counting-sort transpose of a (possibly rectangular) CSR."""
    num_rows = rowptr.shape[0] - 1
    row = np.repeat(np.arange(num_rows, dtype=np.int64),
                    np.diff(rowptr).astype(np.int64))
    order = np.argsort(col, kind='stable')
    t_col = row[order]
    t_ptr = np.zeros(num_cols + 1, np.int64)
    np.cumsum(np.bincount(col, minlength=num_cols)[:num_cols],
              out=t_ptr[1:])
    if return_order:
        return t_ptr, t_col, order
    return t_ptr, t_col


def _plan_chunks(rp, chunk: int) -> int:
    """Chunk count of the (floored) padded layout of ``rp``."""
    num_rows = rp.shape[0] - 1
    tb = np.minimum(
        np.arange(num_rows // TR + (num_rows % TR > 0) + 1) * TR, num_rows)
    counts = rp[tb[1:]] - rp[tb[:-1]]
    return int(np.maximum(-(-counts // chunk), 1).sum())


def _build_range_plan(rowptr, col, num_cols: int, range_split: int, chunk,
                      pad_to_chunks: Optional[int] = None,
                      device=None) -> RangeSpmmPlan:
    bounds = _equal_ranges(num_cols, range_split)
    csrs = _column_range_csrs(rowptr, col, bounds)
    if chunk == 'auto':  # sized on the per-range CSRs, ~1/S as dense
        chunk = max(auto_chunk(rp) for rp, _, _ in csrs)
    # Every range padded to one chunk count, as in the JAX package (where
    # it lets the S applications share one compiled kernel).
    cmax = max(_plan_chunks(rp, chunk) for rp, _, _ in csrs)
    if pad_to_chunks is not None:
        cmax = max(cmax, pad_to_chunks)
    plans = [build_spmm_plan(rp, cl, chunk=chunk, pad_to_chunks=cmax,
                             device=device) for rp, cl, _ in csrs]
    return RangeSpmmPlan(plans=tuple(plans), bounds=tuple(bounds),
                         num_rows=int(rowptr.shape[0] - 1),
                         num_edges=int(col.shape[0]))


def _range_plan_apply(x: torch.Tensor, rp: RangeSpmmPlan,
                      precision: Optional[str] = None) -> torch.Tensor:
    """K1 per range over the row slice ``x[lo:hi]`` (a view), partial
    results added."""
    out = None
    for (lo, hi), plan in zip(rp.bounds, rp.plans):
        o = spmm_plan_apply(x[lo:hi], plan, precision=precision)
        out = o if out is None else out + o
    return out


def _not_ported(what: str, item: str):
    return NotImplementedError(f'{what} is not ported yet (ROADMAP Queue 1 '
                               f'item {item})')


def build_weighted_fused_graph(rowptr, col, num_cols: int, bounds,
                               edge_weight, chunk='auto', bounds_t=None,
                               device=None) -> SpmmGraph:
    """A fused-range :class:`SpmmGraph` with per-edge weights baked in:
    ``out[r] = Σ_e w_e · x[col_e]`` over the explicit column ``bounds``
    (kernel K7 on both sides), with its tensors on ``device`` (default:
    the CUDA card).

    Differentiable through :func:`spmm`: the transpose plan carries the
    same weights, so ``grad_x = Σ_e w_e · g[row_e]``; the weights are plan
    constants. ``bounds_t`` range-partitions the transpose plan the same
    way (destination-row ranges of the forward graph).
    """
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    edge_weight = np.asarray(edge_weight, dtype=np.float32)
    num_rows = rowptr.shape[0] - 1
    fwd = build_fused_range_plan(rowptr, col, num_cols, 1, chunk=chunk,
                                 bounds=bounds, edge_weight=edge_weight,
                                 device=device)
    t_ptr, t_col, order = _transpose_csr(rowptr, col, num_cols,
                                         return_order=True)
    bwd = build_fused_range_plan(t_ptr, t_col, num_rows, 1, chunk=chunk,
                                 bounds=bounds_t,
                                 edge_weight=edge_weight[order],
                                 device=device)
    deg = torch.from_numpy(np.diff(rowptr).astype(np.float32)).to(device)
    return SpmmGraph(fwd=fwd, bwd=bwd, deg=deg)


def build_spmm_graph(rowptr, col, chunk=512, with_edge_maps: bool = False,
                     num_cols: Optional[int] = None, range_split: int = 1,
                     range_fused: bool = False, dedup='off',
                     edge_weight=None, minmax='off', reorder='off',
                     device=None) -> SpmmGraph:
    """Host-side, once per graph: build the forward and transpose plans,
    with their tensors on ``device`` (default: the CUDA card).

    ``num_cols`` is the source-node count of a rectangular adjacency
    (default: the row count). ``chunk='auto'`` sizes the chunk from the
    degree distribution. ``with_edge_maps`` gives the chunked plans the
    maps between original and padded edge coordinates.

    ``dedup`` in {'off', 'auto', 'on'} selects the deduplicated-gather
    plan for sum/mean: ``'auto'`` takes it per side where
    :func:`estimate_dedup` predicts a gain of at least 1.3, the JAX
    package's threshold, kept for parity. ``edge_weight`` (``[E]`` f32,
    dedup only) bakes weights into both sides; max/min ignore it.

    ``minmax`` in {'off', 'auto', 'on'} also builds a ``reduce='max'/
    'min'`` schedule over the pair-deduped edges: ``'on'`` the dedup
    min/max plan (kernel K5), ``'auto'`` that plan where the gain is at
    least 1.3 and otherwise nothing (``fwd`` serves) or, on a dedup
    graph, a chunked plan. ``(ec, uc)`` come from
    :func:`estimate_minmax_config`. Without it, max/min need a chunked
    ``fwd``.

    ``range_split=S`` (S > 1) builds :class:`RangeSpmmPlan` schedules
    over S equal source-node ranges (K1 per range, sum/mean only);
    ``range_fused=True`` builds ``FusedRangePlan`` schedules instead, which
    kernel K7 applies in one pass that writes each output row once.
    ``chunk='auto'`` is then sized on the per-range CSRs. Both refuse
    ``with_edge_maps`` and ``dedup``.

    ``reorder`` is not ported yet and raises ``NotImplementedError``.
    """
    if reorder not in ('off', False):
        raise _not_ported("reorder != 'off'", '12 (partition/)')
    if dedup not in ('off', 'auto', 'on', False, True):
        raise ValueError(f"dedup must be 'off', 'auto' or 'on', got "
                         f'{dedup!r}')
    dedup = {'off': 'off', False: 'off', 'on': 'on', True: 'on',
             'auto': 'auto'}[dedup]
    if minmax not in ('off', 'auto', 'on', False, True):
        raise ValueError(f"minmax must be 'off', 'auto' or 'on', got "
                         f'{minmax!r}')
    minmax = {'off': 'off', False: 'off', 'on': 'on', True: 'on',
              'auto': 'auto'}[minmax]
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_rows = rowptr.shape[0] - 1
    if num_cols is None:
        num_cols = num_rows
    deg = torch.from_numpy(np.diff(rowptr).astype(np.float32)).to(device)
    mm = None
    if minmax != 'off':
        rp_d, cl_d = dedup_pairs(rowptr, col)
        ec_mm, uc_mm = estimate_minmax_config(rp_d, cl_d)
        if minmax == 'on' or estimate_dedup(rp_d, cl_d, ec=ec_mm)[1] >= 1.3:
            mm = build_dedup_minmax_plan(rp_d, cl_d, ec=ec_mm, uc=uc_mm,
                                         _pre_deduped=True, device=device)
            mm = mm._replace(num_edges=int(col.shape[0]))
        elif dedup != 'off' or range_split > 1:
            mm = build_spmm_plan(rp_d, cl_d, chunk=512, device=device)
    if edge_weight is not None and dedup == 'off':
        raise ValueError('edge_weight requires dedup="on"/"auto"')
    if dedup != 'off':
        if with_edge_maps or range_split > 1:
            raise ValueError('dedup is incompatible with with_edge_maps '
                             'and range_split')
        ec = auto_chunk(rowptr) if chunk == 'auto' else int(chunk)
        if edge_weight is not None:
            edge_weight = np.asarray(edge_weight, dtype=np.float32)
            # The plain plan cannot carry weights: both sides dedup.
            dedup = 'on'
        t_ptr, t_col, order = _transpose_csr(rowptr, col, num_cols,
                                             return_order=True)
        t_weight = edge_weight[order] if edge_weight is not None else None

        def side(rp, cl, w):
            if dedup == 'auto' and estimate_dedup(rp, cl, ec=ec)[1] < 1.3:
                return build_spmm_plan(rp, cl, chunk=ec, device=device)
            return build_dedup_plan(rp, cl, ec=ec, edge_weight=w,
                                    device=device)

        return SpmmGraph(fwd=side(rowptr, col, edge_weight),
                         bwd=side(t_ptr, t_col, t_weight), deg=deg, mm=mm)
    if range_split > 1:
        if with_edge_maps:
            raise ValueError('range_split is incompatible with '
                             'with_edge_maps (padded-space ops need the '
                             'single-plan edge layout)')
        t_ptr, t_col = _transpose_csr(rowptr, col, num_cols)
        if range_fused:
            fwd = build_fused_range_plan(rowptr, col, num_cols, range_split,
                                         chunk, device=device)
            bwd = build_fused_range_plan(t_ptr, t_col, num_rows, range_split,
                                         chunk, device=device)
        else:
            fwd = _build_range_plan(rowptr, col, num_cols, range_split, chunk,
                                    device=device)
            bwd = _build_range_plan(t_ptr, t_col, num_rows, range_split,
                                    chunk, device=device)
        return SpmmGraph(fwd=fwd, bwd=bwd, deg=deg, mm=mm)
    if chunk == 'auto':
        chunk = auto_chunk(rowptr)
    fwd = build_spmm_plan(rowptr, col, chunk=chunk,
                          with_edge_maps=with_edge_maps, device=device)
    t_ptr, t_col = _transpose_csr(rowptr, col, num_cols)
    bwd = build_spmm_plan(t_ptr, t_col, chunk=chunk,
                          with_edge_maps=with_edge_maps, device=device)
    return SpmmGraph(fwd=fwd, bwd=bwd, deg=deg, mm=mm)


# spmm_csr's graphs: at most _GRAPH_CACHE_ENTRIES, the oldest dropped first.
_GRAPH_CACHE: dict = {}
_GRAPH_CACHE_ENTRIES = 8


def spmm_csr(x: torch.Tensor, rowptr, col,
             reduce: str = 'sum') -> torch.Tensor:
    """``segment_csr(x[col], rowptr, reduce)`` over a graph built once and
    cached: :func:`build_spmm_graph` on ``x``'s device with its defaults,
    then :func:`spmm`, for callers who do not keep plans themselves.

    ``rowptr`` and ``col`` are numpy arrays, lists or tensors; a CUDA one
    is copied to the host once per call. Up to 8 graphs are cached, keyed
    by buffer identity for numpy arrays and by content otherwise
    (``plan_cache.plan_key``), and every hit is checked against stored
    copies, so a buffer changed in place gets a new graph.
    """
    rp, cl = _host(rowptr), _host(col)
    key = (plan_key(rowptr, rp), plan_key(col, cl), x.device)
    hit = _GRAPH_CACHE.get(key)
    if (hit is None or not np.array_equal(hit[1], rp)
            or not np.array_equal(hit[2], cl)):
        graph = build_spmm_graph(rp, cl, device=x.device)
        if key not in _GRAPH_CACHE and (len(_GRAPH_CACHE) >=
                                        _GRAPH_CACHE_ENTRIES):
            _GRAPH_CACHE.pop(next(iter(_GRAPH_CACHE)))
        _GRAPH_CACHE[key] = hit = (graph, rp.copy(), cl.copy())
    return spmm(x, hit[0], reduce=reduce)


def _plan_apply_any(x: torch.Tensor, plan: Plan,
                    precision: Optional[str] = None) -> torch.Tensor:
    if isinstance(plan, DedupSpmmPlan):
        return dedup_plan_apply(x, plan, precision=precision)
    if isinstance(plan, FusedRangePlan):
        return fused_range_apply(x, plan, precision=precision)
    if isinstance(plan, RangeSpmmPlan):
        return _range_plan_apply(x, plan, precision=precision)
    return spmm_plan_apply(x, plan, precision=precision)


class _SpmmSum(torch.autograd.Function):
    """Sum aggregation whose backward is the same kernel over the
    transpose plan; gradient rows go through the forward's precision."""

    @staticmethod
    def forward(ctx, x, graph, precision):
        ctx.graph = graph
        ctx.precision = precision
        return _plan_apply_any(x, graph.fwd, precision)

    @staticmethod
    def backward(ctx, g):
        return (_plan_apply_any(g.contiguous(), ctx.graph.bwd,
                                ctx.precision), None, None)


def spmm(x: torch.Tensor, graph: SpmmGraph, reduce: str = 'sum',
         precision: Optional[str] = None) -> torch.Tensor:
    """``out[r] = reduce_{e in row r} x[col[e]]`` with a prebuilt plan.

    ``reduce`` in {'sum', 'add', 'mean', 'max', 'min'}. ``precision=None``
    keeps float32 rows; ``'bf16'`` reads rows in bfloat16 with float32
    accumulation; ``'int8'`` quantises ``x`` (and the cotangent in the
    backward) per feature column. max/min ignore ``precision``: they are
    exact (the values of the first winning edge on a chunked plan, of the
    least winning column on a dedup min/max plan; 0 for an empty row), and
    their gradient goes to the winning source row only. They run over
    ``graph.mm``, else ``graph.fwd``, which must then be a chunked plan.
    ``x`` must be on the graph's device.
    """
    if precision not in (None, 'highest', 'bf16', 'int8'):
        raise ValueError(f"spmm precision must be None, 'highest', 'bf16' "
                         f"or 'int8', got {precision!r}")
    if precision == 'highest':
        precision = None
    if reduce not in ('sum', 'add', 'mean', 'max', 'min'):
        raise ValueError(f"spmm reduce must be 'sum', 'add', 'mean', 'max' "
                         f"or 'min', got {reduce!r}")
    if x.device != graph.deg.device:
        raise ValueError(f'x is on {x.device} but the graph is on '
                         f'{graph.deg.device}')
    # The transpose plan has one row per source node: the kernels index
    # x with the plans' column ids unchecked.
    if x.dim() != 2 or x.shape[0] != graph.bwd.num_rows:
        raise ValueError(f'x must be [{graph.bwd.num_rows}, F] for this '
                         f'graph, got {tuple(x.shape)}')
    if reduce in ('max', 'min'):
        plan = graph.mm if graph.mm is not None else graph.fwd
        if not isinstance(plan, (SpmmPlan, DedupMinmaxPlan)):
            raise ValueError(
                "spmm reduce='max'/'min' needs a single-plan graph or one "
                "built with minmax='auto'/'on' (range_split/dedup plans "
                'carry no min/max schedule of their own)')
        empty = (graph.deg < 0.5)[:, None]
        idx = plan.col_padded if isinstance(plan, SpmmPlan) else None
        return _ExactMax.apply(x, plan, idx, reduce == 'min',
                               empty).to(x.dtype)
    out = _SpmmSum.apply(x, graph, precision)
    if reduce == 'mean':
        out = out / graph.deg.clamp(min=1.0).to(out.dtype)[:, None]
    return out


class _ExactMax(torch.autograd.Function):
    """Exact per-row max (min: of the negated messages, negated back) over
    a chunked plan (K4; messages ``src[idx[p]]``, or ``src[p]`` when
    ``idx`` is ``None``) or a dedup min/max plan (K5). Rows in ``empty``
    give 0. The gradient is winner-only: each row's cotangent goes to the
    one source row that won, mapped from its position only here."""

    @staticmethod
    def forward(ctx, src, plan, idx, is_min, empty):
        src32 = src.float().contiguous()
        if isinstance(plan, DedupMinmaxPlan):
            vals, pos = dedup_minmax(src32, plan, negate=is_min)
            idx = plan.uniq_cols
        else:
            vals, pos = segment_max_kernel(src32, plan, idx, negate=is_min)
        if is_min:
            vals = -vals
        vals = torch.where(empty, torch.zeros_like(vals), vals)
        pos = torch.where(empty | (pos >= POS_NONE), torch.full_like(pos, -1),
                          pos)
        ctx.save_for_backward(pos)
        ctx.idx, ctx.n, ctx.dtype = idx, src.shape[0], src.dtype
        return vals

    @staticmethod
    def backward(ctx, g):
        (pos, ) = ctx.saved_tensors
        hit = pos >= 0
        slot = torch.where(hit, pos, torch.zeros_like(pos)).long()
        tgt = slot if ctx.idx is None else ctx.idx[slot].long()
        tgt = torch.where(hit, tgt, torch.full_like(tgt, ctx.n))
        grad = torch.zeros((ctx.n + 1, g.shape[1]), dtype=g.dtype,
                           device=g.device)
        grad.scatter_add_(0, tgt, g)  # row n takes the rows with no winner
        return grad[:ctx.n].to(ctx.dtype), None, None, None, None


def _rows_nonempty(plan: SpmmPlan) -> torch.Tensor:
    """Rows with at least one slot, read off ``tile_ptr``."""
    bounds = plan.tile_ptr[:, 0, :]
    lo = bounds[:, :TR].reshape(-1)[:plan.num_rows]
    hi = bounds[:, 1:TR + 1].reshape(-1)[:plan.num_rows]
    return hi > lo


def segment_max_padded(x_padded: torch.Tensor,
                       plan: SpmmPlan) -> torch.Tensor:
    """Exact per-row max of padded messages ``[E_pad, F]`` (K4), as f32;
    an empty row gives 0, and the gradient goes to the winning slot
    only."""
    return _ExactMax.apply(x_padded, plan, None, False,
                           ~_rows_nonempty(plan)[:, None])


def segment_min_padded(x_padded: torch.Tensor,
                       plan: SpmmPlan) -> torch.Tensor:
    """Per-row min in padded coordinates (negated max)."""
    return -segment_max_padded(-x_padded, plan)


def _gathered_max_padded(src: torch.Tensor,
                         plan: SpmmPlan) -> torch.Tensor:
    """``segment_max_padded(src[plan.col_padded], plan)`` with the gather
    fused into K4, so the ``[E_pad, F]`` message slab is never written;
    values and gradient are the same."""
    return _ExactMax.apply(src, plan, plan.col_padded, False,
                           ~_rows_nonempty(plan)[:, None])


# -- padded-space primitives (attention layers) -------------------------------
#
# These work in a chunked plan's padded edge coordinates, so a GAT layer
# (gather, attention logits, per-row softmax, weighted aggregation) needs no
# per-edge permutation: one gather in, one write of the output rows.


def _need_edge_maps(plan, what: str):
    if not isinstance(plan, SpmmPlan) or plan.row_padded is None:
        raise ValueError(f'{what} needs a plan built with_edge_maps=True '
                         f'(the VJP uses row_padded)')


class _SegmentSumPadded(torch.autograd.Function):
    """K1 over padded messages; the gradient of slot ``p`` is its row's
    cotangent, 0 at pad slots."""

    @staticmethod
    def forward(ctx, msgs_padded, plan):
        ctx.plan, ctx.dtype = plan, msgs_padded.dtype
        return segment_sum_chunked(msgs_padded.contiguous(), plan)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        # Pad slots alias row 0 through row_padded: the mask zeroes them
        # (in place, so one [E_pad, F] slab is written, not two).
        grad = g.index_select(0, plan.row_padded)
        grad.mul_(plan.valid_mask[:, None])
        return grad.to(ctx.dtype), None


def segment_sum_padded(msgs_padded: torch.Tensor,
                       plan: SpmmPlan) -> torch.Tensor:
    """``out[r] = Σ msgs_padded[slots of row r]`` as ``[num_rows, F]`` f32
    (kernel K1 without the gather). Needs a plan built
    ``with_edge_maps=True``; the backward is ``g[row_padded]`` with pad
    slots 0."""
    _need_edge_maps(plan, 'segment_sum_padded')
    return _SegmentSumPadded.apply(msgs_padded, plan)


class _SegmentSoftmaxPadded(torch.autograd.Function):
    """K6 forward; the closed-form backward ``out * (g - Σ_row(out·g))``
    with the row sums through K1."""

    @staticmethod
    def forward(ctx, x_padded, plan):
        out = segment_softmax_planned(x_padded.contiguous(), plan)
        ctx.save_for_backward(out)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, g):
        (out, ) = ctx.saved_tensors
        plan = ctx.plan
        og = out * g
        s = segment_sum_chunked(og.contiguous(), plan)
        grad = out.float() * (g.float() - s.index_select(0, plan.row_padded))
        return grad.to(out.dtype), None


def segment_softmax_padded(x_padded: torch.Tensor,
                           plan: SpmmPlan) -> torch.Tensor:
    """Per-row softmax in padded edge coordinates (kernel K6), ``[E_pad,
    F]`` in ``x_padded``'s type with pad slots 0. Needs a plan built
    ``with_edge_maps=True``. The backward is the closed form
    ``out * (g - Σ_row(out·g))``, its row sums through K1."""
    _need_edge_maps(plan, 'segment_softmax_padded')
    return _SegmentSoftmaxPadded.apply(x_padded, plan)


def sddmm(x: torch.Tensor, y: torch.Tensor, graph: SpmmGraph) -> torch.Tensor:
    """Sampled dense-dense matmul, ``out[e] = <x[row_e], y[col_e]>``, as
    ``[num_edges]`` in the original edge order: per-edge scores from node
    embeddings (attention logits, link prediction). Runs in the forward
    plan's padded coordinates (``with_edge_maps=True``) with plain
    PyTorch gathers, as the JAX package has no kernel for it;
    differentiable by autograd."""
    plan = graph.fwd
    if not isinstance(plan, SpmmPlan) or plan.row_padded is None:
        raise ValueError('sddmm needs build_spmm_graph(with_edge_maps=True)')
    xs = x.index_select(0, plan.row_padded)
    ys = y.index_select(0, plan.col_padded)
    return (xs * ys).sum(-1).index_select(0, plan.edge_pos)
