"""Planned SpMM — the fused full-graph message-passing aggregation.

Port of ``pyg_lib_tpu/ops/spmm.py`` (sum/add/mean over the chunked, the
deduplicated and the range-split plans, max/min over the chunked and the
dedup min/max plans, the row-split plans of graphs too large for one plan,
and the padded-space primitives of attention layers).
:func:`build_spmm_graph` builds the forward plan and the plan of the
transposed graph on the host once per graph; :func:`spmm` runs them
(:func:`build_spmm_graph_sharded` and :func:`spmm_sharded` the same, one
plan per row split). The sum's gradient is the same kernel over the
transpose plan, d/dx (A @ x) = Aᵀ @ g; the max/min gradient goes to each
row's winning source row only.
"""

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from pyg_lib_tpu_torch import partition, profiling
from pyg_lib_tpu_torch.ops.kernels.plan_cache import _host, plan_key
from pyg_lib_tpu_torch.ops.kernels.segment_minmax import (POS_NONE,
                                                          segment_max_kernel)
from pyg_lib_tpu_torch.ops.kernels.segment_softmax import (
    segment_softmax_planned)
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (TR, SpmmPlan,
                                                        auto_chunk,
                                                        build_spmm_plan,
                                                        quantize_columns,
                                                        segment_sum_chunked,
                                                        spmm_chunked,
                                                        spmm_plan_apply)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup import (DedupSpmmPlan,
                                                      build_dedup_plan,
                                                      dedup_plan_apply,
                                                      dedup_sum,
                                                      estimate_dedup, pad_hot,
                                                      pad_plan)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup_minmax import (
    DedupMinmaxPlan, build_dedup_minmax_plan, dedup_minmax, dedup_pairs,
    estimate_minmax_config, pad_minmax_plan)
from pyg_lib_tpu_torch.ops.kernels.spmm_range_fused import (
    FusedRangePlan, _column_range_csrs, _equal_ranges, build_fused_range_plan,
    fused_range_apply, fused_range_sum)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['RangeSpmmPlan', 'ShardedSpmmGraph', 'SpmmGraph',
           'build_spmm_graph', 'build_spmm_graph_sharded',
           'build_weighted_fused_graph', 'sddmm', 'segment_max_padded',
           'segment_min_padded', 'segment_softmax_padded',
           'segment_sum_padded', 'spmm', 'spmm_csr', 'spmm_sharded']


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
    would not pay and ``fwd`` cannot serve.

    A cluster-reordered graph (``build_spmm_graph(reorder=...)``) has its
    plans over the relabelled graph, ``perm[new] = old`` and ``rank[old]
    = new``; :func:`spmm` permutes ``x`` in and the output back, so
    callers keep the original ids (``deg`` is in the original order)."""
    fwd: Plan
    bwd: Plan  # plan over the transposed graph (for grad_x)
    deg: torch.Tensor  # [num_rows] f32 row degrees (for reduce='mean')
    mm: Optional[Union[SpmmPlan, DedupMinmaxPlan]] = None
    perm: Optional[torch.Tensor] = None  # [num_rows] int64, new -> old
    rank: Optional[torch.Tensor] = None  # [num_rows] int64, old -> new


class _PermuteRows(torch.autograd.Function):
    """``x[perm]``; on a permutation the gradient is the inverse gather
    ``g[inv]`` (no scatter)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        (inv, ) = ctx.saved_tensors
        return g[inv], None, None


_permute_rows = _PermuteRows.apply


def _forward_plan(graph: SpmmGraph, what: str) -> Plan:
    """``graph.fwd`` for ``what``, which reads the forward plan's rows and
    columns itself: a cluster-reordered graph's plans are over the
    relabelled ids, so it is refused (only :func:`spmm` permutes)."""
    if graph.perm is not None:
        raise ValueError(f"{what} takes no cluster-reordered graph (built "
                         f"with reorder='auto'/'on'/k): its plans are over "
                         f"the relabelled ids; use spmm, or reorder='off'")
    return graph.fwd


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


def _mode(value, what: str) -> str:
    """``dedup``/``minmax`` as ``'off'``, ``'auto'`` or ``'on'`` (booleans
    taken as off and on)."""
    if value not in ('off', 'auto', 'on', False, True):
        raise ValueError(f"{what} must be 'off', 'auto' or 'on', got "
                         f'{value!r}')
    return {'off': 'off', False: 'off', 'on': 'on', True: 'on',
            'auto': 'auto'}[value]


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


def _gate(side: str, rowptr, col, ec: int) -> float:
    """:func:`estimate_dedup`'s predicted gain of ``(rowptr, col)`` where
    it decides an ``'auto'`` choice, timed as a ``plan.gate`` span."""
    with profiling.setup_span('plan.gate', side=side) as s:
        s.attrs['gain'] = gain = estimate_dedup(rowptr, col, ec=ec)[1]
    return gain


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

    ``reorder`` in {'off', 'auto', 'on'} or a partition count
    relabels the graph first (``partition.metis`` into that many parts,
    256 for ``'on'``, at most one part per 128 rows, then
    ``partition.cluster_reorder``), so that each tile's gathers fall in
    one region of ``x``; :func:`spmm` then permutes ``x`` in and the
    output back. ``'auto'`` keeps the relabelling only where
    :func:`estimate_dedup` predicts at least 1.3 (and 1.1 times the
    original's) dedup gain on it, the JAX package's gate, set on the TPU
    and kept for parity. Square adjacencies only; refuses
    ``with_edge_maps``.

    The build is a ``plan.build`` span of :mod:`~pyg_lib_tpu_torch.
    profiling`, and each gain estimate that decides an ``'auto'`` a
    ``plan.gate`` span (``side``, ``gain``).
    """
    with profiling.setup_span('plan.build'):
        return _build_spmm_graph(rowptr, col, chunk, with_edge_maps,
                                 num_cols, range_split, range_fused, dedup,
                                 edge_weight, minmax, reorder, device)


def _build_spmm_graph(rowptr, col, chunk, with_edge_maps, num_cols,
                      range_split, range_fused, dedup, edge_weight, minmax,
                      reorder, device) -> SpmmGraph:
    dedup = _mode(dedup, 'dedup')
    minmax = _mode(minmax, 'minmax')
    if reorder not in ('off', 'auto', 'on', False, True) and not isinstance(
            reorder, int):
        raise ValueError(f"reorder must be 'off', 'auto', 'on' or a "
                         f'partition count, got {reorder!r}')
    reorder = {'off': 'off', False: 'off', 'on': 'on', True: 'on',
               'auto': 'auto'}.get(reorder, reorder)
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_rows = rowptr.shape[0] - 1
    if num_cols is None:
        num_cols = num_rows
    deg = torch.from_numpy(np.diff(rowptr).astype(np.float32)).to(device)
    perm = rank = None
    if reorder != 'off':
        if num_cols != num_rows:
            raise ValueError('reorder requires a square adjacency')
        if with_edge_maps:
            raise ValueError('reorder is incompatible with with_edge_maps '
                             '(padded-edge coordinates must stay stable)')
        k = reorder if isinstance(reorder, int) else 256
        k = min(k, max(num_rows // 128, 2))
        part = partition.metis(rowptr, col, k)
        rp_r, cl_r, node_perm, edge_perm = partition.cluster_reorder(
            rowptr, col, part)
        adopt = True
        if reorder == 'auto':
            ecr = 512 if chunk == 'auto' else int(chunk)
            g0 = _gate('original', rowptr, col, ecr)
            g1 = _gate('reordered', rp_r, cl_r, ecr)
            adopt = g1 >= max(1.3, 1.1 * g0)
        if adopt:
            rowptr, col = rp_r, cl_r
            if edge_weight is not None:
                edge_weight = np.asarray(edge_weight, np.float32)[edge_perm]
            rank_np = np.empty(num_rows, np.int64)
            rank_np[node_perm] = np.arange(num_rows, dtype=np.int64)
            perm = torch.from_numpy(node_perm.astype(np.int64)).to(device)
            rank = torch.from_numpy(rank_np).to(device)
    mm = None
    if minmax != 'off':
        rp_d, cl_d = dedup_pairs(rowptr, col)
        ec_mm, uc_mm = estimate_minmax_config(rp_d, cl_d)
        if minmax == 'on' or _gate('minmax', rp_d, cl_d, ec_mm) >= 1.3:
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

        def side(name, rp, cl, w):
            if dedup == 'auto' and _gate(name, rp, cl, ec) < 1.3:
                return build_spmm_plan(rp, cl, chunk=ec, device=device)
            return build_dedup_plan(rp, cl, ec=ec, edge_weight=w,
                                    device=device)

        return SpmmGraph(fwd=side('fwd', rowptr, col, edge_weight),
                         bwd=side('bwd', t_ptr, t_col, t_weight), deg=deg,
                         mm=mm, perm=perm, rank=rank)
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
        return SpmmGraph(fwd=fwd, bwd=bwd, deg=deg, mm=mm, perm=perm,
                         rank=rank)
    if chunk == 'auto':
        chunk = auto_chunk(rowptr)
    fwd = build_spmm_plan(rowptr, col, chunk=chunk,
                          with_edge_maps=with_edge_maps, device=device)
    t_ptr, t_col = _transpose_csr(rowptr, col, num_cols)
    bwd = build_spmm_plan(t_ptr, t_col, chunk=chunk,
                          with_edge_maps=with_edge_maps, device=device)
    return SpmmGraph(fwd=fwd, bwd=bwd, deg=deg, mm=mm, perm=perm,
                     rank=rank)


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
        with profiling.span('ops.spmm.backward',
                            plan=type(ctx.graph.bwd).__name__):
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
    ``x`` must be on the graph's device. On a reordered graph ``x`` is
    permuted in and the output back out (each a gather whose gradient is
    the inverse gather).

    The call is an ``ops.spmm`` span of :mod:`~pyg_lib_tpu_torch.
    profiling`, and the backward of a sum an ``ops.spmm.backward`` one.
    """
    with profiling.span('ops.spmm', plan=type(graph.fwd).__name__):
        return _spmm(x, graph, reduce, precision)


def _spmm(x: torch.Tensor, graph: SpmmGraph, reduce: str,
          precision: Optional[str]) -> torch.Tensor:
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
    reordered = graph.perm is not None
    xp = _permute_rows(x, graph.perm, graph.rank) if reordered else x
    if reduce in ('max', 'min'):
        plan = graph.mm if graph.mm is not None else graph.fwd
        if not isinstance(plan, (SpmmPlan, DedupMinmaxPlan)):
            raise ValueError(
                "spmm reduce='max'/'min' needs a single-plan graph or one "
                "built with minmax='auto'/'on' (range_split/dedup plans "
                'carry no min/max schedule of their own)')
        deg = graph.deg[graph.perm] if reordered else graph.deg
        idx = plan.col_padded if isinstance(plan, SpmmPlan) else None
        out = _ExactMax.apply(xp, plan, idx, reduce == 'min',
                              (deg < 0.5)[:, None]).to(x.dtype)
    else:
        out = _SpmmSum.apply(xp, graph, precision)
    if reordered:
        out = _permute_rows(out, graph.rank, graph.perm)
    if reduce == 'mean':
        out = out / graph.deg.clamp(min=1.0).to(out.dtype)[:, None]
    return out


def _exact_max(src, plan, idx, is_min, empty):
    """Exact per-row max (min: of the negated messages, negated back) over
    a chunked plan (K4; messages ``src[idx[p]]``, or ``src[p]`` when
    ``idx`` is ``None``) or a dedup min/max plan (K5), 0 in the rows of
    ``empty``: the values, each winner's position (-1 for none) and the
    index that maps a position to its source row."""
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
    return vals, pos, idx


def _winner_grad(g, found, n, dtype):
    """The winner-only gradient of ``[n, F]`` sources: each row's
    cotangent (rows of ``g`` in the order of ``found``'s ``(pos, idx)``
    pairs) added into the source row that won. Added in f64: a hub column
    of a power-law graph wins in millions of rows, and an f32 sum of m
    terms in any order may be off by m * 2**-24 of their magnitude
    (PERF.md)."""
    grad = torch.zeros((n + 1, g.shape[1]), dtype=torch.float64,
                       device=g.device)  # row n: the rows with no winner
    lo = 0
    for pos, idx in found:
        part = g[lo:lo + pos.shape[0]]
        pos = pos[:part.shape[0]]
        lo += pos.shape[0]
        hit = pos >= 0
        slot = torch.where(hit, pos, torch.zeros_like(pos)).long()
        tgt = slot if idx is None else idx[slot].long()
        grad.scatter_add_(0, torch.where(hit, tgt, n), part.double())
    return grad[:n].to(dtype)


class _ExactMax(torch.autograd.Function):
    """:func:`_exact_max` of one plan. The gradient is winner-only: each
    row's cotangent goes to the one source row that won, mapped from its
    position only here."""

    @staticmethod
    def forward(ctx, src, plan, idx, is_min, empty):
        vals, pos, ctx.idx = _exact_max(src, plan, idx, is_min, empty)
        ctx.save_for_backward(pos)
        ctx.n, ctx.dtype = src.shape[0], src.dtype
        return vals

    @staticmethod
    def backward(ctx, g):
        (pos, ) = ctx.saved_tensors
        return (_winner_grad(g, [(pos, ctx.idx)], ctx.n, ctx.dtype), None,
                None, None, None)


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


# -- row-split plans for graphs too large for one plan ------------------------


class ShardedSpmmGraph(NamedTuple):
    """Row-range-split plans (:func:`build_spmm_graph_sharded`).

    ``fwd`` holds one plan per split of the destination rows, ``bwd`` one
    per split of the transpose's rows (the source nodes), each over its
    rows only; ``mm`` (``minmax=...``) per-split ``reduce='max'/'min'``
    schedules over the pair-deduped edges. Every split has the same row
    count (the last one padded with empty rows) and, per side, the same
    chunk count.
    """
    fwd: tuple
    bwd: tuple
    deg: torch.Tensor  # [num_rows] f32 row degrees (for reduce='mean')
    num_rows: int
    num_cols: int
    mm: Optional[tuple] = None  # per-split min/max plans, or None


def _split_csrs(rowptr, col, num_rows: int, num_splits: int) -> list:
    """``num_splits`` CSRs of ``ceil(num_rows / num_splits)`` rows each,
    over consecutive row ranges; the last ends in empty rows."""
    npd = -(-num_rows // num_splits)
    subs = []
    for i in range(num_splits):
        lo, hi = min(i * npd, num_rows), min((i + 1) * npd, num_rows)
        sub_rp = np.empty(npd + 1, np.int64)
        sub_rp[:hi - lo + 1] = rowptr[lo:hi + 1] - rowptr[lo]
        sub_rp[hi - lo + 1:] = sub_rp[hi - lo]  # trailing empty rows
        subs.append((sub_rp, col[rowptr[lo]:rowptr[hi]]))
    return subs


def _widest(dtypes) -> torch.dtype:
    """The widest of int8, bf16 and f32 among ``dtypes``."""
    rank = [torch.int8, torch.bfloat16, torch.float32]
    return max(dtypes, key=rank.index)


def build_spmm_graph_sharded(rowptr, col, num_splits: int, chunk=512,
                             num_cols: Optional[int] = None,
                             range_split: int = 1, dedup='off',
                             minmax='off', device=None) -> ShardedSpmmGraph:
    """Host-side, once per graph: ``num_splits`` row-range plans of the
    graph and of its transpose, with their tensors on ``device`` (default:
    the CUDA card). Each split's plan holds only its own rows' slots, so a
    graph whose one plan would not fit still runs (:func:`spmm_sharded`).

    The splits take ``ceil(rows / num_splits)`` rows each and, per side,
    one chunk count (pad chunks appended), as in the JAX package, where
    equal shapes share one compiled kernel. ``chunk='auto'`` sizes one
    chunk over the splits. ``range_split=S`` builds a
    :class:`RangeSpmmPlan` per split (K1 per column range), all with one
    chunk size and count.

    ``dedup`` in {'off', 'auto', 'on'} gives every split of a side the
    dedup plan (``'auto'``: where :func:`estimate_dedup` on the whole side
    predicts a gain of at least 1.3), each split with its own ``uc``
    estimate, rebuilt at the largest, a hot level of at most
    ``max(2**30 // num_splits, 32 MiB)`` bytes, and all padded to one
    chunk count, hot width and ``hot_w`` type (:func:`pad_plan`,
    :func:`pad_hot`). ``minmax`` in {'off', 'auto', 'on'} also builds
    per-split max/min plans over the pair-deduped edges: dedup min/max
    plans (K5; ``'auto'``: where the gain on the whole deduped graph is
    at least 1.3) padded to one chunk count and scan depth
    (:func:`pad_minmax_plan`), else chunked plans. Neither goes with
    ``range_split``.
    """
    dedup = _mode(dedup, 'dedup')
    minmax = _mode(minmax, 'minmax')
    if dedup != 'off' and range_split > 1:
        raise ValueError('dedup is incompatible with range_split')
    if minmax != 'off' and range_split > 1:
        raise ValueError('minmax is incompatible with range_split')
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_rows = rowptr.shape[0] - 1
    if num_cols is None:
        num_cols = num_rows

    def chunked(subs, ck):
        cmax = max(_plan_chunks(s_rp, ck) for s_rp, _ in subs)
        return tuple(build_spmm_plan(s_rp, s_cl, chunk=ck, pad_to_chunks=cmax,
                                     device=device) for s_rp, s_cl in subs)

    def split_plans(rp, cl, n_rows, n_cols):
        subs = _split_csrs(rp, cl, n_rows, num_splits)
        if dedup != 'off':
            ec = auto_chunk(rp) if chunk == 'auto' else int(chunk)
            if dedup == 'on' or estimate_dedup(rp, cl, ec=ec)[1] >= 1.3:
                # The hot level's byte budget is per plan: shared out over
                # the splits, as in the JAX package.
                hb = max((1 << 30) // num_splits, 32 << 20)
                plans = [build_dedup_plan(s_rp, s_cl, ec=ec, uc='auto',
                                          hot_budget_bytes=hb, device=device)
                         for s_rp, s_cl in subs]
                ucmax = max(p.uc for p in plans)
                plans = [p if p.uc == ucmax else build_dedup_plan(
                    s_rp, s_cl, ec=ec, uc=ucmax, hot_budget_bytes=hb,
                    device=device) for p, (s_rp, s_cl) in zip(plans, subs)]
                cmax = max(p.num_chunks for p in plans)
                hmax = max(p.num_hot for p in plans)
                hdt = (_widest([p.hot_w.dtype for p in plans if p.num_hot])
                       if hmax else None)
                return tuple(pad_hot(pad_plan(p, cmax), hmax, dtype=hdt)
                             for p in plans)
        if range_split > 1:
            bounds = _equal_ranges(n_cols, range_split)
            range_rps = [rp_r for s_rp, s_cl in subs
                         for rp_r, _, _ in _column_range_csrs(s_rp, s_cl,
                                                              bounds)]
            if chunk != 'auto':
                ck = chunk
            else:
                ck = (max(auto_chunk(rp_r) for rp_r in range_rps)
                      if range_rps else 512)
            cmax = max((_plan_chunks(rp_r, ck) for rp_r in range_rps),
                       default=1)
            return tuple(_build_range_plan(s_rp, s_cl, n_cols, range_split,
                                           ck, pad_to_chunks=cmax,
                                           device=device)
                         for s_rp, s_cl in subs)
        ck = (max(auto_chunk(s_rp) for s_rp, _ in subs) if chunk == 'auto'
              else chunk)
        return chunked(subs, ck)

    fwd = split_plans(rowptr, col, num_rows, num_cols)
    t_ptr, t_col = _transpose_csr(rowptr, col, num_cols)
    bwd = split_plans(t_ptr, t_col, num_cols, num_rows)
    del t_ptr, t_col

    mm = None
    if minmax != 'off':
        # One gate on the whole deduped graph, so every split takes the
        # same kind of schedule.
        rp_d, cl_d = dedup_pairs(rowptr, col)
        ec_mm, uc_mm = estimate_minmax_config(rp_d, cl_d)
        subs_d = _split_csrs(rp_d, cl_d, num_rows, num_splits)
        if minmax == 'on' or _gate('minmax', rp_d, cl_d, ec_mm) >= 1.3:
            plans = [build_dedup_minmax_plan(s_rp, s_cl, ec=ec_mm, uc=uc_mm,
                                             _pre_deduped=True, device=device)
                     for s_rp, s_cl in subs_d]
            cmax = max(p.num_chunks for p in plans)
            smax = max(p.scan_len for p in plans)
            mm = tuple(pad_minmax_plan(p, cmax, scan_len=smax)
                       for p in plans)
        else:
            mm = chunked(subs_d, max(auto_chunk(s_rp) for s_rp, _ in subs_d)
                         if chunk == 'auto' else int(chunk))

    deg = torch.from_numpy(np.diff(rowptr).astype(np.float32)).to(device)
    return ShardedSpmmGraph(fwd=fwd, bwd=bwd, deg=deg, num_rows=num_rows,
                            num_cols=int(num_cols), mm=mm)


def _plan_sum(xm: torch.Tensor, plan) -> torch.Tensor:
    """``plan``'s kernel over rows already in their read type (f32, bf16
    or int8): ``[num_rows, F]`` f32 sums."""
    if isinstance(plan, DedupSpmmPlan):
        return dedup_sum(xm, plan)
    if isinstance(plan, FusedRangePlan):
        return fused_range_sum(xm, plan)
    if isinstance(plan, RangeSpmmPlan):
        out = None
        for (lo, hi), p in zip(plan.bounds, plan.plans):
            o = spmm_chunked(xm[lo:hi], p)
            out = o if out is None else out + o
        return out
    return spmm_chunked(xm, plan)


def _sharded_apply(x: torch.Tensor, plans, num_rows: int,
                   precision: Optional[str] = None) -> torch.Tensor:
    """Every split's sums, concatenated and trimmed to ``num_rows``. The
    rows are cast to bf16 or quantised (``'int8'``: per column, over the
    whole table, so that every split shares the scales) once for all
    splits; an int8 ``x`` under ``'int8'`` is taken as already quantised
    and its raw f32 sums are returned."""
    scale = None
    if precision == 'int8' and x.dtype != torch.int8:
        xm, scale = quantize_columns(x)
    elif precision == 'bf16':
        xm = x.to(torch.bfloat16).contiguous()
    else:
        xm = x.contiguous()
    out = torch.cat([_plan_sum(xm, p) for p in plans])[:num_rows]
    if scale is not None:
        out = out * scale[None, :]
    return out if x.dtype == torch.int8 else out.to(x.dtype)


class _ShardedSum(torch.autograd.Function):
    """Sum over the forward splits; the backward is the same over the
    transpose's splits, in the forward's precision."""

    @staticmethod
    def forward(ctx, x, graph, precision):
        ctx.graph, ctx.precision = graph, precision
        return _sharded_apply(x, graph.fwd, graph.num_rows, precision)

    @staticmethod
    def backward(ctx, g):
        return (_sharded_apply(g, ctx.graph.bwd, ctx.graph.num_cols,
                               ctx.precision), None, None)


class _ShardedMax(torch.autograd.Function):
    """:func:`_exact_max` of each split, concatenated and trimmed to
    ``num_rows``. The backward adds every split's winners into one
    gradient (JAX's ``_spmm_sharded_minmax_bwd``)."""

    @staticmethod
    def forward(ctx, x, plans, is_min, empty, num_rows):
        npd = plans[0].num_rows
        outs, found = [], []
        for i, p in enumerate(plans):
            idx = p.col_padded if isinstance(p, SpmmPlan) else None
            vals, pos, idx = _exact_max(x, p, idx, is_min,
                                        empty[i * npd:(i + 1) * npd, None])
            outs.append(vals)
            found.append((pos, idx))
        ctx.save_for_backward(*[pos for pos, _ in found])
        ctx.idx = [idx for _, idx in found]
        ctx.n, ctx.dtype = x.shape[0], x.dtype
        return torch.cat(outs)[:num_rows]

    @staticmethod
    def backward(ctx, g):
        return (_winner_grad(g, list(zip(ctx.saved_tensors, ctx.idx)),
                             ctx.n, ctx.dtype), None, None, None, None)


def _sharded_minmax(x: torch.Tensor, graph: ShardedSpmmGraph,
                    is_min: bool) -> torch.Tensor:
    """Exact max/min per split (K5 on a dedup min/max plan, K4 with the
    gather fused on a chunked one), concatenated and trimmed; an empty row
    gives 0, and the gradient goes to each row's winner only."""
    plans = graph.mm if graph.mm is not None else graph.fwd
    empty = torch.ones(plans[0].num_rows * len(plans), dtype=torch.bool,
                       device=graph.deg.device)
    empty[:graph.num_rows] = graph.deg < 0.5
    return _ShardedMax.apply(x, plans, is_min, empty, graph.num_rows)


def spmm_sharded(x: torch.Tensor, graph: ShardedSpmmGraph,
                 reduce: str = 'sum',
                 precision: Optional[str] = None) -> torch.Tensor:
    """:func:`spmm` over a :class:`ShardedSpmmGraph`: each split's kernel
    writes its rows, the splits' results are joined.

    ``precision`` as in :func:`spmm` (``'int8'`` quantises ``x`` once, so
    every split shares its column scales). ``reduce='max'/'min'`` is exact,
    with the winner-only gradient, over ``graph.mm`` (a graph built
    ``minmax='auto'/'on'``) or else plain chunked split plans; it ignores
    ``precision``. ``x`` must be ``[num_cols, F]`` on the graph's device.
    """
    if x.device != graph.deg.device:
        raise ValueError(f'x is on {x.device} but the graph is on '
                         f'{graph.deg.device}')
    if x.dim() != 2 or x.shape[0] != graph.num_cols:
        raise ValueError(f'x must be [{graph.num_cols}, F] for this graph, '
                         f'got {tuple(x.shape)}')
    if reduce in ('max', 'min'):
        plans = graph.mm if graph.mm is not None else graph.fwd
        if not all(isinstance(p, (SpmmPlan, DedupMinmaxPlan))
                   for p in plans):
            raise ValueError(
                "spmm_sharded reduce='max'/'min' needs plain split plans "
                "or a graph built with minmax='auto'/'on'")
        return _sharded_minmax(x, graph, reduce == 'min').to(x.dtype)
    if reduce not in ('sum', 'add', 'mean'):
        raise ValueError(f"spmm reduce must be 'sum', 'add' or 'mean', got "
                         f'{reduce!r}')
    if precision not in (None, 'highest', 'bf16', 'int8'):
        raise ValueError(f"spmm precision must be None, 'highest', 'bf16' "
                         f"or 'int8', got {precision!r}")
    if precision == 'highest':
        precision = None
    out = _ShardedSum.apply(x, graph, precision)
    if reduce == 'mean':
        out = out / graph.deg.clamp(min=1.0).to(out.dtype)[:, None]
    return out


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
    plan = _forward_plan(graph, 'sddmm')
    if not isinstance(plan, SpmmPlan) or plan.row_padded is None:
        raise ValueError('sddmm needs build_spmm_graph(with_edge_maps=True)')
    xs = x.index_select(0, plan.row_padded)
    ys = y.index_select(0, plan.col_padded)
    return (xs * ys).sum(-1).index_select(0, plan.edge_pos)
