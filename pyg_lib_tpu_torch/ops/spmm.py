"""Planned SpMM — the fused full-graph message-passing aggregation.

Port of ``pyg_lib_tpu/ops/spmm.py`` (sum/add/mean over the chunked and
the deduplicated plans). :func:`build_spmm_graph` builds the forward plan
and the plan of the transposed graph on the host once per graph;
:func:`spmm` runs them, and its gradient is the same kernel over the
transpose plan: d/dx (A @ x) = Aᵀ @ g.
"""

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (SpmmPlan,
                                                        auto_chunk,
                                                        build_spmm_plan,
                                                        spmm_plan_apply)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup import (DedupSpmmPlan,
                                                      build_dedup_plan,
                                                      dedup_plan_apply,
                                                      estimate_dedup)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['SpmmGraph', 'build_spmm_graph', 'spmm']

Plan = Union[SpmmPlan, DedupSpmmPlan]


class SpmmGraph(NamedTuple):
    """Forward and transpose plans for one CSR graph, plus row degrees."""
    fwd: Plan
    bwd: Plan  # plan over the transposed graph (for grad_x)
    deg: torch.Tensor  # [num_rows] f32 row degrees (for reduce='mean')


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


def _not_ported(what: str, item: str):
    return NotImplementedError(f'{what} is not ported yet (ROADMAP Queue 1 '
                               f'item {item})')


def build_spmm_graph(rowptr, col, chunk=512, with_edge_maps: bool = False,
                     num_cols: Optional[int] = None, range_split: int = 1,
                     range_fused: bool = False, dedup='off',
                     edge_weight=None, minmax='off', reorder='off',
                     device=None) -> SpmmGraph:
    """Host-side, once per graph: build the forward and transpose plans,
    with their tensors on ``device`` (default: the CUDA card).

    ``num_cols`` is the source-node count of a rectangular adjacency
    (default: the row count). ``chunk='auto'`` sizes the chunk from the
    degree distribution. ``dedup`` in {'off', 'auto', 'on'} selects the
    deduplicated-gather plan: ``'auto'`` takes it per side where
    :func:`estimate_dedup` predicts a gain of at least 1.3, the JAX
    package's threshold, kept for parity. ``edge_weight`` (``[E]`` f32,
    dedup only) bakes weights into both sides. ``range_split``,
    ``range_fused``, ``with_edge_maps``, ``minmax`` and ``reorder`` are
    not ported yet and raise ``NotImplementedError``.
    """
    if range_split > 1 or range_fused:
        raise _not_ported('range_split / range_fused', '9')
    if with_edge_maps:
        raise _not_ported('with_edge_maps', '6')
    if minmax not in ('off', False):
        raise _not_ported("minmax != 'off'", '5')
    if reorder not in ('off', False):
        raise _not_ported("reorder != 'off'", '12 (partition/)')
    if dedup not in ('off', 'auto', 'on', False, True):
        raise ValueError(f"dedup must be 'off', 'auto' or 'on', got "
                         f'{dedup!r}')
    dedup = {'off': 'off', False: 'off', 'on': 'on', True: 'on',
             'auto': 'auto'}[dedup]
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_rows = rowptr.shape[0] - 1
    if num_cols is None:
        num_cols = num_rows
    deg = torch.from_numpy(np.diff(rowptr).astype(np.float32)).to(device)
    if edge_weight is not None and dedup == 'off':
        raise ValueError('edge_weight requires dedup="on"/"auto"')
    if dedup != 'off':
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
                         bwd=side(t_ptr, t_col, t_weight), deg=deg)
    if chunk == 'auto':
        chunk = auto_chunk(rowptr)
    fwd = build_spmm_plan(rowptr, col, chunk=chunk, device=device)
    t_ptr, t_col = _transpose_csr(rowptr, col, num_cols)
    bwd = build_spmm_plan(t_ptr, t_col, chunk=chunk, device=device)
    return SpmmGraph(fwd=fwd, bwd=bwd, deg=deg)


def _plan_apply_any(x: torch.Tensor, plan: Plan,
                    precision: Optional[str] = None) -> torch.Tensor:
    if isinstance(plan, DedupSpmmPlan):
        return dedup_plan_apply(x, plan, precision=precision)
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

    ``reduce`` in {'sum', 'add', 'mean'} ('max'/'min' are not ported
    yet). ``precision=None`` keeps float32 rows; ``'bf16'`` reads rows in
    bfloat16 with float32 accumulation; ``'int8'`` quantises ``x`` (and
    the cotangent in the backward) per feature column. ``x`` must be on
    the graph's device.
    """
    if precision not in (None, 'highest', 'bf16', 'int8'):
        raise ValueError(f"spmm precision must be None, 'highest', 'bf16' "
                         f"or 'int8', got {precision!r}")
    if precision == 'highest':
        precision = None
    if reduce in ('max', 'min'):
        raise _not_ported("spmm reduce='max'/'min'", '5')
    if reduce not in ('sum', 'add', 'mean'):
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
    out = _SpmmSum.apply(x, graph, precision)
    if reduce == 'mean':
        out = out / graph.deg.clamp(min=1.0).to(out.dtype)[:, None]
    return out
