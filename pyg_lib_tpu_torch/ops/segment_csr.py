"""CSR segment reductions and ``gather_csr``, the message-passing primitive.

Port of ``pyg_lib_tpu/ops/segment_csr.py`` (reference ``pyg_lib/ops``
``segment_*_csr``). Rows are contiguous runs of ``src`` along
``dim = indptr.dim() - 1``; positions outside ``[indptr[0], indptr[-1])``
belong to no row. ``indptr`` may carry leading batch dims, which
broadcast against ``src``'s, each slice applying its own row ranges.

Where the work goes:

* ``segment_sum_csr`` (and ``segment_mean_csr``) of a 2-D f32/bf16
  ``src`` with a 1-D ``indptr``: kernel K3, summed in f32. Its gradient
  is ``gather_csr`` of the cotangent.
* ``segment_{max,min}_csr`` of a 2-D f32 ``src`` with a 1-D ``indptr``
  that covers every element (``E == indptr[-1]``) and at least 65,536
  of them: kernel K4 over a cached chunked plan of ``indptr``, reading
  ``src`` through the plan's ``edge_perm``. The result is the first
  winner's, exactly as on the other path.
* Everything else (batched ``indptr``, integer dtypes, other ranks):
  plain PyTorch, as the JAX package keeps it on XLA.

Min/max return ``(values, argindex)``: an empty row gives value 0 and the
sentinel ``src.size(dim)``, and the gradient goes to the winner only.
Like the JAX package, the ops return new tensors; ``out=`` is merged into
the result, not written in place.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from pyg_lib_tpu_torch.ops.kernels.plan_cache import plan_for_ptr
from pyg_lib_tpu_torch.ops.kernels.segment_csr import segment_sum_csr_kernel
from pyg_lib_tpu_torch.ops.kernels.segment_minmax import segment_max_kernel
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import TR
from pyg_lib_tpu_torch.utils import (indptr_to_index, max_identity,
                                     min_identity)

__all__ = [
    'gather_csr', 'segment_add_csr', 'segment_csr', 'segment_max_csr',
    'segment_mean_csr', 'segment_min_csr', 'segment_sum_csr',
]

# The planned min/max path pays a host-built plan per indptr: below this
# many edges the plain path is kept (the JAX package's threshold, set on
# the TPU and kept for parity).
_MINMAX_PLANNED_MIN_EDGES = 65536


def _as_indptr(indptr, device) -> torch.Tensor:
    if isinstance(indptr, torch.Tensor):
        return indptr.to(device)
    return torch.as_tensor(np.asarray(indptr), device=device)


def _check_indptr(indptr: torch.Tensor):
    if indptr.dim() < 1:
        raise ValueError('indptr must have at least 1 dimension')
    # A CUDA indptr is not read back (it would synchronise every call),
    # as the JAX package skips device-resident ones.
    if not indptr.is_cuda and indptr.shape[-1] and bool(
            (indptr.diff(dim=-1) < 0).any()):
        raise ValueError('indptr must be non-decreasing')


def _expand_ids(ids: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Row ids ``[E]`` as an index of ``like``'s shape ``[E, *feat]``."""
    return ids.long().view((-1, ) + (1, ) * (like.dim() - 1)).expand_as(like)


# -- the plain paths, for any rank of indptr ----------------------------------
#
# A 1-D indptr is the batched case with no leading dims (L = 1).


def _batched_setup(src: torch.Tensor, indptr: torch.Tensor):
    """Broadcast indptr's leading dims against src's and flatten both to
    ``(L, E, *feat)`` / ``(L, R+1)``."""
    b = indptr.dim() - 1
    if src.dim() < indptr.dim():
        raise ValueError(f'src.ndim ({src.dim()}) must be >= indptr.ndim '
                         f'({indptr.dim()})')
    lead = tuple(src.shape[:b])
    indptr_b = torch.broadcast_to(indptr, lead + indptr.shape[-1:])
    feat = tuple(src.shape[b + 1:])
    num_el = src.shape[b]
    size_l = int(np.prod(lead, dtype=np.int64))
    ip2 = indptr_b.reshape(size_l, indptr.shape[-1])
    src2 = src.reshape((size_l, num_el) + feat)
    return lead, size_l, num_el, feat, ip2, src2


def _batched_ids(ip2: torch.Tensor, num_el: int) -> torch.Tensor:
    """:func:`indptr_to_index` of every slice, shape ``(L, E)``."""
    size_l = ip2.shape[0]
    positions = torch.arange(num_el, dtype=ip2.dtype, device=ip2.device)
    positions = positions.expand(size_l, num_el).contiguous()
    ids = torch.searchsorted(ip2[:, 1:].contiguous(), positions, right=True)
    return torch.where(positions < ip2[:, :1], torch.full_like(ids, -1), ids)


def _batched_flat_ids(ip2: torch.Tensor, num_el: int,
                      num_rows: int) -> torch.Tensor:
    """Fused (slice, row) id of each element, shape ``(L, E)``; elements
    outside their slice's rows get ``L*R``, one past the last row (they
    must not fall into a neighbouring slice's rows)."""
    size_l = ip2.shape[0]
    ids = _batched_ids(ip2, num_el)
    base = (torch.arange(size_l, device=ip2.device) * num_rows)[:, None]
    return torch.where((ids >= 0) & (ids < num_rows), ids + base,
                       torch.full_like(ids, size_l * num_rows))


def _segment_sum_plain(src, indptr):
    lead, size_l, num_el, feat, ip2, src2 = _batched_setup(src, indptr)
    num_rows = indptr.shape[-1] - 1
    gids = _batched_flat_ids(ip2, num_el, num_rows).reshape(-1)
    flat = src2.reshape((size_l * num_el, ) + feat)
    # One extra row takes the elements of no row; index_add_'s own
    # gradient (a gather at gids) is the reference backward.
    out = torch.zeros((size_l * num_rows + 1, ) + feat, dtype=src.dtype,
                      device=src.device)
    out = out.index_add(0, gids, flat)[:size_l * num_rows]
    return out.reshape(lead + (num_rows, ) + feat)


def _minmax_impl(src, indptr, is_min):
    lead, size_l, num_el, feat, ip2, src2 = _batched_setup(src, indptr)
    num_rows = indptr.shape[-1] - 1
    total = size_l * num_rows
    flat_ids = _batched_flat_ids(ip2, num_el, num_rows).reshape(-1)
    flat = src2.reshape((size_l * num_el, ) + feat)
    ident = min_identity(src.dtype) if is_min else max_identity(src.dtype)
    index = _expand_ids(flat_ids, flat)
    vals = torch.full((total + 1, ) + feat, ident.item(), dtype=src.dtype,
                      device=src.device)
    vals.scatter_reduce_(0, index, flat, 'amin' if is_min else 'amax')
    picked = vals[flat_ids]
    # First-winner argindex in per-slice coordinates; sentinel E.
    pos = torch.arange(num_el, dtype=torch.int32,
                       device=src.device).repeat(size_l)
    cand = torch.where(flat == picked, _expand_ids(pos, flat).int(),
                       torch.tensor(num_el, dtype=torch.int32,
                                    device=src.device))
    arg = torch.full((total + 1, ) + feat, num_el, dtype=torch.int32,
                     device=src.device)
    arg.scatter_reduce_(0, index, cand, 'amin')
    vals, arg = vals[:total], arg[:total]
    empty = (ip2.diff(dim=-1) == 0).reshape((total, ) + (1, ) * len(feat))
    vals = torch.where(empty, torch.zeros_like(vals), vals)
    out_shape = lead + (num_rows, ) + feat
    return vals.reshape(out_shape), arg.reshape(out_shape)


class _SegmentMinmaxCsr(torch.autograd.Function):
    """Min/max over CSR rows (batched or not) with the winner-only
    gradient."""

    @staticmethod
    def forward(ctx, src, indptr, is_min):
        vals, arg = _minmax_impl(src, indptr, is_min)
        ctx.mark_non_differentiable(arg)
        ctx.save_for_backward(arg)
        ctx.b, ctx.src_shape = indptr.dim() - 1, tuple(src.shape)
        return vals, arg

    @staticmethod
    def backward(ctx, g, _):
        (arg, ) = ctx.saved_tensors
        b, src_shape = ctx.b, ctx.src_shape
        num_el = src_shape[b]
        size_l = int(np.prod(src_shape[:b], dtype=np.int64))
        num_rows = arg.shape[b]
        kf = int(np.prod(src_shape[b + 1:], dtype=np.int64))
        gf = g.reshape(size_l * num_rows, kf)
        af = arg.reshape(size_l * num_rows, kf).long()
        rowbase = (torch.arange(size_l * num_rows, device=g.device) //
                   max(num_rows, 1)) * num_el
        # The sentinel E maps to the dropped row L*E, not to l*E + E,
        # which would be element 0 of the next slice.
        tgt = torch.where(af < num_el, rowbase[:, None] + af,
                          torch.full_like(af, size_l * num_el))
        grad = torch.zeros((size_l * num_el + 1, kf), dtype=g.dtype,
                           device=g.device)
        grad.scatter_add_(0, tgt, gf)
        return grad[:size_l * num_el].reshape(src_shape), None, None


def _gather_csr_batched(src, indptr, out_size, out):
    b = indptr.dim() - 1
    if src.dim() < indptr.dim():
        raise ValueError(f'src.ndim ({src.dim()}) must be >= indptr.ndim '
                         f'({indptr.dim()})')
    num_rows = indptr.shape[-1] - 1
    if src.shape[b] != num_rows:
        raise ValueError(
            'gather_csr: src.shape[dim] must equal indptr.shape[-1] - 1')
    lead = tuple(src.shape[:b])
    feat = tuple(src.shape[b + 1:])
    indptr_b = torch.broadcast_to(indptr, lead + indptr.shape[-1:])
    size_l = int(np.prod(lead, dtype=np.int64))
    ip2 = indptr_b.reshape(size_l, indptr.shape[-1])
    ids = _batched_ids(ip2, out_size)
    base = (torch.arange(size_l, device=src.device) * num_rows)[:, None]
    flat_ids = torch.where((ids >= 0) & (ids < num_rows), ids + base,
                           torch.full_like(ids, size_l * num_rows))
    flat_ids = flat_ids.reshape(-1)
    src_flat = src.reshape((size_l * num_rows, ) + feat)
    pad = (flat_ids >= size_l * num_rows).reshape(
        (size_l * out_size, ) + (1, ) * len(feat))
    if size_l * num_rows:
        safe = flat_ids.clamp(max=size_l * num_rows - 1)
        res = src_flat[safe]
        res = torch.where(pad, torch.zeros_like(res), res)
    else:
        res = torch.zeros((size_l * out_size, ) + feat, dtype=src.dtype,
                          device=src.device)
    res = res.reshape(lead + (out_size, ) + feat)
    if out is not None:
        written = (~pad).reshape(lead + (out_size, ) + (1, ) * len(feat))
        res = torch.where(written, res.to(out.dtype), out)
    return res


# -- sum ----------------------------------------------------------------------


class _SegmentSumCsr(torch.autograd.Function):
    """K3's sum; the reference backward is ``gather_csr`` of the
    cotangent."""

    @staticmethod
    def forward(ctx, src, indptr):
        ctx.save_for_backward(indptr)
        ctx.num_elements = src.shape[0]
        return segment_sum_csr_kernel(src.contiguous(), indptr)

    @staticmethod
    def backward(ctx, g):
        (indptr, ) = ctx.saved_tensors
        return gather_csr_impl(g, indptr, ctx.num_elements), None


def _segment_sum(src, indptr):
    if (indptr.dim() == 1 and src.dim() == 2
            and src.dtype in (torch.float32, torch.bfloat16)):
        return _SegmentSumCsr.apply(src, indptr)
    return _segment_sum_plain(src, indptr)


def segment_sum_csr(src: torch.Tensor, indptr,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over CSR rows (reference ``segment_sum_csr``); ``out`` is added
    to the result."""
    indptr = _as_indptr(indptr, src.device)
    _check_indptr(indptr)
    result = _segment_sum(src, indptr)
    if out is not None:
        result = out + result
    return result


segment_add_csr = segment_sum_csr


# -- mean ---------------------------------------------------------------------


def segment_mean_csr(src: torch.Tensor, indptr,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over CSR rows; an empty row gives 0, and integer dtypes divide
    with floor (reference ``segment_mean_csr``). The reference overwrites
    ``out`` entirely, so its contents do not reach the result."""
    indptr = _as_indptr(indptr, src.device)
    _check_indptr(indptr)
    b = indptr.dim() - 1
    lead = tuple(src.shape[:b])
    count = torch.broadcast_to(indptr, lead + indptr.shape[-1:]).diff(
        dim=-1).clamp(min=1)
    count = count.reshape(tuple(count.shape) + (1, ) * (src.dim() - b - 1))
    sums = _segment_sum(src, indptr)
    if sums.dtype.is_floating_point:
        return sums / count.to(sums.dtype)
    return torch.div(sums, count.to(sums.dtype), rounding_mode='floor')


# -- min / max ----------------------------------------------------------------


def _use_planned_minmax(src, indptr) -> bool:
    if src.dim() != 2 or src.dtype != torch.float32:
        return False
    if src.shape[0] < _MINMAX_PLANNED_MIN_EDGES:
        return False
    return src.shape[0] == int(indptr[-1])  # else trailing pad edges


class _PlannedMinmax(torch.autograd.Function):
    """Min/max through K4 over the cached plan of ``indptr``."""

    @staticmethod
    def forward(ctx, src, plan, empty, is_min):
        n = src.shape[0]
        vals, pos = segment_max_kernel(src.contiguous(), plan, plan.edge_perm,
                                       negate=is_min)
        if is_min:
            vals = -vals
        rows = torch.arange(plan.num_rows, device=src.device)
        shift = plan.tile_shift[rows // TR][:, None]
        arg = torch.where(empty, torch.full_like(pos, n), pos - shift)
        vals = torch.where(empty, torch.zeros_like(vals), vals)
        ctx.mark_non_differentiable(arg)
        ctx.save_for_backward(arg)
        ctx.n = n
        return vals, arg

    @staticmethod
    def backward(ctx, g, _):
        (arg, ) = ctx.saved_tensors
        grad = torch.zeros((ctx.n + 1, g.shape[1]), dtype=g.dtype,
                           device=g.device)
        grad.scatter_add_(0, arg.long(), g)  # the sentinel n is dropped
        return grad[:ctx.n], None, None, None


def _planned_minmax(src, indptr_arg, indptr, is_min):
    """The planned path; ``indptr_arg`` is the caller's own object, whose
    identity keys the plan cache when it is a numpy buffer."""
    plan = plan_for_ptr(indptr_arg, device=src.device)
    empty = (indptr.diff() == 0)[:, None]
    return _PlannedMinmax.apply(src, plan, empty, is_min)


def _merge_minmax_out(vals, arg, out, indptr, src, is_min):
    """Reference ``out=`` contract: values merge elementwise with ``out``,
    and wherever ``out`` wins (strictly better, or the row is empty) the
    argindex is the sentinel ``src.size(dim)``."""
    b = indptr.dim() - 1
    lead = tuple(src.shape[:b])
    indptr_b = torch.broadcast_to(indptr, lead + indptr.shape[-1:])
    counts = indptr_b.diff(dim=-1)
    nonempty = (counts > 0).reshape(tuple(counts.shape) + (1, ) *
                                    (src.dim() - b - 1))
    merge = torch.minimum if is_min else torch.maximum
    merged = torch.where(nonempty, merge(out, vals), out)
    out_wins = (out < vals) if is_min else (out > vals)
    arg = torch.where(nonempty & ~out_wins, arg,
                      torch.full_like(arg, src.shape[b]))
    return merged, arg


def _segment_minmax(src, indptr_arg, out, is_min):
    indptr = _as_indptr(indptr_arg, src.device)
    _check_indptr(indptr)
    if indptr.dim() == 1 and _use_planned_minmax(src, indptr):
        vals, arg = _planned_minmax(src, indptr_arg, indptr, is_min)
    else:
        vals, arg = _SegmentMinmaxCsr.apply(src, indptr, is_min)
    if out is not None:
        vals, arg = _merge_minmax_out(vals, arg, out, indptr, src, is_min)
    return vals, arg


def segment_min_csr(src: torch.Tensor, indptr,
                    out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min over CSR rows with first-winner argindex (reference
    ``segment_min_csr``)."""
    return _segment_minmax(src, indptr, out, True)


def segment_max_csr(src: torch.Tensor, indptr,
                    out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max over CSR rows with first-winner argindex (reference
    ``segment_max_csr``)."""
    return _segment_minmax(src, indptr, out, False)


# -- gather -------------------------------------------------------------------


def gather_csr_impl(src: torch.Tensor, indptr: torch.Tensor,
                    out_size: int) -> torch.Tensor:
    """``src[r]`` at every position of row ``r``; zeros at positions of no
    row (the leading gap and the trailing pad)."""
    ids = indptr_to_index(indptr, out_size).long()
    pad = ((ids < 0) | (ids >= src.shape[0])).reshape(
        (-1, ) + (1, ) * (src.dim() - 1))
    if src.shape[0] == 0:
        return torch.zeros((out_size, ) + tuple(src.shape[1:]),
                           dtype=src.dtype, device=src.device)
    # In place: the gathered slab is the only one of its size (the
    # backward of the segment sum gathers [E, F] cotangents with it).
    return src[ids.clamp(0, src.shape[0] - 1)].masked_fill_(pad, 0)


def gather_csr(src: torch.Tensor, indptr, out: Optional[torch.Tensor] = None,
               out_size: Optional[int] = None) -> torch.Tensor:
    """Broadcast ``src[r]`` to positions ``[indptr[r], indptr[r+1])``
    (reference ``gather_csr``). ``out_size`` defaults to ``out``'s size
    along ``dim``, else to ``indptr[-1]``; with ``out``, only positions of
    some row are replaced and the rest of ``out`` is kept."""
    indptr = _as_indptr(indptr, src.device)
    _check_indptr(indptr)
    dim = indptr.dim() - 1
    if out is not None:
        out_size = out.shape[dim]
    if out_size is None:
        out_size = int(indptr.reshape(-1)[-1])
    if indptr.dim() != 1:
        return _gather_csr_batched(src, indptr, out_size, out)
    result = gather_csr_impl(src, indptr, out_size)
    if out is not None:
        ids = indptr_to_index(indptr, out_size)
        written = ((ids >= 0) & (ids < indptr.shape[0] - 1)).reshape(
            (-1, ) + (1, ) * (src.dim() - 1))
        result = torch.where(written, result.to(out.dtype), out)
    return result


def segment_csr(src: torch.Tensor, indptr,
                out: Optional[torch.Tensor] = None,
                reduce: str = 'sum') -> torch.Tensor:
    """Reduce over CSR rows by ``reduce`` in {'sum', 'add', 'mean', 'min',
    'max'} (reference ``segment_csr``)."""
    if reduce in ('sum', 'add'):
        return segment_sum_csr(src, indptr, out)
    if reduce == 'mean':
        return segment_mean_csr(src, indptr, out)
    if reduce == 'min':
        return segment_min_csr(src, indptr, out)[0]
    if reduce == 'max':
        return segment_max_csr(src, indptr, out)[0]
    raise ValueError(f'Unknown reduce: {reduce!r}')
