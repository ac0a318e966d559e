"""Sorted-COO segment reductions and ``gather_coo``.

Port of ``pyg_lib_tpu/ops/segment_coo.py`` (reference ``pyg_lib.ops``
``segment_*_coo``, ``gather_coo``). The reduction axis is
``index.dim() - 1``; leading dims of ``index`` broadcast against
``src.shape[:index.dim()]``, each batch row reducing its own sorted run.

Where the work goes:

* sum and mean: a sorted index is a CSR, so one ``torch.searchsorted``
  gives its ``indptr`` and the port's ``segment_sum_csr`` /
  ``segment_mean_csr`` reduce (kernel K3 on the card for a 2-D f32/bf16
  ``src``). A batched index is flattened to one sorted problem first, each
  batch's ids offset by ``b * dim_size``.
* min and max: ``scatter_min`` / ``scatter_max``, with a batched index's
  argindex rebased to each batch's own positions.

COO mean has its own ``out=`` rule: a non-empty bucket is overwritten with
the mean and an empty one keeps ``out``.
"""

import math
from typing import Optional, Tuple

import torch

from pyg_lib_tpu_torch.ops.scatter import (as_index, scatter_max,
                                           scatter_mean, scatter_min,
                                           scatter_sum)
from pyg_lib_tpu_torch.ops.segment_csr import segment_mean_csr, segment_sum_csr
from pyg_lib_tpu_torch.utils import infer_dim_size

__all__ = [
    'segment_sum_coo',
    'segment_add_coo',
    'segment_mean_coo',
    'segment_min_coo',
    'segment_max_coo',
    'gather_coo',
    'segment_coo',
]


def _coo_dim(index: torch.Tensor) -> int:
    return index.dim() - 1


def _coo_to_indptr(index: torch.Tensor, dim_size: int) -> torch.Tensor:
    """A sorted 1-D index as the int32 ``indptr [dim_size + 1]`` of its
    CSR (one ``searchsorted``)."""
    bounds = torch.arange(dim_size + 1, dtype=index.dtype,
                          device=index.device)
    return torch.searchsorted(index.contiguous(), bounds).int()


def _check_batched(src: torch.Tensor, index: torch.Tensor):
    if src.dim() < index.dim():
        raise ValueError(
            f'segment_coo: src.ndim ({src.dim()}) must be >= index.ndim '
            f'({index.dim()})')


def _flatten_batched(src: torch.Tensor, index: torch.Tensor, n: int):
    """``[*B, E, *K]`` and ``[*B, E]`` as one sorted 1-D problem:
    ``(src_flat [B*E, K'], idx_flat [B*E] offset by b*n, B, E, bshape,
    kshape)``."""
    d = index.dim() - 1
    bshape, e, kshape = tuple(src.shape[:d]), src.shape[d], tuple(
        src.shape[d + 1:])
    b, k = math.prod(bshape), math.prod(kshape)
    index_b = torch.broadcast_to(index, bshape + (e, ))
    offs = (torch.arange(b, dtype=index.dtype, device=index.device) *
            n)[:, None]
    idx_flat = (index_b.reshape(b, e) + offs).reshape(b * e)
    return src.reshape(b * e, k), idx_flat, b, e, bshape, kshape


def _infer_n(index: torch.Tensor, out: Optional[torch.Tensor],
             dim_size: Optional[int]) -> int:
    if out is not None:
        return out.shape[index.dim() - 1]
    return infer_dim_size(index, dim_size)


def segment_sum_coo(src: torch.Tensor, index,
                    out: Optional[torch.Tensor] = None,
                    dim_size: Optional[int] = None) -> torch.Tensor:
    """Sum over a sorted COO index (reference ``segment_sum_coo``),
    through ``segment_sum_csr`` (K3 on the card); ``out`` is added to the
    result."""
    index = as_index(index, src.device)
    _check_batched(src, index)
    n = _infer_n(index, out, dim_size)
    if index.dim() > 1:
        src_flat, idx_flat, b, _, bshape, kshape = _flatten_batched(
            src, index, n)
        sums = segment_sum_csr(src_flat, _coo_to_indptr(idx_flat, b * n))
        result = sums.reshape(bshape + (n, ) + kshape)
        return result if out is None else out + result
    if src.dim() == 2 and src.shape[0] == index.shape[0]:
        return segment_sum_csr(src, _coo_to_indptr(index, n), out)
    return scatter_sum(src, index, _coo_dim(index), out, dim_size)


segment_add_coo = segment_sum_coo


def segment_mean_coo(src: torch.Tensor, index,
                     out: Optional[torch.Tensor] = None,
                     dim_size: Optional[int] = None) -> torch.Tensor:
    """Mean over a sorted COO index (reference ``segment_mean_coo``),
    through ``segment_mean_csr`` (K3 on the card). With ``out``, a
    non-empty bucket gets the mean and an empty one keeps ``out``."""
    index = as_index(index, src.device)
    _check_batched(src, index)
    n = _infer_n(index, out, dim_size)
    if index.dim() > 1:
        src_flat, idx_flat, b, _, bshape, kshape = _flatten_batched(
            src, index, n)
        indptr = _coo_to_indptr(idx_flat, b * n)
        result = segment_mean_csr(src_flat, indptr).reshape(
            bshape + (n, ) + kshape)
        if out is None:
            return result
        counts = indptr.diff().reshape(bshape + (n, ) + (1, ) * len(kshape))
        return torch.where(counts > 0, result, out)
    if src.dim() == 2 and src.shape[0] == index.shape[0]:
        indptr = _coo_to_indptr(index, n)
        result = segment_mean_csr(src, indptr)
        if out is None:
            return result
        return torch.where(indptr.diff()[:, None] > 0, result, out)
    dim = _coo_dim(index)
    if out is None:
        return scatter_mean(src, index, dim, None, dim_size)
    result = scatter_mean(src, index, dim, None, out.shape[dim])
    counts = scatter_sum(torch.ones(index.numel(), dtype=torch.int32,
                                    device=src.device), index.reshape(-1),
                         0, None, out.shape[dim])
    shape = [1] * out.dim()
    shape[dim] = out.shape[dim]
    return torch.where(counts.reshape(shape) > 0, result, out)


def _minmax_coo(src, index, out, dim_size, is_min):
    scatter_fn = scatter_min if is_min else scatter_max
    if index.dim() == 1:
        return scatter_fn(src, index, 0, out, dim_size)
    n = _infer_n(index, out, dim_size)
    src_flat, idx_flat, b, e, bshape, kshape = _flatten_batched(
        src, index, n)
    vals, arg = scatter_fn(src_flat, idx_flat, 0, None, b * n)
    # Flattened argindices (sentinel b*e) to per-batch positions along the
    # reduction axis (sentinel e).
    vals = vals.reshape(bshape + (n, ) + kshape)
    arg = arg.reshape((b, n) + kshape)
    base = (torch.arange(b, dtype=arg.dtype, device=arg.device) * e).reshape(
        (b, 1) + (1, ) * len(kshape))
    arg = torch.where(arg >= b * e, torch.full_like(arg, e), arg - base)
    arg = arg.reshape(bshape + (n, ) + kshape)
    if out is not None:
        # Merged elementwise with out; wherever out wins (strictly better,
        # or an empty bucket) the argindex is the sentinel e.
        nonempty = arg < e
        merge = torch.minimum if is_min else torch.maximum
        out_wins = (out < vals) if is_min else (out > vals)
        merged = torch.where(nonempty, merge(out, vals), out)
        arg = torch.where(nonempty & ~out_wins, arg, torch.full_like(arg, e))
        vals = merged
    return vals, arg


def segment_min_coo(src: torch.Tensor, index,
                    out: Optional[torch.Tensor] = None,
                    dim_size: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min over a sorted COO index with first-winner argindex (reference
    ``segment_min_coo``)."""
    index = as_index(index, src.device)
    _check_batched(src, index)
    return _minmax_coo(src, index, out, dim_size, True)


def segment_max_coo(src: torch.Tensor, index,
                    out: Optional[torch.Tensor] = None,
                    dim_size: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max over a sorted COO index with first-winner argindex (reference
    ``segment_max_coo``)."""
    index = as_index(index, src.device)
    _check_batched(src, index)
    return _minmax_coo(src, index, out, dim_size, False)


def gather_coo(src: torch.Tensor, index,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[..., i, k] = src[..., index[..., i], k]`` along
    ``index.dim() - 1``, the inverse of :func:`segment_sum_coo`
    (reference ``gather_coo``); with ``out``, the result takes its
    dtype."""
    index = as_index(index, src.device)
    if index.dim() == 1:
        result = src[index.long()]
    else:
        _check_batched(src, index)
        dim = index.dim() - 1
        index_b = torch.broadcast_to(index, tuple(src.shape[:dim]) +
                                     tuple(index.shape[-1:]))
        expand = index_b.reshape(tuple(index_b.shape) + (1, ) *
                                 (src.dim() - index.dim()))
        expand = expand.expand(tuple(index_b.shape) +
                               tuple(src.shape[dim + 1:]))
        result = src.gather(dim, expand.long())
    if out is not None:
        result = result.to(out.dtype)
    return result


def segment_coo(src: torch.Tensor, index,
                out: Optional[torch.Tensor] = None,
                dim_size: Optional[int] = None,
                reduce: str = 'sum') -> torch.Tensor:
    """Reduce over a sorted COO index by ``reduce`` in {'sum', 'add',
    'mean', 'min', 'max'} (reference ``segment_coo``)."""
    if reduce in ('sum', 'add'):
        return segment_sum_coo(src, index, out, dim_size)
    if reduce == 'mean':
        return segment_mean_coo(src, index, out, dim_size)
    if reduce == 'min':
        return segment_min_coo(src, index, out, dim_size)[0]
    if reduce == 'max':
        return segment_max_coo(src, index, out, dim_size)[0]
    raise ValueError(f'Unknown reduce: {reduce!r}')
