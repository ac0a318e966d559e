"""Unsorted scatter reductions (``scatter_{sum,mul,mean,min,max}``).

Port of ``pyg_lib_tpu/ops/scatter.py`` (reference ``pyg_lib.ops``
``scatter_*``). The JAX package computes these with XLA scatters, not with
Pallas, so they are plain PyTorch here (``index_add``, ``scatter_add``,
``scatter_reduce``). The contracts kept:

* ``index`` is 1-D, laid along ``dim``, or elementwise: of ``src``'s shape
  after broadcasting, one bucket per element.
* Ids are wrapped as Python indices, and those still outside
  ``[0, dim_size)`` are dropped, as JAX's ``.at[...]`` with
  ``mode='drop'`` does (torch's scatters would raise on them): they land
  in a spare row that is cut off.
* ``out=`` is merged into a new tensor, not written in place.
* ``scatter_mul`` has identity 1, and its gradient is the reference's
  closed form, 0 at a zero entry.
* ``scatter_mean`` floor-divides integer inputs. With ``out``, ``out`` is
  added to the sum before the division, and an empty bucket keeps
  ``out``.
* ``scatter_min``/``scatter_max`` return ``(values, argindex)``: an empty
  bucket gives 0 and the sentinel ``src.size(dim)``, the argindex is the
  least position that attains the extreme, and with ``out`` the sentinel
  marks every place where ``out`` wins. The gradient goes to the argindex
  winner only (``scatter_reduce``'s own backward would split it among
  ties).
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from pyg_lib_tpu_torch.utils import (broadcast_index, canonicalize_dim,
                                     infer_dim_size, max_identity,
                                     min_identity)

__all__ = [
    'scatter_sum',
    'scatter_add',
    'scatter_mul',
    'scatter_mean',
    'scatter_min',
    'scatter_max',
    'scatter',
]


def as_index(index, device) -> torch.Tensor:
    """``index`` as a tensor on ``device`` (a numpy array or a list is
    copied there)."""
    if isinstance(index, torch.Tensor):
        return index.to(device)
    return torch.as_tensor(np.asarray(index), device=device)


def _drop_ids(index: torch.Tensor, dim_size: int) -> torch.Tensor:
    """Ids wrapped as Python indices; an id still outside ``[0,
    dim_size)`` becomes ``dim_size``, the spare row."""
    ids = index.long()
    ids = torch.where(ids < 0, ids + dim_size, ids)
    return torch.where((ids >= 0) & (ids < dim_size), ids,
                       torch.full_like(ids, dim_size))


def _flatten_for_scatter(src: torch.Tensor, index: torch.Tensor, dim: int):
    """``(flat [N, K], rows, moved_shape, elementwise)``: ``src`` with
    ``dim`` moved to the front and the other dims flattened, and the
    bucket of each element as ``[N, K]`` ids (a spare row for dropped
    ones)."""
    src_moved = src.movedim(dim, 0)
    k = math.prod(src_moved.shape[1:])
    flat = src_moved.reshape(src_moved.shape[0], k)
    if index.dim() == 1:
        return flat, index, tuple(src_moved.shape), False
    index_moved = broadcast_index(index, src.shape, dim).movedim(dim, 0)
    return (flat, index_moved.reshape(index_moved.shape[0], k),
            tuple(src_moved.shape), True)


def _expand_rows(idx: torch.Tensor, flat: torch.Tensor, dim_size: int,
                 elementwise: bool) -> torch.Tensor:
    rows = _drop_ids(idx, dim_size)
    return rows if elementwise else rows[:, None].expand_as(flat)


def _unflatten(out_flat: torch.Tensor, moved_shape, dim: int,
               dim_size: int) -> torch.Tensor:
    out = out_flat.reshape((dim_size, ) + tuple(moved_shape[1:]))
    return out.movedim(0, dim)


def _resolve(src, index, dim, out, dim_size):
    index = as_index(index, src.device)
    dim = canonicalize_dim(dim, src.dim())
    if out is not None:
        dim_size = out.shape[dim]
    return index, dim, infer_dim_size(index, dim_size)


def scatter_sum(src: torch.Tensor, index, dim: int = -1,
                out: Optional[torch.Tensor] = None,
                dim_size: Optional[int] = None) -> torch.Tensor:
    """Sum ``src`` into the buckets ``index`` gives along ``dim``; with
    ``out``, the sums are added to it (reference ``scatter_sum``)."""
    index, dim, dim_size = _resolve(src, index, dim, out, dim_size)
    flat, idx, moved_shape, elementwise = _flatten_for_scatter(
        src, index, dim)
    zero = flat.new_zeros((dim_size + 1, flat.shape[1]))
    if elementwise:
        result = zero.scatter_add(0, _drop_ids(idx, dim_size), flat)
    else:
        result = zero.index_add(0, _drop_ids(idx, dim_size), flat)
    result = _unflatten(result[:dim_size], moved_shape, dim, dim_size)
    if out is not None:
        result = out + result
    return result


scatter_add = scatter_sum


class _ScatterMul(torch.autograd.Function):
    """Product scatter of ``flat [N, K]`` into ``[dim_size, K]`` with the
    reference gradient ``(g * out)[bucket] / src``: ``out / src[i]`` is the
    product of the bucket's other members. A zero entry gets gradient 0
    (the true derivative, the others' product, cannot be recovered from
    ``out / src`` there)."""

    @staticmethod
    def forward(ctx, flat, rows, dim_size):
        one = flat.new_ones((dim_size + 1, flat.shape[1]))
        res = one.scatter_reduce(0, rows, flat, 'prod')[:dim_size]
        ctx.save_for_backward(flat, rows, res)
        return res

    @staticmethod
    def backward(ctx, g):
        flat, rows, res = ctx.saved_tensors
        num = torch.cat([g * res, g.new_zeros((1, g.shape[1]))])
        gathered = num.gather(0, rows)  # the spare row reads 0
        zero = flat == 0
        grad = torch.where(zero, torch.zeros_like(gathered),
                           gathered / torch.where(zero, torch.ones_like(flat),
                                                  flat))
        return grad, None, None


def scatter_mul(src: torch.Tensor, index, dim: int = -1,
                out: Optional[torch.Tensor] = None,
                dim_size: Optional[int] = None) -> torch.Tensor:
    """Product-reduce; an empty bucket gives 1, and with ``out`` the
    products multiply it (reference ``scatter_mul``)."""
    index, dim, dim_size = _resolve(src, index, dim, out, dim_size)
    flat, idx, moved_shape, elementwise = _flatten_for_scatter(
        src, index, dim)
    rows = _expand_rows(idx, flat, dim_size, elementwise)
    result = _unflatten(_ScatterMul.apply(flat, rows, dim_size), moved_shape,
                        dim, dim_size)
    if out is not None:
        result = out * result
    return result


def _divide(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``num / count``, floor division for integer dtypes."""
    if num.dtype.is_floating_point:
        return num / count.to(num.dtype)
    return torch.div(num, count.to(num.dtype), rounding_mode='floor')


def scatter_mean(src: torch.Tensor, index, dim: int = -1,
                 out: Optional[torch.Tensor] = None,
                 dim_size: Optional[int] = None) -> torch.Tensor:
    """Mean-reduce; an empty bucket gives 0 and integer inputs
    floor-divide (reference ``scatter_mean``). With ``out``, each bucket
    is ``(out + Σsrc) / n``, and an empty bucket keeps ``out``."""
    index, dim, dim_size = _resolve(src, index, dim, out, dim_size)
    sums = scatter_sum(src, index, dim, None, dim_size)
    if index.dim() > 1:  # one count per (bucket, column)
        count_b = scatter_sum(torch.ones_like(src, dtype=torch.int32), index,
                              dim, None, dim_size)
    else:
        count = torch.zeros(dim_size + 1, dtype=torch.int32,
                            device=src.device).index_add_(
                                0, _drop_ids(index, dim_size),
                                torch.ones(index.shape[0], dtype=torch.int32,
                                           device=src.device))
        shape = [1] * src.dim()
        shape[dim] = dim_size
        count_b = count[:dim_size].reshape(shape)
    count_safe = count_b.clamp(min=1)
    if out is not None:
        return torch.where(count_b > 0, _divide(out + sums, count_safe), out)
    return _divide(sums, count_safe)


def _scatter_minmax_fwd(src, index, dim, out, dim_size, is_min):
    n = src.shape[dim]
    flat, idx, moved_shape, elementwise = _flatten_for_scatter(
        src, index, dim)
    rows = _expand_rows(idx, flat, dim_size, elementwise)
    ident = min_identity(src.dtype) if is_min else max_identity(src.dtype)
    vals = torch.full((dim_size + 1, flat.shape[1]), ident.item(),
                      dtype=src.dtype, device=src.device)
    vals = vals.scatter_reduce(0, rows, flat, 'amin' if is_min else 'amax')
    picked = vals.gather(0, rows)
    # argindex: the least position along dim that attains the extreme.
    pos = torch.arange(n, dtype=torch.int32, device=src.device)[:, None]
    cand = torch.where(flat == picked, pos,
                       torch.tensor(n, dtype=torch.int32, device=src.device))
    arg = torch.full((dim_size + 1, flat.shape[1]), n, dtype=torch.int32,
                     device=src.device)
    arg = arg.scatter_reduce(0, rows, cand, 'amin')[:dim_size]
    touched = arg < n
    vals = torch.where(touched, vals[:dim_size],
                       torch.zeros((), dtype=src.dtype, device=src.device))
    vals_out = _unflatten(vals, moved_shape, dim, dim_size)
    arg_out = _unflatten(arg, moved_shape, dim, dim_size)
    if out is not None:
        mask = _unflatten(touched, moved_shape, dim, dim_size)
        combine = torch.minimum if is_min else torch.maximum
        better = (out < vals_out) if is_min else (out > vals_out)
        # Where out (strictly) wins or the bucket is empty, no src element
        # gave the value: the sentinel, so the gradient goes nowhere.
        arg_out = torch.where(~mask | better,
                              torch.full_like(arg_out, n), arg_out)
        vals_out = torch.where(mask, combine(out, vals_out), out)
    return vals_out, arg_out


class _ScatterMinmax(torch.autograd.Function):
    """Min/max with the winner-only gradient: each output's cotangent goes
    to its argindex, and the sentinel drops it."""

    @staticmethod
    def forward(ctx, src, index, out, dim, dim_size, is_min):
        vals, arg = _scatter_minmax_fwd(src, index, dim, out, dim_size,
                                        is_min)
        ctx.mark_non_differentiable(arg)
        ctx.save_for_backward(arg)
        ctx.dim, ctx.src_shape = dim, tuple(src.shape)
        return vals, arg

    @staticmethod
    def backward(ctx, g, _):
        (arg, ) = ctx.saved_tensors
        dim, n = ctx.dim, ctx.src_shape[ctx.dim]
        g_moved = g.movedim(dim, 0)
        k = math.prod(g_moved.shape[1:])
        gf = g_moved.reshape(g_moved.shape[0], k)
        af = arg.movedim(dim, 0).reshape(g_moved.shape[0], k).long()
        grad = g.new_zeros((n + 1, k)).scatter_add_(0, af, gf)[:n]
        grad = grad.reshape((n, ) + tuple(g_moved.shape[1:])).movedim(0, dim)
        return grad, None, None, None, None, None


def _scatter_minmax(src, index, dim, out, dim_size, is_min):
    index, dim, dim_size = _resolve(src, index, dim, out, dim_size)
    return _ScatterMinmax.apply(src, index, out, dim, dim_size, is_min)


def scatter_min(src: torch.Tensor, index, dim: int = -1,
                out: Optional[torch.Tensor] = None,
                dim_size: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-reduce; returns ``(values, argindex)`` (reference
    ``scatter_min``)."""
    return _scatter_minmax(src, index, dim, out, dim_size, True)


def scatter_max(src: torch.Tensor, index, dim: int = -1,
                out: Optional[torch.Tensor] = None,
                dim_size: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-reduce; returns ``(values, argindex)`` (reference
    ``scatter_max``)."""
    return _scatter_minmax(src, index, dim, out, dim_size, False)


def scatter(src: torch.Tensor, index, dim: int = -1,
            out: Optional[torch.Tensor] = None,
            dim_size: Optional[int] = None,
            reduce: str = 'sum') -> torch.Tensor:
    """Reduce by ``reduce`` in {'sum', 'add', 'mul', 'mean', 'min', 'max'}
    (reference ``scatter``)."""
    if reduce in ('sum', 'add'):
        return scatter_sum(src, index, dim, out, dim_size)
    if reduce == 'mul':
        return scatter_mul(src, index, dim, out, dim_size)
    if reduce == 'mean':
        return scatter_mean(src, index, dim, out, dim_size)
    if reduce == 'min':
        return scatter_min(src, index, dim, out, dim_size)[0]
    if reduce == 'max':
        return scatter_max(src, index, dim, out, dim_size)[0]
    raise ValueError(f'Unknown reduce: {reduce!r}')
