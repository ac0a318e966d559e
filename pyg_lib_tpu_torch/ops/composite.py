"""Scatter composites: softmax, log-softmax, std and log-sum-exp per bucket.

Port of ``pyg_lib_tpu/ops/composite.py`` (reference ``pyg_lib.ops``
``scatter_softmax``, ``scatter_log_softmax``, ``scatter_std``,
``scatter_logsumexp``), built on the port's scatter ops and stabilised by
recentering each bucket on its maximum. As in the JAX package, the
gradient also flows through that maximum (winner-only, no stop-gradient).
"""

from typing import Optional

import torch

from pyg_lib_tpu_torch.ops.scatter import as_index, scatter_max, scatter_sum
from pyg_lib_tpu_torch.utils import (broadcast_index, canonicalize_dim,
                                     infer_dim_size)

__all__ = [
    'scatter_softmax',
    'scatter_log_softmax',
    'scatter_std',
    'scatter_logsumexp',
]


def _check_float(src: torch.Tensor, name: str):
    if not src.dtype.is_floating_point:
        raise ValueError(
            f'{name} requires a floating-point src tensor (got {src.dtype})')


def _take_along(per_bucket: torch.Tensor, index: torch.Tensor,
                src: torch.Tensor, dim: int) -> torch.Tensor:
    """``per_bucket`` read back at each element's bucket."""
    idx = broadcast_index(index, src.shape, dim)
    return per_bucket.gather(dim, idx.long())


def _setup(src, index, dim, out, dim_size, name):
    _check_float(src, name)
    index = as_index(index, src.device)
    dim = canonicalize_dim(dim, src.dim())
    if out is not None:
        dim_size = out.shape[dim]
    return index, dim, infer_dim_size(index, dim_size)


def scatter_softmax(src: torch.Tensor, index, dim: int = -1,
                    dim_size: Optional[int] = None) -> torch.Tensor:
    """Softmax of each bucket's elements (reference ``scatter_softmax``)."""
    index, dim, dim_size = _setup(src, index, dim, None, dim_size,
                                  'scatter_softmax')
    max_per_idx = scatter_max(src, index, dim, dim_size=dim_size)[0]
    recentered_exp = torch.exp(src - _take_along(max_per_idx, index, src,
                                                 dim))
    sum_per_idx = scatter_sum(recentered_exp, index, dim, dim_size=dim_size)
    return recentered_exp / _take_along(sum_per_idx, index, src, dim)


def scatter_log_softmax(src: torch.Tensor, index, dim: int = -1,
                        dim_size: Optional[int] = None,
                        eps: float = 1e-12) -> torch.Tensor:
    """Log-softmax of each bucket's elements (reference
    ``scatter_log_softmax``)."""
    index, dim, dim_size = _setup(src, index, dim, None, dim_size,
                                  'scatter_log_softmax')
    max_per_idx = scatter_max(src, index, dim, dim_size=dim_size)[0]
    recentered = src - _take_along(max_per_idx, index, src, dim)
    sum_per_idx = scatter_sum(torch.exp(recentered), index, dim,
                              dim_size=dim_size)
    return recentered - torch.log(
        _take_along(sum_per_idx, index, src, dim) + eps)


def scatter_std(src: torch.Tensor, index, dim: int = -1,
                out: Optional[torch.Tensor] = None,
                dim_size: Optional[int] = None,
                unbiased: bool = True) -> torch.Tensor:
    """Standard deviation of each bucket's elements (reference
    ``scatter_std``); ``out`` is added to the squared deviations' sum."""
    index, dim, dim_size = _setup(src, index, dim, out, dim_size,
                                  'scatter_std')
    count = scatter_sum(torch.ones_like(src), index, dim, dim_size=dim_size)
    sum_per_idx = scatter_sum(src, index, dim, dim_size=dim_size)
    count_safe = count.clamp(min=1)
    mean = sum_per_idx / count_safe
    var = src - _take_along(mean, index, src, dim)
    result = scatter_sum(var * var, index, dim, out, dim_size)
    denom = (count - 1).clamp(min=1) if unbiased else count_safe
    return torch.sqrt(result / denom)


def scatter_logsumexp(src: torch.Tensor, index, dim: int = -1,
                      out: Optional[torch.Tensor] = None,
                      dim_size: Optional[int] = None,
                      eps: float = 1e-12) -> torch.Tensor:
    """Log-sum-exp of each bucket's elements, recentered on its maximum
    (reference ``scatter_logsumexp``). An empty bucket, or any non-finite
    result, gives 0, or ``out``'s value when ``out`` is given."""
    index, dim, dim_size = _setup(src, index, dim, out, dim_size,
                                  'scatter_logsumexp')
    shape = list(src.shape)
    shape[dim] = dim_size
    max_init = torch.full(shape, float('-inf'), dtype=src.dtype,
                          device=src.device)
    max_per_idx = scatter_max(src, index, dim, out=max_init,
                              dim_size=dim_size)[0]
    recentered = src - _take_along(max_per_idx, index, src, dim)
    recentered = torch.where(torch.isnan(recentered),
                             torch.full_like(recentered, float('-inf')),
                             recentered)
    sum_per_idx = scatter_sum(torch.exp(recentered), index, dim,
                              dim_size=dim_size)
    result = max_per_idx + torch.log(sum_per_idx + eps)
    if out is None:
        return torch.nan_to_num(result, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.where(torch.isfinite(result), result, out)
