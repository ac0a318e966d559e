"""Shared helpers for the port's device ops."""

from typing import Optional, Union

import torch

Array = torch.Tensor

__all__ = ['Array', 'broadcast_index', 'canonicalize_dim', 'index_to_indptr',
           'indptr_to_index', 'infer_dim_size', 'is_floating', 'max_identity',
           'min_identity', 'move_dim_back', 'move_dim_front']


def _resolve_device(device: Optional[Union[str, torch.device]]
                    ) -> torch.device:
    """The device an entry point puts its tensors on.

    ``None`` means the CUDA card; without one this raises rather than
    carrying on on the CPU. Callers that want the CPU (the tests) say so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                'the plain PyTorch versions on the CPU')
        return torch.device('cuda')
    return torch.device(device)


def canonicalize_dim(dim: int, ndim: int) -> int:
    """``dim`` in ``[0, ndim)``; a negative ``dim`` counts from the end."""
    if dim < -ndim or dim >= ndim:
        raise ValueError(f'dim {dim} out of range for ndim {ndim}')
    return dim + ndim if dim < 0 else dim


def infer_dim_size(index: torch.Tensor, dim_size: Optional[int]) -> int:
    """The output size along the reduction axis: ``dim_size`` when given,
    else ``index.max() + 1`` (0 for an empty index), the reference's
    minimal size. On a CUDA index this reads back one scalar."""
    if dim_size is not None:
        return int(dim_size)
    if index.numel() == 0:
        return 0
    return int(index.max()) + 1


def broadcast_index(index: torch.Tensor, src_shape, dim: int) -> torch.Tensor:
    """A 1-D ``index`` laid along ``dim`` of ``src_shape`` and broadcast to
    it (the reference's ``_broadcast``); any other index is broadcast as it
    is."""
    if index.dim() == 1 and len(src_shape) > 1:
        shape = [1] * len(src_shape)
        shape[dim] = src_shape[dim]
        index = index.reshape(shape)
    return torch.broadcast_to(index, tuple(src_shape))


def move_dim_front(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with axis ``dim`` moved to the front."""
    return torch.movedim(x, dim, 0)


def move_dim_back(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The inverse of :func:`move_dim_front`: axis 0 moved to ``dim``."""
    return torch.movedim(x, 0, dim)


def is_floating(x: torch.Tensor) -> bool:
    """Whether ``x`` holds floating-point values."""
    return x.dtype.is_floating_point


def min_identity(dtype: torch.dtype) -> torch.Tensor:
    """The identity of ``min`` in ``dtype``: ``+inf``, or the largest
    integer."""
    if dtype.is_floating_point:
        return torch.tensor(float('inf'), dtype=dtype)
    return torch.tensor(torch.iinfo(dtype).max, dtype=dtype)


def max_identity(dtype: torch.dtype) -> torch.Tensor:
    """The identity of ``max`` in ``dtype``: ``-inf``, or the smallest
    integer."""
    if dtype.is_floating_point:
        return torch.tensor(float('-inf'), dtype=dtype)
    return torch.tensor(torch.iinfo(dtype).min, dtype=dtype)


def indptr_to_index(indptr: torch.Tensor, num_elements: int) -> torch.Tensor:
    """Expand a CSR ``indptr`` of shape ``[R+1]`` to the int32 segment id of
    each of ``num_elements`` positions.

    Positions at or past ``indptr[-1]`` (trailing padding) get id ``R``
    and positions before ``indptr[0]`` (a leading gap) get ``-1``: both
    lie outside ``[0, R)``, so they belong to no row, as in the reference's
    row loops, which only read ``[indptr[r], indptr[r+1])``. The ids are
    non-decreasing (``-1`` first, ``R`` last).
    """
    positions = torch.arange(num_elements, dtype=indptr.dtype,
                             device=indptr.device)
    ids = torch.searchsorted(indptr[1:].contiguous(), positions,
                             right=True).to(torch.int32)
    return torch.where(positions < indptr[0], torch.full_like(ids, -1), ids)


def index_to_indptr(index: torch.Tensor, size: int) -> torch.Tensor:
    """Sorted COO ``index`` -> CSR ``indptr`` of shape ``[size+1]``
    (int32).

    Ids outside ``[0, size)`` on either side (the ``-1`` leading-gap and
    ``R`` trailing ids :func:`indptr_to_index` gives) belong to no row:
    they are counted in two extra buckets that are cut off.
    """
    counts = torch.zeros(size + 2, dtype=torch.int32, device=index.device)
    ids = (index.long() + 1).clamp(0, size + 1)
    counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    out = torch.zeros(size + 1, dtype=torch.int32, device=index.device)
    out[1:] = torch.cumsum(counts[1:size + 1], 0)
    return out
