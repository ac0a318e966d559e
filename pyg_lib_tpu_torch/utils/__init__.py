"""Shared helpers for the port's device ops."""

from typing import Optional, Union

import torch

Array = torch.Tensor

__all__ = ['Array', 'indptr_to_index', 'max_identity', 'min_identity']


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
