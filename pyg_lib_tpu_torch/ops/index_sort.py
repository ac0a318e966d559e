"""Stable integer sort returning ``(values, permutation)`` (port of
``pyg_lib_tpu.ops.index_sort``)."""

from typing import Optional, Tuple

import torch

__all__ = ['index_sort']


def index_sort(inputs: torch.Tensor,
               max_value: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorts a 1-D integer vector ascending; returns ``(values, perm)``
    with ``perm`` int64 and equal keys in their input order.

    ``max_value`` is taken for the reference's signature and not needed:
    ``torch.sort`` takes no bound.
    """
    del max_value
    if inputs.dim() != 1:
        raise ValueError('index_sort expects a 1-D tensor')
    values, perm = torch.sort(inputs, stable=True)
    return values, perm.long()
