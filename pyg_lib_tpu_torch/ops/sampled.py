"""Sampled binary ops: ``out = left[left_index] op right[right_index]``
(port of ``pyg_lib_tpu.ops.sampled``).

Each side is gathered along its first axis with ``index_select`` (or taken
as it is when its index is ``None``) and the two are combined with
broadcasting, as the JAX package does with ``jnp.take``. Gradients come
from autograd: the gathers' transposes add into ``left`` and ``right``.
These are the SDDMM building block (edge values from node values).
"""

from typing import Optional

import torch

__all__ = ['sampled_add', 'sampled_sub', 'sampled_mul', 'sampled_div']

_OPS = {'add': torch.add, 'sub': torch.sub, 'mul': torch.mul,
        'div': torch.div}


def _take(t: torch.Tensor, index: Optional[torch.Tensor]) -> torch.Tensor:
    if index is None:
        return t
    index = torch.as_tensor(index, device=t.device)
    flat = t.index_select(0, index.reshape(-1).long())
    return flat.reshape(tuple(index.shape) + tuple(t.shape[1:]))


def _sampled_op(left: torch.Tensor, right: torch.Tensor,
                left_index: Optional[torch.Tensor],
                right_index: Optional[torch.Tensor], op: str
                ) -> torch.Tensor:
    if op not in _OPS:
        raise ValueError(f'Unknown op: {op!r}')
    return _OPS[op](_take(left, left_index), _take(right, right_index))


def sampled_add(left: torch.Tensor, right: torch.Tensor,
                left_index: Optional[torch.Tensor] = None,
                right_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``left[left_index] + right[right_index]``."""
    return _sampled_op(left, right, left_index, right_index, 'add')


def sampled_sub(left: torch.Tensor, right: torch.Tensor,
                left_index: Optional[torch.Tensor] = None,
                right_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``left[left_index] - right[right_index]``."""
    return _sampled_op(left, right, left_index, right_index, 'sub')


def sampled_mul(left: torch.Tensor, right: torch.Tensor,
                left_index: Optional[torch.Tensor] = None,
                right_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``left[left_index] * right[right_index]``."""
    return _sampled_op(left, right, left_index, right_index, 'mul')


def sampled_div(left: torch.Tensor, right: torch.Tensor,
                left_index: Optional[torch.Tensor] = None,
                right_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``left[left_index] / right[right_index]`` (true division, as
    ``jnp``'s ``/``)."""
    return _sampled_op(left, right, left_index, right_index, 'div')
