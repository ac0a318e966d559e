"""Segment and grouped matmul — the per-relation transform of
heterogeneous GNNs.

Port of ``pyg_lib_tpu/ops/matmul.py``. The JAX package runs
``segment_matmul`` as XLA's ``ragged_dot`` (no Pallas kernel: on the TPU it
measured at the roofline knee of one dense GEMM of the same shape); here
each segment is one ``torch.mm`` (cuBLAS on the card) on a row slice of
``inputs``, a view. Autograd derives the reference's gradients:
``grad_inputs = g @ otherᵀ`` per segment and ``grad_other[s] =
inputs[s]ᵀ @ g[s]``, zero for an empty segment. TF32 is left to the
caller (``torch.backends.cuda.matmul.allow_tf32``), as for every other
GEMM of the port.
"""

from typing import List, Optional

import numpy as np
import torch

from pyg_lib_tpu_torch.ops.kernels.plan_cache import _host

__all__ = ['grouped_matmul', 'segment_matmul']


def segment_matmul(inputs: torch.Tensor, ptr, other: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[rows of segment s] = inputs[rows of s] @ other[s] (+ bias[s])``.

    Args:
        inputs: ``[N, K]`` left operand.
        ptr: ``[B+1]`` segment boundaries, numpy or a tensor. Segment ``s``
            holds ``ptr[s+1] - ptr[s]`` rows (empty segments are allowed),
            laid from row 0 in order, as ``ragged_dot``'s group sizes;
            rows at or past ``ptr[-1] - ptr[0]`` are trailing padding and
            give zero rows without bias. The sizes are read on the host:
            a CUDA ``ptr`` costs one device-to-host copy (a synchronisation)
            per call, a numpy ``ptr`` none.
        other: ``[B, K, M]`` per-segment right operands.
        bias: optional ``[B, M]`` per-segment bias.
    """
    sizes = np.diff(_host(ptr).astype(np.int64))
    if other.dim() != 3 or sizes.shape[0] != other.shape[0]:
        raise ValueError(f'other must be [{sizes.shape[0]}, K, M] for a ptr '
                         f'of {sizes.shape[0] + 1} entries, got '
                         f'{tuple(other.shape)}')
    if (sizes < 0).any():
        raise ValueError('ptr must be non-decreasing')
    total = int(sizes.sum())
    n = inputs.shape[0]
    if total > n:
        raise ValueError(f'ptr covers {total} rows but inputs has {n}')
    outs = []
    lo = 0
    # Empty segments still take a 0-row product, so other[s] gets its zero
    # gradient even when no segment has rows.
    for s, size in enumerate(sizes.tolist()):
        seg = inputs[lo:lo + size]
        outs.append(seg @ other[s] if bias is None else
                    torch.addmm(bias[s], seg, other[s]))
        lo += size
    if total < n or not outs:
        outs.append(inputs.new_zeros(
            (n - total, other.shape[2]),
            dtype=torch.promote_types(inputs.dtype, other.dtype)))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def grouped_matmul(inputs: List[torch.Tensor], others: List[torch.Tensor],
                   biases: Optional[List[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """``[inputs[i] @ others[i] (+ biases[i])]`` for groups of their own
    shapes. Groups that all share ``K`` and ``others``' shape go through one
    :func:`segment_matmul` over the concatenated inputs, as in the JAX
    package; others take one ``torch.mm`` each."""
    if len(inputs) != len(others):
        raise ValueError('inputs and others must have equal length')
    same_shape = (len({x.shape[1] for x in inputs}) == 1
                  and len({tuple(w.shape) for w in others}) == 1)
    if same_shape and len(inputs) > 1:
        sizes = [x.shape[0] for x in inputs]
        ptr = np.concatenate([[0], np.cumsum(sizes)])
        out = segment_matmul(torch.cat(inputs), ptr, torch.stack(others))
        outs = list(torch.split(out, sizes))
    else:
        outs = [x @ w for x, w in zip(inputs, others)]
    if biases is not None:
        outs = [o + b for o, b in zip(outs, biases)]
    return outs
