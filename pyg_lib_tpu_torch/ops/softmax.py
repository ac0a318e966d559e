"""Sparse (CSR-grouped) softmax with the closed-form backward.

Port of ``pyg_lib_tpu/ops/softmax.py``. :func:`softmax_csr` computes, for
each group ``[ptr[g], ptr[g+1])`` along ``dim``, ``exp(src - max) /
Σ exp(src - max)``; its gradient is ``out * (g - Σ_group(out·g))``.

Two paths:

* the composite: a per-group ``amax`` and sum by scatter, in ``src``'s
  type, any ``dim`` and shape. Positions before ``ptr[0]`` (a leading gap,
  id -1) are left out of every group's max and sum and are divided by
  group 0's sum, and positions at or past ``ptr[-1]`` (trailing pad, id
  ``R``) are left out of both and shifted and divided by the last group's
  statistics, as in the JAX package;
* the planned kernel K6 (``ops/kernels/segment_softmax.py``) over the
  cached layout-only plan of ``ptr`` (``plan_cache.plan_for_ptr``), for
  ``dim=0``, a 2-D ``src``, a 1-D ``ptr`` with ``ptr[0] == 0`` and
  ``ptr[-1]`` equal to the edge count, and at least 65,536 edges, at any
  width. K6 reads ``src[edge_perm[p]]`` and writes ``out[edge_perm[p]]``,
  so nothing is permuted in memory. The JAX package's other rules (a TPU
  backend, ``F % 128 == 0``) are TPU rules and are not carried over; the
  rule ``ptr[0] == 0`` is the port's own: the plan's rows cover no
  leading gap, which the composite's semantics give.
"""

import numpy as np
import torch

from pyg_lib_tpu_torch.ops.kernels.plan_cache import plan_for_ptr
from pyg_lib_tpu_torch.ops.kernels.segment_softmax import (
    segment_softmax_planned)
from pyg_lib_tpu_torch.utils import indptr_to_index

__all__ = ['softmax_csr']

_PLANNED_MIN_EDGES = 65536


def _group_ids(ptr: torch.Tensor, n: int):
    """Group id + 1 of each position (0: leading gap, R + 1: trailing pad)
    and the clamped id that reads a group's statistics."""
    ids = indptr_to_index(ptr, n).long()
    num_groups = ptr.shape[0] - 1
    return ids + 1, ids.clamp(0, num_groups - 1), num_groups


def _group_sum(vals: torch.Tensor, slot: torch.Tensor,
               num_groups: int) -> torch.Tensor:
    out = torch.zeros((num_groups + 2, ) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, slot, vals)[1:num_groups + 1]


def _softmax_fwd(src_m: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    slot, safe, num_groups = _group_ids(ptr, src_m.shape[0])
    gmax = torch.full((num_groups + 2, ) + src_m.shape[1:], float('-inf'),
                      dtype=src_m.dtype, device=src_m.device)
    idx = slot.view((-1, ) + (1, ) * (src_m.dim() - 1)).expand_as(src_m)
    gmax = gmax.scatter_reduce(0, idx, src_m, 'amax')[1:num_groups + 1]
    e = torch.exp(src_m - gmax[safe])
    return e / _group_sum(e, slot, num_groups)[safe]


def _softmax_bwd(out_m: torch.Tensor, g_m: torch.Tensor,
                 ptr: torch.Tensor) -> torch.Tensor:
    slot, safe, num_groups = _group_ids(ptr, out_m.shape[0])
    gsum = _group_sum(out_m * g_m, slot, num_groups)
    return out_m * (g_m - gsum[safe])


class _SoftmaxCsr(torch.autograd.Function):
    """The composite forward, or K6 where ``plan`` is given (``src`` is
    then ``[E, F]`` and ``dim`` 0); either way the closed-form
    backward."""

    @staticmethod
    def forward(ctx, src, ptr, dim, plan):
        if plan is not None:
            out = segment_softmax_planned(src.contiguous(), plan,
                                          plan.edge_perm)
        else:
            out = _softmax_fwd(src.movedim(dim, 0), ptr).movedim(0, dim)
        ctx.save_for_backward(out, ptr)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, g):
        out, ptr = ctx.saved_tensors
        dim = ctx.dim
        grad = _softmax_bwd(out.movedim(dim, 0), g.movedim(dim, 0), ptr)
        return grad.movedim(0, dim), None, None, None


def _planned_ptr(src: torch.Tensor, ptr, dim: int):
    """The host copy of ``ptr`` when the planned path applies, else
    ``None``."""
    if dim != 0 or src.dim() != 2 or src.shape[0] < _PLANNED_MIN_EDGES:
        return None
    ptr_np = (ptr.detach().cpu().numpy() if isinstance(ptr, torch.Tensor)
              else np.asarray(ptr))
    if ptr_np.ndim != 1 or ptr_np.shape[0] < 2:
        return None
    # Trailing pad edges past ptr[-1] would change the output's shape, and
    # a leading gap belongs to no row of the plan: both keep the composite.
    if int(ptr_np[0]) != 0 or int(ptr_np[-1]) != src.shape[0]:
        return None
    return ptr_np


def softmax_csr(src: torch.Tensor, ptr, dim: int = 0) -> torch.Tensor:
    """Softmax over the CSR groups ``ptr`` along ``dim``.

    Parity: ``pyg_lib_tpu.ops.softmax_csr`` (the reference's
    ``pyg_lib.ops.softmax_csr``). ``ptr`` is a 1-D tensor, or a numpy
    array or list (moved to ``src``'s device). Large 2-D inputs along
    ``dim=0`` take kernel K6 over a cached plan of ``ptr`` (on a CUDA
    ``src``; its plain version on a CPU ``src``); the rest the
    composite. Differentiable in ``src``.
    """
    if not -src.dim() <= dim < src.dim():
        raise ValueError(f'dim {dim} out of range for a {src.dim()}-D src')
    dim = dim % src.dim()
    plan = None
    if _planned_ptr(src, ptr, dim) is not None:
        plan = plan_for_ptr(ptr, device=src.device)
    if not isinstance(ptr, torch.Tensor):
        ptr = torch.as_tensor(np.asarray(ptr, dtype=np.int64),
                              device=src.device)
    return _SoftmaxCsr.apply(src, ptr.to(src.device), dim, plan)
