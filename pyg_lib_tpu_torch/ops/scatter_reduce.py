"""Fused multi-reduction scatter, ``fused_scatter_reduce``.

Port of ``pyg_lib_tpu/ops/scatter_reduce.py`` (reference
``pyg_lib.ops.fused_scatter_reduce``: ``['sum', 'mean', 'min', 'max']``
side by side in one read of the messages). Two paths:

* **Fused** (a CUDA f32 ``[n, F]`` input with ``F % 128 == 0`` and at
  least 65,536 rows, and a non-decreasing host index, a numpy array, list,
  tuple or CPU tensor, of ``n`` ids): kernel K4s computes each row's max
  and sum in one pass over the rows' messages, read through the cached
  plan's ``edge_perm``; a negated pass adds min (K4s again when the sums
  are still missing, else K4). Mean divides the sums by the counts. Both
  thresholds are the JAX package's, set on the TPU and kept for parity.
* **Composite** (everything else): one scatter per reduction.

The output is ``[dim_size, len(reduce_list) * F]``, an empty bucket
giving 0 in every block. Gradients are exact: sum and mean go back to
every element of the bucket, min and max to the winner only.
"""

import hashlib
from typing import List, NamedTuple

import numpy as np
import torch

from pyg_lib_tpu_torch.ops.kernels.plan_cache import plan_for_ptr
from pyg_lib_tpu_torch.ops.kernels.segment_minmax import segment_max_kernel
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import TR, SpmmPlan
from pyg_lib_tpu_torch.ops.scatter import (as_index, scatter_max,
                                           scatter_mean, scatter_min,
                                           scatter_sum)

__all__ = ['fused_scatter_reduce']

REDUCTIONS = ['sum', 'mean', 'min', 'max']

_FUSED_MIN_ROWS = 65536
_FUSED_CACHE: dict = {}
_MAX_ENTRIES = 8


def _host_index(index):
    """``index`` as a numpy array when it lives on the host (numpy array,
    list, tuple or CPU tensor), else ``None``."""
    if isinstance(index, torch.Tensor):
        return index.detach().numpy() if index.device.type == 'cpu' else None
    if isinstance(index, (np.ndarray, list, tuple)):
        return np.asarray(index)
    return None


def _use_fused(inputs: torch.Tensor, index) -> bool:
    if not inputs.is_cuda:
        return False
    if inputs.dim() != 2 or inputs.dtype != torch.float32:
        return False
    if inputs.shape[1] % 128 or inputs.shape[0] < _FUSED_MIN_ROWS:
        return False
    # A CUDA index would be read back on every call to test its order;
    # the plan needs a host index anyway.
    idx = _host_index(index)
    return bool(idx is not None and len(idx) == inputs.shape[0]
                and (np.diff(idx) >= 0).all())


class _State(NamedTuple):
    """The fused path's tensors on one device."""
    plan: SpmmPlan
    counts: torch.Tensor  # [dim_size, 1] f32, at least 1
    empty: torch.Tensor  # [dim_size, 1] bool
    shift: torch.Tensor  # [dim_size, 1] int32: padded slot - edge id
    ids: torch.Tensor  # [n] int64 bucket of each row (0 where none)
    ids_ok: torch.Tensor  # [n, 1] bool: the row's bucket exists


class _FusedReduce:
    """The fused path of one ``(index, dim_size, reduce_list)``: its plan
    and tables per device, built on first use. Calling it applies
    :class:`_FusedFn`."""

    def __init__(self, idx: np.ndarray, dim_size: int, reduce_list):
        self.idx = idx
        self.dim_size = dim_size
        self.reduce_list = tuple(reduce_list)
        self.indptr = np.searchsorted(idx, np.arange(dim_size + 1)).astype(
            np.int64)
        self._states = {}

    def state(self, device) -> _State:
        hit = self._states.get(device)
        if hit is not None:
            return hit
        plan = plan_for_ptr(self.indptr, device=device)
        counts = np.diff(self.indptr).astype(np.float32)
        rows = torch.arange(self.dim_size, device=device)
        ids = torch.as_tensor(self.idx, device=device).long()
        ids = torch.where(ids < 0, ids + self.dim_size, ids)  # as take
        ok = (ids >= 0) & (ids < self.dim_size)
        st = _State(
            plan=plan,
            counts=torch.as_tensor(np.maximum(counts, 1.0),
                                   device=device)[:, None],
            empty=torch.as_tensor(counts == 0, device=device)[:, None],
            shift=plan.tile_shift[rows // TR][:, None],
            ids=torch.where(ok, ids, 0), ids_ok=ok[:, None])
        self._states[device] = st
        return st

    def forward(self, inputs: torch.Tensor, st: _State):
        """``(out, residual)``: the output blocks and the winners of the
        max and min blocks (sentinel ``n`` for an empty bucket)."""
        rl = self.reduce_list
        n = inputs.shape[0]
        x, plan = inputs.contiguous(), st.plan
        need_max, need_min = 'max' in rl, 'min' in rl
        need_sum = 'sum' in rl or 'mean' in rl
        sums = maxv = minv = arg_max = arg_min = None
        if need_max or (need_sum and not need_min):
            if need_sum:
                maxv, pos, sums = segment_max_kernel(x, plan, plan.edge_perm,
                                                     with_sum=True)
            else:
                maxv, pos = segment_max_kernel(x, plan, plan.edge_perm)
            arg_max = pos - st.shift
        if need_min:
            if need_sum and sums is None:
                minv, pos, nsums = segment_max_kernel(
                    x, plan, plan.edge_perm, negate=True, with_sum=True)
                sums = -nsums
            else:
                minv, pos = segment_max_kernel(x, plan, plan.edge_perm,
                                               negate=True)
            minv = -minv
            arg_min = pos - st.shift
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        sentinel = torch.full((), n, dtype=torch.int32, device=x.device)
        blocks, residual = [], {}
        for r in rl:
            if r == 'sum':
                blocks.append(torch.where(st.empty, zero, sums))
            elif r == 'mean':
                blocks.append(torch.where(st.empty, zero, sums / st.counts))
            elif r == 'max':
                blocks.append(torch.where(st.empty, zero, maxv))
                residual['max'] = torch.where(st.empty, sentinel, arg_max)
            elif r == 'min':
                blocks.append(torch.where(st.empty, zero, minv))
                residual['min'] = torch.where(st.empty, sentinel, arg_min)
        return torch.cat(blocks, 1), residual

    def __call__(self, inputs: torch.Tensor) -> torch.Tensor:
        return _FusedFn.apply(inputs, self)


class _FusedFn(torch.autograd.Function):
    """The fused forward; its backward is plain PyTorch, as the JAX
    package's is plain XLA: sum and mean gather the output gradient at
    each row's bucket (NaN for an id outside ``[0, dim_size)``, as JAX's
    ``take`` fills), max and min add it into the winners."""

    @staticmethod
    def forward(ctx, inputs, fused):
        st = fused.state(inputs.device)
        out, residual = fused.forward(inputs, st)
        ctx.fused, ctx.st, ctx.n = fused, st, inputs.shape[0]
        ctx.keys = tuple(residual)
        ctx.save_for_backward(*residual.values())
        return out

    @staticmethod
    def backward(ctx, g):
        st, rl, n = ctx.st, ctx.fused.reduce_list, ctx.n
        winners = dict(zip(ctx.keys, ctx.saved_tensors))
        f_dim = g.shape[1] // len(rl)
        grad = g.new_zeros((n + 1, f_dim))  # row n takes the sentinel
        for bi, r in enumerate(rl):
            gb = g[:, bi * f_dim:(bi + 1) * f_dim]
            if r in ('sum', 'mean'):
                if r == 'mean':
                    gb = gb / st.counts
                taken = torch.where(st.ids_ok, gb[st.ids],
                                    torch.full((), float('nan'),
                                               dtype=g.dtype,
                                               device=g.device))
                grad[:n].add_(taken)
                del taken
            else:
                grad.scatter_add_(0, winners[r].long(), gb)
        return grad[:n], None


def _fused(index, dim_size: int, reduce_list) -> _FusedReduce:
    """The cached fused path of one ``(index, dim_size, reduce_list)``:
    keyed on the sha1 of the index's bytes, and each hit checked against
    the stored copy of the index (at most 8 entries)."""
    idx = _host_index(index)
    if idx is None:
        raise ValueError('the fused path needs a host index')
    key = (hashlib.sha1(idx.tobytes()).hexdigest(), dim_size,
           tuple(reduce_list))
    hit = _FUSED_CACHE.get(key)
    if hit is not None and np.array_equal(hit.idx, idx):
        return hit
    fused = _FusedReduce(idx.copy(), dim_size, reduce_list)
    if key not in _FUSED_CACHE and len(_FUSED_CACHE) >= _MAX_ENTRIES:
        _FUSED_CACHE.pop(next(iter(_FUSED_CACHE)))
    _FUSED_CACHE[key] = fused
    return fused


def fused_scatter_reduce(inputs: torch.Tensor, index, dim_size: int,
                         reduce_list: List[str]) -> torch.Tensor:
    """Several scatter reductions of ``inputs [n, F]`` along rows, side by
    side: ``[dim_size, len(reduce_list) * F]`` (reference
    ``fused_scatter_reduce``). Unlike the reference, which is forward-only,
    it is differentiable; on the card with a sorted host index it takes
    the fused path (module docstring)."""
    ndim = index.dim() if isinstance(index, torch.Tensor) else np.ndim(index)
    if inputs.dim() != 2 or ndim != 1:
        raise ValueError('fused_scatter_reduce expects 2-D inputs, 1-D index')
    if not inputs.dtype.is_floating_point:
        raise ValueError('fused_scatter_reduce requires floating inputs')
    if len(reduce_list) > len(REDUCTIONS):
        raise ValueError(f'at most {len(REDUCTIONS)} reductions')
    for reduce in reduce_list:
        if reduce not in REDUCTIONS:
            raise ValueError(f'Unknown reduction: {reduce!r}')
    if _use_fused(inputs, index):
        return _fused(index, dim_size, tuple(reduce_list))(inputs)
    index = as_index(index, inputs.device)
    outs = []
    for reduce in reduce_list:
        if reduce == 'sum':
            outs.append(scatter_sum(inputs, index, 0, dim_size=dim_size))
        elif reduce == 'mean':
            outs.append(scatter_mean(inputs, index, 0, dim_size=dim_size))
        elif reduce == 'min':
            outs.append(scatter_min(inputs, index, 0, dim_size=dim_size)[0])
        elif reduce == 'max':
            outs.append(scatter_max(inputs, index, 0, dim_size=dim_size)[0])
    return torch.cat(outs, 1)
