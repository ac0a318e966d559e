"""The padded-batch models' row gather ``x[row.clamp(max=N-1)]``, with a
backward written for the card (``csrc/gather_rows.cu``).

A padded batch's pad edges carry ``row == N`` and clamp onto row N-1, so
that row is read by every pad edge, and a real hub source by many edges.
PyTorch's backward of ``x[idx]`` walks each row's duplicates one after
another in one warp; :func:`gather_rows` keeps the forward and gives the
backward of a CUDA ``x`` (f32 or bf16, viewed as ``[N, -1]``) as a device
sort of the source rows (:func:`sorted_segments`) and one segment sum over
the sorted edges, read through the sort's permutation
(:func:`gather_rows_backward`): K3's merge-path schedule, so a long row is
shared by many warps, with its partials added in a fixed order; another
dtype on the card raises. CPU tensors keep PyTorch's own backward
(:func:`gather_rows_backward_plain`).

:func:`gather_rows_backward_split` runs the card's schedule on the CPU
(K3's :func:`~pyg_lib_tpu_torch.ops.kernels.segment_csr.
segment_sum_csr_split` over the sorted rows), so the tests can hold it
against the plain version.
"""

import ctypes
import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from pyg_lib_tpu_torch import _build, profiling
from pyg_lib_tpu_torch.ops.kernels.segment_csr import (k3_units,
                                                       segment_sum_csr_split)
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import DTYPE_CODE, _check_cuda

__all__ = ['gather_rows', 'gather_rows_backward',
           'gather_rows_backward_plain', 'gather_rows_backward_split',
           'sorted_segments']

_SORTED_DTYPES = (torch.float32, torch.bfloat16)


def sorted_segments(idx: torch.Tensor,
                    n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, indptr)`` of the entries of ``idx`` (1-D, in ``[-n, n)``, a
    negative entry counting from the end as in ``x[idx]``) grouped by the
    row they read: ``perm`` sorts them stably by row, so each row keeps its
    entries in their order, and row ``r``'s entries are
    ``perm[indptr[r]:indptr[r+1]]`` (``indptr [n + 1]`` int64)."""
    key = idx.remainder(n).to(torch.int32 if n < 2**31 else torch.int64)
    key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(n + 1, dtype=key.dtype, device=key.device)
    return perm, torch.searchsorted(key, bounds)


def gather_rows_backward_plain(g: torch.Tensor, idx: torch.Tensor,
                               n: int) -> torch.Tensor:
    """The gradient of ``x[idx]`` for ``x`` of ``n`` rows, as PyTorch's
    autograd computes it: ``g``'s entries added into a zero
    ``[n, *g.shape[idx.dim():]]`` by ``index_put_(accumulate=True)``."""
    grad = g.new_zeros((n, *g.shape[idx.dim():]))
    return grad.index_put_((idx,), g, accumulate=True)


def gather_rows_backward_split(g: torch.Tensor, idx: torch.Tensor, n: int,
                               units: int) -> torch.Tensor:
    """:func:`gather_rows_backward`'s schedule on the CPU: the rows sorted
    by :func:`sorted_segments`, then K3's schedule of ``units`` warps over
    them (each warp's stretch summed in f32 and the partials of a shared
    row added in slot order)."""
    perm, indptr = sorted_segments(idx, n)
    return segment_sum_csr_split(g[perm], indptr, units)


def _lib():
    fn = _build.load('gather_rows').pygt_gather_rows_backward
    if fn.argtypes is None:
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp, i, vp, vp, i64, vp, i64, i, i, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def gather_rows_backward(g: torch.Tensor, idx: torch.Tensor,
                         n: int) -> torch.Tensor:
    """``grad[r] = Σ g[e]`` over the entries ``e`` of ``idx`` that read row
    ``r`` (``idx`` 1-D in ``[-n, n)``), ``[n, F]`` in ``g``'s dtype, summed
    in f32 in entry order; a row no entry reads is zero.

    A CUDA ``g`` (2-D f32 or bf16, one row an entry) is sorted by
    :func:`sorted_segments` and summed by the kernel, which reads ``g``
    through the permutation (no ``g[perm]`` is written); it raises on
    anything the kernel does not take. A CPU ``g`` runs
    :func:`gather_rows_backward_plain`. ``gather_rows_backward.launches``
    counts kernel launches.
    """
    if not g.is_cuda:
        return gather_rows_backward_plain(g, idx, n)
    dev = g.device
    if g.dim() != 2 or g.dtype not in _SORTED_DTYPES:
        raise ValueError(f'g must be a 2-D f32/bf16 tensor, got {g.dtype} '
                         f'of shape {tuple(g.shape)}')
    if idx.dim() != 1 or idx.device != dev or idx.shape[0] != g.shape[0]:
        raise ValueError(f'idx must be 1-D with one entry per row of g on '
                         f'{dev}, got shape {tuple(idx.shape)} on '
                         f'{idx.device}')
    _check_cuda('g', g, g.dtype, device=dev)
    num_el, f = g.shape
    out = torch.empty((n, f), dtype=g.dtype, device=dev)
    if n == 0 or f == 0:
        return out
    perm, indptr = sorted_segments(idx, n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    units = k3_units(n, num_el, sms)
    part = torch.empty((2 * units, f), dtype=torch.float32, device=dev)
    code = torch.empty(2 * units, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _lib()(g.data_ptr(), DTYPE_CODE[g.dtype], perm.data_ptr(),
                     indptr.data_ptr(), num_el, out.data_ptr(), n, f, units,
                     part.data_ptr(), code.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'gather_rows.cu launch failed: CUDA error {err}')
    gather_rows_backward.launches += 1
    return out


gather_rows_backward.launches = 0


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` whose backward is :func:`gather_rows_backward` over ``x``
    viewed as ``[N, -1]``: the kernel for a CUDA ``x``, PyTorch's own
    backward for a CPU one."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        with profiling.span('ops.gather.backward',
                            path='sorted' if g.is_cuda else 'plain',
                            edge_slots=idx.numel(), rows=ctx.shape[0]):
            if g.is_cuda:
                return _sorted_backward(ctx, g), None
            return gather_rows_backward_plain(g, idx, ctx.shape[0]), None


@once_differentiable
def _sorted_backward(ctx, g):
    # The kernel writes through ctypes and leaves no graph: a second
    # derivative raises instead of coming back without this term.
    idx, = ctx.saved_tensors
    rows = g.reshape(idx.numel(), math.prod(ctx.shape[1:])).contiguous()
    return gather_rows_backward(rows, idx.reshape(-1),
                                ctx.shape[0]).view(ctx.shape)


def gather_rows(x: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``x[row.clamp(max=N-1)]`` with ``N = x.shape[0]``: a padded batch's
    pad entries (``row == N``) read row N-1.

    Its gradient is that of the same indexing for any cotangent: each
    entry's cotangent row, pads included, goes to ``grad_x[min(row,
    N-1)]``. On the card that is :func:`gather_rows_backward` over ``x``
    viewed as ``[N, -1]`` (f32 or bf16; deterministic, bit for bit run to
    run; no second derivative); on the CPU PyTorch's. An ``x`` that needs
    no gradient costs only the indexing. A backward is an
    ``ops.gather.backward`` span of
    :mod:`~pyg_lib_tpu_torch.profiling` (``path``: ``'sorted'`` or
    ``'plain'``; ``edge_slots``, the entries; ``rows``, N).
    """
    idx = row.clamp(max=x.shape[0] - 1)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return x[idx]
    return _GatherRows.apply(x, idx)
