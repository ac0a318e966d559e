"""Sorted segment sum from raw ``(src, indptr)``, kernel K3
(``csrc/segment_csr.cu``).

Port of ``pyg_lib_tpu/ops/pallas/segment_csr_kernel.py``:
``out[r] = Σ src[indptr[r]:indptr[r+1]]`` for a 2-D f32 or bf16 ``src``,
summed in f32 and returned in ``src``'s dtype. Positions outside
``[indptr[0], indptr[-1])`` belong to no row. The TPU kernel takes only
``F % 128 == 0`` (its lane width); K3 takes any ``F``.

K3 splits the work into equal stretches of one merge path over the row
ends and the edges (:func:`k3_split`), one stretch per warp; rows that
cross a stretch's ends go through an f32 partial table and a second
launch that adds each row's partials in order (:func:`k3_partial_codes`).
:func:`segment_sum_csr_split` runs that schedule on the CPU, so the tests
can hold it against the plain version.

:func:`segment_sum_csr_kernel` is the wrapper: K3 for a CUDA tensor, the
plain PyTorch version (:func:`segment_sum_csr_plain`) for a CPU tensor.
"""

import ctypes
from typing import NamedTuple

import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import DTYPE_CODE, _check_cuda
from pyg_lib_tpu_torch.utils import indptr_to_index

__all__ = ['K3Split', 'k3_partial_codes', 'k3_split', 'k3_units',
           'segment_sum_csr_kernel', 'segment_sum_csr_plain',
           'segment_sum_csr_split']

# Warps (stretches of the merge path) per SM, and the fewest items (row
# ends plus edges) a stretch is given on a small input.
UNITS_PER_SM = 8
MIN_ITEMS = 64


def segment_sum_csr_plain(src: torch.Tensor,
                          indptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: each position's row from
    :func:`indptr_to_index`, ``index_add_`` in f32 into a table with one
    extra row at each end for the positions of no row."""
    num_rows = indptr.shape[0] - 1
    ids = indptr_to_index(indptr, src.shape[0]).long() + 1
    out = torch.zeros((num_rows + 2, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    out.index_add_(0, ids, src.float())
    return out[1:num_rows + 1].to(src.dtype)


def k3_units(num_rows: int, num_el: int, sms: int) -> int:
    """Warps K3 launches: one per ``MIN_ITEMS`` items of the merge path
    (``num_el`` bounds its edges), at most ``UNITS_PER_SM`` per SM."""
    items = num_rows + num_el
    return max(1, min(-(-items // MIN_ITEMS), sms * UNITS_PER_SM))


class K3Split(NamedTuple):
    """K3's schedule for one ``indptr``: ``start[r]`` is row ``r``'s first
    edge in the stream of real edges (``start[R]`` their count); warp
    ``w`` ends rows ``[i[w], i[w+1])`` and takes edges ``[j[w], j[w+1])``
    of that stream."""
    start: torch.Tensor  # [R + 1] int64
    i: torch.Tensor  # [units + 1] int64
    j: torch.Tensor  # [units + 1] int64


def k3_split(indptr: torch.Tensor, num_el: int, units: int) -> K3Split:
    """The merge-path points the kernel's warps find by binary search:
    diagonal ``d = (R + E) * w // units`` meets the path at ``i`` row ends
    and ``j = d - i`` edges, ``i`` the least row with
    ``start[i + 1] + i >= d``."""
    c = indptr.to(torch.int64).clamp(0, num_el)
    start = (c - c[0]).clamp(min=0)
    total = int(start[-1])
    start = start.clamp(max=total)
    rows = indptr.shape[0] - 1
    diag = (rows + total) * torch.arange(units + 1, dtype=torch.int64,
                                         device=indptr.device) // units
    key = start[1:] + torch.arange(rows, dtype=torch.int64,
                                   device=indptr.device)
    i = torch.searchsorted(key, diag)
    i = torch.minimum(torch.maximum(i, (diag - total).clamp(min=0)),
                      diag.clamp(max=rows))
    return K3Split(start, i, diag - i)


def k3_partial_codes(split: K3Split) -> torch.Tensor:
    """The code of each of the ``2 * units`` partial slots: slot ``2w``
    holds warp ``w``'s first row when an earlier warp began it, slot
    ``2w + 1`` its last row when a later warp ends it. ``-1`` marks an
    unused slot, ``r`` the slot where row ``r``'s run of partials starts
    (its warp holds the row's first edge), ``-2 - r`` one that goes on."""
    start, i, j = split
    rows = start.shape[0] - 1
    i0, i1, j0, j1 = i[:-1], i[1:], j[:-1], j[1:]
    neg = torch.full_like(i0, -1)
    head = (i0 < i1) & (start[i0.clamp(max=rows)] < j0)
    tail_start = start[i1.clamp(max=rows)]
    tail = (i1 < rows) & (j1 > tail_start)
    codes = torch.stack([
        torch.where(head, -2 - i0, neg),
        torch.where(tail, torch.where(tail_start >= j0, i1, -2 - i1), neg)
    ], 1)
    return codes.reshape(-1)


def segment_sum_csr_split(src: torch.Tensor, indptr: torch.Tensor,
                          units: int) -> torch.Tensor:
    """K3's schedule run on the CPU: each warp's stretch summed in f32,
    rows that end in it written, rows it shares with its neighbours put in
    the partial table, then each run of partials added in slot order and
    rounded once. Raises if a row would be written other than once."""
    num_rows = indptr.shape[0] - 1
    num_el, f = src.shape
    split = k3_split(indptr.cpu(), num_el, units)
    start, i, j = (t.tolist() for t in split)
    codes = k3_partial_codes(split).tolist()
    base = max(min(int(indptr[0]), num_el), 0)
    edges = src[base:base + start[-1]].float()
    out = torch.zeros((num_rows, f), dtype=torch.float32)
    written = torch.zeros(num_rows, dtype=torch.int64)
    part = torch.zeros((2 * units, f), dtype=torch.float32)
    ends = torch.tensor(start[1:], dtype=torch.int64)
    for w in range(units):
        i0, i1, j0, j1 = i[w], i[w + 1], j[w], j[w + 1]
        last = min(i1, num_rows - 1)
        local = torch.zeros((max(last - i0 + 1, 0), f), dtype=torch.float32)
        if j1 > j0:
            e = torch.arange(j0, j1)
            local.index_add_(0, torch.searchsorted(ends, e, right=True) - i0,
                             edges[j0:j1])
        for r in range(i0, i1):
            if r == i0 and codes[2 * w] != -1:
                part[2 * w] = local[0]
            else:
                out[r] = local[r - i0]
                written[r] += 1
        if codes[2 * w + 1] != -1:
            part[2 * w + 1] = local[i1 - i0]
    for s, r in enumerate(codes):
        if r < 0:
            continue
        acc = part[s].clone()
        for t in range(s + 1, 2 * units):
            if codes[t] == -2 - r:
                acc += part[t]
            elif codes[t] != -1:
                break
        out[r] = acc
        written[r] += 1
    if not bool((written == 1).all()):
        raise AssertionError('K3 schedule writes a row other than once')
    return out.to(src.dtype)


def _k3_lib():
    lib = _build.load('segment_csr')
    fn = lib.pygt_segment_sum_csr
    if fn.argtypes is None:
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp, i, vp, i64, vp, i64, i, i, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def segment_sum_csr_kernel(src: torch.Tensor,
                           indptr: torch.Tensor) -> torch.Tensor:
    """K3: ``out[r] = Σ_{e in [indptr[r], indptr[r+1])} src[e]`` as
    ``[R, F]`` in ``src``'s dtype, summed in f32.

    ``src`` is 2-D f32 or bf16, ``indptr`` 1-D (any integer dtype,
    non-decreasing). A CUDA ``src`` launches the kernel (and raises on
    anything it does not take); a CPU ``src`` runs
    :func:`segment_sum_csr_plain`. ``segment_sum_csr_kernel.launches``
    counts kernel launches.
    """
    if not src.is_cuda:
        return segment_sum_csr_plain(src, indptr)
    dev = src.device
    if src.dim() != 2 or src.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'src must be a 2-D f32/bf16 tensor, got '
                         f'{src.dtype} of shape {tuple(src.shape)}')
    if indptr.dim() != 1 or indptr.device != dev:
        raise ValueError(f'indptr must be 1-D on {dev}, got shape '
                         f'{tuple(indptr.shape)} on {indptr.device}')
    _check_cuda('src', src, src.dtype, device=dev)
    ptr = indptr.to(torch.int64).contiguous()
    num_rows = ptr.shape[0] - 1
    f = src.shape[1]
    out = torch.empty((num_rows, f), dtype=src.dtype, device=dev)
    if num_rows == 0 or f == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    units = k3_units(num_rows, src.shape[0], sms)
    part = torch.empty((2 * units, f), dtype=torch.float32, device=dev)
    code = torch.empty(2 * units, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _k3_lib()(src.data_ptr(), DTYPE_CODE[src.dtype], ptr.data_ptr(),
                        src.shape[0], out.data_ptr(), num_rows, f, units,
                        part.data_ptr(), code.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K3 (segment_csr.cu) launch failed: CUDA error '
                           f'{err}')
    segment_sum_csr_kernel.launches += 1
    return out


segment_sum_csr_kernel.launches = 0
