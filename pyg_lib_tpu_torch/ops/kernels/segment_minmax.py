"""Exact per-row max with first-winner positions over the chunked plan,
kernel K4 (``csrc/segment_minmax.cu``).

Port of ``pyg_lib_tpu/ops/pallas/segment_minmax_kernel.py`` (without its
row-sum output). Over a :class:`SpmmPlan`'s padded layout, row ``r``'s
messages are its padded slots ``p``; the message at ``p`` is

* ``src[p]`` when ``idx`` is ``None`` (``src`` is a padded slab
  ``[E_pad, F]``, as ``segment_max_padded`` gives it);
* ``src[idx[p]]`` otherwise: ``idx=plan.col_padded`` is ``spmm``'s
  gather, ``idx=plan.edge_perm`` the planned ``segment_max_csr``'s
  original edge order. The gather is fused, so the ``[E_pad, F]`` slab
  the TPU path writes first never exists on the card.

The result is ``(values [N, F] f32, padded_pos [N, F] int32)``: the
row's maximum and the first slot that holds it. A row with no slots gets
``(-inf, POS_NONE)``; a row whose true maximum is ``-inf`` reports its
first slot. Ties, ``-0.0`` against ``+0.0`` included, go to the first
slot, and the value is that slot's own bits. ``negate=True`` takes the
maximum of ``-message`` (for min: the caller negates the values back).

:func:`segment_max_kernel` is the wrapper: K4 for a CUDA tensor, the
plain PyTorch version (:func:`segment_max_plain`, the counterpart of
``_minmax_padded_xla``) for a CPU tensor.
"""

import ctypes
from typing import Optional

import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (PTR_SUB, TP,
                                                        SpmmPlan,
                                                        _check_cuda,
                                                        _padded_rows)

__all__ = ['NEG', 'POS_NONE', 'segment_max_kernel', 'segment_max_plain']

NEG = float('-inf')
POS_NONE = 1 << 30  # position of a row with no slots


def winner_values(src, rows, hit, negate):
    """``±src[rows[r, f], f]`` where ``hit``, ``-inf`` elsewhere: each
    winner's value re-read from its source, with its own bits."""
    vals = torch.gather(src.float(), 0, torch.where(hit, rows, 0).long())
    if negate:
        vals = -vals
    return torch.where(hit, vals, torch.full_like(vals, NEG))


def segment_max_plain(src: torch.Tensor, plan: SpmmPlan,
                      idx: Optional[torch.Tensor] = None,
                      negate: bool = False):
    """Plain PyTorch version of K4: per-row ``amax`` of the messages,
    then the least slot whose message equals it; the value is re-read at
    that slot, so a ``±0.0`` tie keeps the first slot's sign."""
    slot, row = _padded_rows(plan.tile_ptr)
    f = src.shape[1]
    msgs = src[slot if idx is None else idx[slot].long()].float()
    if negate:
        msgs = -msgs
    rows = row[:, None].expand(-1, f)
    vals = torch.full((plan.num_rows, f), NEG, dtype=torch.float32,
                      device=src.device)
    vals.scatter_reduce_(0, rows, msgs, 'amax')
    cand = torch.where(msgs == vals[row], slot[:, None].to(torch.int32),
                       torch.tensor(POS_NONE, dtype=torch.int32,
                                    device=src.device))
    pos = torch.full((plan.num_rows, f), POS_NONE, dtype=torch.int32,
                     device=src.device)
    pos.scatter_reduce_(0, rows, cand, 'amin')
    hit = pos < POS_NONE
    slot = torch.where(hit, pos, 0)
    return winner_values(src, slot if idx is None else idx[slot.long()],
                         hit, negate), pos


def _k4_lib():
    lib = _build.load('segment_minmax')
    fn = lib.pygt_segment_max
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, vp, vp, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def segment_max_kernel(src: torch.Tensor, plan: SpmmPlan,
                       idx: Optional[torch.Tensor] = None,
                       negate: bool = False):
    """K4: ``(values, padded_pos)`` of the per-row maximum of
    ``±src[p]`` (``idx=None``) or ``±src[idx[p]]`` over each row's padded
    slots ``p``.

    ``src`` is f32. A CUDA ``src`` launches the kernel (and raises on
    anything it does not take); a CPU ``src`` runs
    :func:`segment_max_plain`. ``segment_max_kernel.launches`` counts
    kernel launches.
    """
    if not src.is_cuda:
        return segment_max_plain(src, plan, idx, negate)
    dev = src.device
    if src.dim() != 2:
        raise ValueError(f'src must be 2-D, got shape {tuple(src.shape)}')
    num_tiles = plan.tile_ptr.shape[0]
    e_pad = plan.col_padded.shape[0]
    f = src.shape[1]
    _check_cuda('src', src, torch.float32, device=dev)
    _check_cuda('tile_ptr', plan.tile_ptr, torch.int32,
                (num_tiles, PTR_SUB, TP), dev)
    if idx is not None:
        _check_cuda('idx', idx, torch.int32, (e_pad, ), dev)
    elif src.shape[0] < e_pad:
        raise ValueError(f'a padded src needs {e_pad} rows, got '
                         f'{src.shape[0]}')
    if src.shape[0] >= 2**31 or e_pad >= 2**31:
        raise ValueError('K4 indexes rows and slots with int32')
    vals = torch.empty((plan.num_rows, f), dtype=torch.float32, device=dev)
    pos = torch.empty((plan.num_rows, f), dtype=torch.int32, device=dev)
    if plan.num_rows == 0 or f == 0:
        return vals, pos
    with torch.cuda.device(dev):
        err = _k4_lib()(src.data_ptr(),
                        None if idx is None else idx.data_ptr(),
                        plan.tile_ptr.data_ptr(), int(negate),
                        vals.data_ptr(), pos.data_ptr(), num_tiles,
                        plan.num_rows, f,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K4 (segment_minmax.cu) launch failed: CUDA '
                           f'error {err}')
    segment_max_kernel.launches += 1
    return vals, pos


segment_max_kernel.launches = 0
