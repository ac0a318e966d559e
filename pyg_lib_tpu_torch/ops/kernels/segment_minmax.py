"""Exact per-row max with first-winner positions over the chunked plan,
kernel K4 (``csrc/segment_minmax.cu``), and with the row sums of the same
pass, kernel K4s.

Port of ``pyg_lib_tpu/ops/pallas/segment_minmax_kernel.py``, its row-sum
output (``with_sum=True``) included. Over a :class:`SpmmPlan`'s padded
layout, row ``r``'s messages are its padded slots ``p``; the message at
``p`` is

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
``with_sum=True`` also returns ``sums [N, F] f32``, each row's sum of the
same (negated, with ``negate``) messages, 0 for a row with no slots; the
values and positions stay bit for bit those without it.

K4 walks each row's slots with one warp; a row of more than ``K4_LONG``
slots is cut into pieces of ``K4_LONG`` (:func:`k4_pieces`), a warp each,
whose results are merged in order by :func:`k4_merge` (and whose sums
are added in piece order). :func:`segment_max_split` runs that schedule
with PyTorch, so the tests can hold its merge against the plain version
bit for bit.

:func:`segment_max_kernel` is the wrapper: K4 for a CUDA tensor, the
plain PyTorch version (:func:`segment_max_plain`, the counterpart of
``_minmax_padded_xla``) for a CPU tensor.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (PTR_SUB, TP, TR,
                                                        SpmmPlan, _cached,
                                                        _check_cuda,
                                                        _padded_rows)

__all__ = ['NEG', 'POS_NONE', 'K4Pieces', 'k4_merge', 'k4_pieces',
           'segment_max_kernel', 'segment_max_plain', 'segment_max_split']

NEG = float('-inf')
POS_NONE = 1 << 30  # position of a row with no slots
# The row length above which K4 cuts a row into pieces of K4_LONG slots, a
# warp each (LONG in csrc/segment_minmax.cu).
K4_LONG = 512


class K4Pieces(NamedTuple):
    """The rows longer than ``K4_LONG`` slots, cut into pieces."""
    pieces: torch.Tensor  # [P, 3] int32: row, first slot, end slot
    rows: torch.Tensor  # [L, 3] int32: row, first piece, piece count


def _row_bounds(tile_ptr, num_rows):
    """Each row's first padded slot and slot count, read off ``tile_ptr``."""
    bounds = tile_ptr[:, 0, :TR + 1].long()
    lo = bounds[:, :-1].reshape(-1)[:num_rows]
    return lo, (bounds[:, 1:] - bounds[:, :-1]).reshape(-1)[:num_rows]


def _derive_pieces(tile_ptr, num_rows) -> K4Pieces:
    lo, n = _row_bounds(tile_ptr, num_rows)
    rows = torch.nonzero(n > K4_LONG).reshape(-1)
    count = -(-n[rows] // K4_LONG)
    first = torch.cumsum(count, 0) - count
    of = torch.repeat_interleave(torch.arange(rows.shape[0],
                                              device=rows.device), count)
    start = lo[rows][of] + (torch.arange(of.shape[0], device=rows.device) -
                            first[of]) * K4_LONG
    end = torch.minimum(start + K4_LONG, (lo + n)[rows][of])
    return K4Pieces(
        pieces=torch.stack([rows[of], start, end], 1).int().contiguous(),
        rows=torch.stack([rows, first, count], 1).int().contiguous())


def k4_pieces(plan: SpmmPlan) -> K4Pieces:
    """The piece table K4 reads for ``plan``'s rows of more than
    ``K4_LONG`` slots, derived with tensor ops on ``plan.tile_ptr``'s
    device on first use and cached per ``tile_ptr`` (as K2's tables)."""
    return _cached(('k4_pieces', plan.num_rows, K4_LONG), (plan.tile_ptr, ),
                   lambda tp: _derive_pieces(tp, plan.num_rows))


def winner_values(src, rows, hit, negate):
    """``±src[rows[r, f], f]`` where ``hit``, ``-inf`` elsewhere: each
    winner's value re-read from its source, with its own bits."""
    vals = torch.gather(src.float(), 0, torch.where(hit, rows, 0).long())
    if negate:
        vals = -vals
    return torch.where(hit, vals, torch.full_like(vals, NEG))


def segment_max_plain(src: torch.Tensor, plan: SpmmPlan,
                      idx: Optional[torch.Tensor] = None,
                      negate: bool = False, with_sum: bool = False):
    """Plain PyTorch version of K4: per-row ``amax`` of the messages,
    then the least slot whose message equals it; the value is re-read at
    that slot, so a ``±0.0`` tie keeps the first slot's sign. With
    ``with_sum`` (K4s), also an ``index_add_`` of the messages by row."""
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
    at = torch.where(hit, pos, 0)
    vals = winner_values(src, at if idx is None else idx[at.long()], hit,
                         negate)
    if not with_sum:
        return vals, pos
    sums = torch.zeros((plan.num_rows, f), dtype=torch.float32,
                       device=src.device).index_add_(0, row, msgs)
    return vals, pos, sums


def k4_merge(bv, bp, ov, op):
    """K4's merge of two partial results ``(value, slot)``: a taken slot
    beats ``POS_NONE``, the greater value wins, an equal value (``-0.0``
    and ``+0.0`` included) with the smaller slot wins. Associative and
    commutative; the winner keeps its own bits."""
    take = (op != POS_NONE) & ((bp == POS_NONE) | (ov > bv) |
                               ((ov == bv) & (op < bp)))
    return torch.where(take, ov, bv), torch.where(take, op, bp)


def segment_max_split(src: torch.Tensor, plan: SpmmPlan,
                      idx: Optional[torch.Tensor] = None,
                      negate: bool = False, with_sum: bool = False):
    """K4's schedule run with PyTorch: a row of more than ``K4_LONG`` slots
    is cut into pieces of ``K4_LONG``; each piece (or shorter row) is
    walked in slot order with the first-winner update, and a row's pieces
    are merged in order by :func:`k4_merge`. With ``with_sum`` (K4s) each
    piece also sums its messages in slot order, and a row's piece sums are
    added in piece order."""
    slot, row = _padded_rows(plan.tile_ptr)
    f = src.shape[1]
    lo, _ = _row_bounds(plan.tile_ptr, plan.num_rows)
    k = slot - lo[row]
    piece, step = k // K4_LONG, k % K4_LONG
    npieces = int(piece.max()) + 1 if piece.numel() else 1
    msgs = src[slot if idx is None else idx[slot].long()].float()
    if negate:
        msgs = -msgs
    best = torch.full((plan.num_rows, npieces, f), NEG, device=src.device)
    bpos = torch.full((plan.num_rows, npieces, f), POS_NONE,
                      dtype=torch.int32, device=src.device)
    acc = torch.zeros((plan.num_rows, npieces, f), device=src.device)
    for t in range(int(step.max()) + 1 if step.numel() else 0):
        sel = step == t
        at = (row[sel], piece[sel])
        m, b, p = msgs[sel], best[at], bpos[at]
        take = (m > b) | ((m == b) & (p == POS_NONE))
        best[at] = torch.where(take, m, b)
        bpos[at] = torch.where(take, slot[sel, None].to(torch.int32), p)
        acc[at] = acc[at] + m
    vals, pos, sums = best[:, 0], bpos[:, 0], acc[:, 0]
    for p in range(1, npieces):
        vals, pos = k4_merge(vals, pos, best[:, p], bpos[:, p])
        sums = sums + acc[:, p]
    return (vals, pos, sums) if with_sum else (vals, pos)


def _k4_lib(with_sum: bool):
    lib = _build.load('segment_minmax')
    fn = lib.pygt_segment_max_sum if with_sum else lib.pygt_segment_max
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # src, idx, tile_ptr, negate, the outputs (vals, pos[, sums]),
        # num_tiles, num_rows, F, pieces, num_pieces, long_rows, num_long,
        # the scratch tables (part_val, part_pos[, part_sum]), stream
        n = 3 if with_sum else 2
        fn.argtypes = ([vp, vp, vp, i] + [vp] * n + [i, i, i, vp, i, vp, i]
                       + [vp] * n + [vp])
        fn.restype = ctypes.c_int
    return fn


def segment_max_kernel(src: torch.Tensor, plan: SpmmPlan,
                       idx: Optional[torch.Tensor] = None,
                       negate: bool = False, with_sum: bool = False):
    """K4: ``(values, padded_pos)`` of the per-row maximum of
    ``±src[p]`` (``idx=None``) or ``±src[idx[p]]`` over each row's padded
    slots ``p``; with ``with_sum``, K4s: ``(values, padded_pos, sums)``,
    the row sums of the same messages from the same pass.

    ``src`` is f32. A CUDA ``src`` launches the kernel (and raises on
    anything it does not take); a CPU ``src`` runs
    :func:`segment_max_plain`. ``segment_max_kernel.launches`` counts K4
    launches and ``segment_max_kernel.sum_launches`` K4s launches.
    """
    if not src.is_cuda:
        return segment_max_plain(src, plan, idx, negate, with_sum)
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
    shape = (plan.num_rows, f)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    pos = torch.empty(shape, dtype=torch.int32, device=dev)
    outs = (vals, pos)
    if with_sum:
        outs += (torch.empty(shape, dtype=torch.float32, device=dev), )
    if plan.num_rows == 0 or f == 0:
        return outs
    cut = k4_pieces(plan)
    npieces = cut.pieces.shape[0]
    parts = [torch.empty((npieces, f), dtype=torch.float32, device=dev),
             torch.empty((npieces, f), dtype=torch.int32, device=dev)]
    if with_sum:
        parts.append(torch.empty((npieces, f), dtype=torch.float32,
                                 device=dev))
    with torch.cuda.device(dev):
        err = _k4_lib(with_sum)(
            src.data_ptr(), None if idx is None else idx.data_ptr(),
            plan.tile_ptr.data_ptr(), int(negate),
            *(t.data_ptr() for t in outs), num_tiles, plan.num_rows, f,
            cut.pieces.data_ptr(), npieces, cut.rows.data_ptr(),
            cut.rows.shape[0], *(t.data_ptr() for t in parts),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K4{"s" if with_sum else ""} (segment_minmax.cu)'
                           f' launch failed: CUDA error {err}')
    if with_sum:
        segment_max_kernel.sum_launches += 1
    else:
        segment_max_kernel.launches += 1
    return outs


segment_max_kernel.launches = 0
segment_max_kernel.sum_launches = 0
