"""Fused multi-range SpMM, kernel K7 (``csrc/spmm_range_fused.cu``).

Port of ``pyg_lib_tpu/ops/pallas/spmm_range_fused.py``. A
:class:`FusedRangePlan` splits the source-node space into S column ranges
``[lo_s, hi_s)`` and holds one chunked layout per range over the edges
whose column falls in it (columns rebased to the range); a range with no
edges in a tile gets no chunks there. The result is

    out[r] = Σ_s Σ_{p in row r of range s} w_s[p] · x[lo_s + col_s[p]]

written once per row (``w_s`` only on a weighted plan).

The plan's fields are bit for bit the JAX package's, the TPU schedule
(``step_tile``, ``blocks``, ``posb``) included, which the kernel on the
card does not read. Beside them the port keeps the per-range column ids
and weights concatenated (``cat_cols``, with ``lo_s`` added, and
``cat_weights``) and each range's first slot in the concatenation
(``slot_base``): K7 takes the S ranges as one array each, not as S
pointers.

K7 walks each row with one warp; a row's run of more than ``K7_LONG``
slots in one range is left out of that walk and cut into pieces of at
most ``K7_LONG`` slots (:func:`k7_pieces`), a warp each, whose sums a
last launch adds up in order, scales and adds to the rest of the row
(K1's design for its long rows too, ``csrc/row_walk.cuh``).

:func:`fused_range_sum` is the kernel's wrapper: K7 for a CUDA tensor, the
plain PyTorch version (:func:`fused_range_plain`, which follows the JAX
package's path off the TPU: per-range partial sums added in f32) for a CPU
tensor. :func:`fused_range_apply` adds the precision modes.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (
    DTYPE_CODE, PTR_SUB, TP, TR, RowPieces, _build_padded_layout, _cached,
    _check_cuda, _derive_pieces, _padded_rows, auto_chunk, build_spmm_plan,
    quantize_columns)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['FusedRangePlan', 'build_fused_range_plan',
           'fused_range_apply', 'fused_range_plain', 'fused_range_sum',
           'k7_pieces']

# Position base of the TPU schedule's inactive (range, step) pairs.
_INACTIVE = -(1 << 30)
# The run length (a row's slots in one range) above which K7 cuts the run
# into pieces of at most K7_LONG slots, a warp each; the kernel takes it as
# an argument.
K7_LONG = 512


class FusedRangePlan(NamedTuple):
    """Tile-major fused schedule over S column ranges (host-built)."""
    plans: tuple  # per-range SpmmPlan, columns rebased to the range
    bounds: tuple  # ((lo, hi), ...) source-node ranges
    step_tile: torch.Tensor  # [NS] int32 — TPU schedule: tile of each step
    blocks: torch.Tensor  # [S, NS] int32 — TPU schedule: chunk per step
    posb: torch.Tensor  # [S, NS] int32 — block*chunk, or _INACTIVE
    tile_ptrs: torch.Tensor  # [T, S8, TP] int32 — per-range padded rowptr
    #                          rows (S padded up to a multiple of 8)
    num_rows: int
    num_edges: int
    chunk: int
    weights: Optional[tuple] = None  # per-range [E_pad_s] f32, or None
    # The port's concatenation of the per-range arrays, which K7 reads.
    cat_cols: Optional[torch.Tensor] = None  # [Σ E_pad_s] int32, lo_s added
    cat_weights: Optional[torch.Tensor] = None  # [Σ E_pad_s] f32 or None
    slot_base: Optional[torch.Tensor] = None  # [S] int32 first slot of s


def _equal_ranges(num_cols: int, range_split: int) -> list:
    """``range_split`` equal ``(lo, hi)`` source-node ranges over
    ``num_cols`` (fewer when the last ones would be empty)."""
    num_cols = int(num_cols)
    ns = -(-num_cols // range_split)
    return [(r * ns, min((r + 1) * ns, num_cols)) for r in range(range_split)
            if r * ns < num_cols]


def _column_range_csrs(rowptr, col, bounds, edge_weight=None) -> list:
    """Per column range ``(lo, hi)``: ``(rowptr_s, col_s - lo, w_s)``, the
    CSR of the edges whose column falls in it (``w_s``: their weights, or
    ``None``)."""
    num_rows = rowptr.shape[0] - 1
    row_of_edge = np.repeat(np.arange(num_rows, dtype=np.int64),
                            np.diff(rowptr).astype(np.int64))
    csrs = []
    for lo, hi in bounds:
        mask = (col >= lo) & (col < hi)
        rp = np.zeros(num_rows + 1, np.int64)
        np.cumsum(np.bincount(row_of_edge[mask], minlength=num_rows),
                  out=rp[1:])
        csrs.append((rp, (col[mask] - lo).astype(np.int64),
                     None if edge_weight is None else edge_weight[mask]))
    return csrs


def build_fused_range_plan(rowptr, col, num_cols: int, range_split: int,
                           chunk=512, bounds=None, edge_weight=None,
                           device=None) -> FusedRangePlan:
    """Host-side: per-range chunked layouts and the step tables, with the
    tensors on ``device`` (default: the CUDA card).

    ``chunk='auto'`` sizes the chunk on the per-range CSRs. ``bounds``
    gives explicit sorted, disjoint ``(lo, hi)`` column ranges that cover
    every edge instead of ``range_split`` equal ones; edgeless ranges are
    dropped. ``edge_weight`` (one per edge, CSR order) bakes
    ``out[r] = Σ w_e · x[col_e]`` into the plan.
    """
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_rows = rowptr.shape[0] - 1
    if edge_weight is not None:
        edge_weight = np.asarray(edge_weight, dtype=np.float32)
        if edge_weight.shape[0] != col.shape[0]:
            raise ValueError('edge_weight must have one entry per edge')
    if bounds is None:
        bounds = _equal_ranges(num_cols, range_split)
    else:
        bounds = [(int(lo), int(hi)) for lo, hi in bounds]
        for (_, ahi), (blo, _) in zip(bounds, bounds[1:]):
            if ahi > blo:
                raise ValueError('bounds must be sorted and disjoint')
        if len(col) and (col.min() < bounds[0][0]
                         or col.max() >= bounds[-1][1]):
            raise ValueError('bounds must cover every column id')
    csrs, kept = [], []
    # An edgeless range has no layout.
    for b, csr in zip(bounds, _column_range_csrs(rowptr, col, bounds,
                                                edge_weight)):
        if len(csr[1]):
            csrs.append(csr)
            kept.append(b)
    covered = sum(len(c) for _, c, _ in csrs)
    if covered != int(col.shape[0]):
        raise ValueError(
            f'bounds leave {int(col.shape[0]) - covered} edges uncovered '
            '(column ids falling in gaps between ranges)')
    bounds = kept
    if chunk == 'auto':
        chunk = (max(auto_chunk(rp) for rp, _, _ in csrs)
                 if csrs else auto_chunk(rowptr))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    plans, weights, chunk_tiles, ptr_rows, cols = [], [], [], [], []
    for (lo, _), (rp_r, col_r, w_r) in zip(bounds, csrs):
        layout = _build_padded_layout(rp_r, chunk, allow_empty_tiles=True)
        orig, valid, chunk_tile, tile_ptr, _ = layout
        plans.append(build_spmm_plan(rp_r, col_r, chunk=chunk,
                                     allow_empty_tiles=True, _layout=layout,
                                     device=device))
        chunk_tiles.append(chunk_tile)
        ptr_rows.append(tile_ptr[:, 0, :])
        cols.append(np.where(valid, col_r[np.minimum(orig, len(col_r) - 1)]
                             + lo, 0).astype(np.int32))
        if w_r is not None:
            weights.append(np.where(
                valid, w_r[np.minimum(orig, max(len(w_r) - 1, 0))],
                0.0).astype(np.float32))
    if not plans:
        # An edgeless graph: one ordinary plan covers every row.
        orig, valid, chunk_tile, tile_ptr, _ = _build_padded_layout(
            rowptr, chunk)
        plans.append(build_spmm_plan(rowptr, col, chunk=chunk,
                                     device=device))
        chunk_tiles.append(chunk_tile)
        ptr_rows.append(tile_ptr[:, 0, :])
        cols.append(np.zeros(orig.shape[0], np.int32))
        bounds.append((0, int(num_cols)))
        if edge_weight is not None:
            weights.append(np.zeros(orig.shape[0], np.float32))
    s_eff = len(plans)

    # Per (tile, range) chunk counts (chunk_tile is non-decreasing).
    num_tiles = ptr_rows[0].shape[0]
    per_tile = np.zeros((s_eff, num_tiles), np.int64)
    offs = np.zeros((s_eff, num_tiles), np.int64)
    for r, ct in enumerate(chunk_tiles):
        per_tile[r] = np.bincount(ct, minlength=num_tiles)
        offs[r, 1:] = np.cumsum(per_tile[r])[:-1]
    # The TPU schedule: every tile gets at least one step.
    k_t = np.maximum(per_tile.max(axis=0), 1)
    n_steps = int(k_t.sum())
    step_tile = np.repeat(np.arange(num_tiles, dtype=np.int32), k_t)
    k_in_tile = (np.arange(n_steps, dtype=np.int64) -
                 np.repeat(np.cumsum(k_t) - k_t, k_t))
    t_of_step = step_tile.astype(np.int64)
    blocks = np.empty((s_eff, n_steps), np.int32)
    posb = np.empty((s_eff, n_steps), np.int32)
    for r in range(s_eff):
        active = k_in_tile < per_tile[r, t_of_step]
        blk = np.maximum(
            offs[r, t_of_step] + np.minimum(k_in_tile,
                                            per_tile[r, t_of_step] - 1), 0)
        blocks[r] = blk.astype(np.int32)
        posb[r] = np.where(active, blk * chunk, _INACTIVE).astype(np.int32)

    s8 = -(-s_eff // PTR_SUB) * PTR_SUB
    tile_ptrs = np.zeros((num_tiles, s8, TP), np.int32)
    for r, rows in enumerate(ptr_rows):
        tile_ptrs[:, r, :] = rows
    sizes = [c.shape[0] for c in cols]
    slot_base = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    if sum(sizes) >= 2**31:
        raise ValueError('a fused range plan indexes its slots with int32')
    return FusedRangePlan(
        plans=tuple(plans),
        bounds=tuple(bounds),
        step_tile=dev(step_tile),
        blocks=dev(blocks),
        posb=dev(posb),
        tile_ptrs=dev(tile_ptrs),
        num_rows=int(num_rows),
        num_edges=int(col.shape[0]),
        chunk=int(chunk),
        weights=tuple(dev(w) for w in weights) if weights else None,
        cat_cols=dev(np.concatenate(cols)),
        cat_weights=dev(np.concatenate(weights)) if weights else None,
        slot_base=dev(slot_base.astype(np.int32)),
    )


def fused_range_plain(xm: torch.Tensor, plan: FusedRangePlan,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K7, the JAX package's path off the TPU:
    each range's partial sum over its own layout (``x[lo_s + col_s[p]]``,
    times ``w_s[p]`` on a weighted plan) by ``index_add_``, the partials
    added in f32, then the column ``scale`` if given."""
    out = None
    for r, ((lo, _), p) in enumerate(zip(plan.bounds, plan.plans)):
        slot, row = _padded_rows(p.tile_ptr)
        msgs = xm[p.col_padded[slot].long() + lo].float()
        if plan.weights is not None:
            msgs = msgs * plan.weights[r][slot][:, None]
        o = torch.zeros((plan.num_rows, xm.shape[1]), dtype=torch.float32,
                        device=xm.device).index_add_(0, row, msgs)
        out = o if out is None else out + o
    return out if scale is None else out * scale[None, :]


def k7_pieces(plan: FusedRangePlan) -> RowPieces:
    """The piece table K7 reads for ``plan``'s runs of more than
    ``K7_LONG`` slots (a row's slots in one range): each such run cut
    into pieces of at most ``K7_LONG``, a row's pieces in range and slot
    order, and the rows that have such a run. Derived with tensor ops on
    the plan's device on first use and cached per ``tile_ptrs`` and
    ``slot_base`` (as K4's pieces)."""
    return _cached(('k7_pieces', plan.num_rows, K7_LONG),
                   (plan.tile_ptrs, plan.slot_base),
                   lambda tp, sb: _derive_pieces(tp, sb, plan.num_rows,
                                                 K7_LONG))


def _k7_lib():
    lib = _build.load('spmm_range_fused')
    fn = lib.pygt_spmm_range_fused
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, vp, i, i, vp, vp, i, i, i, i, vp,
                       i, vp, i, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def fused_range_sum(xm: torch.Tensor, plan: FusedRangePlan,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7: ``out[r] = scale * Σ_s Σ_{p in row r of range s} w_s[p] ·
    xm[lo_s + col_s[p]]`` as ``[num_rows, F]`` f32.

    ``xm`` is f32, bf16 or int8 (int8 only on an unweighted plan). A CUDA
    ``xm`` launches the kernel (and raises on anything it does not take);
    a CPU ``xm`` runs :func:`fused_range_plain`.
    ``fused_range_sum.launches`` counts kernel launches.
    """
    if xm.dtype == torch.int8 and plan.weights is not None:
        raise ValueError('K7 takes int8 rows only on an unweighted plan')
    if not xm.is_cuda:
        return fused_range_plain(xm, plan, scale)
    dev = xm.device
    if xm.dim() != 2 or xm.dtype not in DTYPE_CODE:
        raise ValueError(f'x must be a 2-D f32/bf16/int8 tensor, got '
                         f'{xm.dtype} of shape {tuple(xm.shape)}')
    num_tiles, s8 = plan.tile_ptrs.shape[:2]
    s_eff = len(plan.plans)
    f = xm.shape[1]
    _check_cuda('x', xm, xm.dtype, device=dev)
    _check_cuda('tile_ptrs', plan.tile_ptrs, torch.int32,
                (num_tiles, s8, TP), dev)
    _check_cuda('cat_cols', plan.cat_cols, torch.int32, device=dev)
    _check_cuda('slot_base', plan.slot_base, torch.int32, (s_eff, ), dev)
    if plan.cat_weights is not None:
        _check_cuda('cat_weights', plan.cat_weights, torch.float32,
                    plan.cat_cols.shape, dev)
    if scale is not None:
        _check_cuda('scale', scale, torch.float32, (f, ), dev)
    if xm.shape[0] < plan.bounds[-1][1] or xm.shape[0] >= 2**31:
        raise ValueError(f'x must have at least {plan.bounds[-1][1]} rows '
                         f'(and fewer than 2**31), got {xm.shape[0]}')
    out = torch.empty((plan.num_rows, f), dtype=torch.float32, device=dev)
    if plan.num_rows == 0 or f == 0:
        return out
    cut = k7_pieces(plan)
    npieces = cut.pieces.shape[0]
    part = torch.empty((npieces, f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _k7_lib()(
            xm.data_ptr(), DTYPE_CODE[xm.dtype], plan.cat_cols.data_ptr(),
            None if plan.cat_weights is None else plan.cat_weights.data_ptr(),
            plan.tile_ptrs.data_ptr(), plan.slot_base.data_ptr(), s_eff, s8,
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            num_tiles, plan.num_rows, f, K7_LONG, cut.pieces.data_ptr(),
            npieces, cut.rows.data_ptr(), cut.rows.shape[0], part.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K7 (spmm_range_fused.cu) launch failed: CUDA '
                           f'error {err}')
    fused_range_sum.launches += 1
    return out


fused_range_sum.launches = 0


def fused_range_apply(x: torch.Tensor, plan: FusedRangePlan,
                      precision: Optional[str] = None) -> torch.Tensor:
    """``out[r] = Σ_{e in row r} x[col[e]]`` (times ``w_e`` on a weighted
    plan) over the fused range plan, in ``x``'s dtype.

    Precision modes as ``spmm_plan_apply``: ``'bf16'`` reads the rows in
    bfloat16 (on a weighted plan each row times its weight is added in
    f32, where the TPU kernel rounds that product to bf16 and the JAX
    package's path off the TPU reads f32 rows); ``'int8'`` quantises ``x``
    per feature column and scales the f32 sums once at the end, and is
    refused on weighted plans, as in the JAX package.
    """
    scale = None
    if precision == 'int8':
        if plan.weights is not None:
            raise ValueError("precision='int8' is not supported on "
                             'weighted fused-range plans (the per-edge '
                             'multiply would upcast the int8 slab)')
        xm, scale = quantize_columns(x)
    elif precision == 'bf16' and x.dtype != torch.bfloat16:
        xm = x.to(torch.bfloat16)
    else:
        xm = x
    return fused_range_sum(xm.contiguous(), plan, scale).to(x.dtype)
