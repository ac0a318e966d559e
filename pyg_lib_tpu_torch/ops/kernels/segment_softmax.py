"""Per-row softmax over the chunked plan's padded layout, kernel K6
(``csrc/segment_softmax.cu``).

Port of ``pyg_lib_tpu/ops/pallas/segment_softmax_kernel.py``. Over a
:class:`SpmmPlan`'s padded layout, row ``r``'s messages are its padded
slots ``p``; the message at ``p`` is

* ``src[p]`` when ``index`` is ``None``: ``src`` is a padded slab
  ``[E_pad, F]`` and so is the result, with every pad slot 0, as the TPU
  kernel gives it (``segment_softmax_padded``, GAT's attention);
* ``src[index[p]]`` otherwise, written to ``out[index[p]]``: with
  ``index=plan.edge_perm`` (a plan of ``indptr`` covering every edge) the
  input and the result are in the original edge order, ``[E, F]``, so the
  permuted copy and the gather back never exist (the planned
  ``softmax_csr``).

Each row's values become ``exp(m - max) / Σ exp(m - max)`` per feature, in
the input's type (f32 or bf16) with f32 inside. A ``-inf`` message gives 0
beside a finite maximum and a row of ``-inf`` gives NaN, as the XLA
composite ``softmax_csr`` does; the TPU kernel can turn a whole chunk
column into NaN when a row's first slot is ``-inf`` (a difference inside
the reference, ROADMAP Queue 3).

:func:`segment_softmax_planned` is the wrapper: K6 for a CUDA tensor, the
plain PyTorch version (:func:`segment_softmax_plain`) for a CPU tensor.

K6 cuts the padded slots into equal stretches, a warp each
(:func:`k6_stretch`), over the table of the non-empty rows' bounds
(:func:`k6_rows`); each row's ``(max, sum)`` pair is built from groups of
32 slots merged in order, a row cut by stretch ends (:func:`k6_cut`)
through partial pairs that a second launch merges, and a third
launch writes the quotients. :func:`segment_softmax_split` runs that
schedule with PyTorch, so the tests can hold it against the JAX package.
"""

import ctypes
from typing import Optional

import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.segment_minmax import _row_bounds
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (DTYPE_CODE, PTR_SUB,
                                                        TP, SpmmPlan,
                                                        _cached, _check_cuda,
                                                        _padded_rows)

__all__ = ['k6_cut', 'k6_rows', 'k6_stretch', 'segment_softmax_planned',
           'segment_softmax_plain', 'segment_softmax_split']

# Warps (stretches of slots) per SM, and the fewest slots a stretch is
# given on a small input (a multiple of 32, a warp's group of slots).
K6_UNITS_PER_SM = 32
K6_MIN_STRETCH = 256


def segment_softmax_plain(src: torch.Tensor, plan: SpmmPlan,
                          index: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of K6: per-row ``amax``, ``exp``, per-row sum
    and the quotient, in f32, over the slots ``tile_ptr`` gives each row;
    slots of no row (and rows of ``src`` that ``index`` does not name) are
    0."""
    slot, row = _padded_rows(plan.tile_ptr)
    at = slot if index is None else index[slot].long()
    vals = src[at].float()
    rows = row[:, None].expand(-1, src.shape[1])
    gmax = torch.full((plan.num_rows, src.shape[1]), float('-inf'),
                      device=src.device)
    gmax.scatter_reduce_(0, rows, vals, 'amax')
    e = torch.exp(vals - gmax[row])
    gsum = torch.zeros_like(gmax).index_add_(0, row, e)
    out = torch.zeros_like(src)
    out[at] = (e / gsum[row]).to(src.dtype)
    return out


def k6_stretch(e_pad: int, sms: int) -> int:
    """Slots a K6 warp takes: ``e_pad`` over ``K6_UNITS_PER_SM`` warps an
    SM, rounded up to 32, at least ``K6_MIN_STRETCH``."""
    units = max(sms * K6_UNITS_PER_SM, 1)
    return max(-(-(-(-e_pad // units)) // 32) * 32, K6_MIN_STRETCH)


def _derive_rows(tile_ptr, num_rows):
    lo, n = _row_bounds(tile_ptr, num_rows)
    nz = n > 0
    lo = lo[nz]
    hi = lo + n[nz]
    if lo.shape[0] > 1 and not bool((lo[1:] >= hi[:-1]).all()):
        raise ValueError('tile_ptr rows are not in slot order')
    return torch.stack([lo, hi]).int().contiguous()


def k6_rows(plan: SpmmPlan) -> torch.Tensor:
    """``[2, L]`` int32: the first slots, then the end slots, of ``plan``'s
    non-empty rows, in slot order; derived with tensor ops on
    ``plan.tile_ptr``'s device on first use and cached per ``tile_ptr``
    (as K2's tables)."""
    return _cached(('k6_rows', plan.num_rows), (plan.tile_ptr, ),
                   lambda tp: _derive_rows(tp, plan.num_rows))


def _derive_cut(rows, stretch):
    lo, hi = rows.long()
    wa, wb = lo // stretch, (hi - 1) // stretch
    sel = torch.nonzero(wa != wb).reshape(-1)
    return torch.stack([sel, wa[sel], wb[sel]], 1).int().contiguous()


def k6_cut(plan: SpmmPlan, stretch: int) -> torch.Tensor:
    """``[S, 3]`` int32: each non-empty row (its index in :func:`k6_rows`)
    that crosses an end of the stretches of ``stretch`` slots, with its
    first and last stretch; cached as :func:`k6_rows`."""
    return _cached(('k6_cut', plan.num_rows, stretch), (plan.tile_ptr, ),
                   lambda tp: _derive_cut(k6_rows(plan), stretch))


def _merge(m, s, m2, s2):
    """K6's merge of two (max, sum) pairs, the second into the first."""
    mn = torch.maximum(m, m2)
    s = (torch.where(m == mn, s, s * torch.exp(m - mn)) +
         torch.where(m2 == mn, s2, s2 * torch.exp(m2 - mn)))
    return mn, s


def segment_softmax_split(src: torch.Tensor, plan: SpmmPlan,
                          index: Optional[torch.Tensor] = None,
                          stretch: int = K6_MIN_STRETCH) -> torch.Tensor:
    """K6's schedule run with PyTorch: each group of 32 slots gives each of
    its rows its max and its sum of ``exp(m - max)`` (1 where ``m`` is the
    max); a row's groups within a stretch are merged in order; a row that
    lies in one stretch has its pair, a row cut by stretch ends leaves
    partials (slot ``2w`` where it began in an earlier stretch, ``2w + 1``
    where it goes on past stretch ``w``), merged as the fixup's warp
    merges them (32 lanes in slot order, then a butterfly);
    then every slot gets ``exp(m - max) / sum``. Raises if a row's pair
    would be written other than once."""
    if stretch <= 0 or stretch % 32:
        raise ValueError(f'stretch must be a positive multiple of 32, got '
                         f'{stretch}')
    f = src.shape[1]
    rows = _derive_rows(plan.tile_ptr, plan.num_rows).long()
    nrows = rows.shape[1]
    slot, row = _padded_rows(plan.tile_ptr)
    at = slot if index is None else index[slot].long()
    vals = src[at].float()
    # Each slot's non-empty row: its place among the rows in slot order.
    q = torch.searchsorted(rows[0], slot, right=True) - 1
    w, g = slot // stretch, slot // 32
    # Pieces: (group, row) in slot order, then (stretch, row).
    piece, inv = torch.unique(g * nrows + q, return_inverse=True)
    p_row = piece % nrows
    p_w = (piece // nrows) * 32 // stretch
    pm = torch.full((piece.shape[0], f), float('-inf')).scatter_reduce_(
        0, inv[:, None].expand(-1, f), vals, 'amax')
    e = torch.where(vals == pm[inv], torch.ones_like(vals),
                    torch.exp(vals - pm[inv]))
    ps = torch.zeros_like(pm).index_add_(0, inv, e)
    run, rinv = torch.unique(p_w * nrows + p_row, return_inverse=True)
    rank = torch.arange(piece.shape[0]) - torch.searchsorted(rinv, rinv)
    am = torch.full((run.shape[0], f), float('-inf'))
    asum = torch.zeros_like(am)
    for t in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == t
        if t == 0:
            am[rinv[sel]], asum[rinv[sel]] = pm[sel], ps[sel]
        else:
            am[rinv[sel]], asum[rinv[sel]] = _merge(am[rinv[sel]],
                                                    asum[rinv[sel]], pm[sel],
                                                    ps[sel])
    r_row, r_w = run % nrows, run // nrows
    lo, hi = rows[0][r_row], rows[1][r_row]
    whole = (lo // stretch == r_w) & ((hi - 1) // stretch == r_w)
    pair_m = torch.full((nrows, f), float('-inf'))
    pair_s = torch.zeros((nrows, f))
    written = torch.zeros(nrows, dtype=torch.int64)
    pair_m[r_row[whole]], pair_s[r_row[whole]] = am[whole], asum[whole]
    written.index_add_(0, r_row[whole], torch.ones_like(r_row[whole]))
    units = -(-plan.col_padded.shape[0] // stretch)
    slot_of = torch.where(hi > (r_w + 1) * stretch, 2 * r_w + 1, 2 * r_w)
    part_m = torch.full((2 * units, f), float('-inf'))
    part_s = torch.zeros((2 * units, f))
    part_m[slot_of[~whole]], part_s[slot_of[~whole]] = am[~whole], asum[~whole]
    for qr, wa, wb in _derive_cut(rows, stretch).tolist():
        # The fixup's warp: lane l merges partials l, l + 32, ... in order,
        # then the lanes merge by a butterfly.
        slots = [2 * w_ + 1 for w_ in range(wa, wb)] + [2 * wb]
        m = torch.full((32, f), float('-inf'))
        s = torch.zeros((32, f))
        for i, k in enumerate(slots):
            m[i % 32], s[i % 32] = _merge(m[i % 32], s[i % 32], part_m[k],
                                          part_s[k])
        for off in (16, 8, 4, 2, 1):
            other = torch.arange(32) ^ off
            m, s = _merge(m, s, m[other], s[other])
        pair_m[qr], pair_s[qr] = m[0], s[0]
        written[qr] += 1
    if not bool((written == 1).all()):
        raise AssertionError('K6 schedule writes a row other than once')
    out = torch.zeros_like(src)
    out[at] = (torch.exp(vals - pair_m[q]) / pair_s[q]).to(src.dtype)
    return out


def _k6_lib():
    lib = _build.load('segment_softmax')
    fn = lib.pygt_segment_softmax
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # src, dtype, idx, rows, num_rows, cut, num_cut, e_pad, F, stretch,
        # pair, part, out, stream
        fn.argtypes = [vp, i, vp, vp, i, vp, i, i, i, i, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def segment_softmax_planned(src: torch.Tensor, plan: SpmmPlan,
                            index: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """K6: the per-row softmax of ``src[p]`` (``index=None``; ``src`` and
    the result are ``[E_pad, F]``, pad slots 0) or of ``src[index[p]]``
    written to ``out[index[p]]`` over each row's padded slots ``p``.

    ``src`` is f32 or bf16 and the result has its type. A CUDA ``src``
    launches the kernel (and raises on anything it does not take); a CPU
    ``src`` runs :func:`segment_softmax_plain`.
    ``segment_softmax_planned.launches`` counts wrapper calls that launch
    K6 (three kernel launches each, two when no row crosses a stretch end).
    """
    if not src.is_cuda:
        return segment_softmax_plain(src, plan, index)
    dev = src.device
    if src.dim() != 2 or src.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'src must be a 2-D f32/bf16 tensor, got '
                         f'{src.dtype} of shape {tuple(src.shape)}')
    num_tiles = plan.tile_ptr.shape[0]
    e_pad = plan.col_padded.shape[0]
    _check_cuda('src', src, src.dtype, device=dev)
    _check_cuda('tile_ptr', plan.tile_ptr, torch.int32,
                (num_tiles, PTR_SUB, TP), dev)
    if index is not None:
        _check_cuda('index', index, torch.int32, (e_pad, ), dev)
    elif src.shape[0] != e_pad:
        raise ValueError(f'a padded src needs E_pad = {e_pad} rows, got '
                         f'{src.shape[0]}')
    if src.shape[0] >= 2**31 or e_pad >= 2**31:
        raise ValueError('K6 indexes rows and slots with int32')
    # K6 writes every slot of the padded result, and in the index mode only
    # the rows ``index`` names: all of them when ``index`` is the edge_perm
    # of a plan over every row of ``src``, otherwise the rest stay 0.
    covered = index is None or (plan.edge_pos is not None
                                and plan.edge_pos.shape[0] == src.shape[0])
    out = torch.empty_like(src) if covered else torch.zeros_like(src)
    if src.numel() == 0 or e_pad == 0:
        return out
    f = src.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stretch = k6_stretch(e_pad, sms)
    rows = k6_rows(plan)
    cut = k6_cut(plan, stretch)
    units = -(-e_pad // stretch)
    pair = torch.empty((max(rows.shape[1], 1), f, 2), dtype=torch.float32,
                       device=dev)
    part = torch.empty((2 * units, f, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _k6_lib()(src.data_ptr(), DTYPE_CODE[src.dtype],
                        None if index is None else index.data_ptr(),
                        rows.data_ptr(), rows.shape[1], cut.data_ptr(),
                        cut.shape[0], e_pad, f, stretch, pair.data_ptr(),
                        part.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K6 (segment_softmax.cu) launch failed: CUDA '
                           f'error {err}')
    segment_softmax_planned.launches += 1
    return out


segment_softmax_planned.launches = 0
