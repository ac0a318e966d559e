"""Chunked SpMM plan and kernel K1 (``csrc/spmm_chunked.cu``).

Port of ``pyg_lib_tpu/ops/pallas/spmm_chunked.py``. The host-side plan
(``build_spmm_plan``) pads each 128-row output tile's edge span to a
multiple of ``chunk``; the plan arrays are bit-for-bit those of the JAX
package. On the card, K1 computes ``out[r] = Σ x[col_padded[p]]`` over
row ``r``'s padded slots with the gather fused into the reduction, so the
padded message slab the TPU path materialises never exists here.

K1 walks each row with one warp. A row of more than ``K1_LONG`` slots (a
hub row: the transpose of a power-law graph has rows of millions) is left
out of that walk and cut into pieces of at most ``K1_LONG`` slots
(:func:`k1_pieces`), a warp each, whose sums a last launch adds up in
order; K7 cuts its long runs the same way.

K1 has two wrappers, each K1 for a CUDA tensor and a plain PyTorch
version for a CPU tensor: :func:`spmm_chunked` gathers through
``col_padded`` (plain: :func:`spmm_chunked_plain`), and
:func:`segment_sum_chunked` reduces messages already in padded
coordinates, ``msgs_padded[p]`` (plain: :func:`segment_sum_chunked_plain`).
"""

import ctypes
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = [
    'RowPieces', 'SpmmPlan', 'build_spmm_plan', 'k1_pieces',
    'spmm_plan_apply', 'spmm_chunked', 'spmm_chunked_plain',
    'segment_sum_chunked', 'segment_sum_chunked_plain', 'auto_chunk',
    'quantize_columns',
]

TR = 128  # output rows per tile
TP = 256  # lanes of one tile-pointer row (TR+1 rounded up)
PTR_SUB = 8  # sublane copies of each tile-pointer row (kept for parity)

# Element type codes of the C entry points (csrc/common.cuh).
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# The row length above which K1 cuts a row into pieces of at most K1_LONG
# slots, a warp each (K7's K7_LONG); the kernel takes it as an argument.
K1_LONG = 512


class SpmmPlan(NamedTuple):
    """Static gather/reduce schedule for one CSR graph (host-built)."""
    col_padded: torch.Tensor  # [E_pad] int32 — col ids, pad slots -> 0
    chunk_tile: torch.Tensor  # [C] int32 — output tile of each chunk
    tile_ptr: torch.Tensor  # [T, PTR_SUB, TP] int32 — padded-coord rowptr
    tile_shift: torch.Tensor  # [T] int32 — padded_start - orig_start
    num_rows: int
    num_edges: int
    chunk: int
    # Optional (with_edge_maps=True): move per-edge values between the
    # original and the padded coordinates.
    edge_perm: Optional[torch.Tensor] = None  # [E_pad] int32 orig edge
    #                                           per slot (pads -> 0)
    edge_pos: Optional[torch.Tensor] = None  # [E] int32 slot per orig edge
    row_padded: Optional[torch.Tensor] = None  # [E_pad] int32 dst row per
    #                                            slot (pads -> 0)
    valid_mask: Optional[torch.Tensor] = None  # [E_pad] bool, real slots

    @property
    def num_chunks(self) -> int:
        return self.chunk_tile.shape[0]


def _build_padded_layout(rowptr: np.ndarray, chunk: int,
                         allow_empty_tiles: bool = False):
    """Pad each TR-row tile's edge span to a multiple of ``chunk``.

    Returns (orig, valid, chunk_tile, tile_ptr, shift); ``shift[t]`` maps
    padded position -> original edge id (orig = padded_pos - shift).
    Every tile gets at least one chunk, unless ``allow_empty_tiles``: then
    an edgeless tile gets none, and its rows empty slot ranges. Such a
    layout is for the fused multi-range plans (K7), where every output row
    is written whatever its ranges hold.
    """
    num_rows = rowptr.shape[0] - 1
    num_tiles = max(-(-num_rows // TR), 1)
    tb = np.minimum(np.arange(num_tiles + 1) * TR, num_rows)
    tile_lo = rowptr[tb[:-1]]
    tile_hi = rowptr[tb[1:]]
    counts = tile_hi - tile_lo
    nchunks = -(-counts // chunk)
    if not allow_empty_tiles:
        nchunks = np.maximum(nchunks, 1)
    padded_counts = nchunks * chunk
    padded_starts = np.zeros(num_tiles + 1, np.int64)
    np.cumsum(padded_counts, out=padded_starts[1:])
    e_pad = int(padded_starts[-1])

    tile_of_slot = np.repeat(np.arange(num_tiles), padded_counts)
    slot_in_tile = np.arange(e_pad) - padded_starts[tile_of_slot]
    orig = tile_lo[tile_of_slot] + slot_in_tile
    valid = slot_in_tile < counts[tile_of_slot]

    chunk_tile = np.repeat(np.arange(num_tiles), nchunks).astype(np.int32)
    # tile_ptr[t, l] = rowptr[min(tb[t]+l, tb[t+1])] + shift[t]: rows past
    # the tile (and past num_rows in the last tile) get empty ranges.
    shift = padded_starts[:-1] - tile_lo
    lanes = np.minimum(np.arange(TP), TR)
    row_idx = np.minimum(tb[:-1, None] + lanes[None, :], tb[1:, None])
    tile_ptr = (rowptr[row_idx] + shift[:, None]).astype(np.int32)
    tile_ptr = np.broadcast_to(tile_ptr[:, None, :],
                               (num_tiles, PTR_SUB, TP)).copy()
    return orig, valid, chunk_tile, tile_ptr, shift


def quantize_columns(x: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
    """Symmetric per-feature-column int8 quantisation.

    Returns ``(xq int8, scale f32[F])`` with ``x ≈ xq * scale[None, :]``
    and ``scale[f] = maxabs(x[:, f]) / 127`` (1.0 for all-zero columns).
    Rounding is to nearest, ties to even, as ``jnp.round``. A
    ``generator`` switches to stochastic rounding, ``floor(y + U[0,1))``,
    with the uniform draws taken from it.
    """
    xf = x.float()
    scale = xf.abs().amax(dim=0) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = xf / scale[None, :]
    if generator is None:
        r = torch.round(y)
    else:
        r = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       device=y.device))
    return r.clamp(-127, 127).to(torch.int8), scale


def auto_chunk(rowptr, candidates=(512, 256, 128),
               waste_budget: float = 0.15) -> int:
    """Pick the chunk size for a degree distribution: the largest
    candidate whose padded-slot count stays within ``waste_budget`` of the
    least-padding candidate's."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    num_rows = rowptr.shape[0] - 1
    num_tiles = max(-(-num_rows // TR), 1)
    tb = np.minimum(np.arange(num_tiles + 1) * TR, num_rows)
    counts = rowptr[tb[1:]] - rowptr[tb[:-1]]

    def padded(c):
        return int((np.maximum(-(-counts // c), 1) * c).sum())

    floor = min(padded(c) for c in candidates)
    for c in sorted(candidates, reverse=True):
        if padded(c) <= (1.0 + waste_budget) * floor:
            return c
    return min(candidates)


def build_spmm_plan(rowptr, col, chunk=512, with_edge_maps: bool = False,
                    pad_to_chunks: Optional[int] = None,
                    allow_empty_tiles: bool = False, _layout=None,
                    device=None) -> SpmmPlan:
    """Build the chunked schedule for ``out[r] = Σ x[col[e]]`` over CSR
    rows, with its tensors on ``device`` (default: the CUDA card).

    ``chunk='auto'`` sizes the chunk with :func:`auto_chunk`.
    ``with_edge_maps`` also stores the maps between original and padded
    edge coordinates (``edge_perm``, ``edge_pos``, ``row_padded``,
    ``valid_mask``), which the planned ``segment_{max,min}_csr``, the
    planned softmax and the padded-space primitives read.
    ``pad_to_chunks`` appends all-pad chunks (in no row's slot range) up
    to that chunk count, so the per-range plans of a ``RangeSpmmPlan``
    share one shape. ``allow_empty_tiles`` and ``_layout`` (a
    :func:`_build_padded_layout` result for the same ``rowptr``, ``chunk``
    and ``allow_empty_tiles``) serve the fused multi-range builder.
    """
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col)
    if chunk == 'auto':
        chunk = auto_chunk(rowptr)
    orig, valid, chunk_tile, tile_ptr, shift = (
        _layout if _layout is not None else _build_padded_layout(
            rowptr, chunk, allow_empty_tiles))
    if len(col):
        col_padded = np.where(valid, col[np.minimum(orig, len(col) - 1)],
                              0).astype(np.int32)
    else:
        col_padded = np.zeros(orig.shape[0], np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    extra = 0
    if pad_to_chunks is not None:
        extra = max(int(pad_to_chunks) - chunk_tile.shape[0], 0)
    if extra:
        last_tile = chunk_tile[-1] if len(chunk_tile) else 0
        chunk_tile = np.concatenate(
            [chunk_tile, np.full(extra, last_tile, np.int32)])
        col_padded = np.concatenate(
            [col_padded, np.zeros(extra * chunk, np.int32)])
    maps = {}
    if with_edge_maps:
        num_rows = rowptr.shape[0] - 1
        pos = np.zeros(int(col.shape[0]), np.int32)
        pos[orig[valid]] = np.nonzero(valid)[0].astype(np.int32)
        row_of_edge = np.repeat(np.arange(num_rows, dtype=np.int32),
                                np.diff(rowptr).astype(np.int64))
        if len(row_of_edge):
            rp = np.where(valid, row_of_edge[np.minimum(
                orig, len(row_of_edge) - 1)], 0).astype(np.int32)
        else:
            rp = np.zeros(orig.shape[0], np.int32)
        perm = np.where(valid, orig, 0).astype(np.int32)
        pad = np.zeros(extra * chunk, np.int32)
        maps = dict(edge_perm=dev(np.concatenate([perm, pad])),
                    edge_pos=dev(pos), row_padded=dev(np.concatenate([rp,
                                                                      pad])),
                    valid_mask=dev(np.concatenate([valid,
                                                   pad.astype(bool)])))
    return SpmmPlan(
        col_padded=dev(col_padded),
        chunk_tile=dev(chunk_tile),
        tile_ptr=dev(tile_ptr),
        tile_shift=dev(shift.astype(np.int32)),
        num_rows=int(rowptr.shape[0] - 1),
        num_edges=int(col.shape[0]),
        chunk=int(chunk),
        **maps,
    )


# (what, id of each source tensor) -> (weak references to the sources,
# their _version counters, the derived tables); an entry goes when one of
# its sources is freed.
_derived = {}


def _cached(what, sources, make):
    """``make(*sources)``, cached per source tensor object (a weak
    reference, not its address, which a freed buffer hands on) and its
    in-place version: a plan given another tensor by ``_replace``, or one
    changed in place, gets fresh tables. An inference tensor has no
    version counter and is keyed on its object alone: a change made to it
    in place under ``torch.inference_mode`` is not seen."""
    key = (what, ) + tuple(id(t) for t in sources)
    version = tuple(None if t.is_inference() else t._version
                    for t in sources)
    hit = _derived.get(key)
    if (hit is not None and all(r() is t for r, t in zip(hit[0], sources))
            and hit[1] == version):
        return hit[2]

    def drop(ref, key=key):
        entry = _derived.get(key)
        if entry is not None and any(r is ref for r in entry[0]):
            del _derived[key]

    value = make(*sources)
    _derived[key] = (tuple(weakref.ref(t, drop) for t in sources), version,
                     value)
    return value


def _padded_rows(tile_ptr: torch.Tensor):
    """``(slot, row)`` of every real padded slot, read off ``tile_ptr``."""
    bounds = tile_ptr[:, 0, :TR + 1].long()  # [T, TR+1]
    lo = bounds[:, :-1].reshape(-1)
    counts = (bounds[:, 1:] - bounds[:, :-1]).reshape(-1)
    rows = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts)
    starts = torch.cumsum(counts, 0) - counts
    k = torch.arange(rows.shape[0], device=counts.device)
    return lo[rows] + k - starts[rows], rows


class RowPieces(NamedTuple):
    """Slot runs longer than a cut length, cut into pieces (K1, K7)."""
    pieces: torch.Tensor  # [P, 3] int32: row, first slot, end slot
    rows: torch.Tensor  # [L, 3] int32: row, first piece, piece count


def _derive_pieces(tile_ptrs, slot_base, num_rows, long_len) -> RowPieces:
    """The runs of more than ``long_len`` slots of the S ranges whose
    tile-pointer rows are ``tile_ptrs[:, :S]`` and whose first slots are
    ``slot_base`` (``[S]``), cut into pieces of at most ``long_len``: a
    row's pieces in range and slot order."""
    s_eff = slot_base.shape[0]
    bounds = tile_ptrs[:, :s_eff, :TR + 1].long()  # [T, S, TR + 1]
    # Per row and range: the run's first slot in the concatenation, its
    # length.
    lo = (bounds[:, :, :-1] + slot_base.long()[None, :, None]).transpose(
        1, 2).reshape(-1, s_eff)[:num_rows]
    n = (bounds[:, :, 1:] - bounds[:, :, :-1]).transpose(1, 2).reshape(
        -1, s_eff)[:num_rows]
    long_run = n > long_len
    rows = torch.nonzero(long_run.any(1)).reshape(-1)
    # The rows' runs, row-major and in range order; a short run gets none.
    n = torch.where(long_run[rows], n[rows], 0).reshape(-1)
    lo = lo[rows].reshape(-1)
    count = -(-n // long_len)
    first = torch.cumsum(count, 0) - count
    of = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device),
                                 count)
    start = lo[of] + (torch.arange(of.shape[0], device=n.device) -
                      first[of]) * long_len
    end = torch.minimum(start + long_len, (lo + n)[of])
    per_row = count.reshape(-1, s_eff).sum(1)
    return RowPieces(
        pieces=torch.stack([rows[of // s_eff], start, end],
                           1).int().contiguous(),
        rows=torch.stack([rows, torch.cumsum(per_row, 0) - per_row, per_row],
                         1).int().contiguous())


def k1_pieces(plan: SpmmPlan) -> RowPieces:
    """The piece table K1 reads for ``plan``'s rows of more than
    ``K1_LONG`` slots: each cut into pieces of at most ``K1_LONG`` in slot
    order. Derived with tensor ops on the plan's device on first use and
    cached per ``tile_ptr`` (:func:`_cached`)."""
    return _cached(('k1_pieces', plan.num_rows, K1_LONG), (plan.tile_ptr, ),
                   lambda tp: _derive_pieces(
                       tp, torch.zeros(1, dtype=torch.int32,
                                       device=tp.device), plan.num_rows,
                       K1_LONG))


def segment_sum_chunked_plain(msgs_padded: torch.Tensor,
                              plan: SpmmPlan) -> torch.Tensor:
    """Plain PyTorch reduction of padded messages into ``[num_rows, F]``
    f32 sums, over the same plan layout as the TPU kernel K1 reduces
    (counterpart of ``_segment_sum_padded_xla``)."""
    slot, row = _padded_rows(plan.tile_ptr)
    out = torch.zeros((plan.num_rows, msgs_padded.shape[1]),
                      dtype=torch.float32, device=msgs_padded.device)
    return out.index_add_(0, row, msgs_padded[slot].float())


def spmm_chunked_plain(x: torch.Tensor, plan: SpmmPlan,
                       scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of K1: gather, derive each slot's row from
    ``tile_ptr``, ``index_add_``; times ``scale`` per column if given."""
    slot, row = _padded_rows(plan.tile_ptr)
    out = torch.zeros((plan.num_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, row, x[plan.col_padded[slot].long()].float())
    return out if scale is None else out * scale[None, :]


def _k1_lib():
    lib = _build.load('spmm_chunked')
    fn = lib.pygt_spmm_chunked
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, i, vp, i, vp, i, vp,
                       vp]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(name, t, dtype, shape=None, device=None):
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f'{name} must be on {device}, got {t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} must have shape {tuple(shape)}, got '
                         f'{tuple(t.shape)}')


def _launch_k1(x: torch.Tensor, idx: Optional[torch.Tensor], plan: SpmmPlan,
               scale: Optional[torch.Tensor]):
    """Check K1's inputs and launch it: ``x[idx[p]]``, or ``x[p]`` when
    ``idx`` is ``None``, summed over each row's slots. Returns the sums and
    whether rows were cut into pieces (:func:`k1_pieces`)."""
    dev = x.device
    if x.dim() != 2 or x.dtype not in DTYPE_CODE:
        raise ValueError(f'x must be a 2-D f32/bf16/int8 tensor, got '
                         f'{x.dtype} of shape {tuple(x.shape)}')
    num_tiles = plan.tile_ptr.shape[0]
    f = x.shape[1]
    _check_cuda('x', x, x.dtype, device=dev)
    _check_cuda('col_padded', plan.col_padded, torch.int32, device=dev)
    _check_cuda('tile_ptr', plan.tile_ptr, torch.int32,
                (num_tiles, PTR_SUB, TP), dev)
    if idx is None and x.shape[0] < plan.col_padded.shape[0]:
        raise ValueError(f'msgs_padded must have at least E_pad = '
                         f'{plan.col_padded.shape[0]} rows, got {x.shape[0]}')
    if scale is not None:
        _check_cuda('scale', scale, torch.float32, (f, ), dev)
    if x.shape[0] >= 2**31 or plan.col_padded.numel() >= 2**31:
        raise ValueError('K1 indexes rows and slots with int32')
    out = torch.empty((plan.num_rows, f), dtype=torch.float32, device=dev)
    if plan.num_rows == 0 or f == 0:
        return out, False
    cut = k1_pieces(plan)
    npieces = cut.pieces.shape[0]
    part = torch.empty((npieces, f), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _k1_lib()(x.data_ptr(), DTYPE_CODE[x.dtype],
                        None if idx is None else idx.data_ptr(),
                        plan.tile_ptr.data_ptr(),
                        None if scale is None else scale.data_ptr(),
                        out.data_ptr(), num_tiles, plan.num_rows, f, K1_LONG,
                        cut.pieces.data_ptr(), npieces, cut.rows.data_ptr(),
                        cut.rows.shape[0], part.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K1 (spmm_chunked.cu) launch failed: CUDA error '
                           f'{err}')
    return out, npieces > 0


def spmm_chunked(x: torch.Tensor, plan: SpmmPlan,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``out[r] = scale * Σ_{p in row r} x[col_padded[p]]`` as
    ``[num_rows, F]`` f32.

    ``x`` is f32, bf16 or int8. A CUDA ``x`` launches the kernel (and
    raises on anything it does not take); a CPU ``x`` runs
    :func:`spmm_chunked_plain`. ``spmm_chunked.launches`` counts kernel
    calls, ``spmm_chunked.piece_launches`` those that also cut rows into
    pieces.
    """
    if not x.is_cuda:
        return spmm_chunked_plain(x, plan, scale)
    out, cut = _launch_k1(x, plan.col_padded, plan, scale)
    spmm_chunked.launches += 1
    spmm_chunked.piece_launches += cut
    return out


spmm_chunked.launches = 0
spmm_chunked.piece_launches = 0


def segment_sum_chunked(msgs_padded: torch.Tensor,
                        plan: SpmmPlan) -> torch.Tensor:
    """K1 without the gather: ``out[r] = Σ_{p in row r} msgs_padded[p]`` as
    ``[num_rows, F]`` f32, for messages already in the plan's padded
    coordinates (``[E_pad, F]``, f32, bf16 or int8; pad slots are read by
    no row).

    A CUDA tensor launches K1 with no column index; a CPU tensor runs
    :func:`segment_sum_chunked_plain`. ``segment_sum_chunked.launches``
    counts these calls, apart from :func:`spmm_chunked`'s, and
    ``segment_sum_chunked.piece_launches`` those that cut rows into
    pieces.
    """
    if not msgs_padded.is_cuda:
        return segment_sum_chunked_plain(msgs_padded, plan)
    out, cut = _launch_k1(msgs_padded, None, plan, None)
    segment_sum_chunked.launches += 1
    segment_sum_chunked.piece_launches += cut
    return out


segment_sum_chunked.launches = 0
segment_sum_chunked.piece_launches = 0


def spmm_plan_apply(x: torch.Tensor, plan: SpmmPlan,
                    precision: Optional[str] = None) -> torch.Tensor:
    """``out[r] = Σ_{e in row r} x[col[e]]`` — gather + chunked reduce.

    ``precision='bf16'`` reads the gathered rows in bfloat16 with float32
    accumulation; ``'int8'`` quantises ``x`` per feature column
    (:func:`quantize_columns`), sums the int8 values exactly in f32 and
    multiplies by the column scale. An int8 ``x`` under ``'int8'`` is
    taken as already quantised and its raw f32 sums are returned. The
    output dtype is ``x.dtype`` otherwise.
    """
    if precision == 'int8':
        if x.dtype == torch.int8:
            return spmm_chunked(x, plan)
        xq, scale = quantize_columns(x)
        return spmm_chunked(xq, plan, scale).to(x.dtype)
    xm = x.to(torch.bfloat16) if precision == 'bf16' else x
    return spmm_chunked(xm.contiguous(), plan).to(x.dtype)
