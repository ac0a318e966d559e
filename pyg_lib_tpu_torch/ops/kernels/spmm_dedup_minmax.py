"""Deduplicated-gather exact max, kernel K5 (``csrc/spmm_dedup_minmax.cu``).

Port of ``pyg_lib_tpu/ops/pallas/spmm_dedup_minmax.py``. For an order
statistic, duplicate ``(row, col)`` edges are redundant, and at the scope
of a 128-row tile each distinct column needs to be read once. The host
plan (:func:`build_dedup_minmax_plan`) drops duplicate pairs, packs each
tile's column-sorted edges into chunks of at most ``ec`` edges over at
most ``uc`` distinct columns (the sum plan's ``_pack_tile``), and stores
each chunk's edges sorted by row. The plan arrays are bit-for-bit the JAX
package's.

The kernel returns ``(values [N, F] f32, pos [N, F] int32)``: each row's
maximum and the least global unique slot ``chunk·uc + lid`` that holds it
(ties, ``-0.0`` against ``+0.0`` included, go to the least slot, which on
this plan is the least column), with the value re-read from that slot so
its bits are the slot's own. ``plan.uniq_cols[pos]`` is the winning
column. A row with no edges gets ``(-inf, POS_NONE)``; callers apply the
empty-row contract through their degree mask.

K5 gives each tile's chunks to one block (:func:`k5_units`: a tile of
more than ``K5_SEG`` chunks is cut into units whose partial results a
second launch merges in order) and carries each row's best (value, slot)
as it walks the edges in slot order, so the value is the winning slot's
own bits and ``x`` is not read again. :func:`dedup_minmax_split` runs
that schedule with PyTorch, so the tests can hold it against the JAX
package bit for bit.

:func:`dedup_minmax` is the wrapper: K5 for a CUDA tensor, the plain
PyTorch version (:func:`dedup_minmax_plain`, the counterpart of
``_dedup_minmax_xla``) for a CPU tensor.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.segment_minmax import (NEG, POS_NONE,
                                                          k4_merge,
                                                          winner_values)
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (TR, _cached,
                                                        _check_cuda)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup import (META_SUB, _pack_tile,
                                                      _tile_slices,
                                                      estimate_dedup)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = [
    'DedupMinmaxPlan', 'K5Units', 'build_dedup_minmax_plan', 'dedup_minmax',
    'dedup_minmax_apply', 'dedup_minmax_plain', 'dedup_minmax_split',
    'dedup_pairs', 'estimate_minmax_config', 'k5_units', 'pad_minmax_plan',
]

# Unique slots a plan may hold: the TPU kernel carries slot positions
# through an f32 channel, exact below 2**24. The port's kernel would take
# slots up to POS_NONE, but keeps the JAX package's cap so both refuse the
# same graphs.
MAX_SLOTS = 1 << 24
# Chunks a K5 block walks at most: a tile of more is cut into units of
# K5_SEG chunks, merged by a second launch (the unit table, k5_units).
K5_SEG = 8


class DedupMinmaxPlan(NamedTuple):
    """Static dedup-gather order-statistic schedule (host-built).

    ``edge_meta`` rows: 0 the local row (``TR`` marks a pad edge), 1 the
    chunk-local unique id, 2 the last-edge-of-its-row-in-chunk flag.
    """
    uniq_cols: torch.Tensor  # [C*UC] int32 — unique-col gather list
    edge_meta: torch.Tensor  # [C, META_SUB, EC] int32 (row-sorted)
    chunk_tile: torch.Tensor  # [C] int32
    num_rows: int
    num_edges: int  # edges before the pair dedup
    ec: int
    uc: int
    # The TPU kernel's scan depth (longest row run in a chunk, as a power
    # of two); K5 walks the runs and does not read it.
    scan_len: int = 0

    @property
    def num_chunks(self) -> int:
        return self.chunk_tile.shape[0]


def dedup_pairs(rowptr, col):
    """Drop duplicate ``(row, col)`` edges; returns the deduped CSR
    (columns sorted within each row). For order statistics only."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_rows = rowptr.shape[0] - 1
    row = np.repeat(np.arange(num_rows, dtype=np.int64),
                    np.diff(rowptr).astype(np.int64))
    order = np.lexsort((col, row))
    r, c = row[order], col[order]
    if r.shape[0]:
        keep = np.empty(r.shape[0], bool)
        keep[0] = True
        keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        r, c = r[keep], c[keep]
    rp = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=num_rows), out=rp[1:])
    return rp, c


def estimate_minmax_config(rowptr, col, sample_tiles: int = 64,
                           candidates=((512, 192), (256, 128), (512, 256),
                                       (384, 160), (256, 96), (128, 64))):
    """Pick ``(ec, uc)`` for a pair-deduped CSR from the host layout.

    The cost model (22 ns per gathered unique row, 8 ns per padded edge
    slot, 0.8 µs per chunk) is the JAX package's, calibrated on its TPU
    kernel; it is kept for parity and has not been re-measured on the
    card.
    """
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_tiles, tb = _tile_slices(rowptr)
    if num_tiles > sample_tiles:
        pick = np.linspace(0, num_tiles - 1, sample_tiles).astype(np.int64)
    else:
        pick = np.arange(num_tiles)
    scale = num_tiles / max(len(pick), 1)
    best = None
    for ec, uc in candidates:
        uc = min(uc, ec)
        chunks = 0
        for t in pick:
            lo, hi = int(rowptr[tb[t]]), int(rowptr[tb[t + 1]])
            if hi == lo:
                chunks += 1
                continue
            c = np.sort(col[lo:hi])
            n = hi - lo
            new = np.empty(n, bool)
            new[0] = True
            np.not_equal(c[1:], c[:-1], out=new[1:])
            ucum = np.cumsum(new)
            start = 0
            while start < n:
                end = min(start + ec, n)
                if ucum[end - 1] - ucum[start] + 1 > uc:
                    end = start + int(
                        np.searchsorted(ucum[start:end],
                                        ucum[start] + uc - 1, side='right'))
                chunks += 1
                start = end
        cost = chunks * (22.0 * uc + 8.0 * ec + 800.0) * scale
        if best is None or cost < best[0]:
            best = (cost, ec, uc)
    return best[1], best[2]


def _too_large(chunks: int, uc: int):
    return ValueError(
        f'dedup minmax plan too large ({chunks} chunks x uc={uc}): unique '
        f'slots must stay below {MAX_SLOTS}; shard the graph or use the '
        f'per-edge min/max path')


def build_dedup_minmax_plan(rowptr, col, ec: int = 512, uc='auto',
                            _pre_deduped: bool = False,
                            device=None) -> DedupMinmaxPlan:
    """Build the dedup min/max schedule, with its tensors on ``device``
    (default: the CUDA card).

    ``ec`` and ``uc`` bound the edges and the distinct columns of a chunk
    (``uc='auto'``: :func:`estimate_dedup` on the pair-deduped CSR). A
    plan holds fewer than ``2**24`` unique slots (``chunks · uc``), the
    JAX package's cap, kept; a larger graph raises ``ValueError``.
    """
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_rows = rowptr.shape[0] - 1
    num_edges_total = int(col.shape[0])
    if _pre_deduped:
        rowptr_d, col_d = rowptr, col
    else:
        rowptr_d, col_d = dedup_pairs(rowptr, col)
    if uc == 'auto':
        uc, _ = estimate_dedup(rowptr_d, col_d, ec=ec)
    uc = int(min(max(-(-uc // 8) * 8, 8), ec))
    num_tiles, tb = _tile_slices(rowptr_d)

    # Each tile needs at least ceil(edges / ec) chunks (one when empty).
    counts = rowptr_d[tb[1:]] - rowptr_d[tb[:-1]]
    min_chunks = int(np.maximum(-(-counts // ec), 1).sum())
    if min_chunks * uc >= MAX_SLOTS:
        raise _too_large(min_chunks, uc)

    uniqs, metas, tiles = [], [], []
    maxrun = 1
    for t in range(num_tiles):
        lo, hi = int(rowptr_d[tb[t]]), int(rowptr_d[tb[t + 1]])
        rloc = np.repeat(
            np.arange(tb[t + 1] - tb[t], dtype=np.int32),
            np.diff(rowptr_d[tb[t]:tb[t + 1] + 1]).astype(np.int64))
        ctile = col_d[lo:hi]
        order = np.argsort(ctile, kind='stable')
        packed = _pack_tile(ctile[order].astype(np.int64), rloc[order],
                            None, ec, uc)
        for uniq, rows_p, lid_p, _ in packed:
            # Row-sort the chunk (pads -> TR, after every real edge) and
            # flag each row's last edge in the chunk.
            rows2 = np.where(rows_p < 0, TR, rows_p).astype(np.int32)
            o = np.argsort(rows2, kind='stable')
            rows2, lid2 = rows2[o], lid_p[o]
            last = np.zeros(ec, np.int32)
            real = rows2 < TR
            if real.any():
                nreal = int(real.sum())
                last[:nreal - 1] = rows2[:nreal - 1] != rows2[1:nreal]
                last[nreal - 1] = 1
                maxrun = max(maxrun, int(np.bincount(rows2[:nreal]).max()))
            m = np.zeros((META_SUB, ec), np.int32)
            m[0], m[1], m[2] = rows2, lid2, last
            uniqs.append(uniq)
            metas.append(m)
            tiles.append(t)
    scan_len = 1
    while scan_len < maxrun:
        scan_len *= 2

    c = len(tiles)
    if c * uc >= MAX_SLOTS:
        raise _too_large(c, uc)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DedupMinmaxPlan(
        uniq_cols=dev(np.concatenate(uniqs).astype(np.int32)),
        edge_meta=dev(np.stack(metas)),
        chunk_tile=dev(np.asarray(tiles, np.int32)),
        num_rows=int(num_rows),
        num_edges=num_edges_total,
        ec=int(ec),
        uc=int(uc),
        scan_len=int(scan_len),
    )


def pad_minmax_plan(plan: DedupMinmaxPlan, num_chunks: int,
                    scan_len: Optional[int] = None) -> DedupMinmaxPlan:
    """``plan`` with all-pad chunks appended up to ``num_chunks`` (every
    edge a pad, local row ``TR``, on the last chunk's tile) and its scan
    depth raised to ``scan_len``, as the JAX package pads the sharded
    builder's splits to one kernel shape."""
    if scan_len is not None and scan_len > plan.scan_len:
        plan = plan._replace(scan_len=int(scan_len))
    extra = num_chunks - plan.num_chunks
    if extra <= 0:
        return plan
    dev = plan.edge_meta.device
    meta = torch.zeros((extra, META_SUB, plan.ec), dtype=torch.int32,
                       device=dev)
    meta[:, 0, :] = TR  # pad edges name no output row
    last = (plan.chunk_tile[-1:] if plan.num_chunks else
            torch.zeros(1, dtype=torch.int32, device=dev))
    return plan._replace(
        uniq_cols=torch.cat([plan.uniq_cols, torch.zeros(
            extra * plan.uc, dtype=torch.int32, device=dev)]),
        edge_meta=torch.cat([plan.edge_meta, meta]),
        chunk_tile=torch.cat([plan.chunk_tile, last.expand(extra)]))


def dedup_minmax_plain(x: torch.Tensor, plan: DedupMinmaxPlan,
                       negate: bool = False):
    """Plain PyTorch version of K5: every real edge's ``±x`` row by its
    unique slot, per-row ``amax``, then the least slot whose value equals
    it; the value is re-read at that slot."""
    f = x.shape[1]
    rows = plan.edge_meta[:, 0, :]
    c_idx, e_idx = torch.nonzero(rows < TR, as_tuple=True)
    slot = c_idx * plan.uc + plan.edge_meta[c_idx, 1, e_idx]
    dst = plan.chunk_tile[c_idx].long() * TR + rows[c_idx, e_idx].long()
    msgs = x[plan.uniq_cols[slot].long()].float()
    if negate:
        msgs = -msgs
    index = dst[:, None].expand(-1, f)
    num_tiles = max(-(-plan.num_rows // TR), 1)
    vals = torch.full((num_tiles * TR, f), NEG, dtype=torch.float32,
                      device=x.device)
    vals.scatter_reduce_(0, index, msgs, 'amax')
    cand = torch.where(msgs == vals[dst], slot[:, None].to(torch.int32),
                       torch.tensor(POS_NONE, dtype=torch.int32,
                                    device=x.device))
    pos = torch.full((num_tiles * TR, f), POS_NONE, dtype=torch.int32,
                     device=x.device)
    pos.scatter_reduce_(0, index, cand, 'amin')
    pos = pos[:plan.num_rows]
    hit = pos < POS_NONE
    win = plan.uniq_cols[torch.where(hit, pos, 0).long()]
    return winner_values(x, win, hit, negate), pos


class K5Units(NamedTuple):
    """K5's work units for one plan: a tile of at most ``K5_SEG`` chunks
    is one unit; a longer one is cut into units of ``K5_SEG`` chunks, each
    writing a partial, and is merged by a second launch."""
    units: torch.Tensor  # [U, 4] int32: tile, first chunk, end chunk, partial
    chunks: torch.Tensor  # [C, 2] int32: real edges, used unique slots
    merges: torch.Tensor  # [M, 3] int32: cut tile, first partial, count
    num_parts: int


def _derive_units(chunk_tile, edge_meta, num_rows, seg) -> K5Units:
    dev = chunk_tile.device
    num_tiles = -(-num_rows // TR)
    first = torch.searchsorted(chunk_tile.long(),
                               torch.arange(num_tiles + 1, device=dev))
    n = first[1:] - first[:-1]
    segs = torch.where(n > seg, -(-n // seg), torch.ones_like(n))
    tile = torch.repeat_interleave(torch.arange(num_tiles, device=dev), segs)
    k = torch.arange(tile.shape[0], device=dev) - (torch.cumsum(segs, 0) -
                                                   segs)[tile]
    lo = first[:-1][tile] + k * seg
    hi = torch.minimum(lo + seg, first[1:][tile])
    cut = n[tile] > seg
    part = torch.where(cut, torch.cumsum(cut.long(), 0) - 1,
                       torch.full_like(tile, -1))
    cut_tiles = torch.nonzero(n > seg).reshape(-1)
    count = segs[cut_tiles]
    merges = torch.stack([cut_tiles, torch.cumsum(count, 0) - count, count],
                         1)
    real = edge_meta[:, 0, :] < TR
    if real.shape[1] > 1 and not bool((real[:, 1:] <= real[:, :-1]).all()):
        raise ValueError('a chunk has a real edge after a pad edge')
    rows, lid = edge_meta[:, 0, :], edge_meta[:, 1, :]
    same = real[:, 1:] & (rows[:, 1:] == rows[:, :-1])
    if not bool((lid[:, 1:] > lid[:, :-1])[same].all()):
        raise ValueError("a chunk's edges of one row are not in slot order")
    used = torch.where(real, lid, -1).amax(1) + 1
    return K5Units(
        units=torch.stack([tile, lo, hi, part], 1).int().contiguous(),
        chunks=torch.stack([real.sum(1), used], 1).int().contiguous(),
        merges=merges.int().contiguous(), num_parts=int(cut.sum()))


def k5_units(plan: DedupMinmaxPlan, seg: int = None) -> K5Units:
    """The tables K5 reads for ``plan`` (``seg`` chunks a unit at most,
    default ``K5_SEG``), derived with tensor ops on the plan's device on
    first use and cached per ``chunk_tile`` and ``edge_meta`` (as K2's
    tables)."""
    seg = K5_SEG if seg is None else seg
    return _cached(('k5_units', plan.num_rows, seg),
                   (plan.chunk_tile, plan.edge_meta),
                   lambda ct, meta: _derive_units(ct, meta, plan.num_rows,
                                                  seg))


def dedup_minmax_split(x: torch.Tensor, plan: DedupMinmaxPlan,
                       negate: bool = False, seg: int = None):
    """K5's schedule run with PyTorch: each unit of :func:`k5_units` takes
    each row's greatest value over its edges, the least slot among equals
    (``-0.0`` and ``+0.0`` equal) and that slot's own bits, as the kernel's
    in-order walk does; a tile's only unit writes ``vals`` and ``pos``, a
    cut tile's units go to a partial table and are merged in order by
    :func:`k4_merge`. Raises if a tile would be written other than once."""
    f = x.shape[1]
    cut = k5_units(plan, seg)
    units = cut.units.long()
    rows = plan.edge_meta[:, 0, :]
    c_idx, e_idx = torch.nonzero(rows < TR, as_tuple=True)
    slot = c_idx * plan.uc + plan.edge_meta[c_idx, 1, e_idx]
    unit = torch.searchsorted(units[:, 2].contiguous(), c_idx, right=True)
    dst = unit * TR + rows[c_idx, e_idx].long()
    msgs = x[plan.uniq_cols[slot].long()].float()
    if negate:
        msgs = -msgs
    index = dst[:, None].expand(-1, f)
    best = torch.full((units.shape[0] * TR, f), NEG, device=x.device)
    best.scatter_reduce_(0, index, msgs, 'amax')
    cand = torch.where(msgs == best[dst], slot[:, None].to(torch.int32),
                       torch.tensor(POS_NONE, dtype=torch.int32))
    bpos = torch.full((units.shape[0] * TR, f), POS_NONE, dtype=torch.int32,
                      device=x.device)
    bpos.scatter_reduce_(0, index, cand, 'amin')
    hit = bpos < POS_NONE
    win = plan.uniq_cols[torch.where(hit, bpos, 0).long()]
    bval = winner_values(x, win, hit, negate).view(-1, TR, f)
    bpos = bpos.view(-1, TR, f)
    num_tiles = -(-plan.num_rows // TR)
    vals = torch.full((num_tiles, TR, f), NEG, device=x.device)
    pos = torch.full((num_tiles, TR, f), POS_NONE, dtype=torch.int32,
                     device=x.device)
    written = torch.zeros(num_tiles, dtype=torch.int64)
    direct = units[:, 3] < 0
    vals[units[direct, 0]] = bval[direct]
    pos[units[direct, 0]] = bpos[direct]
    written.index_add_(0, units[direct, 0].cpu(),
                       torch.ones(int(direct.sum()), dtype=torch.int64))
    part_v = torch.empty((cut.num_parts, TR, f), device=x.device)
    part_p = torch.empty((cut.num_parts, TR, f), dtype=torch.int32,
                         device=x.device)
    part_v[units[~direct, 3]] = bval[~direct]
    part_p[units[~direct, 3]] = bpos[~direct]
    for t, first, count in cut.merges.tolist():
        v, p = part_v[first], part_p[first]
        for q in range(first + 1, first + count):
            v, p = k4_merge(v, p, part_v[q], part_p[q])
        vals[t], pos[t] = v, p
        written[t] += 1
    if not bool((written == 1).all()):
        raise AssertionError('K5 schedule writes a tile other than once')
    return vals.view(-1, f)[:plan.num_rows], pos.view(-1, f)[:plan.num_rows]


def _k5_lib():
    lib = _build.load('spmm_dedup_minmax')
    fn = lib.pygt_dedup_max
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # x, uniq_cols, edge_meta, units, num_units, chunks, merges,
        # num_merges, ec, uc, negate, part_val, part_pos, vals, pos,
        # num_rows, F, stream
        fn.argtypes = [vp, vp, vp, vp, i, vp, vp, i, i, i, i, vp, vp, vp, vp,
                       i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def dedup_minmax(x: torch.Tensor, plan: DedupMinmaxPlan,
                 negate: bool = False):
    """K5: ``(values, pos)`` of each row's maximum of ``±x[col]`` over its
    pair-deduped edges, ``pos`` the least winning unique slot.

    ``x`` is f32. A CUDA ``x`` launches the kernel (and raises on anything
    it does not take); a CPU ``x`` runs :func:`dedup_minmax_plain`.
    ``dedup_minmax.launches`` counts kernel launches.
    """
    if not x.is_cuda:
        return dedup_minmax_plain(x, plan, negate)
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f'x must be 2-D, got shape {tuple(x.shape)}')
    f = x.shape[1]
    c = plan.num_chunks
    _check_cuda('x', x, torch.float32, device=dev)
    _check_cuda('uniq_cols', plan.uniq_cols, torch.int32, (c * plan.uc, ),
                dev)
    _check_cuda('edge_meta', plan.edge_meta, torch.int32,
                (c, META_SUB, plan.ec), dev)
    _check_cuda('chunk_tile', plan.chunk_tile, torch.int32, (c, ), dev)
    if x.shape[0] >= 2**31 or c * plan.uc >= MAX_SLOTS or plan.uc >= 2**23:
        raise ValueError('K5 indexes rows and unique slots with int32 (a '
                         'unique id in 23 bits)')
    vals = torch.empty((plan.num_rows, f), dtype=torch.float32, device=dev)
    pos = torch.empty((plan.num_rows, f), dtype=torch.int32, device=dev)
    if plan.num_rows == 0 or f == 0:
        return vals, pos
    cut = k5_units(plan)
    parts = [torch.empty((cut.num_parts, TR, f), dtype=dt, device=dev)
             if cut.num_parts else None
             for dt in (torch.float32, torch.int32)]
    with torch.cuda.device(dev):
        err = _k5_lib()(x.data_ptr(), plan.uniq_cols.data_ptr(),
                        plan.edge_meta.data_ptr(), cut.units.data_ptr(),
                        cut.units.shape[0], cut.chunks.data_ptr(),
                        cut.merges.data_ptr(),
                        cut.merges.shape[0], plan.ec, plan.uc, int(negate),
                        *(None if t is None else t.data_ptr()
                          for t in parts), vals.data_ptr(), pos.data_ptr(),
                        plan.num_rows, f,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K5 (spmm_dedup_minmax.cu) launch failed: CUDA '
                           f'error {err}')
    dedup_minmax.launches += 1
    return vals, pos


dedup_minmax.launches = 0


def dedup_minmax_apply(x: torch.Tensor, plan: DedupMinmaxPlan):
    """Exact per-row maxima and winning unique slots of ``x`` (any float
    dtype, read as f32) over the plan. For min, negate the input and the
    returned values."""
    return dedup_minmax(x.float().contiguous(), plan)
