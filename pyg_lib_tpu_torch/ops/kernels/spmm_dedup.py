"""Deduplicated-gather SpMM plan and kernels K2/K2h (``csrc/spmm_dedup.cu``).

Port of ``pyg_lib_tpu/ops/pallas/spmm_dedup.py``. The host-side plan packs
each 128-row tile's column-sorted edges into chunks of at most ``ec``
edges referencing at most ``uc`` distinct columns, so each (tile, column)
pair is gathered once per chunk; a two-level plan also moves the columns
that span many tiles into a global hot set with a dense per-row count (or
weight-sum) matrix ``hot_w``. The plan arrays are bit-for-bit those of
the JAX package, and the ``'auto'`` thresholds are the JAX package's.

:func:`dedup_sum` is the kernels' wrapper: K2 (or K2h for a hot plan) for
a CUDA tensor, the plain PyTorch version (:func:`dedup_sum_plain`) for a
CPU tensor. The kernels read tables derived once from the plan and
cached: each chunk's edges sorted by row (:func:`cold_edges`) and, for
K2h, the row list of ``hot_w``'s non-zeros (:func:`hot_list`).
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from pyg_lib_tpu_torch import _build
# _derived is the derived tables' cache, which _cached fills.
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (  # noqa: F401
    DTYPE_CODE, TR, _cached, _check_cuda, _derived, quantize_columns)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = [
    'ColdEdges', 'DedupSpmmPlan', 'HotList', 'build_dedup_plan',
    'cold_edges', 'cold_pass_fits', 'dedup_plan_apply', 'dedup_sum',
    'dedup_sum_plain', 'estimate_dedup', 'hot_list', 'pad_hot', 'pad_plan',
]

META_SUB = 8  # rows of the edge-metadata block (3 used)
K2_MAX_SMEM = 232448  # shared memory a block may use on the H100 (bytes)


class DedupSpmmPlan(NamedTuple):
    """Static dedup-gather schedule for one CSR graph (host-built)."""
    uniq_cols: torch.Tensor  # [C*UC] int32 — unique-col gather list
    edge_meta: torch.Tensor  # [C, META_SUB, EC] int32 — r0: local row
    #                          (-1 pad), r1: chunk-local unique id,
    #                          r2: f32 weight bits
    chunk_tile: torch.Tensor  # [C] int32 — output tile of each chunk
    num_rows: int
    num_edges: int
    ec: int
    uc: int
    weighted: bool
    hot_cols: Optional[torch.Tensor] = None  # [H] int32
    hot_w: Optional[torch.Tensor] = None  # [num_tiles*TR, H] i8|bf16|f32

    @property
    def num_chunks(self) -> int:
        return self.chunk_tile.shape[0]

    @property
    def num_hot(self) -> int:
        return 0 if self.hot_cols is None else int(self.hot_cols.shape[0])


def _tile_slices(rowptr: np.ndarray):
    num_rows = rowptr.shape[0] - 1
    num_tiles = max(-(-num_rows // TR), 1)
    tb = np.minimum(np.arange(num_tiles + 1) * TR, num_rows)
    return num_tiles, tb


def _pack_tile(cols_sorted, rows_sorted, w_sorted, ec: int, uc: int):
    """Greedy chunk packing of one tile's col-sorted edge list.

    Returns per-chunk (uniq_list, row_ids, lids, weights) numpy arrays,
    padded to (uc,) / (ec,) each.
    """
    n = cols_sorted.shape[0]
    out = []
    if n == 0:
        return [(np.zeros(uc, np.int32), np.full(ec, -1, np.int32),
                 np.zeros(ec, np.int32), np.zeros(ec, np.float32))]
    new = np.empty(n, bool)
    new[0] = True
    np.not_equal(cols_sorted[1:], cols_sorted[:-1], out=new[1:])
    ucum = np.cumsum(new)  # 1-based global unique index per edge
    start = 0
    while start < n:
        end = min(start + ec, n)
        if ucum[end - 1] - ucum[start] + 1 > uc:
            # cut before the (uc+1)-th chunk-local unique
            end = start + int(
                np.searchsorted(ucum[start:end], ucum[start] + uc - 1,
                                side='right'))
        lid = (ucum[start:end] - ucum[start]).astype(np.int32)
        cols_c = cols_sorted[start:end]
        first = np.empty(end - start, bool)
        first[0] = True
        np.not_equal(lid[1:], lid[:-1], out=first[1:])
        uniq = np.zeros(uc, np.int32)
        uniq[:int(lid[-1]) + 1] = cols_c[first]
        rows_p = np.full(ec, -1, np.int32)
        rows_p[:end - start] = rows_sorted[start:end]
        lid_p = np.zeros(ec, np.int32)
        lid_p[:end - start] = lid
        w_p = np.zeros(ec, np.float32)
        if w_sorted is not None:
            w_p[:end - start] = w_sorted[start:end]
        out.append((uniq, rows_p, lid_p, w_p))
        start = end
    return out


def _select_hot(rowptr, col, num_tiles: int, hot, hot_thresh,
                hot_max: int, hot_budget_bytes: int, bytes_per_entry: int):
    """Pick the global hot column set from per-column tile spans.

    The span threshold (``num_tiles // 56`` columns' worth, times the
    entry width) is the JAX package's, calibrated there; it is kept for
    parity. Returns a sorted int64 column array, or ``None``.
    """
    if hot == 'off' or num_tiles <= 1 or col.shape[0] == 0:
        return None
    explicit = not isinstance(hot, str)
    if explicit:
        hot_thresh = 1 if hot_thresh is None else hot_thresh
    elif hot_thresh is None:
        if num_tiles < 16:
            return None  # the dense count stream cannot pay on tiny grids
        hot_thresh = max(num_tiles // 56, 4) * max(bytes_per_entry, 1)
    row = np.repeat(np.arange(rowptr.shape[0] - 1, dtype=np.int64),
                    np.diff(rowptr).astype(np.int64))
    key = col.astype(np.int64) * num_tiles + row // TR
    uniq_key = np.unique(key)
    span = np.bincount(uniq_key // num_tiles)
    cand = np.nonzero(span >= hot_thresh)[0]
    if cand.size == 0:
        return None
    cand = cand[np.argsort(span[cand], kind='stable')[::-1]]
    cap = int(hot) if explicit else hot_max
    cap = min(cap,
              hot_budget_bytes // max(num_tiles * TR * bytes_per_entry, 1))
    h = (min(cand.size, max(cap, 0)) // 8) * 8
    if h < 8:
        return None
    return np.sort(cand[:h])


def estimate_dedup(rowptr, col, ec: int = 512,
                   uc_candidates=(64, 128, 256, 512),
                   sample_tiles: int = 64):
    """Pick ``uc`` and predict the gather saving from the host layout.

    Returns ``(uc, gain)``: ``gain`` is the single plan's per-edge gather
    slots over the dedup plan's padded unique slots, sampled over at most
    ``sample_tiles`` tiles. ``build_spmm_graph(dedup='auto')`` takes the
    dedup plan from ``gain >= 1.3``, the JAX package's threshold.
    """
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    num_tiles, tb = _tile_slices(rowptr)
    if num_tiles > sample_tiles:
        pick = np.linspace(0, num_tiles - 1, sample_tiles).astype(np.int64)
    else:
        pick = np.arange(num_tiles)
    best = None
    base_slots = 0
    for t in pick:
        lo, hi = int(rowptr[tb[t]]), int(rowptr[tb[t + 1]])
        base_slots += max(-(-(hi - lo) // ec), 1) * ec
    for uc in uc_candidates:
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
        cost = chunks * (uc + 0.25 * ec)
        if best is None or cost < best[0]:
            best = (cost, uc, chunks)
    _, uc, chunks = best
    gain = base_slots / max(chunks * uc, 1)
    return uc, float(gain)


def build_dedup_plan(rowptr, col, ec: int = 512, uc='auto',
                     edge_weight=None, pad_to_chunks: Optional[int] = None,
                     hot='auto', hot_thresh: Optional[int] = None,
                     hot_max: int = 4096, hot_budget_bytes: int = 1 << 30,
                     device=None) -> DedupSpmmPlan:
    """Build the dedup-gather schedule, with its tensors on ``device``
    (default: the CUDA card).

    ``ec`` bounds edges per chunk, ``uc`` distinct columns per chunk
    (``'auto'``: :func:`estimate_dedup`). ``edge_weight`` (``[E]`` f32)
    bakes per-edge weights in: ``out[r] = Σ_e w_e · x[col_e]``. ``hot``
    is ``'auto'`` (columns past the span threshold), ``'off'``, or an int
    forcing the top-``hot`` spanning columns into the hot level;
    ``hot_thresh``, ``hot_max`` and ``hot_budget_bytes`` bound it as in
    the JAX package. ``hot_w`` is stored in the narrowest exact type:
    int8 for counts up to 127, bf16 up to 256, f32 otherwise and for
    weight sums. Like the JAX package, the builder holds ``hot_w`` in f32
    on the host first (4.3 GB at 262,144 rows and 4,096 hot columns).
    ``pad_to_chunks`` appends all-pad chunks (on the last tile, with no
    edge) up to that chunk count, as :func:`pad_plan` does.
    """
    device = _resolve_device(device)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    weighted = edge_weight is not None
    if weighted:
        edge_weight = np.asarray(edge_weight, dtype=np.float32)
    num_rows = rowptr.shape[0] - 1
    num_edges_total = int(col.shape[0])
    num_tiles, tb = _tile_slices(rowptr)

    hot_sel = _select_hot(rowptr, col, num_tiles, hot, hot_thresh, hot_max,
                          hot_budget_bytes, 4 if weighted else 1)
    hot_cols = hot_w = None
    while hot_sel is not None:
        hot_cols = np.sort(hot_sel)
        h = hot_cols.shape[0]
        hid_of = np.full(int(max(col.max(), hot_cols.max())) + 1, -1,
                         np.int64)
        hid_of[hot_cols] = np.arange(h)
        hid_e = hid_of[col]
        is_hot = hid_e >= 0
        row_e = np.repeat(np.arange(num_rows, dtype=np.int64),
                          np.diff(rowptr).astype(np.int64))
        hot_w = np.zeros((num_tiles * TR, h), np.float32)
        np.add.at(hot_w, (row_e[is_hot], hid_e[is_hot]),
                  edge_weight[is_hot] if weighted else 1.0)
        # Re-clamp against the byte budget with the storage width used.
        mx = float(hot_w.max())
        item = 4 if (weighted or mx > 256) else (1 if mx <= 127 else 2)
        cap = hot_budget_bytes // max(num_tiles * TR * item, 1)
        if h <= cap:
            break
        h8 = (min(h, cap) // 8) * 8
        if h8 < 8:
            hot_sel = hot_cols = hot_w = None
            break
        hot_sel = hot_sel[:h8]  # span-ordered: keep the widest spans
    if hot_w is not None:
        # Cold remainder CSR (row order is preserved by the mask).
        keep = ~is_hot
        rowptr_c = np.zeros(num_rows + 1, np.int64)
        np.cumsum(np.bincount(row_e[keep], minlength=num_rows),
                  out=rowptr_c[1:])
        rowptr, col = rowptr_c, col[keep]
        if weighted:
            edge_weight = edge_weight[keep]
        del row_e, hid_e, is_hot, keep

    if uc == 'auto':
        uc, _ = estimate_dedup(rowptr, col, ec=ec)
    uc = int(min(max(-(-uc // 8) * 8, 8), ec))

    uniqs, rows, lids, ws, tiles = [], [], [], [], []
    for t in range(num_tiles):
        lo, hi = int(rowptr[tb[t]]), int(rowptr[tb[t + 1]])
        rloc = np.repeat(
            np.arange(tb[t + 1] - tb[t], dtype=np.int32),
            np.diff(rowptr[tb[t]:tb[t + 1] + 1]).astype(np.int64))
        ctile = col[lo:hi]
        order = np.argsort(ctile, kind='stable')
        w_sorted = edge_weight[lo:hi][order] if weighted else None
        for uniq, rp, lp, wp in _pack_tile(ctile[order].astype(np.int64),
                                           rloc[order], w_sorted, ec, uc):
            uniqs.append(uniq)
            rows.append(rp)
            lids.append(lp)
            ws.append(wp)
            tiles.append(t)
    if pad_to_chunks is not None:
        while len(tiles) < pad_to_chunks:
            uniqs.append(np.zeros(uc, np.int32))
            rows.append(np.full(ec, -1, np.int32))
            lids.append(np.zeros(ec, np.int32))
            ws.append(np.zeros(ec, np.float32))
            tiles.append(tiles[-1] if tiles else 0)

    c = len(tiles)
    meta = np.zeros((c, META_SUB, ec), np.int32)
    meta[:, 0, :] = np.stack(rows)
    meta[:, 1, :] = np.stack(lids)
    if weighted:
        meta[:, 2, :] = np.stack(ws).view(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if hot_w is not None:
        mx = float(hot_w.max())
        if not weighted and mx <= 127:
            hot_w = dev(hot_w.astype(np.int8))
        elif not weighted and mx <= 256:
            hot_w = dev(hot_w).to(torch.bfloat16)
        else:
            hot_w = dev(hot_w)
        hot_cols = dev(hot_cols.astype(np.int32))
    return DedupSpmmPlan(
        uniq_cols=dev(np.concatenate(uniqs).astype(np.int32)),
        edge_meta=dev(meta),
        chunk_tile=dev(np.asarray(tiles, np.int32)),
        num_rows=int(num_rows),
        num_edges=num_edges_total,
        ec=int(ec),
        uc=int(uc),
        weighted=weighted,
        hot_cols=hot_cols,
        hot_w=hot_w,
    )


def pad_plan(plan: DedupSpmmPlan, num_chunks: int) -> DedupSpmmPlan:
    """``plan`` with all-pad chunks appended up to ``num_chunks``: no edge
    (local rows -1), on the last chunk's tile, so they add nothing. The
    sharded builder pads its splits to one chunk count, as the JAX package
    does (where it lets them share one compiled kernel)."""
    extra = num_chunks - plan.num_chunks
    if extra <= 0:
        return plan
    dev = plan.edge_meta.device
    meta = torch.zeros((extra, META_SUB, plan.ec), dtype=torch.int32,
                       device=dev)
    meta[:, 0, :] = -1
    last = (plan.chunk_tile[-1:] if plan.num_chunks else
            torch.zeros(1, dtype=torch.int32, device=dev))
    return plan._replace(
        uniq_cols=torch.cat([plan.uniq_cols, torch.zeros(
            extra * plan.uc, dtype=torch.int32, device=dev)]),
        edge_meta=torch.cat([plan.edge_meta, meta]),
        chunk_tile=torch.cat([plan.chunk_tile, last.expand(extra)]))


def pad_hot(plan: DedupSpmmPlan, num_hot: int,
            dtype: Optional[torch.dtype] = None) -> DedupSpmmPlan:
    """``plan`` with its hot level padded to ``num_hot`` columns: all-zero
    count columns naming column 0, which add nothing. ``dtype`` casts
    ``hot_w`` (through f32) so that sibling plans also agree on its
    storage; a plan with no hot level gets an all-zero one of ``dtype``
    (int8 by default). Raises ``ValueError`` for fewer columns than the
    plan has."""
    h = plan.num_hot
    if dtype is not None and h and plan.hot_w.dtype != dtype:
        plan = plan._replace(hot_w=plan.hot_w.float().to(dtype))
    if num_hot <= 0 or h == num_hot:
        return plan
    if num_hot < h:
        raise ValueError('cannot shrink the hot level')
    dev = plan.edge_meta.device
    num_tiles = max(-(-plan.num_rows // TR), 1)
    if h == 0:
        return plan._replace(
            hot_cols=torch.zeros(num_hot, dtype=torch.int32, device=dev),
            hot_w=torch.zeros((num_tiles * TR, num_hot),
                              dtype=dtype or torch.int8, device=dev))
    return plan._replace(
        hot_cols=torch.cat([plan.hot_cols, torch.zeros(
            num_hot - h, dtype=torch.int32, device=dev)]),
        hot_w=torch.cat([plan.hot_w, torch.zeros(
            (plan.hot_w.shape[0], num_hot - h), dtype=plan.hot_w.dtype,
            device=dev)], 1))


def dedup_sum_plain(x: torch.Tensor, plan: DedupSpmmPlan,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K2/K2h (counterpart of ``_dedup_sum_xla``
    and ``_dedup_sum_xla_hot``): every real edge's unique row, times its
    weight, ``index_add_``-ed into its row, plus ``hot_w @ x[hot_cols]``
    as an f32 matmul; times ``scale`` per column if given."""
    f = x.shape[1]
    num_tiles = max(-(-plan.num_rows // TR), 1)
    rows = plan.edge_meta[:, 0, :]
    c_idx, e_idx = torch.nonzero(rows >= 0, as_tuple=True)
    lid = plan.edge_meta[c_idx, 1, e_idx].long()
    src = plan.uniq_cols[c_idx * plan.uc + lid].long()
    dst = plan.chunk_tile[c_idx].long() * TR + rows[c_idx, e_idx].long()
    msgs = x[src].float()
    if plan.weighted:
        w = plan.edge_meta[c_idx, 2, e_idx].view(torch.float32)
        msgs = msgs * w[:, None]
    out = torch.zeros((num_tiles * TR, f), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, dst, msgs)
    if plan.num_hot:
        out += plan.hot_w.float() @ x[plan.hot_cols.long()].float()
    out = out[:plan.num_rows]
    return out if scale is None else out * scale[None, :]


class HotList(NamedTuple):
    """The row list of a hot plan's ``hot_w`` non-zeros (CSR), read by
    K2h in place of the dense ``hot_w``."""
    ptr: torch.Tensor  # [num_tiles*TR + 1] int32 — row r's entries
    src: torch.Tensor  # [nnz] int32 — row of x (hot_cols resolved)
    val: torch.Tensor  # [nnz] f32 — the count or weight sum, exact


class ColdEdges(NamedTuple):
    """A plan's chunk edges as K2 reads them: each chunk's real edges
    (pads dropped), sorted by row (stable), packed."""
    ptr: torch.Tensor  # [C + 1] int32 — chunk c's edges
    code: torch.Tensor  # [E] int32 — unique id << 7 | local row
    w: Optional[torch.Tensor]  # [E] f32 — weights of a weighted plan
    num_uniq: torch.Tensor  # [C] int32 — unique ids the edges name


def _derive_hot_list(hot_w: torch.Tensor,
                     hot_cols: torch.Tensor) -> HotList:
    rows, h = torch.nonzero(hot_w, as_tuple=True)
    if rows.numel() >= 2**31:
        raise ValueError('K2h indexes the hot list with int32')
    ptr = torch.zeros(hot_w.shape[0] + 1, dtype=torch.int64,
                      device=hot_w.device)
    torch.cumsum(torch.bincount(rows, minlength=hot_w.shape[0]), 0,
                 out=ptr[1:])
    return HotList(ptr=ptr.int(), src=hot_cols[h].int(),
                   val=hot_w[rows, h].float())


def _derive_cold_edges(edge_meta: torch.Tensor,
                       weighted: bool) -> ColdEdges:
    rows = edge_meta[:, 0, :]
    order = torch.sort(torch.where(rows >= 0, rows, TR), dim=1,
                       stable=True).indices
    rows = torch.gather(rows, 1, order)
    keep = rows >= 0  # the pads, last in each chunk
    lids = torch.gather(edge_meta[:, 1, :], 1, order)
    # A chunk's edges name unique ids 0, 1, ...: the rest pad it.
    num_uniq = (torch.where(keep, lids, -1).amax(1) + 1).int()
    code = (lids << 7 | rows)[keep]
    if code.numel() >= 2**31:
        raise ValueError('K2 indexes the edges with int32')
    ptr = torch.zeros(edge_meta.shape[0] + 1, dtype=torch.int64,
                      device=edge_meta.device)
    torch.cumsum(keep.sum(1), 0, out=ptr[1:])
    w = None
    if weighted:
        w = torch.gather(edge_meta[:, 2, :], 1, order)[keep].view(
            torch.float32)
    return ColdEdges(ptr=ptr.int(), code=code, w=w, num_uniq=num_uniq)


def hot_list(plan: DedupSpmmPlan) -> HotList:
    """The row list of ``plan.hot_w``'s non-zeros, on its device, derived
    with tensor ops on first use and cached per ``hot_w`` and
    ``hot_cols`` (:func:`_cached`). The plan itself is left as the JAX
    package builds it."""
    return _cached('hot', (plan.hot_w, plan.hot_cols), _derive_hot_list)


def cold_edges(plan: DedupSpmmPlan) -> ColdEdges:
    """``plan.edge_meta``'s real edges, each chunk's sorted by row and
    packed, on its device; derived and cached like :func:`hot_list`."""
    return _cached(('cold', plan.weighted), (plan.edge_meta, ),
                   lambda meta: _derive_cold_edges(meta, plan.weighted))


def cold_pass_fits(plan: DedupSpmmPlan, x_dtype: torch.dtype) -> bool:
    """Whether K2's cold pass fits a block's shared memory for ``plan``
    and an ``x`` of ``x_dtype`` at its narrowest, 32 features and one slab
    of unique rows (``cold_smem`` in ``csrc/spmm_dedup.cu``). Unweighted
    with ``uc == ec``, f32 fits up to 1,496 and bf16 up to 2,696."""
    item = torch.empty((), dtype=x_dtype).element_size()
    smem = (TR * 32 * 4 + plan.uc * 32 * item + 2 * plan.uc * 4 +
            2 * (2 if plan.weighted else 1) * plan.ec * 4)
    return smem <= K2_MAX_SMEM


def _k2_lib():
    lib = _build.load('spmm_dedup')
    fn = lib.pygt_dedup_sum
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, i, i, vp, vp, vp, vp, i, vp, vp, vp,
                       vp, vp, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def dedup_sum(x: torch.Tensor, plan: DedupSpmmPlan,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 (K2h for a hot plan): ``out[r] = scale * (Σ_e w_e x[col_e] +
    Σ_h hot_w[r, h] x[hot_cols[h]])`` as ``[num_rows, F]`` f32.

    ``x`` is f32, bf16 or int8. A CUDA ``x`` launches the kernel (and
    raises on anything it does not take); a CPU ``x`` runs
    :func:`dedup_sum_plain`. The kernels read the chunk edges from
    :func:`cold_edges` and K2h the hot term from :func:`hot_list`, both
    derived from the plan once and cached. ``dedup_sum.launches`` and
    ``dedup_sum.hot_launches`` count the calls of K2 and K2h, one per call
    whatever the number of CUDA launches in it.
    """
    if not x.is_cuda:
        return dedup_sum_plain(x, plan, scale)
    dev = x.device
    if x.dim() != 2 or x.dtype not in DTYPE_CODE:
        raise ValueError(f'x must be a 2-D f32/bf16/int8 tensor, got '
                         f'{x.dtype} of shape {tuple(x.shape)}')
    f = x.shape[1]
    c = plan.num_chunks
    num_tiles = max(-(-plan.num_rows // TR), 1)
    _check_cuda('x', x, x.dtype, device=dev)
    _check_cuda('uniq_cols', plan.uniq_cols, torch.int32, (c * plan.uc, ),
                dev)
    _check_cuda('edge_meta', plan.edge_meta, torch.int32,
                (c, META_SUB, plan.ec), dev)
    _check_cuda('chunk_tile', plan.chunk_tile, torch.int32, (c, ), dev)
    hot = plan.num_hot > 0
    if hot:
        _check_cuda('hot_cols', plan.hot_cols, torch.int32,
                    (plan.num_hot, ), dev)
        _check_cuda('hot_w', plan.hot_w, plan.hot_w.dtype,
                    (num_tiles * TR, plan.num_hot), dev)
        hl = hot_list(plan)
    if scale is not None:
        _check_cuda('scale', scale, torch.float32, (f, ), dev)
    if x.shape[0] >= 2**31 or plan.uc >= 2**24:
        raise ValueError('K2 indexes rows with int32 and unique ids with '
                         '24 bits')
    if not cold_pass_fits(plan, x.dtype):
        raise ValueError(f'K2 cannot hold a chunk of uc={plan.uc} unique '
                         f'rows and ec={plan.ec} edges of {x.dtype} x in '
                         f'shared memory; build the plan with a smaller uc '
                         f'or ec')
    edges = cold_edges(plan)
    # Not zero-filled: the kernel writes every row.
    out = torch.empty((plan.num_rows, f), dtype=torch.float32, device=dev)
    if plan.num_rows == 0 or f == 0:
        return out
    with torch.cuda.device(dev):
        err = _k2_lib()(
            x.data_ptr(), DTYPE_CODE[x.dtype], plan.uniq_cols.data_ptr(),
            plan.chunk_tile.data_ptr(), c, plan.uc, edges.ptr.data_ptr(),
            edges.code.data_ptr(),
            None if edges.w is None else edges.w.data_ptr(),
            edges.num_uniq.data_ptr(), plan.ec,
            hl.ptr.data_ptr() if hot else None,
            hl.src.data_ptr() if hot else None,
            hl.val.data_ptr() if hot else None,
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            plan.num_rows, f,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K2 (spmm_dedup.cu) launch failed: CUDA error '
                           f'{err}')
    if hot:
        dedup_sum.hot_launches += 1
    else:
        dedup_sum.launches += 1
    return out


dedup_sum.launches = 0
dedup_sum.hot_launches = 0


def dedup_plan_apply(x: torch.Tensor, plan: DedupSpmmPlan,
                     precision: Optional[str] = None) -> torch.Tensor:
    """``out[r] = Σ_{e in row r} w_e · x[col[e]]`` via the dedup schedule.

    ``precision`` as in ``spmm_plan_apply``: ``'bf16'`` reads bfloat16
    rows, ``'int8'`` quantises ``x`` per feature column (an int8 ``x`` is
    taken as already quantised and its raw f32 sums are returned).
    """
    if precision == 'int8':
        if x.dtype == torch.int8:
            return dedup_sum(x, plan)
        xq, scale = quantize_columns(x)
        return dedup_sum(xq, plan, scale).to(x.dtype)
    xm = x.to(torch.bfloat16) if precision == 'bf16' else x
    return dedup_sum(xm.contiguous(), plan).to(x.dtype)
