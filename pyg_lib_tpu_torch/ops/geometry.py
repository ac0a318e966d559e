"""Point-cloud and clustering ops: ``fps``, ``knn``, ``radius``,
``nearest``, ``grid_cluster``, ``graclus_cluster``, ``edge_sample`` (port
of ``pyg_lib_tpu.ops.geometry``).

The host/device split is the JAX package's: batch pointers are read once
on the host, distances, top-k and argmin run on the input's device per
batch, ragged outputs are assembled on the host, and the sequential
algorithms (``graclus_cluster``, ``edge_sample``) run in numpy with the
same ``np.random.default_rng(seed)`` draws in the same order, so their
results equal the JAX package's. ``fps`` runs all clouds in one launch of
kernel F1 on a CUDA tensor (its plain version on the CPU). Outputs lie on
the input's device. Indices are int64, PyTorch's index type (the JAX
package's int32 where it lacks x64), except ``fps``'s, which stay int32
as ``_fps_one``'s are.
"""

import math

import numpy as np
import torch

from pyg_lib_tpu_torch.ops.kernels.fps import fps_kernel

__all__ = ['edge_sample', 'fps', 'graclus_cluster', 'grid_cluster', 'knn',
           'nearest', 'radius']

# The largest distance tile (query rows × reference points) of one block.
TILE_ELEMENTS = 1 << 24


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """``[N]`` squared norms of the rows, summed left to right."""
    out = x[:, 0] * x[:, 0]
    for d in range(1, x.shape[1]):
        out = out + x[:, d] * x[:, d]
    return out


def _dots(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[N, M]`` dot products summed left to right over the coordinates."""
    out = x[:, None, 0] * y[None, :, 0]
    for d in range(1, x.shape[1]):
        out = out + x[:, None, d] * y[None, :, d]
    return out


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[N, M]`` squared distances ``|x|² + |y|² - 2 x·y`` in f32,
    clamped at 0.

    Each sum runs left to right over the coordinates with one rounding
    per product and per sum, not through a matrix product: a GEMM rounds
    in an order of its own on each device (cuBLAS against the CPU's
    BLAS), which moves neighbours across a k-th distance or a radius. So
    the same inputs give the same distances on the card and on the CPU
    (no TF32 can enter), and the JAX package's HIGHEST-precision dot's
    within f32 rounding.
    """
    x, y = x.float(), y.float()
    return torch.clamp(_sq_norms(x)[:, None] + _sq_norms(y)[None, :] -
                       2.0 * _dots(x, y), min=0.0)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows divided by their norm, the norm guarded at 1e-12 (a zero row
    stays 0)."""
    x = x.float()
    return x / torch.clamp(torch.sqrt(_sq_norms(x)), min=1e-12)[:, None]


def _host_ptr(ptr, n: int) -> np.ndarray:
    if ptr is None:
        return np.array([0, n], dtype=np.int64)
    if isinstance(ptr, torch.Tensor):
        return ptr.detach().cpu().numpy().astype(np.int64)
    return np.asarray(ptr, dtype=np.int64)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _blocks(rows: int, cols: int):
    """Query-row blocks whose distance tile holds at most
    :data:`TILE_ELEMENTS` elements."""
    block = max(1, min(rows, TILE_ELEMENTS // max(cols, 1)))
    return [(i, min(i + block, rows)) for i in range(0, rows, block)]


def _index_pair(rows, cols, device) -> torch.Tensor:
    if not rows:
        return torch.zeros((2, 0), dtype=torch.int64, device=device)
    return torch.from_numpy(np.stack([np.concatenate(rows),
                                      np.concatenate(cols)]).astype(
                                          np.int64)).to(device)


def fps(src: torch.Tensor, ptr, ratio: float = 0.5,
        random_start: bool = True, seed: int = 0) -> torch.Tensor:
    """Farthest point sampling of each cloud ``src[ptr[b]:ptr[b+1]]``:
    ``m = max(1, ceil(ratio · n))`` picks of each non-empty cloud, the
    first at ``rng.integers(n)`` (``np.random.default_rng(seed)``, one
    draw per non-empty cloud in order) or at 0, as int32 global indices,
    the clouds one after the other. One launch of F1 for the whole batch
    on a CUDA ``src``."""
    hptr = _host_ptr(ptr, src.shape[0])
    rng = np.random.default_rng(seed)
    clouds = []
    for b in range(len(hptr) - 1):
        lo, hi = int(hptr[b]), int(hptr[b + 1])
        n = hi - lo
        if n == 0:
            continue
        m = max(1, int(math.ceil(ratio * n)))
        start = int(rng.integers(n)) if random_start else 0
        clouds.append((lo, n, m, start))
    if not clouds:
        return torch.zeros((0, ), dtype=torch.int32, device=src.device)
    return fps_kernel(src.float().contiguous(),
                      np.asarray(clouds, np.int64))


def knn(x: torch.Tensor, y: torch.Tensor, k: int = 1,
        ptr_x=None, ptr_y=None, cosine: bool = False,
        num_workers: int = 1) -> torch.Tensor:
    """For each point of ``y``, the ``min(k, |x_b|)`` nearest points of
    ``x`` in its batch, nearest first and the lower index first among
    equal distances (``lax.top_k``'s order): ``[2, Σ My·kk]`` int64, row 0
    the query, row 1 the reference point. ``cosine`` ranks by ``1 -`` the
    cosine similarity, a zero-norm row's similarity 0."""
    del num_workers
    if k < 1:
        raise ValueError(f'knn needs k >= 1, got {k}')
    hx = _host_ptr(ptr_x, x.shape[0])
    hy = _host_ptr(ptr_y, y.shape[0])
    if len(hx) != len(hy):
        raise ValueError('ptr_x and ptr_y must have equal batch count')
    rows, cols = [], []
    for b in range(len(hx) - 1):
        xs, xe = int(hx[b]), int(hx[b + 1])
        ys, ye = int(hy[b]), int(hy[b + 1])
        if ye - ys == 0 or xe - xs == 0:
            continue
        xb = _unit_rows(x[xs:xe]) if cosine else x[xs:xe]
        kk = min(k, xe - xs)
        parts = []
        for q0, q1 in _blocks(ye - ys, xe - xs):
            yb = y[ys + q0:ys + q1]
            d = (1.0 - _dots(_unit_rows(yb), xb) if cosine else
                 _pairwise_sqdist(yb, xb))
            # A stable sort keeps the lower index first among equal
            # distances; torch.topk gives no order on ties.
            parts.append(torch.sort(d, dim=1, stable=True)[1][:, :kk])
        idx = torch.cat(parts).cpu().numpy() + xs
        rows.append(np.repeat(np.arange(ys, ye), kk))
        cols.append(idx.reshape(-1))
    return _index_pair(rows, cols, x.device)


def radius(x: torch.Tensor, y: torch.Tensor, r: float = 1.0,
           ptr_x=None, ptr_y=None, max_num_neighbors: int = 32,
           num_workers: int = 1,
           ignore_same_index: bool = False) -> torch.Tensor:
    """All points of ``x`` within distance ``r`` of each point of ``y`` in
    its batch, at most ``max_num_neighbors``, the lowest indices first:
    ``[2, P]`` int64, row 0 the query, row 1 the reference point, sorted
    by query and then by reference index. ``ignore_same_index`` drops the
    pair of a query with the reference point of its own global index."""
    del num_workers
    if r < 0:
        raise ValueError(f'radius must be non-negative, got {r} '
                         '(r*r would silently match everything)')
    hx = _host_ptr(ptr_x, x.shape[0])
    hy = _host_ptr(ptr_y, y.shape[0])
    r2 = float(r * r)
    rows, cols = [], []
    for b in range(len(hx) - 1):
        xs, xe = int(hx[b]), int(hx[b + 1])
        ys, ye = int(hy[b]), int(hy[b + 1])
        mx, my = xe - xs, ye - ys
        if my == 0 or mx == 0:
            continue
        kk = min(max_num_neighbors, mx)
        xb = x[xs:xe]
        col = torch.arange(mx, device=x.device)
        # |x| - col is largest at the lowest in-radius column and cannot
        # tie, so topk returns the first kk in-radius columns in order.
        rank = mx - col
        idx, valid = [], []
        for q0, q1 in _blocks(my, mx):
            within = _pairwise_sqdist(y[ys + q0:ys + q1], xb) <= r2
            if ignore_same_index:
                q = torch.arange(ys + q0, ys + q1, device=x.device)
                within &= q[:, None] != (col + xs)[None, :]
            key = torch.where(within, rank, torch.full_like(rank, -1))
            vals, top = torch.topk(key, kk, dim=1)
            idx.append(top)
            valid.append(vals > 0)
        idx = torch.cat(idx).cpu().numpy()
        valid = torch.cat(valid).cpu().numpy()
        q, slot = np.nonzero(valid)
        rows.append(q + ys)
        cols.append(idx[q, slot] + xs)
    return _index_pair(rows, cols, x.device)


def nearest(x: torch.Tensor, y: torch.Tensor, ptr_x=None,
            ptr_y=None) -> torch.Tensor:
    """For each point of ``x``, the index of its nearest point of ``y`` in
    its batch (the lower index among equal distances), int64."""
    hx = _host_ptr(ptr_x, x.shape[0])
    hy = _host_ptr(ptr_y, y.shape[0])
    if len(hx) != len(hy):
        raise ValueError('ptr_x and ptr_y must have equal batch count')
    parts = []
    for b in range(len(hx) - 1):
        xs, xe = int(hx[b]), int(hx[b + 1])
        ys, ye = int(hy[b]), int(hy[b + 1])
        if xe - xs == 0:
            continue
        if ye - ys == 0:
            raise ValueError(
                f'nearest: batch {b} has {xe - xs} query points but an '
                'empty reference segment')
        for q0, q1 in _blocks(xe - xs, ye - ys):
            d = _pairwise_sqdist(x[xs + q0:xs + q1], y[ys:ye])
            parts.append(torch.argmin(d, dim=1).cpu().numpy() + ys)
    if not parts:
        return torch.zeros((0, ), dtype=torch.int64, device=x.device)
    return torch.from_numpy(np.concatenate(parts).astype(np.int64)).to(
        x.device)


def grid_cluster(pos: torch.Tensor, size, start=None,
                 end=None) -> torch.Tensor:
    """Voxel-grid clustering: each point's voxel id over the grid from
    ``start`` (default: the minimum) to ``end`` (default: the maximum) in
    steps of ``size``, the first dimension fastest; int64 throughout (the
    reference's id type, which needs no int32 guard here)."""
    size = torch.as_tensor(size, dtype=pos.dtype, device=pos.device)
    start = (pos.amin(0) if start is None else
             torch.as_tensor(start, dtype=pos.dtype, device=pos.device))
    end = (pos.amax(0) if end is None else
           torch.as_tensor(end, dtype=pos.dtype, device=pos.device))
    num_voxels = torch.floor((end - start) / size).long() + 1
    coords = torch.floor((pos - start) / size).long()
    coords = torch.minimum(torch.clamp(coords, min=0), num_voxels - 1)
    strides = torch.cat([torch.ones(1, dtype=torch.int64, device=pos.device),
                         torch.cumprod(num_voxels[:-1], 0)])
    return (coords * strides).sum(-1)


def graclus_cluster(rowptr, col, weight=None, seed: int = 0) -> torch.Tensor:
    """Greedy randomized heavy-edge matching over the CSR ``(rowptr,
    col)``: nodes in ``np.random.default_rng(seed).permutation`` order,
    each unmatched one matched with its heaviest unmatched neighbour (the
    first among equal weights), cluster id ``min(u, v)``; int64 on
    ``rowptr``'s device. Sequential, on the host."""
    device = rowptr.device if isinstance(rowptr, torch.Tensor) else 'cpu'
    rp, cl = _host(rowptr), _host(col)
    w = None if weight is None else _host(weight)
    n = len(rp) - 1
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    cluster = np.full(n, -1, dtype=np.int64)
    for u in order:
        if cluster[u] >= 0:
            continue
        nbrs = cl[rp[u]:rp[u + 1]]
        wts = None if w is None else w[rp[u]:rp[u + 1]]
        best, best_w = -1, -1.0
        for j, v in enumerate(nbrs):
            if v == u or cluster[v] >= 0:
                continue
            wt = 1.0 if wts is None else float(wts[j])
            if wt > best_w:
                best, best_w = int(v), wt
        if best >= 0:
            cid = min(int(u), best)
            cluster[u] = cid
            cluster[best] = cid
        else:
            cluster[u] = int(u)
    return torch.from_numpy(cluster).to(device)


def edge_sample(start, rowptr, count: int = 0, factor: float = 1.0,
                seed: int = 0) -> torch.Tensor:
    """For each start node, a random subset without replacement of its
    incident edge ids (``count`` of them, or ``ceil(factor · deg)`` when
    ``count < 1``, at most ``deg``), drawn with
    ``np.random.default_rng(seed).choice`` node by node; int64 on
    ``rowptr``'s device. On the host."""
    device = rowptr.device if isinstance(rowptr, torch.Tensor) else 'cpu'
    st, rp = _host(start), _host(rowptr)
    rng = np.random.default_rng(seed)
    out = []
    for v in st:
        lo, hi = int(rp[v]), int(rp[v + 1])
        deg = hi - lo
        if deg == 0:
            continue
        c = count if count >= 1 else int(math.ceil(factor * deg))
        c = min(c, deg)
        out.append(lo + rng.choice(deg, size=c, replace=False))
    if not out:
        return torch.zeros((0, ), dtype=torch.int64, device=device)
    return torch.from_numpy(np.concatenate(out).astype(np.int64)).to(device)
