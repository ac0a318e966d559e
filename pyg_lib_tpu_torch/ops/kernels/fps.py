"""Greedy farthest point sampling of every cloud of a batch, kernel F1
(``csrc/fps.cu``).

F1 replaces the XLA loop of ``pyg_lib_tpu/ops/geometry.py`` ``_fps_one``
(no Pallas counterpart): for each cloud ``c`` of ``clouds``, a row
``(lo, n, m, start)`` naming the points ``pos[lo:lo + n]``, the ``m``
greedy picks starting from ``start``, each the point farthest from those
picked so far (its running minimum squared distance the largest, the
lowest index among equal ones), returned as ``lo + pick`` in int32, the
clouds' picks one after the other.

The squared distance is summed left to right over the coordinates, each
difference, square and sum rounded once: F1 does the same arithmetic in
the same order, so its indices equal :func:`fps_plain`'s exactly, and
``jnp.argmax``'s lowest-index rule holds in both.

:func:`fps_kernel` is the wrapper: one launch of F1 for all clouds on a
CUDA ``pos``, the plain PyTorch version on a CPU ``pos``;
``fps_kernel.launches`` counts the launches. F1 has three tiers, and a
batch takes the one its largest cloud needs (:func:`_f1_plan`): S, one
block a cloud with its points in registers (points of 3 coordinates
only); C, a thread-block cluster a cloud with its slices in the blocks'
shared memory; G, the same cluster streaming the slices from device
memory. :func:`fps_floor` times F1's
chain of argmaxes alone, in the tier's form.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import _check_cuda

__all__ = ['F1Plan', 'active_clusters', 'fps_floor', 'fps_kernel',
           'fps_plain']

# Threads of a block in tiers S, C and G: the source's F1_S_THREADS,
# F1_C_THREADS and F1_G_THREADS (a launch with others is refused).
S_THREADS = 256
C_THREADS = 512
G_THREADS = 1024
# The one D whose points the kernels hold in registers (the source's
# REG_D: a point cloud's), the register points a tier-S thread may hold,
# and the register floats it gives them: ITEMS * (REG_D + 1) <= S_REGS.
REG_D = 3
ITEMS = (1, 2, 4, 8, 16)
S_REGS = 64
# Cluster sizes of tiers C and G.
CLUSTERS = (2, 4, 8, 16)
# Shared memory a block may hold (232,448 B on sm_90), less 2 KB for the
# kernel's own arrays.
SMEM_BLOCK = 232_448
SMEM_MAX = SMEM_BLOCK - 2_048
TIERS = {'S': 0, 'C': 1, 'G': 2}


class F1Plan(NamedTuple):
    """F1's launch for a batch: ``tier`` ``'S'``, ``'C'`` or ``'G'``, the
    blocks a cloud (``cluster``, 1 in tier S), ``threads`` a block, the
    points a thread holds in registers (tier S; 0 in C and G, whose
    threads walk their slice), and the dynamic shared memory of a block
    in bytes."""
    tier: str
    cluster: int
    threads: int
    items: int
    smem_bytes: int


def _f1_plan(n_max: int, dim: int) -> F1Plan:
    """F1's tier for a batch whose largest cloud has ``n_max`` points of
    ``dim`` coordinates: S where a block's registers hold the cloud
    (``dim == REG_D``), else C with the smallest cluster whose slices of
    ``ceil(n_max / C)`` points (their coordinates and distances) fit
    ``SMEM_MAX``, else G with 16 blocks streaming their slices. Pure
    Python: the CPU tests check it."""
    if dim == REG_D:
        cap = max(k for k in ITEMS if k * (REG_D + 1) <= S_REGS)
        if n_max <= S_THREADS * cap:
            items = next(k for k in ITEMS if S_THREADS * k >= n_max)
            return F1Plan('S', 1, S_THREADS, items, 0)
    # Any other D passes the winner's coordinates through shared memory.
    extra = 0 if dim == REG_D else 4 * dim
    for c in CLUSTERS:
        smem = 4 * (dim + 1) * _ceil(n_max, c) + extra
        if smem <= SMEM_MAX:
            return F1Plan('C', c, C_THREADS, 0, smem)
    return F1Plan('G', CLUSTERS[-1], G_THREADS, 0, extra)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _batch_plan(clouds: np.ndarray, dim: int) -> F1Plan:
    """The plan of a batch: its largest cloud's."""
    return _f1_plan(int(clouds[:, 1].max()), dim)


def _steps_plain(pts: torch.Tensor, m: int, start: int) -> torch.Tensor:
    n, d = pts.shape
    dist = torch.full((n, ), float('inf'), dtype=pts.dtype,
                      device=pts.device)
    picks = torch.empty(m, dtype=torch.int64, device=pts.device)
    picks[0] = start
    last = pts[start]
    for i in range(1, m):
        sq = pts - last
        sq = sq * sq
        dd = sq[:, 0]
        for j in range(1, d):
            dd = dd + sq[:, j]
        dist = torch.minimum(dist, dd)
        pick = torch.argmax(dist)
        picks[i] = pick
        last = pts[pick]
    return picks


def fps_plain(pos: torch.Tensor, clouds: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version of F1: the greedy loop of each cloud, one
    after the other (``torch.argmax`` takes the first of equal maxima)."""
    out = [(_steps_plain(pos[lo:lo + n], int(m), int(start)) + lo)
           for lo, n, m, start in np.asarray(clouds, np.int64).tolist()]
    if not out:
        return torch.zeros((0, ), dtype=torch.int32, device=pos.device)
    return torch.cat(out).to(torch.int32)


def _f1_lib(name='pygt_fps'):
    fn = getattr(_build.load('fps'), name)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            'pygt_fps': [vp, i, vp, i, vp, vp, i, i, i, i, i, vp],
            'pygt_fps_floor': [vp, i, vp, i, i, i, vp],
            'pygt_fps_active_clusters': [i, i, i, i,
                                         ctypes.POINTER(ctypes.c_int)]}[name]
        fn.restype = ctypes.c_int
    return fn


def _table(clouds: np.ndarray, dev: torch.device) -> torch.Tensor:
    """F1's ``[B, 5]`` int64 table of rows ``(lo, n, m, start, off)``,
    ``off`` the first output slot of each cloud, on ``dev``. The copy does
    not wait for the stream (a blocking copy synchronises it, so each call
    would wait for the kernel before); CUDA stages the pageable
    source before the call returns."""
    m = clouds[:, 2]
    off = np.concatenate([[0], np.cumsum(m)[:-1]])
    return torch.from_numpy(np.concatenate([clouds, off[:, None]], 1)).to(
        dev, non_blocking=True)


_active = {}


def active_clusters(plan: F1Plan, dim: int, dev: torch.device) -> int:
    """How many of ``plan``'s clusters (tier C or G, points of ``dim``
    coordinates) the card ``dev`` holds at once, by
    ``cudaOccupancyMaxActiveClusters``, asked once per plan. Raises if it
    holds none: F1 has no other form for such a cloud."""
    dev = torch.device(dev)
    key = (dev.index, dim, plan)
    if key not in _active:
        got = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = _f1_lib('pygt_fps_active_clusters')(
                dim, TIERS[plan.tier], plan.cluster, plan.smem_bytes,
                ctypes.byref(got))
        if err != 0:
            raise RuntimeError(f'F1 (fps.cu) occupancy query failed: CUDA '
                               f'error {err}')
        _active[key] = got.value
    if _active[key] == 0:
        raise RuntimeError(
            f'F1: the card holds no cluster of {plan.cluster} blocks of '
            f'{plan.threads} threads with {plan.smem_bytes} B of shared '
            f'memory each (tier {plan.tier})')
    return _active[key]


def fps_kernel(pos: torch.Tensor, clouds: np.ndarray) -> torch.Tensor:
    """F1: the farthest-point picks of every cloud of ``clouds`` (a host
    ``[B, 4]`` int64 array of rows ``(lo, n, m, start)``, ``n >= 1``,
    ``m >= 1``, ``0 <= start < n``) over ``pos [N, D]`` f32, as one int32
    tensor of ``Σ m`` global indices.

    A CUDA ``pos`` launches the kernel once for the whole batch, in the
    tier :func:`_f1_plan` gives its largest cloud (and raises on anything
    it does not take, or where the card cannot hold the tier's cluster);
    a CPU ``pos`` runs :func:`fps_plain`.
    """
    clouds = np.asarray(clouds, np.int64).reshape(-1, 4)
    if not pos.is_cuda:
        return fps_plain(pos, clouds)
    dev = pos.device
    if pos.dim() != 2 or pos.shape[1] < 1:
        raise ValueError(f'pos must be [N, D] with D >= 1, got shape '
                         f'{tuple(pos.shape)}')
    _check_cuda('pos', pos, torch.float32, device=dev)
    lo, n, m, start = clouds.T
    if pos.shape[0] >= 2**31:
        raise ValueError('F1 indexes points with int32')
    if clouds.shape[0] and ((n < 1).any() or (m < 1).any() or
                            (start < 0).any() or (start >= n).any() or
                            (lo < 0).any() or (lo + n > pos.shape[0]).any()):
        raise ValueError('every cloud needs 1 <= n, 1 <= m, 0 <= start < n '
                         'and its points inside pos')
    total = int(m.sum())
    out = torch.empty(total, dtype=torch.int32, device=dev)
    if clouds.shape[0] == 0:
        return out
    dim = pos.shape[1]
    plan = _batch_plan(clouds, dim)
    if plan.tier != 'S':
        active_clusters(plan, dim, dev)
    table = _table(clouds, dev)
    scratch = torch.empty(pos.shape[0] if plan.tier == 'G' else 0,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _f1_lib()(pos.data_ptr(), dim, table.data_ptr(),
                        clouds.shape[0], out.data_ptr(), scratch.data_ptr(),
                        TIERS[plan.tier], plan.cluster, plan.threads,
                        plan.items, plan.smem_bytes,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'F1 (fps.cu) launch failed: CUDA error {err}')
    fps_kernel.launches += 1
    return out


fps_kernel.launches = 0


def fps_floor(clouds: np.ndarray, dev: torch.device,
              dim: int = 3) -> torch.Tensor:
    """F1's latency floor, for measurement only: one launch that runs, for
    each cloud of ``clouds`` (as :func:`fps_kernel` takes them, points of
    ``dim`` coordinates), the same ``m - 1`` dependent argmaxes as F1 in
    the form of the tier :func:`_f1_plan` picks, with no distance work:
    one block a cloud for tier S, one cluster of the plan's size for C
    and G (block argmax, slot, cluster barrier, the C slots and the
    winner's owner read through distributed shared memory). Returns its
    ``Σ m`` winners (int32, of no use but to wait for). No path calls it,
    so it counts no launch."""
    clouds = np.asarray(clouds, np.int64).reshape(-1, 4)
    plan = _batch_plan(clouds, dim)
    out = torch.empty(int(clouds[:, 2].sum()), dtype=torch.int32,
                      device=dev)
    table = _table(clouds, dev)
    with torch.cuda.device(dev):
        err = _f1_lib('pygt_fps_floor')(
            table.data_ptr(), clouds.shape[0], out.data_ptr(),
            TIERS[plan.tier], plan.cluster, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'F1 floor (fps.cu) launch failed: CUDA error '
                           f'{err}')
    return out
