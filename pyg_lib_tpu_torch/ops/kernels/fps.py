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
``fps_kernel.launches`` counts the launches. :func:`fps_floor` times
F1's chain of block-wide argmaxes alone.
"""

import ctypes

import numpy as np
import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import _check_cuda

__all__ = ['fps_floor', 'fps_kernel', 'fps_plain']

THREADS = 512  # threads of F1's block (one block per cloud)
# Register distances a thread may hold; a larger cloud keeps its
# distances in a global scratch buffer.
ITEMS = (1, 2, 4, 8, 16)


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
        fn.argtypes = ([vp, i, vp, i, vp, vp, i, vp]
                       if name == 'pygt_fps' else [vp, i, vp, vp])
        fn.restype = ctypes.c_int
    return fn


def _table(clouds: np.ndarray, dev: torch.device) -> torch.Tensor:
    """F1's ``[B, 5]`` int64 table of rows ``(lo, n, m, start, off)``,
    ``off`` the first output slot of each cloud, on ``dev``."""
    m = clouds[:, 2]
    off = np.concatenate([[0], np.cumsum(m)[:-1]])
    return torch.from_numpy(np.concatenate([clouds, off[:, None]], 1)).to(
        dev)


def fps_kernel(pos: torch.Tensor, clouds: np.ndarray) -> torch.Tensor:
    """F1: the farthest-point picks of every cloud of ``clouds`` (a host
    ``[B, 4]`` int64 array of rows ``(lo, n, m, start)``, ``n >= 1``,
    ``m >= 1``, ``0 <= start < n``) over ``pos [N, D]`` f32, as one int32
    tensor of ``Σ m`` global indices.

    A CUDA ``pos`` launches the kernel once for the whole batch (and
    raises on anything it does not take); a CPU ``pos`` runs
    :func:`fps_plain`.
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
    table = _table(clouds, dev)
    # The fewest register distances a thread needs for the largest
    # cloud, at most ITEMS[-1]; larger clouds use the scratch.
    items = next((k for k in ITEMS if THREADS * k >= n.max()), ITEMS[-1])
    scratch = torch.empty(pos.shape[0] if n.max() > THREADS * items else 0,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _f1_lib()(pos.data_ptr(), pos.shape[1], table.data_ptr(),
                        clouds.shape[0], out.data_ptr(), scratch.data_ptr(),
                        items, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'F1 (fps.cu) launch failed: CUDA error {err}')
    fps_kernel.launches += 1
    return out


fps_kernel.launches = 0


def fps_floor(clouds: np.ndarray, dev: torch.device) -> torch.Tensor:
    """F1's latency floor, for measurement only: one launch that runs, for
    each cloud of ``clouds`` (as :func:`fps_kernel` takes them), the same
    ``m - 1`` dependent block-wide argmaxes as F1 with no distance work;
    returns its ``Σ m`` winners (int32, of no use but to wait for). No
    path calls it, so it counts no launch."""
    clouds = np.asarray(clouds, np.int64).reshape(-1, 4)
    out = torch.empty(int(clouds[:, 2].sum()), dtype=torch.int32,
                      device=dev)
    table = _table(clouds, dev)
    with torch.cuda.device(dev):
        err = _f1_lib('pygt_fps_floor')(
            table.data_ptr(), clouds.shape[0], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'F1 floor (fps.cu) launch failed: CUDA error '
                           f'{err}')
    return out
