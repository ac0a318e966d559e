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
"""

import ctypes
from typing import Optional

import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (DTYPE_CODE, PTR_SUB,
                                                        TP, SpmmPlan,
                                                        _check_cuda,
                                                        _padded_rows)

__all__ = ['segment_softmax_planned', 'segment_softmax_plain']


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


def _k6_lib():
    lib = _build.load('segment_softmax')
    fn = lib.pygt_segment_softmax
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, i, i, i, vp]
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
    ``segment_softmax_planned.launches`` counts kernel launches.
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
    if src.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _k6_lib()(src.data_ptr(), DTYPE_CODE[src.dtype],
                        None if index is None else index.data_ptr(),
                        plan.tile_ptr.data_ptr(), out.data_ptr(), num_tiles,
                        e_pad, src.shape[1],
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K6 (segment_softmax.cu) launch failed: CUDA '
                           f'error {err}')
    segment_softmax_planned.launches += 1
    return out


segment_softmax_planned.launches = 0
