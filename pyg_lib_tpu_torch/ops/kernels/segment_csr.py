"""Sorted segment sum from raw ``(src, indptr)``, kernel K3
(``csrc/segment_csr.cu``).

Port of ``pyg_lib_tpu/ops/pallas/segment_csr_kernel.py``:
``out[r] = Σ src[indptr[r]:indptr[r+1]]`` for a 2-D f32 or bf16 ``src``,
summed in f32 and returned in ``src``'s dtype. Positions outside
``[indptr[0], indptr[-1])`` belong to no row. The TPU kernel takes only
``F % 128 == 0`` (its lane width); K3 takes any ``F``.

:func:`segment_sum_csr_kernel` is the wrapper: K3 for a CUDA tensor, the
plain PyTorch version (:func:`segment_sum_csr_plain`) for a CPU tensor.
"""

import ctypes

import torch

from pyg_lib_tpu_torch import _build
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import DTYPE_CODE, _check_cuda
from pyg_lib_tpu_torch.utils import indptr_to_index

__all__ = ['segment_sum_csr_kernel', 'segment_sum_csr_plain']


def segment_sum_csr_plain(src: torch.Tensor,
                          indptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: each position's row from
    :func:`indptr_to_index`, ``index_add_`` in f32 into a table with one
    extra row at each end for the positions of no row."""
    num_rows = indptr.shape[0] - 1
    ids = indptr_to_index(indptr, src.shape[0]).long() + 1
    out = torch.zeros((num_rows + 2, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    out.index_add_(0, ids, src.float())
    return out[1:num_rows + 1].to(src.dtype)


def _k3_lib():
    lib = _build.load('segment_csr')
    fn = lib.pygt_segment_sum_csr
    if fn.argtypes is None:
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp, i, vp, i64, vp, i64, i, vp]
        fn.restype = ctypes.c_int
    return fn


def segment_sum_csr_kernel(src: torch.Tensor,
                           indptr: torch.Tensor) -> torch.Tensor:
    """K3: ``out[r] = Σ_{e in [indptr[r], indptr[r+1])} src[e]`` as
    ``[R, F]`` in ``src``'s dtype, summed in f32.

    ``src`` is 2-D f32 or bf16, ``indptr`` 1-D (any integer dtype). A CUDA
    ``src`` launches the kernel (and raises on anything it does not take);
    a CPU ``src`` runs :func:`segment_sum_csr_plain`.
    ``segment_sum_csr_kernel.launches`` counts kernel launches.
    """
    if not src.is_cuda:
        return segment_sum_csr_plain(src, indptr)
    dev = src.device
    if src.dim() != 2 or src.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'src must be a 2-D f32/bf16 tensor, got '
                         f'{src.dtype} of shape {tuple(src.shape)}')
    if indptr.dim() != 1 or indptr.device != dev:
        raise ValueError(f'indptr must be 1-D on {dev}, got shape '
                         f'{tuple(indptr.shape)} on {indptr.device}')
    _check_cuda('src', src, src.dtype, device=dev)
    ptr = indptr.to(torch.int64).contiguous()
    num_rows = ptr.shape[0] - 1
    f = src.shape[1]
    out = torch.empty((num_rows, f), dtype=src.dtype, device=dev)
    if num_rows == 0 or f == 0:
        return out
    with torch.cuda.device(dev):
        err = _k3_lib()(src.data_ptr(), DTYPE_CODE[src.dtype], ptr.data_ptr(),
                        src.shape[0], out.data_ptr(), num_rows, f,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'K3 (segment_csr.cu) launch failed: CUDA error '
                           f'{err}')
    segment_sum_csr_kernel.launches += 1
    return out


segment_sum_csr_kernel.launches = 0
