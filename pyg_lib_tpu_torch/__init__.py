"""pyg_lib_tpu_torch: the PyTorch + CUDA port of ``pyg_lib_tpu``.

The JAX package stays the reference; this package does the same work in
PyTorch on one NVIDIA Hopper card. Plain tensor code is PyTorch, and each
Pallas kernel of the JAX package becomes a kernel written by hand in CUDA
C++ under ``csrc/``, built with ``nvcc`` at first use (``_build.py``).

Entry points put their tensors on ``cuda`` unless the caller passes
``device='cpu'``. On CPU tensors every kernel wrapper runs its plain
PyTorch version; on CUDA tensors it launches the kernel or raises.

* ``pyg_lib_tpu_torch.ops`` — planned SpMM (``build_spmm_graph``,
  ``spmm``) over the chunked and the deduplicated plans.
* ``pyg_lib_tpu_torch.models`` — full-graph GCN over a planned graph.

This package never imports ``jax`` or ``pyg_lib_tpu``.
"""

import torch

from pyg_lib_tpu_torch import models, ops, utils
from pyg_lib_tpu_torch._version import __version__


def cuda_version() -> str:
    """The name of CUDA device 0, or '' when no CUDA device is present.

    Counterpart of ``pyg_lib_tpu.tpu_version()`` and of the reference's
    ``pyg_lib.cuda_version()``: a runtime probe of the accelerator.
    """
    if not torch.cuda.is_available():
        return ''
    return torch.cuda.get_device_name(0)


__all__ = ['__version__', 'cuda_version', 'models', 'ops', 'utils']
