"""pyg_lib_tpu_torch: the PyTorch + CUDA port of ``pyg_lib_tpu``.

The JAX package stays the reference; this package does the same work in
PyTorch on one NVIDIA Hopper card. Plain tensor code is PyTorch, and each
Pallas kernel of the JAX package becomes a kernel written by hand in CUDA
C++ under ``csrc/``, built with ``nvcc`` at first use (``_build.py``).

Entry points put their tensors on ``cuda`` unless the caller passes
``device='cpu'``. On CPU tensors every kernel wrapper runs its plain
PyTorch version; on CUDA tensors it launches the kernel or raises.

* ``pyg_lib_tpu_torch.ops`` — planned SpMM (``build_spmm_graph``,
  ``spmm``: sum/mean over the chunked, deduplicated and range-split
  plans, exact max/min over the chunked and the dedup min/max plans), the
  CSR segment family (``segment_*_csr``, ``gather_csr``), the
  padded-space primitives, the attention ops (``softmax_csr``,
  ``sddmm``), the scatter family (``scatter_*``), the sorted-COO family
  (``segment_*_coo``, ``gather_coo``), the scatter composites
  (``scatter_softmax``, ``scatter_log_softmax``, ``scatter_std``,
  ``scatter_logsumexp``) and ``fused_scatter_reduce``.
* ``pyg_lib_tpu_torch.models`` — GCN, GraphSAGE (mean, max and
  full-graph max-pool), the full-graph GAT and the padded-batch GAT.
* The host layer: ``sampler`` (neighbour, hetero, subgraph and random
  walk sampling on the C++ engine of ``csrc/host``, built with ``g++`` at
  first use, and the padding of samples into fixed-shape batches),
  ``partition`` (``metis``, ``cluster_reorder``, the mesh partitions),
  ``classes`` (``HashMap``, ``DeviceHashMap``, the stateful samplers),
  ``loader`` (``NeighborLoader``, ``HeteroNeighborLoader``: sampling
  threads, pinned host batches copied to the card one batch ahead),
  ``metrics``, ``datasets``, and ``entry`` (a GraphSAGE forward over one
  sampled batch).
* ``pyg_lib_tpu_torch.parallel`` — ranks of a ``torch.distributed``
  group: meshes, halo aggregation, data-parallel train steps (imported at
  its first use: ``torch.distributed.tensor`` takes about a second to
  import, which every process that imports the package would pay).
* ``profiling`` (the card's roofline, ``trace``, ``measure``) and
  ``checkpoint`` (``save_checkpoint``, ``restore_checkpoint``,
  ``latest_step``).

This package never imports ``jax`` or ``pyg_lib_tpu``.
"""

import importlib

import torch

from pyg_lib_tpu_torch import (checkpoint, classes, datasets, loader, metrics,
                               models, ops, partition, profiling, sampler,
                               utils)
from pyg_lib_tpu_torch._version import __version__
from pyg_lib_tpu_torch.home import get_home_dir, set_home_dir


def cuda_version() -> str:
    """The name of CUDA device 0, or '' when no CUDA device is present.

    Counterpart of ``pyg_lib_tpu.tpu_version()`` and of the reference's
    ``pyg_lib.cuda_version()``: a runtime probe of the accelerator.
    """
    if not torch.cuda.is_available():
        return ''
    return torch.cuda.get_device_name(0)


def __getattr__(name):
    if name == 'parallel':
        return importlib.import_module('pyg_lib_tpu_torch.parallel')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


__all__ = ['__version__', 'checkpoint', 'classes', 'cuda_version',
           'datasets', 'get_home_dir', 'loader', 'metrics', 'models', 'ops',
           'parallel', 'partition', 'profiling', 'sampler', 'set_home_dir',
           'utils']
