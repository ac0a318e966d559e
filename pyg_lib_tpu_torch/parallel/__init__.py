"""Distribution over ranks: meshes, halo aggregation, train steps (port of
``pyg_lib_tpu.parallel``).

The JAX package runs one program over a device mesh (``shard_map``,
``psum``, ``ppermute``, ``all_gather`` inside ``jit``); here each rank is
a process of a ``torch.distributed`` group and runs its own shard with
explicit collectives:

* :func:`make_mesh`, :func:`named_sharding`: a named mesh over the ranks
  (one process group per axis) and the DTensor placements of a spec;
* :func:`halo_exchange_aggregate`: edge-partitioned aggregation, the
  source rows by one all-gather, summed by ``segment_sum_csr`` (K3);
* :func:`ring_halo_aggregate`: the same sums with source blocks passed
  round a ring, each transfer overlapping the sum of the block before;
* :func:`make_train_step`: a data-parallel (optionally tensor-sharded)
  step with the gradient all-reduced over the ``data`` axis;
* :mod:`~pyg_lib_tpu_torch.parallel.launch`: :func:`spawn` starts the
  ranks (``torch.multiprocessing``, a ``file://`` rendezvous).

CUDA tensors on a gloo group pass through pinned host memory
(``parallel._collectives``); on NCCL they stay on the card.
"""

from pyg_lib_tpu_torch.parallel.halo import (halo_exchange_aggregate,
                                             ring_halo_aggregate)
from pyg_lib_tpu_torch.parallel.launch import spawn
from pyg_lib_tpu_torch.parallel.mesh import make_mesh, named_sharding
from pyg_lib_tpu_torch.parallel.train import make_train_step

__all__ = ['halo_exchange_aggregate', 'make_mesh', 'make_train_step',
           'named_sharding', 'ring_halo_aggregate', 'spawn']
