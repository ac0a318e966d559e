"""Named meshes over the ranks of the default process group (port of
``pyg_lib_tpu/parallel/mesh.py``).

A JAX ``Mesh`` names the axes of an array of devices; here it names the
axes of an array of ranks, with one process group per axis
(``torch.distributed.device_mesh``): ``mesh.get_group('data')`` is the
group of the ranks that differ only along ``data``.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['NamedSharding', 'make_mesh', 'named_sharding']


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ('data', 'model'),
              device=None) -> DeviceMesh:
    """A named mesh over the default group's ranks, in rank order. The
    default shape puts every rank on the first axis (``data``) and size 1
    on the others. ``device`` is the ranks' device type (``'cuda'`` or
    ``'cpu'``; default: the CUDA card, and without one this raises)."""
    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n, ) + (1, ) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f'mesh shape {shape} != {n} devices')
    if len(shape) != len(axis_names):
        raise ValueError(f'mesh shape {shape} has {len(shape)} axes, names '
                         f'{axis_names} {len(axis_names)}')
    return init_device_mesh(_resolve_device(device).type, shape,
                            mesh_dim_names=axis_names)


class NamedSharding(NamedTuple):
    """``spec`` (a ``PartitionSpec``'s entries: per tensor dimension the
    mesh axis it is split over, or ``None``) on ``mesh``, and the DTensor
    ``placements`` that say the same per mesh axis."""
    mesh: DeviceMesh
    spec: tuple
    placements: tuple


def named_sharding(mesh: DeviceMesh, *spec) -> NamedSharding:
    """The sharding of ``P(*spec)`` on ``mesh``: tensor dimension ``i`` is
    split over mesh axis ``spec[i]`` (``Shard(i)`` on that axis), and
    every axis no dimension names holds a full copy (``Replicate()``)."""
    names = mesh.mesh_dim_names
    placements = [Replicate()] * len(names)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in names:
            raise ValueError(f'no mesh axis {axis!r} in {names}')
        i = names.index(axis)
        if not isinstance(placements[i], Replicate):
            raise ValueError(f'mesh axis {axis!r} shards two dimensions')
        placements[i] = Shard(dim)
    return NamedSharding(mesh, tuple(spec), tuple(placements))
