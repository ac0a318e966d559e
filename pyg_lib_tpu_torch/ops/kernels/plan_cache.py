"""Per-``indptr`` cache of layout-only chunked plans.

Port of ``pyg_lib_tpu/ops/pallas/plan_cache.py``. The planned
``segment_{min,max}_csr`` path needs a host-built :class:`SpmmPlan` (with
edge maps; its column ids are unused zeros) for each ``indptr``. Plans
cost O(E) to build, so they are cached: keyed on identity for a numpy
buffer (and checked against a stored copy, so a buffer changed in place
is rebuilt), and on content for a tensor or a list, whose host copy is
new on every call.
"""

import hashlib

import numpy as np
import torch

from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (SpmmPlan,
                                                        build_spmm_plan)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['plan_for_ptr', 'plan_key']

_CACHE: dict = {}
_MAX_ENTRIES = 8


def plan_key(ptr, ptr_np: np.ndarray):
    """The cache key of ``ptr``, whose host copy is ``ptr_np``."""
    if isinstance(ptr, np.ndarray):
        return ('id', ptr_np.ctypes.data, ptr_np.shape[0])
    return ('sha', hashlib.sha1(ptr_np.tobytes()).hexdigest(),
            ptr_np.shape[0])


def _host(ptr) -> np.ndarray:
    if isinstance(ptr, torch.Tensor):
        return ptr.detach().cpu().numpy()
    return np.asarray(ptr)


def plan_for_ptr(ptr, chunk: int = 512, device=None) -> SpmmPlan:
    """The cached layout-only plan (``with_edge_maps=True``) of one
    ``indptr``, with its tensors on ``device`` (default: ``ptr``'s device
    for a tensor, else the CUDA card)."""
    if device is None and isinstance(ptr, torch.Tensor):
        device = ptr.device
    device = _resolve_device(device)
    ptr_np = _host(ptr)
    key = (plan_key(ptr, ptr_np), chunk, device)
    hit = _CACHE.get(key)
    if hit is not None and np.array_equal(hit[1], ptr_np):
        return hit[0]
    e = int(ptr_np[-1])
    plan = build_spmm_plan(ptr_np, np.zeros(e, np.int32), chunk=chunk,
                           with_edge_maps=True, device=device)
    if key not in _CACHE and len(_CACHE) >= _MAX_ENTRIES:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = (plan, ptr_np.copy())
    return plan
