"""Full-graph GCN over a planned graph (port of
``pyg_lib_tpu.models.gnn.init_gcn`` / ``gcn_forward_spmm``).

Parameters are ``{'layers': [{'w': [in, out], 'b': [out]}, ...]}``, the
JAX package's tree with tensors for arrays, so converted JAX weights
(:func:`gcn_params_from_jax`) and a :class:`GCN` module's weights run
through the same functional forward.
"""

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from pyg_lib_tpu_torch.ops import spmm
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['GCN', 'gcn_forward_spmm', 'gcn_params_from_jax']


def gcn_forward_spmm(params: Dict, x: torch.Tensor, graph) -> torch.Tensor:
    """Kipf-Welling GCN with symmetric degree normalisation, aggregating
    with the planned :func:`~pyg_lib_tpu_torch.ops.spmm` over ``graph``
    (a :class:`~pyg_lib_tpu_torch.ops.SpmmGraph`, whose ``deg`` supplies
    the degrees)."""
    inv_sqrt = torch.rsqrt(graph.deg.to(x.dtype).clamp(min=1.0))[:, None]
    layers = params['layers']
    for i, layer in enumerate(layers):
        h = x @ layer['w']
        agg = spmm(h * inv_sqrt, graph)
        x = agg * inv_sqrt + h * inv_sqrt**2 + layer['b']
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def gcn_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's GCN tree (``init_gcn``; arrays as numpy or
    anything ``np.asarray`` takes) into the port's parameters: f32
    tensors on ``device`` (default: the CUDA card)."""
    device = _resolve_device(device)
    return {'layers': [{
        k: torch.tensor(np.asarray(layer[k], dtype=np.float32), device=device)
        for k in ('w', 'b')
    } for layer in tree['layers']]}


class GCN(nn.Module):
    """GCN over a planned graph, ``dims = [in, hidden..., out]``.

    Weights are Glorot-uniform from ``generator`` and biases zero, as in
    ``init_gcn``.
    """

    def __init__(self, dims: List[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = _resolve_device(device)
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            limit = (6.0 / (fan_in + fan_out))**0.5
            w = torch.rand((fan_in, fan_out), generator=generator)
            self.w.append(nn.Parameter(((2 * w - 1) * limit).to(device)))
            self.b.append(nn.Parameter(torch.zeros(fan_out, device=device)))

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return {'layers': [{'w': w, 'b': b} for w, b in zip(self.w, self.b)]}

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        return gcn_forward_spmm(self.params(), x, graph)
