"""GIN, EdgeConv (DGCNN), the PointNet++ set abstraction and node2vec's
loss (port of ``pyg_lib_tpu.models.extra``: ``init_gin``,
``gin_forward``, ``init_edgeconv``, ``edgeconv_forward``,
``init_pointnet_sa``, ``pointnet_sa_forward``, ``init_node2vec``,
``node2vec_loss``).

* GIN sums its neighbours with ``segment_sum_csr`` (kernel K3 on the card);
* EdgeConv max-pools densely over each node's ``k`` neighbours of a
  ``knn`` graph (``torch.amax``, which splits the gradient among ties as
  JAX's ``max`` does);
* the PointNet++ set abstraction pools each centroid's group with
  ``segment_max_csr`` (kernel K4 over a cached plan from 65,536 grouped
  points up); its grouping comes from ``fps`` (kernel F1) and ``radius``;
* node2vec's skip-gram loss with negative sampling over given walks.

Parameters are the JAX package's trees with tensors for arrays: an MLP is
a list ``[{'w': [in, out], 'b': [out]}, ...]``; GIN ``{'layers': [{'mlp':
MLP, 'eps': []}, ...]}``, EdgeConv ``{'layers': [{'mlp': MLP}, ...]}``,
the set abstraction ``{'mlp': MLP}`` and node2vec ``{'emb': [N, D]}``, so
converted JAX weights (``*_params_from_jax``) and a module's weights run
through the same functional forwards.
"""

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from pyg_lib_tpu_torch.models.gnn import _gather_src, _glorot
from pyg_lib_tpu_torch.ops import segment_max_csr, segment_sum_csr
from pyg_lib_tpu_torch.utils import _resolve_device, indptr_to_index

__all__ = ['GIN', 'EdgeConv', 'PointNetSA', 'edgeconv_forward',
           'edgeconv_params_from_jax', 'gin_forward', 'gin_params_from_jax',
           'init_edgeconv', 'init_gin', 'init_node2vec', 'init_pointnet_sa',
           'node2vec_loss', 'node2vec_params_from_jax',
           'pointnet_sa_forward', 'pointnet_sa_params_from_jax']


def _init_mlp(dims, generator, device) -> List[Dict]:
    return [{'w': _glorot(fan_in, fan_out, generator, device),
             'b': torch.zeros(fan_out, device=device)}
            for fan_in, fan_out in zip(dims[:-1], dims[1:])]


def _mlp(layers, h: torch.Tensor) -> torch.Tensor:
    """Linear layers with a ReLU between them (none after the last)."""
    for i, layer in enumerate(layers):
        h = h @ layer['w'] + layer['b']
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _mlp_from_jax(layers, device) -> List[Dict]:
    return [{'w': _tensor(l['w'], device), 'b': _tensor(l['b'], device)}
            for l in layers]


class _Module(nn.Module):
    """A module that holds a parameter tree: every tensor of ``tree``
    becomes a parameter named by its path (``layers_0_mlp_1_w``), and
    :meth:`params` gives the tree back with them."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._spec = self._flatten(tree, ())

    def _flatten(self, node, path):
        if isinstance(node, torch.Tensor):
            name = '_'.join(map(str, path))
            self.register_parameter(name, nn.Parameter(node))
            return name
        if isinstance(node, dict):
            return {k: self._flatten(v, path + (k, ))
                    for k, v in node.items()}
        return [self._flatten(v, path + (i, )) for i, v in enumerate(node)]

    def _unflatten(self, spec):
        if isinstance(spec, str):
            return getattr(self, spec)
        if isinstance(spec, dict):
            return {k: self._unflatten(v) for k, v in spec.items()}
        return [self._unflatten(v) for v in spec]

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return self._unflatten(self._spec)


# -- GIN ----------------------------------------------------------------------


def init_gin(dims: List[int], hidden_mult: int = 2,
             generator: Optional[torch.Generator] = None,
             device=None) -> Dict:
    """``dims = [in, hidden..., out]``; each GIN layer owns an MLP
    ``[in, hidden_mult · out, out]`` (Glorot-uniform from ``generator``,
    zero biases) and a learnable ``eps`` (0), as ``init_gin``."""
    device = _resolve_device(device)
    return {'layers': [{
        'mlp': _init_mlp([fan_in, hidden_mult * fan_out, fan_out], generator,
                         device),
        'eps': torch.zeros((), device=device)}
        for fan_in, fan_out in zip(dims[:-1], dims[1:])]}


def gin_forward(params: Dict, x: torch.Tensor, rowptr: torch.Tensor,
                row: torch.Tensor) -> torch.Tensor:
    """``h = MLP((1 + eps) · h + Σ_{j∈N(i)} h_j)`` per layer, a ReLU
    between layers; the sum by ``segment_sum_csr`` (K3 on the card). A
    batch as ``models.gnn``'s: pad edges sit past ``rowptr[-1]``."""
    h = x
    layers = params['layers']
    for i, layer in enumerate(layers):
        agg = segment_sum_csr(_gather_src(h, row), rowptr)[:h.shape[0]]
        h = _mlp(layer['mlp'], (1.0 + layer['eps']) * h + agg)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def gin_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's GIN tree (``init_gin``; arrays as numpy or
    anything ``np.asarray`` takes) into the port's parameters: f32
    tensors on ``device`` (default: the CUDA card)."""
    device = _resolve_device(device)
    return {'layers': [{'mlp': _mlp_from_jax(l['mlp'], device),
                        'eps': _tensor(l['eps'], device)}
                       for l in tree['layers']]}


class GIN(_Module):
    """GIN over a CSR batch (:func:`gin_forward`), weights as
    :func:`init_gin` draws them."""

    def __init__(self, dims: List[int], hidden_mult: int = 2,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_gin(dims, hidden_mult, generator, device))

    def forward(self, x: torch.Tensor, rowptr: torch.Tensor,
                row: torch.Tensor) -> torch.Tensor:
        return gin_forward(self.params(), x, rowptr, row)


# -- EdgeConv / DGCNN ---------------------------------------------------------


def init_edgeconv(dims: List[int], hidden_mult: int = 1,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Dict:
    """One MLP ``[2 · in, hidden_mult · out, out]`` per EdgeConv layer over
    ``[h_i, h_j - h_i]``, as ``init_edgeconv``."""
    device = _resolve_device(device)
    return {'layers': [{
        'mlp': _init_mlp([2 * fan_in, hidden_mult * fan_out, fan_out],
                         generator, device)}
        for fan_in, fan_out in zip(dims[:-1], dims[1:])]}


def edgeconv_forward(params: Dict, x: torch.Tensor, knn_idx: torch.Tensor,
                     k: int) -> torch.Tensor:
    """DGCNN EdgeConv: ``h_i = max_{j∈knn(i)} MLP([h_i, h_j − h_i])``.

    ``knn_idx`` is ``ops.knn(x, x, k)``'s ``[2, N·k]`` (row 1 the
    neighbours, ``k`` per node in query order), so the max pools densely
    over an ``[N, k, F]`` view; the graph is the same for every layer.
    """
    n = x.shape[0]
    nbr = knn_idx[1].reshape(n, k)
    h = x
    for layer in params['layers']:
        hj = h[nbr]  # [N, k, F]
        hi = h[:, None, :]
        edge = torch.cat([hi.expand_as(hj), hj - hi], dim=-1)
        h = torch.amax(_mlp(layer['mlp'], edge), dim=1)
    return h


def edgeconv_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's EdgeConv tree (``init_edgeconv``) into the
    port's parameters: f32 tensors on ``device`` (default: the CUDA
    card)."""
    device = _resolve_device(device)
    return {'layers': [{'mlp': _mlp_from_jax(l['mlp'], device)}
                       for l in tree['layers']]}


class EdgeConv(_Module):
    """EdgeConv layers over a static ``knn`` graph
    (:func:`edgeconv_forward`), weights as :func:`init_edgeconv` draws
    them."""

    def __init__(self, dims: List[int], hidden_mult: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_edgeconv(dims, hidden_mult, generator, device))

    def forward(self, x: torch.Tensor, knn_idx: torch.Tensor,
                k: int) -> torch.Tensor:
        return edgeconv_forward(self.params(), x, knn_idx, k)


# -- PointNet++ set abstraction -----------------------------------------------


def init_pointnet_sa(in_dim: int, mlp_dims: List[int],
                     generator: Optional[torch.Generator] = None,
                     device=None) -> Dict:
    """One set-abstraction level: an MLP ``[in_dim + 3, *mlp_dims]`` over
    each grouped point's relative position and features, as
    ``init_pointnet_sa``."""
    return {'mlp': _init_mlp([in_dim + 3] + list(mlp_dims), generator,
                             _resolve_device(device))}


def pointnet_sa_forward(params: Dict, pos: torch.Tensor,
                        feat: Optional[torch.Tensor],
                        centroid_idx: torch.Tensor, rowptr: torch.Tensor,
                        col: torch.Tensor):
    """PointNet++ set abstraction on a grouping built beforehand:
    ``centroid_idx`` from ``ops.fps``, ``(rowptr, col)`` the CSR over the
    centroids of ``ops.radius(pos, pos[centroid_idx], r, cap)``'s pairs
    (pad entries past ``rowptr[-1]``). Each centroid's row is the max of
    ``MLP([pos_j − pos_i, feat_j])`` over its group by
    ``segment_max_csr`` (0 for an empty group).

    Returns ``(new_pos [M, 3], new_feat [M, mlp_dims[-1]])``.
    """
    m = centroid_idx.shape[0]
    cpos = pos[centroid_idx.long()]
    owner = indptr_to_index(rowptr, col.shape[0]).long().clamp(0, m - 1)
    rel = _gather_src(pos, col) - cpos[owner]
    h = rel if feat is None else torch.cat([rel, _gather_src(feat, col)],
                                           dim=-1)
    h = _mlp(params['mlp'], h)
    return cpos, segment_max_csr(h, rowptr)[0][:m]


def pointnet_sa_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's set-abstraction tree (``init_pointnet_sa``)
    into the port's parameters: f32 tensors on ``device`` (default: the
    CUDA card)."""
    return {'mlp': _mlp_from_jax(tree['mlp'], _resolve_device(device))}


class PointNetSA(_Module):
    """One PointNet++ set-abstraction level (:func:`pointnet_sa_forward`),
    weights as :func:`init_pointnet_sa` draws them."""

    def __init__(self, in_dim: int, mlp_dims: List[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(init_pointnet_sa(in_dim, mlp_dims, generator,
                                          device))

    def forward(self, pos, feat, centroid_idx, rowptr, col):
        return pointnet_sa_forward(self.params(), pos, feat, centroid_idx,
                                   rowptr, col)


# -- node2vec -----------------------------------------------------------------


def init_node2vec(num_nodes: int, dim: int,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Dict:
    """An embedding table of standard normals scaled by ``1/sqrt(dim)``."""
    emb = torch.randn((num_nodes, dim), generator=generator) / dim**0.5
    return {'emb': emb.to(_resolve_device(device))}


def node2vec_loss(params: Dict, walks: torch.Tensor, neg: torch.Tensor,
                  window: int = 2) -> torch.Tensor:
    """Skip-gram with negative sampling over random walks ``[B, L+1]`` and
    negatives ``[B, num_neg]``: the mean of ``-log σ(z_u·z_v)`` over the
    pairs ``(walk[t], walk[t+d])`` for each ``d`` in ``1..window`` and of
    ``-log σ(-z_u·z_n)`` for the walk's first node against its
    negatives, averaged over the ``window + 1`` terms."""
    emb = params['emb']
    z = emb[walks.long()]  # [B, L+1, D]
    loss = 0.0
    for d in range(1, window + 1):
        logits = (z[:, :-d] * z[:, d:]).sum(-1)
        loss = loss - torch.nn.functional.logsigmoid(logits).mean()
    neg_logits = (z[:, 0:1, :] * emb[neg.long()]).sum(-1)
    loss = loss - torch.nn.functional.logsigmoid(-neg_logits).mean()
    return loss / (window + 1)


def node2vec_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's node2vec tree (``init_node2vec``) into the
    port's parameters: an f32 tensor on ``device`` (default: the CUDA
    card)."""
    return {'emb': _tensor(tree['emb'], _resolve_device(device))}
