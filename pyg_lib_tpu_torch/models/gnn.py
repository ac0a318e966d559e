"""GNN models of the port: GCN, GraphSAGE and GAT, on a planned graph and
(GCN, GraphSAGE, GAT) on a CSR batch (port of ``pyg_lib_tpu.models.gnn``:
``init_gcn``, ``gcn_forward``, ``gcn_forward_spmm``, ``init_sage``,
``sage_forward``, ``sage_maxpool_forward_spmm``, ``init_gat``,
``gat_forward``, ``init_gat_spmm``, ``gat_forward_spmm``).

Parameters are the JAX package's trees with tensors for arrays:
``{'layers': [{'w': [in, out], 'b': [out]}, ...]}`` for GCN,
``{'layers': [{'w_self', 'w_nbr': [in, out], 'b': [out]}, ...]}`` for
GraphSAGE, ``{'layers': [{'w': [in, heads*out_h], 'a_src', 'a_dst':
[heads, out_h]}, ...]}`` for the planned GAT and ``{'layers': [{'w',
'att_src', 'att_dst': [1, heads, out], 'b'}, ...], 'heads': heads}`` for
the padded-batch GAT, so converted JAX weights
(:func:`gcn_params_from_jax`, :func:`sage_params_from_jax`,
:func:`gat_params_from_jax`, :func:`gat_batch_params_from_jax`) and a
module's weights run through the same functional forwards.

The CSR forwards take a batch as the JAX package lays it out: ``x [N, F]``,
``rowptr [N+1]`` over destination nodes and ``row [E]`` the source of each
edge, sorted by destination (``col [E]``, its destination, for GAT); pad
edges (``row == col == N``) sit past ``rowptr[-1]`` and belong to no row.
"""

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from pyg_lib_tpu_torch.ops import (scatter_softmax, segment_max_csr,
                                   segment_mean_csr, segment_softmax_padded,
                                   segment_sum_csr, segment_sum_padded, spmm)
from pyg_lib_tpu_torch.ops.spmm import _gathered_max_padded
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['GAT', 'GATBatch', 'GCN', 'SAGE', 'gat_batch_params_from_jax',
           'gat_forward', 'gat_forward_spmm', 'gat_params_from_jax',
           'gcn_forward', 'gcn_forward_spmm', 'gcn_params_from_jax',
           'sage_forward', 'sage_maxpool_forward_spmm',
           'sage_params_from_jax']


def _gather_src(x: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    # Pad edges carry row == N: clip; they sit past rowptr[-1], so the
    # segment op drops their messages.
    return x[row.clamp(max=x.shape[0] - 1)]


def _glorot(fan_in: int, fan_out: int, generator, device) -> torch.Tensor:
    limit = (6.0 / (fan_in + fan_out))**0.5
    w = torch.rand((fan_in, fan_out), generator=generator)
    return ((2 * w - 1) * limit).to(device)


def _params_from_jax(tree: Dict, keys, device) -> Dict:
    device = _resolve_device(device)
    return {'layers': [{
        k: torch.tensor(np.asarray(layer[k], dtype=np.float32), device=device)
        for k in keys
    } for layer in tree['layers']]}


# -- GCN ----------------------------------------------------------------------


def gcn_forward(params: Dict, x: torch.Tensor, rowptr: torch.Tensor,
                row: torch.Tensor) -> torch.Tensor:
    """Kipf-Welling GCN with symmetric in-batch degree normalisation over a
    CSR batch; aggregates with ``segment_sum_csr`` (kernel K3 on the
    card)."""
    deg = (rowptr[1:] - rowptr[:-1]).to(x.dtype)
    inv_sqrt = torch.rsqrt(deg.clamp(min=1.0))[:, None]
    n = x.shape[0]
    layers = params['layers']
    for i, layer in enumerate(layers):
        h = x @ layer['w']
        msgs = _gather_src(h * inv_sqrt, row)
        agg = segment_sum_csr(msgs, rowptr)[:n]
        x = agg * inv_sqrt + h * inv_sqrt**2 + layer['b']
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


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
    return _params_from_jax(tree, ('w', 'b'), device)


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
            self.w.append(nn.Parameter(_glorot(fan_in, fan_out, generator,
                                               device)))
            self.b.append(nn.Parameter(torch.zeros(fan_out, device=device)))

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return {'layers': [{'w': w, 'b': b} for w, b in zip(self.w, self.b)]}

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        return gcn_forward_spmm(self.params(), x, graph)


# -- GraphSAGE ----------------------------------------------------------------


def sage_forward(params: Dict, x: torch.Tensor, rowptr: torch.Tensor,
                 row: torch.Tensor, aggr: str = 'mean') -> torch.Tensor:
    """GraphSAGE with the mean or max aggregator over a CSR batch:
    ``segment_mean_csr`` (K3) or ``segment_max_csr`` (K4 over a cached
    plan at 65,536 edges and more)."""
    n = x.shape[0]
    layers = params['layers']
    for i, layer in enumerate(layers):
        msgs = _gather_src(x, row)
        if aggr == 'mean':
            agg = segment_mean_csr(msgs, rowptr)[:n]
        elif aggr == 'max':
            agg = segment_max_csr(msgs, rowptr)[0][:n]
        else:
            raise ValueError(f'Unknown aggr: {aggr!r}')
        x = x @ layer['w_self'] + agg @ layer['w_nbr'] + layer['b']
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def sage_maxpool_forward_spmm(params: Dict, x: torch.Tensor,
                              graph) -> torch.Tensor:
    """Full-graph GraphSAGE with max-pooling aggregation over a planned
    graph: neighbour features go through the pooling layer
    ``relu(x @ w_nbr)``, are max-reduced per destination row over
    ``graph.fwd`` (a chunked plan), and are added to the self term. K4
    reads the pooled rows through the plan's ``col_padded``, so the padded
    message slab the JAX package gathers first is never written; the
    values and the gradient (winner-only, then the gather's transpose) are
    the same."""
    plan = graph.fwd
    layers = params['layers']
    for i, layer in enumerate(layers):
        h_pool = torch.relu(x @ layer['w_nbr'])
        agg = _gathered_max_padded(h_pool, plan)
        x = x @ layer['w_self'] + agg + layer['b']
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def sage_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's GraphSAGE tree (``init_sage``) into the
    port's parameters: f32 tensors on ``device`` (default: the CUDA
    card)."""
    return _params_from_jax(tree, ('w_self', 'w_nbr', 'b'), device)


class SAGE(nn.Module):
    """GraphSAGE, ``dims = [in, hidden..., out]``; its forward is the
    full-graph max-pool model (:func:`sage_maxpool_forward_spmm`), and
    :meth:`params` also feeds :func:`sage_forward`.

    Weights are Glorot-uniform from ``generator`` (``w_self``, then
    ``w_nbr``, layer by layer) and biases zero, as in ``init_sage``.
    """

    def __init__(self, dims: List[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = _resolve_device(device)
        self.w_self = nn.ParameterList()
        self.w_nbr = nn.ParameterList()
        self.b = nn.ParameterList()
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            for ws in (self.w_self, self.w_nbr):
                ws.append(nn.Parameter(_glorot(fan_in, fan_out, generator,
                                               device)))
            self.b.append(nn.Parameter(torch.zeros(fan_out, device=device)))

    def params(self) -> Dict:
        """The parameters as the functional forwards' tree."""
        return {'layers': [{'w_self': ws, 'w_nbr': wn, 'b': b}
                           for ws, wn, b in zip(self.w_self, self.w_nbr,
                                                self.b)]}

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        return sage_maxpool_forward_spmm(self.params(), x, graph)


# -- GAT ----------------------------------------------------------------------


def gat_forward_spmm(params: Dict, x: torch.Tensor, graph) -> torch.Tensor:
    """Full-graph GAT over a graph built ``with_edge_maps=True`` (a chunked
    ``graph.fwd``).

    Every per-edge stage runs in the plan's padded coordinates: the
    attention logits ``leaky_relu(s_src[col] + s_dst[row], 0.2)`` as
    ``[E_pad, heads]``, their per-row softmax (kernel K6, at the head
    count's width), the gather ``h[col_padded]`` weighted by each head's
    attention, and the sum into the rows (kernel K1 without the gather).
    Heads are read per layer from ``a_src``'s shape, so the last layer may
    have its own count; heads are concatenated, with ELU between layers.
    """
    plan = graph.fwd
    layers = params['layers']
    for i, layer in enumerate(layers):
        heads, out_h = layer['a_src'].shape
        h = x @ layer['w']
        n, hf = h.shape
        hh = h.view(n, heads, out_h)
        s_src = (hh * layer['a_src']).sum(-1)  # [N, heads]
        s_dst = (hh * layer['a_dst']).sum(-1)
        logits = torch.nn.functional.leaky_relu(
            s_src.index_select(0, plan.col_padded) +
            s_dst.index_select(0, plan.row_padded), 0.2)  # [E_pad, heads]
        alpha = segment_softmax_padded(logits, plan)
        msgs = h.index_select(0, plan.col_padded).view(-1, heads, out_h)
        msgs = (msgs * alpha[:, :, None]).view(-1, hf)
        x = segment_sum_padded(msgs, plan)
        if i < len(layers) - 1:
            x = torch.nn.functional.elu(x)
    return x


def gat_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's planned-GAT tree (``init_gat_spmm``; any
    per-layer head count) into the port's parameters: f32 tensors on
    ``device`` (default: the CUDA card)."""
    return _params_from_jax(tree, ('w', 'a_src', 'a_dst'), device)


class GAT(nn.Module):
    """Full-graph GAT (:func:`gat_forward_spmm`), ``dims = [in, hidden...,
    out]`` with ``heads`` heads of ``dims[i+1] // heads`` features in
    every layer, concatenated.

    Weights are Glorot-uniform from ``generator`` (``w``, ``a_src``,
    ``a_dst``, layer by layer), as in ``init_gat_spmm``, which also
    requires each width to be a multiple of ``heads``.
    """

    def __init__(self, dims: List[int], heads: int = 4,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = _resolve_device(device)
        self.w = nn.ParameterList()
        self.a_src = nn.ParameterList()
        self.a_dst = nn.ParameterList()
        for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
            if fan_out % heads:
                raise ValueError(f'dims[{i + 1}]={fan_out} not divisible by '
                                 f'heads={heads}')
            out_h = fan_out // heads
            self.w.append(nn.Parameter(_glorot(fan_in, heads * out_h,
                                               generator, device)))
            self.a_src.append(nn.Parameter(_glorot(heads, out_h, generator,
                                                   device)))
            self.a_dst.append(nn.Parameter(_glorot(heads, out_h, generator,
                                                   device)))

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return {'layers': [{'w': w, 'a_src': a, 'a_dst': d}
                           for w, a, d in zip(self.w, self.a_src,
                                              self.a_dst)]}

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        return gat_forward_spmm(self.params(), x, graph)


# -- GAT on a padded batch ----------------------------------------------------


def gat_forward(params: Dict, x: torch.Tensor, rowptr: torch.Tensor,
                row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Graph attention over a padded CSR batch: each destination's
    softmax over its incoming edges (``scatter_softmax``), the weighted
    messages summed over the destination CSR by ``segment_sum_csr``
    (kernel K3 on the card). Hidden layers concatenate their heads and
    apply ELU; the last averages them. Pad edges carry ``col == N``: their
    ends are clamped to ``N - 1`` and their logits set to ``-inf``, so
    they get no attention."""
    heads = params['heads']
    n = x.shape[0]
    layers = params['layers']
    src = row.clamp(max=n - 1)
    dst = col.clamp(max=n - 1)
    pad = (col >= n)[:, None]
    for i, layer in enumerate(layers):
        out_dim = layer['att_src'].shape[-1]
        h = (x @ layer['w']).view(n, heads, out_dim)
        a_src = (h * layer['att_src']).sum(-1)  # [N, H]
        a_dst = (h * layer['att_dst']).sum(-1)
        # index_select, not h[src]: its backward is an index_add_, while
        # advanced indexing's backward sorts the indices first (most of
        # the step's device time on the H100, PERF.md).
        logits = torch.nn.functional.leaky_relu(
            a_src.index_select(0, src) + a_dst.index_select(0, dst), 0.2)
        logits = logits.masked_fill(pad, float('-inf'))  # [E, H]
        alpha = scatter_softmax(logits, dst, dim=0, dim_size=n)
        alpha = alpha.masked_fill(pad, 0.0)
        msgs = h.index_select(0, src) * alpha[:, :, None]  # [E, H, D]
        agg = segment_sum_csr(msgs.reshape(msgs.shape[0], -1),
                              rowptr)[:n].view(n, heads, out_dim)
        if i < len(layers) - 1:
            x = torch.nn.functional.elu(agg.reshape(n, heads * out_dim) +
                                        layer['b'])
        else:
            x = agg.mean(1) + layer['b']
    return x


def gat_batch_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's padded-batch GAT tree (``init_gat``: ``w``,
    ``att_src``/``att_dst`` ``[1, heads, out]``, ``b`` and ``heads``) into
    the port's parameters: f32 tensors on ``device`` (default: the CUDA
    card)."""
    params = _params_from_jax(tree, ('w', 'att_src', 'att_dst', 'b'), device)
    params['heads'] = int(tree['heads'])
    return params


class GATBatch(nn.Module):
    """GAT over a padded CSR batch (:func:`gat_forward`), ``dims = [in,
    hidden..., out]`` with ``heads`` heads of ``dims[i+1]`` features in
    every layer: hidden layers concatenate them (the next layer takes
    ``heads * dims[i]``), the last averages them.

    Weights are Glorot-uniform from ``generator`` (``w``, ``att_src``,
    ``att_dst``, layer by layer) and biases zero, as in ``init_gat``.
    """

    def __init__(self, dims: List[int], heads: int = 4,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = _resolve_device(device)
        self.heads = heads
        self.w = nn.ParameterList()
        self.att_src = nn.ParameterList()
        self.att_dst = nn.ParameterList()
        self.b = nn.ParameterList()
        for i, (fan_in, out) in enumerate(zip(dims[:-1], dims[1:])):
            in_dim = fan_in if i == 0 else heads * fan_in
            self.w.append(nn.Parameter(_glorot(in_dim, heads * out,
                                               generator, device)))
            for att in (self.att_src, self.att_dst):
                att.append(nn.Parameter(_glorot(heads, out, generator,
                                                device).view(1, heads, out)))
            width = out * heads if i < len(dims) - 2 else out
            self.b.append(nn.Parameter(torch.zeros(width, device=device)))

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return {'layers': [{'w': w, 'att_src': a, 'att_dst': d, 'b': b}
                           for w, a, d, b in zip(self.w, self.att_src,
                                                 self.att_dst, self.b)],
                'heads': self.heads}

    def forward(self, x: torch.Tensor, rowptr: torch.Tensor,
                row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        return gat_forward(self.params(), x, rowptr, row, col)
