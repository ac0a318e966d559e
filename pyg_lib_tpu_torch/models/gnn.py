"""GNN models of the port: GCN, GraphSAGE, GAT and R-GCN, on a planned
graph and (GCN, GraphSAGE, GAT, R-GCN) on a CSR batch (port of
``pyg_lib_tpu.models.gnn``: ``init_gcn``, ``gcn_forward``,
``gcn_forward_spmm``, ``init_sage``, ``sage_forward``,
``sage_maxpool_forward_spmm``, ``init_gat``, ``gat_forward``,
``init_gat_spmm``, ``gat_forward_spmm``, ``init_rgcn``, ``rgcn_forward``,
``init_rgcn_spmm``, ``build_rgcn_graphs``, ``rgcn_forward_spmm``,
``HeteroSpmmPlan``, ``build_rgcn_planned``, ``rgcn_forward_planned``).

Parameters are the JAX package's trees with tensors for arrays:
``{'layers': [{'w': [in, out], 'b': [out]}, ...]}`` for GCN,
``{'layers': [{'w_self', 'w_nbr': [in, out], 'b': [out]}, ...]}`` for
GraphSAGE, ``{'layers': [{'w': [in, heads*out_h], 'a_src', 'a_dst':
[heads, out_h]}, ...]}`` for the planned GAT and ``{'layers': [{'w',
'att_src', 'att_dst': [1, heads, out], 'b'}, ...], 'heads': heads}`` for
the padded-batch GAT, ``{'layers': [{'w_rel': [R, in, out], 'w_root': [in,
out], 'b'}, ...]}`` for the padded-batch R-GCN and ``{'layers': [{'w': [R,
in, out], 'w_self': [in, out], 'b'}, ...]}`` for the full-graph R-GCN, so
converted JAX weights (:func:`gcn_params_from_jax`,
:func:`sage_params_from_jax`, :func:`gat_params_from_jax`,
:func:`gat_batch_params_from_jax`, :func:`rgcn_params_from_jax`,
:func:`rgcn_spmm_params_from_jax`) and a module's weights run through the
same functional forwards.

The CSR forwards take a batch as the JAX package lays it out: ``x [N, F]``,
``rowptr [N+1]`` over destination nodes and ``row [E]`` the source of each
edge, sorted by destination (``col [E]``, its destination, for GAT); pad
edges (``row == col == N``) sit past ``rowptr[-1]`` and belong to no row.
"""

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from pyg_lib_tpu_torch import profiling
from pyg_lib_tpu_torch.ops import (FusedRangePlan, build_spmm_graph,
                                   build_weighted_fused_graph,
                                   scatter_softmax, scatter_sum,
                                   segment_matmul, segment_max_csr,
                                   segment_mean_csr, segment_softmax_padded,
                                   segment_sum_csr, segment_sum_padded, spmm)
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import _build_padded_layout
from pyg_lib_tpu_torch.ops.spmm import _forward_plan, _gathered_max_padded
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['GAT', 'GATBatch', 'GCN', 'RGCN', 'RGCNBatch', 'SAGE',
           'HeteroSpmmPlan', 'build_rgcn_graphs', 'build_rgcn_planned',
           'gat_batch_params_from_jax', 'gat_forward', 'gat_forward_spmm',
           'gat_params_from_jax', 'gcn_forward', 'gcn_forward_spmm',
           'gcn_params_from_jax', 'init_gat', 'init_gat_spmm', 'init_gcn',
           'init_rgcn', 'init_rgcn_spmm', 'init_sage',
           'rgcn_forward', 'rgcn_forward_planned', 'rgcn_forward_spmm',
           'rgcn_params_from_jax', 'rgcn_spmm_params_from_jax',
           'sage_forward', 'sage_maxpool_forward_spmm',
           'sage_params_from_jax']


def _gather_src(x: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    # Pad edges carry row == N: clip; they sit past rowptr[-1], so the
    # segment op drops their messages.
    return x[row.clamp(max=x.shape[0] - 1)]


def _glorot(fan_in: int, fan_out: int, generator, device,
            lead=()) -> torch.Tensor:
    """``[*lead, fan_in, fan_out]`` uniform in ``±sqrt(6 / (fan_in +
    fan_out))``."""
    limit = (6.0 / (fan_in + fan_out))**0.5
    w = torch.rand((*lead, fan_in, fan_out), generator=generator)
    return ((2 * w - 1) * limit).to(device)


def _set_lists(module: nn.Module, tree: Dict, keys) -> None:
    """Give ``module`` one ``nn.ParameterList`` per key of ``keys``, of
    that key's tensor in each layer of ``tree``."""
    for k in keys:
        setattr(module, k, nn.ParameterList(
            nn.Parameter(layer[k]) for layer in tree['layers']))


def _params_from_jax(tree: Dict, keys, device) -> Dict:
    device = _resolve_device(device)
    return {'layers': [{
        k: torch.tensor(np.asarray(layer[k], dtype=np.float32), device=device)
        for k in keys
    } for layer in tree['layers']]}


# -- GCN ----------------------------------------------------------------------


def init_gcn(dims: List[int], generator: Optional[torch.Generator] = None,
             device=None) -> Dict:
    """Parameters of the GCN forwards, ``dims = [in, hidden..., out]``: per
    layer ``w [in, out]`` Glorot-uniform from ``generator`` and a zero
    bias ``b``, as ``init_gcn`` builds them; on ``device`` (default: the
    CUDA card)."""
    device = _resolve_device(device)
    return {'layers': [{'w': _glorot(fan_in, fan_out, generator, device),
                        'b': torch.zeros(fan_out, device=device)}
                       for fan_in, fan_out in zip(dims[:-1], dims[1:])]}


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
    the degrees). Each layer's phases are ``model.dense``,
    ``model.aggregate`` and ``model.combine`` spans of
    :mod:`~pyg_lib_tpu_torch.profiling` (``layer``)."""
    inv_sqrt = torch.rsqrt(graph.deg.to(x.dtype).clamp(min=1.0))[:, None]
    layers = params['layers']
    for i, layer in enumerate(layers):
        with profiling.span('model.dense', layer=i):
            h = x @ layer['w']
        with profiling.span('model.aggregate', layer=i):
            agg = spmm(h * inv_sqrt, graph)
        with profiling.span('model.combine', layer=i):
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
        _set_lists(self, init_gcn(dims, generator, device), ('w', 'b'))

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return {'layers': [{'w': w, 'b': b} for w, b in zip(self.w, self.b)]}

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        return gcn_forward_spmm(self.params(), x, graph)


# -- GraphSAGE ----------------------------------------------------------------


def init_sage(dims: List[int], generator: Optional[torch.Generator] = None,
              device=None) -> Dict:
    """Parameters of the GraphSAGE forwards: per layer ``w_self`` and
    ``w_nbr [in, out]`` Glorot-uniform from ``generator`` (in that order)
    and a zero bias ``b``, as ``init_sage`` builds them; on ``device``
    (default: the CUDA card)."""
    device = _resolve_device(device)
    return {'layers': [{'w_self': _glorot(fan_in, fan_out, generator, device),
                        'w_nbr': _glorot(fan_in, fan_out, generator, device),
                        'b': torch.zeros(fan_out, device=device)}
                       for fan_in, fan_out in zip(dims[:-1], dims[1:])]}


def sage_forward(params: Dict, x: torch.Tensor, rowptr: torch.Tensor,
                 row: torch.Tensor, aggr: str = 'mean') -> torch.Tensor:
    """GraphSAGE with the mean or max aggregator over a CSR batch:
    ``segment_mean_csr`` (K3) or ``segment_max_csr`` (K4 over a cached
    plan at 65,536 edges and more). Each layer's phases are
    ``model.gather``, ``model.aggregate``, ``model.dense`` and
    ``model.combine`` spans of :mod:`~pyg_lib_tpu_torch.profiling`
    (``layer``)."""
    n = x.shape[0]
    layers = params['layers']
    for i, layer in enumerate(layers):
        with profiling.span('model.gather', layer=i):
            msgs = _gather_src(x, row)
        with profiling.span('model.aggregate', layer=i):
            if aggr == 'mean':
                agg = segment_mean_csr(msgs, rowptr)[:n]
            elif aggr == 'max':
                agg = segment_max_csr(msgs, rowptr)[0][:n]
            else:
                raise ValueError(f'Unknown aggr: {aggr!r}')
        # x is rebound at once: a name kept for the dense sum would hold
        # its [N, F] rows until the next layer.
        with profiling.span('model.dense', layer=i):
            x = x @ layer['w_self'] + agg @ layer['w_nbr']
        with profiling.span('model.combine', layer=i):
            x = x + layer['b']
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
    the same. A cluster-reordered graph raises ``ValueError``."""
    plan = _forward_plan(graph, 'sage_maxpool_forward_spmm')
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
        _set_lists(self, init_sage(dims, generator, device),
                   ('w_self', 'w_nbr', 'b'))

    def params(self) -> Dict:
        """The parameters as the functional forwards' tree."""
        return {'layers': [{'w_self': ws, 'w_nbr': wn, 'b': b}
                           for ws, wn, b in zip(self.w_self, self.w_nbr,
                                                self.b)]}

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        return sage_maxpool_forward_spmm(self.params(), x, graph)


# -- GAT ----------------------------------------------------------------------


def init_gat_spmm(dims: List[int], heads: int = 4,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Dict:
    """Parameters of :func:`gat_forward_spmm`: per layer ``w [in,
    heads*out_h]`` and the attention vectors ``a_src``, ``a_dst [heads,
    out_h]`` with ``out_h = dims[i+1] // heads``, Glorot-uniform from
    ``generator`` in that order, as ``init_gat_spmm`` builds them; on
    ``device`` (default: the CUDA card). A width that ``heads`` does not
    divide raises ``ValueError``."""
    device = _resolve_device(device)
    layers = []
    for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
        if fan_out % heads:
            raise ValueError(f'dims[{i + 1}]={fan_out} not divisible by '
                             f'heads={heads}')
        out_h = fan_out // heads
        layers.append({'w': _glorot(fan_in, heads * out_h, generator, device),
                       'a_src': _glorot(heads, out_h, generator, device),
                       'a_dst': _glorot(heads, out_h, generator, device)})
    return {'layers': layers}


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
    A cluster-reordered graph raises ``ValueError``.
    """
    plan = _forward_plan(graph, 'gat_forward_spmm')
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
        _set_lists(self, init_gat_spmm(dims, heads, generator, device),
                   ('w', 'a_src', 'a_dst'))

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return {'layers': [{'w': w, 'a_src': a, 'a_dst': d}
                           for w, a, d in zip(self.w, self.a_src,
                                              self.a_dst)]}

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        return gat_forward_spmm(self.params(), x, graph)


# -- GAT on a padded batch ----------------------------------------------------


def init_gat(dims: List[int], heads: int = 4,
             generator: Optional[torch.Generator] = None,
             device=None) -> Dict:
    """Parameters of :func:`gat_forward`, ``heads`` heads of ``dims[i+1]``
    features in every layer: per layer ``w [in, heads*out]`` (hidden
    layers concatenate their heads, so layer ``i > 0`` takes ``heads *
    dims[i]``), ``att_src`` and ``att_dst [1, heads, out]``,
    Glorot-uniform from ``generator`` in that order, and a zero bias ``b``
    of ``heads * out`` (the last layer: ``out``); and ``'heads'``, as
    ``init_gat`` builds them. On ``device`` (default: the CUDA card)."""
    device = _resolve_device(device)
    layers = []
    for i, (fan_in, out) in enumerate(zip(dims[:-1], dims[1:])):
        in_dim = fan_in if i == 0 else heads * fan_in
        layers.append({
            'w': _glorot(in_dim, heads * out, generator, device),
            'att_src': _glorot(heads, out, generator, device).view(
                1, heads, out),
            'att_dst': _glorot(heads, out, generator, device).view(
                1, heads, out),
            'b': torch.zeros(out * heads if i < len(dims) - 2 else out,
                             device=device)})
    return {'layers': layers, 'heads': heads}


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
        self.heads = heads
        _set_lists(self, init_gat(dims, heads, generator, device),
                   ('w', 'att_src', 'att_dst', 'b'))

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return {'layers': [{'w': w, 'att_src': a, 'att_dst': d, 'b': b}
                           for w, a, d, b in zip(self.w, self.att_src,
                                                 self.att_dst, self.b)],
                'heads': self.heads}

    def forward(self, x: torch.Tensor, rowptr: torch.Tensor,
                row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        return gat_forward(self.params(), x, rowptr, row, col)


# -- R-GCN --------------------------------------------------------------------


def _init_rgcn_tree(dims: List[int], num_relations: int, keys, generator,
                    device) -> Dict:
    device = _resolve_device(device)
    rel, root = keys
    layers = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        layers.append({
            rel: _glorot(fan_in, fan_out, generator, device,
                         (num_relations, )),
            root: _glorot(fan_in, fan_out, generator, device),
            'b': torch.zeros(fan_out, device=device),
        })
    return {'layers': layers}


def init_rgcn(dims: List[int], num_relations: int,
              generator: Optional[torch.Generator] = None,
              device=None) -> Dict:
    """Parameters of :func:`rgcn_forward`: per layer one weight per
    relation ``w_rel [R, in, out]`` and a root weight ``w_root [in, out]``
    (Glorot-uniform from ``generator``, in that order) and a zero bias, as
    ``init_rgcn`` builds them; on ``device`` (default: the CUDA card)."""
    return _init_rgcn_tree(dims, num_relations, ('w_rel', 'w_root'),
                           generator, device)


def rgcn_forward(params: Dict, x: torch.Tensor, row: torch.Tensor,
                 col: torch.Tensor, rel_ptr) -> torch.Tensor:
    """R-GCN over a batch whose edges are grouped by relation type:
    ``rel_ptr [R+1]`` bounds each relation's edges (numpy or a tensor; a
    CUDA one is read back once per layer by :func:`segment_matmul`).

    Per layer the messages ``x[row]`` go through their relation's weight
    in one :func:`segment_matmul`, are divided by the in-count of their
    (destination, relation) pair (Schlichtkrull's ``1/c_{i,r}``) and are
    summed into ``col`` by ``scatter_sum``; the root term ``x @ w_root``
    and the bias are added, with ReLU between layers. Pad edges carry
    ``col == N`` and are dropped. No kernel of the port runs here.
    """
    n = x.shape[0]
    num_rel = params['layers'][0]['w_rel'].shape[0]
    e = row.shape[0]
    bounds = torch.as_tensor(rel_ptr, device=x.device).long()
    # Relation of each edge from the boundaries, clipped as the JAX
    # package does; counts over (N+1)·R keys, pad edges in bucket N.
    rel_id = (torch.searchsorted(bounds, torch.arange(e, device=x.device),
                                 right=True) - 1).clamp(0, num_rel - 1)
    dst = col.long().clamp(max=n)
    key = dst * num_rel + rel_id
    counts = scatter_sum(torch.ones(e, device=x.device), key, dim=0,
                         dim_size=(n + 1) * num_rel)
    inv = (1.0 / counts.clamp(min=1.0))[key][:, None].to(x.dtype)
    layers = params['layers']
    for i, layer in enumerate(layers):
        msgs = _gather_src(x, row)
        transformed = segment_matmul(msgs, rel_ptr, layer['w_rel']) * inv
        agg = scatter_sum(transformed, dst, dim=0, dim_size=n + 1)[:n]
        x = agg + x @ layer['w_root'] + layer['b']
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def rgcn_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's padded-batch R-GCN tree (``init_rgcn``) into
    the port's parameters: f32 tensors on ``device`` (default: the CUDA
    card)."""
    return _params_from_jax(tree, ('w_rel', 'w_root', 'b'), device)


class RGCNBatch(nn.Module):
    """R-GCN over a batch of relation-grouped edges (:func:`rgcn_forward`),
    ``dims = [in, hidden..., out]``, ``num_relations`` relations; weights
    as :func:`init_rgcn` draws them."""

    def __init__(self, dims: List[int], num_relations: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _set_lists(self, init_rgcn(dims, num_relations, generator, device),
                   ('w_rel', 'w_root', 'b'))

    def params(self) -> Dict:
        """The parameters as the functional forward's tree."""
        return {'layers': [{'w_rel': w, 'w_root': r, 'b': b}
                           for w, r, b in zip(self.w_rel, self.w_root,
                                              self.b)]}

    def forward(self, x: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                rel_ptr) -> torch.Tensor:
        return rgcn_forward(self.params(), x, row, col, rel_ptr)


def build_rgcn_graphs(rowptr_dict, col_dict, num_nodes_dict, chunk=512,
                      dedup='auto', device=None) -> Dict:
    """One :class:`~pyg_lib_tpu_torch.ops.SpmmGraph` per relation for
    :func:`rgcn_forward_spmm` (host-built, once), on ``device`` (default:
    the CUDA card).

    ``rowptr_dict[(src, rel, dst)]`` is the relation's CSR over the
    destination type's nodes, ``col_dict`` its source ids. Each graph is
    rectangular (``num_cols`` the source type's count); ``dedup='auto'``
    lets each side of each relation take the dedup plan where it pays.
    """
    device = _resolve_device(device)
    return {k: build_spmm_graph(rowptr, col_dict[k], chunk=chunk,
                                num_cols=num_nodes_dict[k[0]], dedup=dedup,
                                device=device)
            for k, rowptr in rowptr_dict.items()}


def rgcn_forward_spmm(params: Dict, x_dict: Dict, graphs: Dict) -> Dict:
    """Full-graph R-GCN over per-relation plans: per layer and relation
    ``(src, rel, dst)``, the source nodes' features times the relation's
    weight, then the planned mean into the destination type (:func:`spmm`:
    K1, or K2/K2h on a dedup side); plus each type's self term and bias,
    ReLU between layers.

    ``params['layers'][i]['w'][r]`` is the weight of the ``r``-th relation
    of ``sorted(graphs)``; ``w_self`` is shared by all types.
    """
    rels = sorted(graphs)
    layers = params['layers']
    for i, layer in enumerate(layers):
        out = {t: h @ layer['w_self'] + layer['b']
               for t, h in x_dict.items()}
        for ri, k in enumerate(rels):
            src_t, _, dst_t = k
            agg = spmm(x_dict[src_t] @ layer['w'][ri], graphs[k],
                       reduce='mean')
            out[dst_t] = out[dst_t] + agg[:out[dst_t].shape[0]]
        x_dict = out
        if i < len(layers) - 1:
            x_dict = {t: torch.relu(v) for t, v in x_dict.items()}
    return x_dict


def init_rgcn_spmm(dims: List[int], num_relations: int,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Dict:
    """Parameters of :func:`rgcn_forward_spmm` and
    :func:`rgcn_forward_planned`: per layer ``w [R, in, out]`` and
    ``w_self [in, out]`` (Glorot-uniform from ``generator``, in that
    order) and a zero bias, as ``init_rgcn_spmm`` builds them; on
    ``device`` (default: the CUDA card)."""
    return _init_rgcn_tree(dims, num_relations, ('w', 'w_self'), generator,
                           device)


def rgcn_spmm_params_from_jax(tree: Dict, device=None) -> Dict:
    """Turn the JAX package's full-graph R-GCN tree (``init_rgcn_spmm``)
    into the port's parameters: f32 tensors on ``device`` (default: the
    CUDA card)."""
    return _params_from_jax(tree, ('w', 'w_self', 'b'), device)


class HeteroSpmmPlan(NamedTuple):
    """The relations into each destination type stacked into one plan
    (host-built, once).

    Per destination node its edges of all relations follow each other in
    relation order, and their columns point into the stack of the
    relations' source features (``src_ptr`` bounds each relation's rows).
    A layer then takes one :func:`segment_matmul` over the stack and one
    reduce per destination type. On a chunked plan the mean's
    ``1/deg_r(dst)`` is a per-slot scale in padded coordinates
    (``deginv``); a range-sliced plan carries it as edge weights.
    """
    graphs: Dict  # dst type -> SpmmGraph over the stacked sources
    deginv: Dict  # dst type -> [E_pad] f32 (chunked plans only)
    rel_order: tuple  # relations in stack order, sorted
    src_ptr: np.ndarray  # [R+1] int64 row offsets of the stacked sources
    num_nodes: Dict  # node type -> count


def build_rgcn_planned(rowptr_dict, col_dict, num_nodes_dict, chunk=512,
                       range_sliced: bool = False,
                       device=None) -> HeteroSpmmPlan:
    """Stack the relations into one plan per destination type (host-side),
    on ``device`` (default: the CUDA card).

    By default each plan is chunked with edge maps (``chunk`` an integer:
    the padded ``1/deg`` table is laid out with the same chunk, and the
    JAX package cannot take ``'auto'`` here either), and
    :func:`rgcn_forward_planned` gathers the stacked rows into padded
    coordinates and sums them with K1. ``range_sliced=True`` builds a
    weighted fused-range graph instead, whose column ranges are the
    relations' segments of the stack and whose weights are ``1/deg``
    (K7 in both directions; ``chunk='auto'`` allowed).
    """
    if not range_sliced and not isinstance(chunk, (int, np.integer)):
        raise ValueError(f'the stacked (chunked) plan needs an integer '
                         f'chunk, got {chunk!r}; chunk=\'auto\' is for '
                         f'range_sliced=True')
    device = _resolve_device(device)
    rel_order = tuple(sorted(rowptr_dict))
    src_ptr = np.zeros(len(rel_order) + 1, np.int64)
    for i, k in enumerate(rel_order):
        src_ptr[i + 1] = src_ptr[i] + num_nodes_dict[k[0]]

    graphs, deginv = {}, {}
    for dst_t in sorted({k[2] for k in rel_order}):
        ks = [(i, k) for i, k in enumerate(rel_order) if k[2] == dst_t]
        n_dst = num_nodes_dict[dst_t]
        # Each relation's (row, stacked column, 1/deg) triples in relation
        # order, then a stable sort by row: within a row the edges stay
        # relation-major.
        rows_all, cols_all, dinv_all = [], [], []
        for ri, k in ks:
            rp = np.asarray(rowptr_dict[k], dtype=np.int64)
            cl = np.asarray(col_dict[k], dtype=np.int64)
            deg_r = np.diff(rp)
            rows_all.append(np.repeat(np.arange(n_dst, dtype=np.int64),
                                      deg_r))
            cols_all.append(cl + src_ptr[ri])
            with np.errstate(divide='ignore'):
                per_row = np.where(deg_r > 0, 1.0 / deg_r, 0.0)
            dinv_all.append(np.repeat(per_row, deg_r).astype(np.float32))
        rows_cat = np.concatenate(rows_all)
        order = np.argsort(rows_cat, kind='stable')
        col = np.concatenate(cols_all)[order]
        dinv = np.concatenate(dinv_all)[order]
        rowptr = np.zeros(n_dst + 1, np.int64)
        np.cumsum(np.bincount(rows_cat, minlength=n_dst), out=rowptr[1:])
        if range_sliced:
            graphs[dst_t] = build_weighted_fused_graph(
                rowptr, col, int(src_ptr[-1]),
                bounds=[(int(src_ptr[ri]), int(src_ptr[ri + 1]))
                        for ri, _ in ks],
                edge_weight=dinv, chunk=chunk, device=device)
            continue
        graphs[dst_t] = build_spmm_graph(rowptr, col, chunk=chunk,
                                         with_edge_maps=True,
                                         num_cols=int(src_ptr[-1]),
                                         device=device)
        # 1/deg of each padded slot, from the same host layout the plan
        # was built on (pad slots 0).
        orig, valid, _, _, _ = _build_padded_layout(rowptr, int(chunk))
        if len(dinv):
            dp = np.where(valid, dinv[np.minimum(orig, len(dinv) - 1)],
                          0.0).astype(np.float32)
        else:  # no edges into this type: every slot is padding
            dp = np.zeros(len(orig), np.float32)
        deginv[dst_t] = torch.from_numpy(dp).to(device)
    return HeteroSpmmPlan(graphs=graphs, deginv=deginv, rel_order=rel_order,
                          src_ptr=src_ptr, num_nodes=dict(num_nodes_dict))


def rgcn_forward_planned(params: Dict, x_dict: Dict,
                         hplan: HeteroSpmmPlan) -> Dict:
    """The R-GCN of :func:`rgcn_forward_spmm` (same parameters) over a
    :class:`HeteroSpmmPlan`: per layer one :func:`segment_matmul`
    transforms the stacked sources, then each destination type takes one
    reduce over all its relations: the gather ``h[col_padded]`` scaled by
    ``1/deg`` and summed by K1 without its gather (``segment_sum_padded``)
    on a chunked plan, or K7 with the weights on a range-sliced one.
    """
    rels = hplan.rel_order
    layers = params['layers']
    for i, layer in enumerate(layers):
        out = {t: h @ layer['w_self'] + layer['b']
               for t, h in x_dict.items()}
        x_cat = torch.cat([x_dict[k[0]] for k in rels])
        h_cat = segment_matmul(x_cat, hplan.src_ptr, layer['w'])
        del x_cat
        for dst_t, g in hplan.graphs.items():
            plan = g.fwd
            if isinstance(plan, FusedRangePlan):
                agg = spmm(h_cat, g)
            else:
                msgs = h_cat.index_select(0, plan.col_padded)
                # In place: index_select's backward does not read its
                # output, and this keeps one [E_pad, F] slab, not two.
                msgs.mul_(hplan.deginv[dst_t][:, None].to(msgs.dtype))
                agg = segment_sum_padded(msgs, plan).to(h_cat.dtype)
                del msgs
            out[dst_t] = out[dst_t] + agg[:out[dst_t].shape[0]]
        x_dict = out
        if i < len(layers) - 1:
            x_dict = {t: torch.relu(v) for t, v in x_dict.items()}
    return x_dict


class RGCN(nn.Module):
    """Full-graph R-GCN, ``dims = [in, hidden..., out]`` shared by every
    node type, ``num_relations`` relations; weights as
    :func:`init_rgcn_spmm` draws them. Its forward takes the per-relation
    graphs of :func:`build_rgcn_graphs` (:func:`rgcn_forward_spmm`) or a
    :class:`HeteroSpmmPlan` (:func:`rgcn_forward_planned`); both index
    the relation weights in sorted relation order."""

    def __init__(self, dims: List[int], num_relations: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _set_lists(self, init_rgcn_spmm(dims, num_relations, generator,
                                        device), ('w', 'w_self', 'b'))

    def params(self) -> Dict:
        """The parameters as the functional forwards' tree."""
        return {'layers': [{'w': w, 'w_self': s, 'b': b}
                           for w, s, b in zip(self.w, self.w_self, self.b)]}

    def forward(self, x_dict: Dict, graphs) -> Dict:
        if isinstance(graphs, HeteroSpmmPlan):
            return rgcn_forward_planned(self.params(), x_dict, graphs)
        return rgcn_forward_spmm(self.params(), x_dict, graphs)
