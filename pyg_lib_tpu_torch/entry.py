"""The port's counterpart of the repository's ``__graft_entry__.entry``: a
GraphSAGE forward over one padded mini-batch from the port's own sampler.

    fn, args = entry()          # on the CUDA card
    out = fn(*args)             # [64, 7]

``example_batch`` samples from the cycle-graph fixture exactly as the JAX
entry does (the same seeds, the same engine streams, the same features
from numpy), so the batch equals the JAX one bit for bit; only the
weights differ (``SAGE`` from a ``torch.Generator``, where the JAX entry
draws from ``jax.random``). The multi-chip dry run waits for ROADMAP
Queue 1 item 13.
"""

from typing import Dict

import numpy as np
import torch

from pyg_lib_tpu_torch import sampler
from pyg_lib_tpu_torch.models import SAGE, sage_forward
from pyg_lib_tpu_torch.testing import cycle_graph
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['entry', 'example_batch']

DIMS = [32, 64, 7]


def example_batch(num_graphs: int, max_nodes: int = 64, max_edges: int = 128,
                  feat: int = 32, seed: int = 0, device=None
                  ) -> Dict[str, torch.Tensor]:
    """``num_graphs`` padded mini-batches sampled from ``cycle_graph(32)``
    (4 seeds, fanouts [4, 4]), stacked, on ``device`` (default: the CUDA
    card): ``x``, ``rowptr``, ``row``, ``node_mask`` and ``label``."""
    device = _resolve_device(device)
    rowptr, col = cycle_graph(32)
    rng = np.random.default_rng(seed)
    xs, rps, rows, masks, labels = [], [], [], [], []
    for g in range(num_graphs):
        seeds = rng.choice(32, size=4, replace=False)
        out = sampler.neighbor_sample(rowptr, col, seeds, [4, 4],
                                      rng=seed + g)
        b = sampler.padding.pad_sample_output(out, max_nodes, max_edges,
                                              num_seeds=4)
        xs.append(rng.normal(size=(max_nodes, feat)).astype(np.float32))
        rps.append(b.rowptr)
        rows.append(b.row)
        masks.append(b.node_mask)
        labels.append(rng.integers(0, 7, size=max_nodes))
    return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in (
        ('x', xs), ('rowptr', rps), ('row', rows), ('node_mask', masks),
        ('label', [a.astype(np.int32) for a in labels]))}


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is ``sage_forward`` at ``[32, 64, 7]``
    (mean aggregation, kernel K3 on the card) over one padded batch of
    :func:`example_batch`, with weights from ``torch.Generator`` seed 0,
    on ``device`` (default: the CUDA card)."""
    device = _resolve_device(device)
    batch = example_batch(num_graphs=1, device=device)
    model = SAGE(DIMS, generator=torch.Generator().manual_seed(0),
                 device=device)
    params = {'layers': [{k: v.detach() for k, v in layer.items()}
                         for layer in model.params()['layers']]}

    def forward(params, x, rowptr, row):
        return sage_forward(params, x, rowptr, row)

    return forward, (params, batch['x'][0], batch['rowptr'][0],
                     batch['row'][0])
