"""Full-batch GCN on a synthetic SBM graph through the planned SpMM
(counterpart of ``examples/train_gcn_fullgraph_spmm.py``).

    python -m pyg_lib_tpu_torch.examples.train_gcn_fullgraph_spmm \
        [--device cpu] [--epochs 60]

Every layer's aggregation is ``ops.spmm`` over one plan built on the host
for the whole run (kernel K1 on the card), the pipeline ``bench.py``
measures; compare ``train_gcn``, which aggregates a CSR batch. Runs on
the CUDA card unless ``--device`` names another device, and raises when
there is no card.
"""

import argparse
import time

import torch

from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.datasets import sbm_graph
from pyg_lib_tpu_torch.examples.train_gcn import trainable
from pyg_lib_tpu_torch.metrics import Metrics
from pyg_lib_tpu_torch.models import (gcn_forward_spmm, gcn_params_from_jax,
                                      init_gcn)
from pyg_lib_tpu_torch.utils import _resolve_device


def main(num_nodes: int = 4000, epochs: int = 60, verbose: bool = True,
         device=None, params=None):
    """Train on ``device`` (None: the CUDA card), from ``params`` (the
    JAX package's ``init_gcn`` tree as numpy arrays) or from
    :func:`init_gcn`'s weights (``torch.Generator`` seed 0). Returns the
    test accuracy and the loss of every epoch."""
    device = _resolve_device(device)
    d = sbm_graph(num_nodes=num_nodes, num_classes=4, seed=0)
    graph = ops.build_spmm_graph(d['rowptr'], d['col'], device=device)
    x, train, test = (torch.as_tensor(d[k], device=device)
                      for k in ('x', 'train_mask', 'test_mask'))
    y = torch.as_tensor(d['y'], device=device).long()
    dims = [x.shape[1], 64, d['num_classes']]
    params = (init_gcn(dims, torch.Generator().manual_seed(0), device)
              if params is None else gcn_params_from_jax(params, device))
    tree, leaves = trainable(params)
    opt = torch.optim.Adam(leaves, lr=1e-2)

    # Per-epoch HBM gauge: 2 layers x forward and backward SpMM passes
    # over the edge slab (x rows per edge + output), the dominant traffic.
    e, f = len(d['col']), 64
    metrics = Metrics(every=20, edges_per_step=2 * e,
                      bytes_per_step=4 * (2 * e * f + 2 * num_nodes * f),
                      sink=None if verbose else lambda rec: None)
    losses = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        with metrics.phase('step'):
            opt.zero_grad()
            logp = torch.log_softmax(gcn_forward_spmm(tree, x, graph), 1)
            nll = -logp.gather(1, y[:, None])[:, 0]
            loss = torch.where(train, nll, 0.0).sum() / train.sum()
            loss.backward()
            opt.step()
        metrics.step(loss=loss.detach())
        losses.append(loss.detach())
    losses = [float(v) for v in losses]
    with torch.no_grad():
        pred = gcn_forward_spmm(tree, x, graph).argmax(-1)
    acc = float(((pred == y) & test).sum() / test.sum())
    if verbose:
        print(f'metrics: {metrics.summary()}')
        print(f'{epochs} epochs in {time.perf_counter() - t0:.1f}s, final '
              f'loss {losses[-1]:.4f}, test acc {acc:.3f} ({device})')
    return acc, losses


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--epochs', type=int, default=60)
    args = parser.parse_args()
    main(epochs=args.epochs, device=args.device)
