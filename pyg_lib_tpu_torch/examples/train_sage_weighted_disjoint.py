"""Mini-batch GraphSAGE with edge-weight-biased, disjoint sampling
(counterpart of ``examples/train_sage_weighted_disjoint.py``: a synthetic
stand-in for BASELINE.json config 3, ogbn-products GraphSAGE with
weighted, disjoint neighbour sampling).

    python -m pyg_lib_tpu_torch.examples.train_sage_weighted_disjoint \
        [--device cpu] [--epochs 5] [--steps N]

It drives:

* the C++ engine's biased sampling (Efraimidis-Spirakis, without
  replacement) through ``NeighborLoader(edge_weight=...)``;
* disjoint per-seed subgraphs (``disjoint=True``: a ``batch`` vector in
  every batch);
* the loss over the seeds of each padded batch, one Adam step of
  ``sage_forward`` a batch (mean aggregation: kernel K3 on the card).

The test accuracy comes from batches of the test nodes sampled the same
way. Runs on the CUDA card unless ``--device`` names another device, and
raises when there is no card.
"""

import argparse
import time

import numpy as np
import torch

from pyg_lib_tpu_torch.datasets import sbm_graph
from pyg_lib_tpu_torch.examples.train_gcn import trainable
from pyg_lib_tpu_torch.loader import NeighborLoader
from pyg_lib_tpu_torch.models import (init_sage, sage_forward,
                                      sage_params_from_jax)
from pyg_lib_tpu_torch.utils import _resolve_device


def seed_loss(tree, batch):
    """The mean cross-entropy over the batch's seeds (its first
    ``num_seeds`` nodes, all real)."""
    logp = torch.log_softmax(sage_forward(tree, batch['x'], batch['rowptr'],
                                          batch['row']), 1)
    nll = -logp.gather(1, batch['y'].long()[:, None])[:, 0]
    mask = batch['node_mask'] & (torch.arange(nll.shape[0], device=nll.device)
                                 < batch['num_seeds'])
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def train_on_loader(data, make_loader, epochs, steps, verbose, device,
                    params, what):
    """Adam (lr 5e-3) on ``sage_forward`` [F, 64, classes] over the
    batches of ``make_loader(seeds)`` for ``epochs`` epochs of the training
    nodes (or ``steps`` steps, when given), from ``params`` (the JAX
    package's ``init_sage`` tree as numpy arrays) or from
    :func:`init_sage`'s weights (``torch.Generator`` seed 0); then the
    accuracy over the seeds of the test nodes' batches. Returns the
    accuracy and the loss of every step."""
    dims = [data['x'].shape[1], 64, data['num_classes']]
    params = (init_sage(dims, torch.Generator().manual_seed(0), device)
              if params is None else sage_params_from_jax(params, device))
    tree, leaves = trainable(params)
    opt = torch.optim.Adam(leaves, lr=5e-3)
    loader = make_loader(np.nonzero(data['train_mask'])[0])
    losses = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        for batch in loader:
            opt.zero_grad()
            loss = seed_loss(tree, batch)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if len(losses) == steps:
                break
        if len(losses) == steps:
            break
    losses = [float(v) for v in losses]
    elapsed = time.perf_counter() - t0
    correct = total = 0
    with torch.no_grad():
        test = make_loader(np.nonzero(data['test_mask'])[0], drop_last=False)
        for batch in test:
            n = batch['num_seeds']
            pred = sage_forward(tree, batch['x'], batch['rowptr'],
                                batch['row'])[:n].argmax(1)
            correct += int((pred == batch['y'][:n].long()).sum())
            total += n
    acc = correct / max(total, 1)
    if verbose:
        print(f'{len(losses)} steps in {elapsed:.1f}s, final loss '
              f'{losses[-1]:.4f}, test accuracy {acc:.3f} ({what}, '
              f'{device})')
    return acc, losses


def main(num_nodes: int = 3000, epochs: int = 5, steps=None,
         verbose: bool = True, device=None, params=None):
    """Train on ``device`` (None: the CUDA card) for ``epochs`` epochs (or
    ``steps`` steps); see :func:`train_on_loader`. Returns the test
    accuracy and the loss of every step."""
    device = _resolve_device(device)
    d = sbm_graph(num_nodes=num_nodes, num_classes=4, seed=1)
    ew = np.random.default_rng(0).uniform(0.05, 1.0, size=len(d['col']))

    def make_loader(seeds, drop_last=True):
        return NeighborLoader(d['rowptr'], d['col'], d['x'], d['y'], seeds,
                              batch_size=64, num_neighbors=[10, 5],
                              num_workers=2, rng=0, device=device,
                              drop_last=drop_last, disjoint=True,
                              edge_weight=ew)

    return train_on_loader(d, make_loader, epochs, steps, verbose, device,
                           params, 'weighted + disjoint sampling')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--epochs', type=int, default=5)
    parser.add_argument('--steps', type=int, default=None)
    args = parser.parse_args()
    main(epochs=args.epochs, steps=args.steps, device=args.device)
