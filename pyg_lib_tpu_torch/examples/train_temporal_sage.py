"""Temporal GraphSAGE: node-time-constrained, disjoint neighbour sampling
(counterpart of ``examples/train_temporal_sage.py``).

    python -m pyg_lib_tpu_torch.examples.train_temporal_sage \
        [--device cpu] [--epochs 5] [--steps N]

Each seed's subgraph holds only neighbours whose time is at or before the
seed's (causality, as in TGN/TGAT-style pipelines): the reference's
node-temporal mode (reference
``csrc/sampler/cpu/neighbor_kernel.cpp:74-108``) through
``NeighborLoader(node_time=..., temporal_strategy='last')``, with the
training loop of ``train_sage_weighted_disjoint`` (kernel K3 on the
card). The neighbourhoods are time-sorted once up front, the reference's
precondition. Runs on the CUDA card unless ``--device`` names another
device, and raises when there is no card.
"""

import argparse

import numpy as np
import torch

from pyg_lib_tpu_torch.datasets import sbm_graph
from pyg_lib_tpu_torch.examples.train_sage_weighted_disjoint import \
    train_on_loader
from pyg_lib_tpu_torch.loader import NeighborLoader
from pyg_lib_tpu_torch.utils import _resolve_device


def time_sort_neighborhoods(rowptr, col, node_time, device=None):
    """``col`` with each row's neighbours in a stable order of their
    ``node_time``: the JAX example's result, which sorts row after row.

    Two stable sorts of all edges at once, by time and then by row, on
    ``device`` (default: the CUDA card): on ogbn-products' 123.7M edges a
    loop over its 2.4M rows would take hours. Returns a numpy array of
    ``col``'s dtype."""
    device = _resolve_device(device)
    col = np.asarray(col)
    deg = torch.as_tensor(np.diff(np.asarray(rowptr, np.int64)),
                          device=device)
    row = torch.repeat_interleave(
        torch.arange(deg.shape[0], device=device), deg)
    cols = torch.as_tensor(col, device=device)
    t = torch.as_tensor(np.asarray(node_time, np.int64),
                        device=device)[cols.long()]
    order = torch.sort(t, stable=True).indices
    order = order[torch.sort(row[order], stable=True).indices]
    return cols[order].cpu().numpy()


def main(num_nodes: int = 2000, epochs: int = 5, steps=None,
         verbose: bool = True, device=None, params=None):
    """Train on ``device`` (None: the CUDA card) for ``epochs`` epochs (or
    ``steps`` steps); see ``train_sage_weighted_disjoint.train_on_loader``.
    Returns the test accuracy and the loss of every step."""
    device = _resolve_device(device)
    d = sbm_graph(num_nodes=num_nodes, num_classes=4, seed=3)
    node_time = np.random.default_rng(0).integers(
        0, 100, size=num_nodes).astype(np.int64)
    col = time_sort_neighborhoods(d['rowptr'], d['col'], node_time, device)

    def make_loader(seeds, drop_last=True):
        return NeighborLoader(d['rowptr'], col, d['x'], d['y'], seeds,
                              batch_size=64, num_neighbors=[8, 4],
                              num_workers=2, rng=0, device=device,
                              drop_last=drop_last, disjoint=True,
                              node_time=node_time, temporal_strategy='last')

    return train_on_loader(d, make_loader, epochs, steps, verbose, device,
                           params, 'node-temporal disjoint sampling')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--epochs', type=int, default=5)
    parser.add_argument('--steps', type=int, default=None)
    args = parser.parse_args()
    main(epochs=args.epochs, steps=args.steps, device=args.device)
