"""Distributed full-graph GCN over edge-partitioned ranks (counterpart of
``examples/train_dist_fullgraph.py``).

    python -m pyg_lib_tpu_torch.examples.train_dist_fullgraph \
        [--ranks 4] [--backend gloo] [--device cpu] [--aggregate ring]

Each rank owns a range of the nodes (their features, labels and incoming
edges, ``partition.mesh_edge_partition_blocked``); every layer's
aggregation is ``parallel.ring_halo_aggregate`` (source blocks passed
round the ring; ``--aggregate halo`` takes ``halo_exchange_aggregate``,
one all-gather), summed by K3 on the card, and the gradient flows back
through the ring. ``parallel.make_train_step`` takes the masked mean of
the training nodes over all ranks and all-reduces the weights' gradient.
The ranks run on the CUDA card unless ``--device`` names another device.
"""

import argparse
import functools
import time

import numpy as np
import torch

from pyg_lib_tpu_torch import parallel, partition
from pyg_lib_tpu_torch.datasets import sbm_graph
from pyg_lib_tpu_torch.models.gnn import _glorot
from pyg_lib_tpu_torch.parallel import _collectives as C
from pyg_lib_tpu_torch.utils import _resolve_device


def gcn_forward(p, x, inv_sqrt, aggregate):
    """The two-layer GCN of the JAX example: ``aggregate`` sums each
    destination's sources over the ranks."""
    h = x @ p['w1'] + p['b1']
    agg = aggregate(h * inv_sqrt)
    h = torch.relu(agg * inv_sqrt + h * inv_sqrt**2)
    h = h @ p['w2'] + p['b2']
    agg = aggregate(h * inv_sqrt)
    return agg * inv_sqrt + h * inv_sqrt**2


def _rank(rank, world, device, epochs, num_nodes, aggregate):
    device = torch.device(device)
    mesh = parallel.make_mesh((world, ), ('data', ), device=device.type)
    d = sbm_graph(num_nodes=num_nodes, num_classes=4, seed=0)
    if aggregate == 'ring':
        part = partition.mesh_edge_partition_blocked(d['rowptr'], d['col'],
                                                     world)
        tables = (part.rowptr_blk[rank], part.src_blk[rank])
        agg_fn = parallel.ring_halo_aggregate
    else:
        part = partition.mesh_edge_partition(d['rowptr'], d['col'], world)
        tables = (part.src_ids[rank], part.rowptr[rank])
        agg_fn = parallel.halo_exchange_aggregate
    tables = [torch.from_numpy(t).to(device) for t in tables]
    npd = part.nodes_per_device

    def mine(a):
        """This rank's rows of a per-node array, padded past the end."""
        pad = np.zeros((part.num_nodes_padded, ) + a.shape[1:], a.dtype)
        pad[:len(a)] = a
        return torch.from_numpy(pad[rank * npd:(rank + 1) * npd]).to(device)

    x, y = mine(d['x']), mine(d['y'].astype(np.int64))
    train, test = mine(d['train_mask']), mine(d['test_mask'])
    deg = np.diff(d['rowptr']).astype(np.float32)
    inv_sqrt = torch.rsqrt(mine(deg).clamp(min=1.0))[:, None]
    gen = torch.Generator().manual_seed(0)
    f, c = d['x'].shape[1], d['num_classes']
    params = {'w1': _glorot(f, 64, gen, device),
              'b1': torch.zeros(64, device=device),
              'w2': _glorot(64, c, gen, device),
              'b2': torch.zeros(c, device=device)}

    def aggregate(h):
        return agg_fn(mesh, h, *tables)

    def loss_fn(p, _):
        logits = gcn_forward(p, x, inv_sqrt, aggregate)
        nll = torch.nn.functional.cross_entropy(logits, y, reduction='none')
        return torch.where(train, nll, 0.0).sum(), train.sum()

    step = parallel.make_train_step(
        loss_fn, functools.partial(torch.optim.Adam, lr=1e-2), mesh)
    opt = None
    t0 = time.perf_counter()
    for _ in range(epochs):
        params, opt, loss = step(params, opt, None)
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        pred = gcn_forward(params, x, inv_sqrt, aggregate).argmax(-1)
        counts = torch.stack([(pred == y)[test].sum(), test.sum()]).float()
        C.all_reduce_(counts, mesh.get_group('data'))
    return {'loss': float(loss), 'acc': float(counts[0] / counts[1]),
            'seconds': seconds}


def main(ranks: int = 4, backend: str = 'gloo', device=None,
         epochs: int = 40, num_nodes: int = 4096, aggregate: str = 'ring',
         verbose: bool = True):
    """Train on ``ranks`` ranks of ``backend`` on ``device`` (None: the
    CUDA card); returns rank 0's ``{'loss', 'acc', 'seconds'}``."""
    if aggregate not in ('ring', 'halo'):
        raise ValueError(f"aggregate must be 'ring' or 'halo', got "
                         f'{aggregate!r}')
    device = str(_resolve_device(device))
    out = parallel.spawn(_rank, ranks, backend, device, epochs, num_nodes,
                         aggregate)[0]
    if verbose:
        print(f'{ranks}-rank mesh ({backend}, {device}, {aggregate}): '
              f'{epochs} epochs in {out["seconds"]:.1f}s, final loss '
              f'{out["loss"]:.4f}, test acc {out["acc"]:.3f}')
    return out


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ranks', type=int, default=4)
    parser.add_argument('--backend', default='gloo')
    parser.add_argument('--device', default=None)
    parser.add_argument('--epochs', type=int, default=40)
    parser.add_argument('--aggregate', default='ring',
                        choices=['ring', 'halo'])
    args = parser.parse_args()
    main(args.ranks, args.backend, args.device, args.epochs,
         aggregate=args.aggregate)
