"""Distributed mini-batch GraphSAGE: the distributed sampling protocol and
the collective feature fetch (counterpart of
``examples/train_dist_sampled.py``).

    python -m pyg_lib_tpu_torch.examples.train_dist_sampled \
        [--ranks 4] [--backend gloo] [--device cpu] [--steps 30]

The graph lives partitioned over the ranks (``partition_graph``), and each
rank holds its range of the feature rows. Every step each rank runs the
coordinator of sample -> merge -> relabel (``DistNeighborSampler``, the
same seeds in every rank), the batch's features arrive by
``collective_feature_fetch`` (each rank gives its own rows, an all-reduce
sums them), and ``parallel.make_train_step`` takes one Adam step of
``sage_forward`` (K3 on the card). The ranks run on the CUDA card unless
``--device`` names another device.
"""

import argparse
import functools
import time

import numpy as np
import torch

from pyg_lib_tpu_torch import parallel
from pyg_lib_tpu_torch.datasets import sbm_graph
from pyg_lib_tpu_torch.models import SAGE, sage_forward
from pyg_lib_tpu_torch.sampler.dist_service import (DistNeighborSampler,
                                                    collective_feature_fetch,
                                                    partition_graph)
from pyg_lib_tpu_torch.sampler.padding import pad_sample_output
from pyg_lib_tpu_torch.utils import _resolve_device


def _rank(rank, world, device, steps, num_nodes):
    device = torch.device(device)
    mesh = parallel.make_mesh((world, ), ('data', ), device=device.type)
    d = sbm_graph(num_nodes=num_nodes, num_classes=4, seed=0)
    n_local = -(-num_nodes // world)
    x = np.zeros((n_local * world, d['x'].shape[1]), np.float32)
    x[:num_nodes] = d['x']
    x_mine = torch.from_numpy(x[rank * n_local:(rank + 1) * n_local]).to(
        device)
    y = d['y'].astype(np.int64)
    ds = DistNeighborSampler(partition_graph(d['rowptr'], d['col'], world),
                             rng=0)
    batch_seeds, fanouts = 64, [10, 5]
    max_nodes, max_edges = 4096, 8192
    model = SAGE([x.shape[1], 64, d['num_classes']],
                 generator=torch.Generator().manual_seed(0), device=device)
    params = {'layers': [{k: v.detach() for k, v in layer.items()}
                         for layer in model.params()['layers']]}

    def loss_fn(p, batch):
        logits = sage_forward(p, batch['x'], batch['rowptr'], batch['row'])
        nll = torch.nn.functional.cross_entropy(logits, batch['y'],
                                                reduction='none')
        mask = batch['mask']
        return (nll * mask).sum(), mask.sum()

    step = parallel.make_train_step(
        loss_fn, functools.partial(torch.optim.Adam, lr=5e-3), mesh)
    rng = np.random.default_rng(0)
    opt, losses = None, []
    t0 = time.perf_counter()
    for _ in range(steps):
        seeds = rng.choice(num_nodes, size=batch_seeds, replace=False)
        row, col, node_id, _ = ds.sample(seeds, fanouts)
        b = pad_sample_output((row, col, node_id, None, [], []), max_nodes,
                              max_edges, num_seeds=batch_seeds)
        pad_ids = np.zeros(max_nodes, np.int64)
        pad_ids[:len(node_id)] = node_id
        batch = {
            'x': collective_feature_fetch(
                mesh, x_mine, torch.from_numpy(pad_ids).to(device)),
            'rowptr': torch.from_numpy(b.rowptr).to(device),
            'row': torch.from_numpy(b.row).to(device),
            'y': torch.from_numpy(y[pad_ids]).to(device),
            'mask': torch.from_numpy(b.node_mask.astype(np.float32)).to(
                device),
        }
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return {'losses': losses, 'seconds': time.perf_counter() - t0}


def main(ranks: int = 4, backend: str = 'gloo', device=None,
         steps: int = 30, num_nodes: int = 4096, verbose: bool = True):
    """Train on ``ranks`` ranks of ``backend`` on ``device`` (None: the
    CUDA card); returns rank 0's ``{'losses', 'seconds'}``."""
    device = str(_resolve_device(device))
    out = parallel.spawn(_rank, ranks, backend, device, steps, num_nodes)[0]
    if verbose:
        for i in range(0, steps, 10):
            print(f'step {i:3d}  loss {out["losses"][i]:.4f}')
        print(f'final loss {out["losses"][-1]:.4f}  ({out["seconds"]:.1f}s, '
              f'{ranks} ranks, {backend}, {device})')
    return out


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ranks', type=int, default=4)
    parser.add_argument('--backend', default='gloo')
    parser.add_argument('--device', default=None)
    parser.add_argument('--steps', type=int, default=30)
    args = parser.parse_args()
    out = main(args.ranks, args.backend, args.device, args.steps)
    assert out['losses'][-1] < 1.0, 'did not converge'
