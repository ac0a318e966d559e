"""Full-graph R-GCN over per-relation SpMM plans (the planned hetero path).

    python -m pyg_lib_tpu_torch.examples.train_rgcn_fullgraph_spmm \
        [--device cpu] [--epochs 60]

A synthetic graph of 2 node types and 3 relations; each relation
transforms its source nodes, then the planned gather and mean run into
the destination type (``spmm``, kernels K1 or K2/K2h on the card), with
no per-edge messages. Trains with Adam on 60% of the ``a`` nodes and
reports the held-out accuracy. Runs on the CUDA card unless ``--device``
names another device, and raises when there is no card.
"""

import argparse
import time

import numpy as np
import torch

from pyg_lib_tpu_torch.models import RGCN, build_rgcn_graphs
from pyg_lib_tpu_torch.utils import _resolve_device


def main(device=None, epochs: int = 60, seed: int = 0):
    """Train on ``device`` (None: the CUDA card); return the loss of every
    epoch."""
    device = _resolve_device(device)
    rng = np.random.default_rng(seed)
    n_a, n_b, f = 4000, 2000, 32

    def csr(nd, ns, d):  # CSR over the destination nodes, col = sources
        deg = rng.integers(0, 2 * d, size=nd)
        rp = np.zeros(nd + 1, np.int64)
        rp[1:] = np.cumsum(deg)
        return rp, rng.integers(0, ns, size=int(rp[-1])).astype(np.int64)

    rowptr_d, col_d = {}, {}
    rowptr_d[('a', 'r1', 'a')], col_d[('a', 'r1', 'a')] = csr(n_a, n_a, 6)
    rowptr_d[('b', 'r2', 'a')], col_d[('b', 'r2', 'a')] = csr(n_a, n_b, 3)
    rowptr_d[('a', 'r3', 'b')], col_d[('a', 'r3', 'b')] = csr(n_b, n_a, 3)
    graphs = build_rgcn_graphs(rowptr_d, col_d, {'a': n_a, 'b': n_b},
                               device=device)

    x_np = {'a': rng.normal(size=(n_a, f)).astype(np.float32),
            'b': rng.normal(size=(n_b, f)).astype(np.float32)}
    proj = rng.normal(size=(f, 4)).astype(np.float32)
    y = torch.from_numpy((x_np['a'] @ proj).argmax(-1)).to(device)
    train = torch.from_numpy(rng.random(n_a) < 0.6).to(device)
    x_dict = {t: torch.from_numpy(v).to(device) for t, v in x_np.items()}

    model = RGCN([f, 64, 4], num_relations=3,
                 generator=torch.Generator().manual_seed(seed), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    losses = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        opt.zero_grad()
        logits = model(x_dict, graphs)['a']
        loss = torch.nn.functional.cross_entropy(logits[train], y[train])
        loss.backward()
        opt.step()
        losses.append(loss.item())
    with torch.no_grad():
        pred = model(x_dict, graphs)['a'].argmax(-1)
        acc = (pred == y)[~train].float().mean().item()
    print(f'{epochs} epochs in {time.perf_counter() - t0:.1f}s, loss '
          f'{losses[-1]:.4f}, held-out acc {acc:.3f} ({device})')
    return losses


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--epochs', type=int, default=60)
    args = parser.parse_args()
    main(args.device, args.epochs)
