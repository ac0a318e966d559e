"""Mini-batch GraphSAGE with the host sampling pipeline (counterpart of
``examples/train_sage_minibatch.py``: Reddit's GraphSAGE [25, 10] shape at
small scale).

    python -m pyg_lib_tpu_torch.examples.train_sage_minibatch \
        [--device cpu] [--steps 60]

Each step samples a batch of training seeds with the C++ engine, pads it
to one fixed shape, and takes one Adam step of ``sage_forward`` (mean
aggregation: kernel K3 on the card); then the accuracy on the test seeds
is reported. Runs on the CUDA card unless ``--device`` names another
device, and raises when there is no card.
"""

import argparse
import time

import numpy as np
import torch

from pyg_lib_tpu_torch import sampler
from pyg_lib_tpu_torch.datasets import sbm_graph
from pyg_lib_tpu_torch.metrics import Metrics
from pyg_lib_tpu_torch.models import SAGE, sage_forward, sage_params_from_jax
from pyg_lib_tpu_torch.utils import _resolve_device


def main(num_nodes: int = 1000, steps: int = 60, batch_size: int = 64,
         fanouts=(10, 5), verbose: bool = True, device=None, params=None):
    """Train on ``device`` (None: the CUDA card), from ``params`` (the
    JAX package's ``init_sage`` tree as numpy arrays) or from ``SAGE``'s
    weights (``torch.Generator`` seed 0). Returns the test accuracy and
    the losses of the training steps."""
    device = _resolve_device(device)
    data = sbm_graph(num_nodes=num_nodes, p_in=0.03, p_out=0.002, seed=1)
    x_full, y_full = data['x'], data['y']
    rowptr, col = data['rowptr'], data['col']
    train_idx = np.nonzero(data['train_mask'])[0]
    test_idx = np.nonzero(data['test_mask'])[0]
    max_nodes, max_edges = sampler.padding.budget_for(batch_size,
                                                      list(fanouts))
    max_nodes, max_edges = min(max_nodes, 4096), min(max_edges, 8192)

    dims = [x_full.shape[1], 64, data['num_classes']]
    if params is None:
        params = SAGE(dims, generator=torch.Generator().manual_seed(0),
                      device=device).params()
    else:
        params = sage_params_from_jax(params, device)
    tree = {'layers': [{k: v.detach().requires_grad_()
                        for k, v in layer.items()}
                       for layer in params['layers']]}
    opt = torch.optim.Adam([w for layer in tree['layers']
                            for w in layer.values()], lr=1e-2)

    def make_batch(seeds, rng):
        out = sampler.neighbor_sample(rowptr, col, seeds, list(fanouts),
                                      rng=rng)
        b = sampler.padding.pad_sample_output(out, max_nodes, max_edges,
                                              len(seeds))
        x = np.zeros((max_nodes, x_full.shape[1]), np.float32)
        x[:b.num_nodes] = x_full[b.node_id[:b.num_nodes]]
        labels = np.zeros(max_nodes, np.int64)
        labels[:b.num_nodes] = y_full[b.node_id[:b.num_nodes]]
        seed_mask = np.zeros(max_nodes, bool)
        seed_mask[:b.num_seeds] = True  # the seeds are the first locals
        return tuple(torch.from_numpy(a).to(device) for a in (
            x, b.rowptr, b.row, labels, seed_mask))

    def loss_fn(x, rowptr_b, row_b, labels, seed_mask):
        logp = torch.log_softmax(sage_forward(tree, x, rowptr_b, row_b), 1)
        nll = -logp.gather(1, labels[:, None])[:, 0]
        return torch.where(seed_mask, nll, 0.0).sum() / seed_mask.sum()

    rng = np.random.default_rng(0)
    metrics = Metrics(every=20, edges_per_step=max_edges,
                      sink=None if verbose else lambda rec: None)
    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        seeds = rng.choice(train_idx, size=batch_size, replace=False)
        with metrics.phase('sample'):
            batch = make_batch(seeds, it)
        with metrics.phase('step'):
            opt.zero_grad()
            loss = loss_fn(*batch)
            loss.backward()
            opt.step()
        metrics.step(loss=loss.detach())
        losses.append(loss.detach())
    losses = [float(v) for v in losses]
    elapsed = time.perf_counter() - t0
    if verbose:
        print(f'metrics: {metrics.summary()}')

    correct = total = 0
    with torch.no_grad():
        for lo in range(0, len(test_idx), batch_size):
            x, rp, rw, labels, seed_mask = make_batch(
                test_idx[lo:lo + batch_size], 10_000 + lo)
            pred = sage_forward(tree, x, rp, rw).argmax(1)
            correct += int((pred == labels)[seed_mask].sum())
            total += int(seed_mask.sum())
    acc = correct / max(total, 1)
    if verbose:
        print(f'test accuracy {acc:.3f} ({elapsed:.1f}s train, {device})')
    return acc, losses


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--steps', type=int, default=60)
    args = parser.parse_args()
    main(steps=args.steps, device=args.device)
