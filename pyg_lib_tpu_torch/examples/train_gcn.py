"""Full-batch GCN training (counterpart of ``examples/train_gcn.py``:
BASELINE.json config 1's shape on a synthetic SBM graph).

    python -m pyg_lib_tpu_torch.examples.train_gcn [--device cpu] \
        [--epochs 100]

Every epoch is one Adam step of ``gcn_forward`` over the whole graph as
one CSR batch (``segment_sum_csr``: kernel K3 on the card); the test
accuracy is reported every 20 epochs and at the end. Runs on the CUDA
card unless ``--device`` names another device, and raises when there is
no card.
"""

import argparse
import time

import torch

from pyg_lib_tpu_torch.datasets import sbm_graph
from pyg_lib_tpu_torch.models import gcn_forward, gcn_params_from_jax, init_gcn
from pyg_lib_tpu_torch.utils import _resolve_device


def trainable(params):
    """``params`` with every tensor a fresh leaf that requires a gradient,
    and the list of those leaves (for the optimizer)."""
    tree = {'layers': [{k: v.detach().requires_grad_()
                        for k, v in layer.items()}
                       for layer in params['layers']]}
    return tree, [w for layer in tree['layers'] for w in layer.values()]


def main(num_nodes: int = 400, epochs: int = 100, verbose: bool = True,
         device=None, params=None):
    """Train on ``device`` (None: the CUDA card), from ``params`` (the
    JAX package's ``init_gcn`` tree as numpy arrays) or from
    :func:`init_gcn`'s weights (``torch.Generator`` seed 0). Returns the
    test accuracy and the loss of every epoch."""
    device = _resolve_device(device)
    data = sbm_graph(num_nodes=num_nodes, seed=0)
    x, rowptr, row, train, test = (
        torch.as_tensor(data[k], device=device)
        for k in ('x', 'rowptr', 'col', 'train_mask', 'test_mask'))
    y = torch.as_tensor(data['y'], device=device).long()
    # The graph is symmetric, so the CSR's columns are the sources of each
    # row's incoming edges.
    dims = [x.shape[1], 32, data['num_classes']]
    params = (init_gcn(dims, torch.Generator().manual_seed(0), device)
              if params is None else gcn_params_from_jax(params, device))
    tree, leaves = trainable(params)
    opt = torch.optim.Adam(leaves, lr=1e-2)

    def accuracy(mask):
        with torch.no_grad():
            pred = gcn_forward(tree, x, rowptr, row).argmax(1)
        return float(((pred == y) & mask).sum() / mask.sum())

    losses = []
    t0 = time.perf_counter()
    for epoch in range(epochs):
        opt.zero_grad()
        logp = torch.log_softmax(gcn_forward(tree, x, rowptr, row), 1)
        nll = -logp.gather(1, y[:, None])[:, 0]
        loss = torch.where(train, nll, 0.0).sum() / train.sum()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if verbose and (epoch + 1) % 20 == 0:
            print(f'epoch {epoch + 1}: loss={float(losses[-1]):.4f} '
                  f'test_acc={accuracy(test):.3f}')
    losses = [float(v) for v in losses]
    elapsed = time.perf_counter() - t0
    acc = accuracy(test)
    if verbose:
        print(f'final test accuracy: {acc:.3f} ({elapsed:.1f}s, {device})')
    return acc, losses


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--epochs', type=int, default=100)
    args = parser.parse_args()
    main(epochs=args.epochs, device=args.device)
