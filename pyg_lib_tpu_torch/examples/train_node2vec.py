"""node2vec embeddings: host random walks and skip-gram training on the
card (counterpart of ``examples/train_node2vec.py``).

    python -m pyg_lib_tpu_torch.examples.train_node2vec [--device cpu] \
        [--steps 300]

The C++ walker (``sampler.random_walk``) draws a batch of walks on the
host each step, and Adam trains the embedding table with skip-gram and
negative sampling (``models.node2vec_loss``); then the SBM communities'
1-NN agreement in the embedding is reported. Runs on the CUDA card unless
``--device`` names another device, and raises when there is no card.
"""

import argparse
import time

import numpy as np
import torch

from pyg_lib_tpu_torch.datasets import sbm_graph
from pyg_lib_tpu_torch.models import (init_node2vec, node2vec_loss,
                                      node2vec_params_from_jax)
from pyg_lib_tpu_torch.sampler import random_walk
from pyg_lib_tpu_torch.utils import _resolve_device


def main(num_nodes: int = 600, steps: int = 300, dim: int = 32,
         batch: int = 256, walk_length: int = 10, num_neg: int = 5,
         verbose: bool = True, device=None, params=None):
    """Train on ``device`` (None: the CUDA card), from ``params`` (the
    JAX package's ``init_node2vec`` tree as numpy arrays) or from
    :func:`init_node2vec` (``torch.Generator`` seed 0). Returns the 1-NN
    community agreement and the losses of the training steps."""
    device = _resolve_device(device)
    data = sbm_graph(num_nodes=num_nodes, seed=0)
    rowptr, col = data['rowptr'], data['col']
    labels = np.asarray(data['y'])
    rng = np.random.default_rng(1)
    if params is None:
        params = init_node2vec(num_nodes, dim,
                               generator=torch.Generator().manual_seed(0),
                               device=device)
    else:
        params = node2vec_params_from_jax(params, device)
    params['emb'].requires_grad_()
    opt = torch.optim.Adam([params['emb']], lr=2e-2)

    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        seeds = rng.integers(0, num_nodes, batch)
        walks = random_walk(rowptr, col, seeds, walk_length=walk_length,
                            rng=i)
        neg = rng.integers(0, num_nodes, (batch, num_neg))
        opt.zero_grad()
        loss = node2vec_loss(params, torch.from_numpy(walks).to(device),
                             torch.from_numpy(neg).to(device))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if verbose and i % 50 == 0:
            print(f'step {i:4d} loss {float(loss):.4f}')
    losses = [float(v) for v in losses]

    # The SBM communities should be linearly separable in the embedding:
    # score a 1-NN community-agreement rate.
    emb = params['emb'].detach().cpu().numpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sims = emb @ emb.T
    np.fill_diagonal(sims, -np.inf)
    agree = float((labels[np.argmax(sims, axis=1)] == labels).mean())
    if verbose:
        print(f'1-NN community agreement: {agree:.3f} '
              f'({time.perf_counter() - t0:.1f}s, {device})')
    return agree, losses


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--steps', type=int, default=300)
    args = parser.parse_args()
    main(steps=args.steps, device=args.device)
