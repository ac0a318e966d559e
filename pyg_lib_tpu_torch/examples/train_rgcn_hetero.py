"""Heterogeneous R-GCN with hetero neighbour sampling (counterpart of
``examples/train_rgcn_hetero.py``: ogbn-mag's R-GCN shape at small scale).

    python -m pyg_lib_tpu_torch.examples.train_rgcn_hetero \
        [--device cpu] [--steps 60]

Pipeline: ``hetero_neighbor_sample`` (the C++ engine) ->
``pad_hetero_sample_output`` (the flattened relation-blocked layout) ->
``rgcn_forward`` (``segment_matmul`` per relation) -> Adam. Runs on the
CUDA card unless ``--device`` names another device, and raises when there
is no card.
"""

import argparse
import time

import numpy as np
import torch

from pyg_lib_tpu_torch import sampler
from pyg_lib_tpu_torch.datasets import sbm_graph, to_csr
from pyg_lib_tpu_torch.models import (init_rgcn, rgcn_forward,
                                      rgcn_params_from_jax)
from pyg_lib_tpu_torch.utils import _resolve_device


def make_hetero_data(num_papers=400, num_authors=200, seed=0):
    """Papers with SBM structure and authors who write 1-5 papers each;
    returns the papers' SBM dict, the author -> paper CSR, the paper ->
    author CSR and the author count."""
    rng = np.random.default_rng(seed)
    paper = sbm_graph(num_nodes=num_papers, p_in=0.04, p_out=0.003,
                      seed=seed)
    a_src, a_dst = [], []
    for a in range(num_authors):
        k = rng.integers(1, 6)
        papers = rng.choice(num_papers, size=k, replace=False)
        a_src.extend([a] * k)
        a_dst.extend(papers.tolist())
    ap_rowptr, ap_col, _ = to_csr(np.asarray(a_src), np.asarray(a_dst),
                                  num_authors)
    pa_rowptr, pa_col, _ = to_csr(np.asarray(a_dst), np.asarray(a_src),
                                  num_papers)
    return paper, (ap_rowptr, ap_col), (pa_rowptr, pa_col), num_authors


def main(num_papers=400, num_authors=200, steps=60, batch_size=32,
         verbose=True, device=None, params=None):
    """Train on ``device`` (None: the CUDA card), from ``params`` (the
    JAX package's ``init_rgcn`` tree as numpy arrays) or from
    :func:`init_rgcn` (``torch.Generator`` seed 0). Returns the test
    accuracy and the losses of the training steps."""
    device = _resolve_device(device)
    paper, (ap_rowptr, ap_col), (pa_rowptr, pa_col), _ = make_hetero_data(
        num_papers, num_authors)
    rowptr_dict = {
        ('paper', 'cites', 'paper'): paper['rowptr'],
        ('author', 'writes', 'paper'): ap_rowptr,
        ('paper', 'rev_writes', 'author'): pa_rowptr,
    }
    col_dict = {
        ('paper', 'cites', 'paper'): paper['col'],
        ('author', 'writes', 'paper'): ap_col,
        ('paper', 'rev_writes', 'author'): pa_col,
    }
    num_neighbors = {k: [5, 5] for k in rowptr_dict}
    feat = paper['x'].shape[1]
    x_paper = paper['x']
    x_author = np.random.default_rng(1).normal(
        size=(num_authors, feat)).astype(np.float32)
    y = paper['y']
    train_idx = np.nonzero(paper['train_mask'])[0]
    test_idx = np.nonzero(paper['test_mask'])[0]
    budgets = {'paper': 2048, 'author': 1024}
    max_edges = 8192

    dims = [feat, 64, paper['num_classes']]
    if params is None:
        params = init_rgcn(dims, len(rowptr_dict),
                           generator=torch.Generator().manual_seed(0),
                           device=device)
    else:
        params = rgcn_params_from_jax(params, device)
    weights = [w.requires_grad_() for layer in params['layers']
               for w in layer.values()]
    opt = torch.optim.Adam(weights, lr=5e-3)

    def make_batch(seeds, rng_seed):
        out = sampler.hetero_neighbor_sample(
            rowptr_dict, col_dict, {'paper': seeds}, num_neighbors,
            rng=rng_seed)
        hb = sampler.padding.pad_hetero_sample_output(out, budgets,
                                                      max_edges)
        n = hb.num_flat_nodes
        x = np.zeros((n, feat), np.float32)
        po, ao = hb.type_offset['paper'], hb.type_offset['author']
        x[po:po + budgets['paper']] = x_paper[hb.node_id['paper']]
        x[ao:ao + budgets['author']] = x_author[hb.node_id['author']]
        x[po:po + budgets['paper']][~hb.node_mask['paper']] = 0
        x[ao:ao + budgets['author']][~hb.node_mask['author']] = 0
        labels = np.zeros(n, np.int64)
        labels[po:po + budgets['paper']] = y[hb.node_id['paper']]
        seed_mask = np.zeros(n, bool)
        seed_mask[po:po + len(seeds)] = True
        tensors = tuple(torch.from_numpy(a).to(device) for a in (
            x, hb.row, hb.col, labels, seed_mask))
        return tensors[:3] + (hb.rel_ptr, ) + tensors[3:]

    def loss_fn(x, row, col, rel_ptr, labels, seed_mask):
        logp = torch.log_softmax(rgcn_forward(params, x, row, col, rel_ptr),
                                 1)
        nll = -logp.gather(1, labels[:, None])[:, 0]
        return torch.where(seed_mask, nll, 0.0).sum() / seed_mask.sum()

    rng = np.random.default_rng(0)
    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        seeds = rng.choice(train_idx, size=batch_size, replace=False)
        opt.zero_grad()
        loss = loss_fn(*make_batch(seeds, it))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if verbose and (it + 1) % 20 == 0:
            print(f'step {it + 1}: loss={float(loss):.4f}')
    losses = [float(v) for v in losses]
    elapsed = time.perf_counter() - t0

    correct = total = 0
    with torch.no_grad():
        for lo in range(0, len(test_idx), batch_size):
            x, row, col, rel_ptr, labels, seed_mask = make_batch(
                test_idx[lo:lo + batch_size], 10_000 + lo)
            pred = rgcn_forward(params, x, row, col, rel_ptr).argmax(1)
            correct += int((pred == labels)[seed_mask].sum())
            total += int(seed_mask.sum())
    acc = correct / max(total, 1)
    if verbose:
        print(f'test accuracy {acc:.3f} ({elapsed:.1f}s, {device})')
    return acc, losses


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None)
    parser.add_argument('--steps', type=int, default=60)
    args = parser.parse_args()
    main(steps=args.steps, device=args.device)
