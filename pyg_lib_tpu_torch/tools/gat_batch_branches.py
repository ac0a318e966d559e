#!/usr/bin/env python3
"""Hold the padded-batch GAT's weight gradients on the card against the
plain versions, with each leaky_relu free to take its own branch and
with the kernel path's branches, over several weight seeds.

    python3 pyg_lib_tpu_torch/tools/gat_batch_branches.py [TRIALS]

The batch is ``chip_smoke.py``'s: the uniform graph as one padded batch
of ``EDGE_BUDGET``-sized edge slots, ``GATBatch`` ``GAT_BATCH_DIMS`` with
``HEADS`` heads. Each trial seeds the weights with its number, takes
``STEPS`` SGD steps (lr 0.1, cross-entropy on random labels), then
computes the weight gradients of ``sum(out * cot)`` through the model
(K3) and through :func:`chip_smoke.plain_gat_batch`, once with its own
leaky_relu and once with the branches the kernel path took
(:func:`chip_smoke.relu_signs`). It prints, per trial and per
parameter, ``max|kernel - plain|`` over ``testing.GCN_RTOL *
max|plain|`` (above 1 fails ``chip_smoke.py``'s check), and for each
plain run the count of edge logits whose branch differs from the
kernel path's: with its own branches, those the two paths' rounding
switched; with the kernel path's, those it would have switched.
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the batch, the plain GAT, the recorder)
from pyg_lib_tpu_torch.testing import GCN_RTOL, uniform_graph  # noqa: E402


def main(trials):
    import torch

    from pyg_lib_tpu_torch import _build
    from pyg_lib_tpu_torch.models import GATBatch

    dev = chip_smoke.card_setup()
    print(chip_smoke.card(), flush=True)
    _build.build()
    n = chip_smoke.N_NODES
    rowptr, src = uniform_graph(n, chip_smoke.N_EDGES)
    e = int(rowptr[-1])
    slots = -(-e // chip_smoke.EDGE_BUDGET) * chip_smoke.EDGE_BUDGET
    row = torch.full((slots, ), n, dtype=torch.int64, device=dev)
    col = torch.full((slots, ), n, dtype=torch.int64, device=dev)
    row[:e] = torch.tensor(src.astype(np.int64), device=dev)
    col[:e] = torch.tensor(np.repeat(np.arange(n), np.diff(rowptr)),
                           device=dev)
    batch = (torch.tensor(rowptr, device=dev), row, col)
    dims = chip_smoke.GAT_BATCH_DIMS
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, dims[0]), generator=gen, device=dev)
    labels = torch.randint(0, dims[-1], (n, ), generator=gen, device=dev)
    cot = torch.randn((n, dims[-1]), generator=gen, device=dev)
    worst = {'own': 0.0, 'kernel': 0.0}
    for trial in range(trials):
        model = GATBatch(dims, heads=chip_smoke.HEADS,
                         generator=torch.Generator().manual_seed(trial),
                         device=dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        for _ in range(chip_smoke.STEPS):
            opt.zero_grad()
            torch.nn.functional.cross_entropy(model(x, *batch),
                                              labels).backward()
            opt.step()
        leaves = list(model.parameters())
        out, signs = chip_smoke.relu_signs(lambda: model(x, *batch))
        grads = torch.autograd.grad((out * cot).sum(), leaves)
        real = (col < n)[:, None]
        parts = []
        for branches, given in (('own', None), ('kernel', signs)):
            (ref, switched), taken = chip_smoke.relu_signs(
                lambda: chip_smoke.plain_gat_batch(model.params(), x,
                                                   *batch, given))
            if given is None:
                switched = sum(int(((a != b) & real).sum())
                               for a, b in zip(taken, signs))
            refs = torch.autograd.grad((ref * cot).sum(), leaves)
            ratios = [float((g - r).abs().max()) /
                      (GCN_RTOL * float(r.abs().max()))
                      for g, r in zip(grads, refs)]
            worst[branches] = max(worst[branches], max(ratios))
            parts.append(f'{branches} branches ({switched} switched): ' +
                         ' '.join(f'{name} {v:.3g}' for (name, _), v in zip(
                             model.named_parameters(), ratios)))
            del ref, refs, taken
        print(f'trial {trial}: ' + '; '.join(parts), flush=True)
        del model, opt, out, grads, signs
        torch.cuda.empty_cache()
    print(f'largest error / tolerance: {worst}', flush=True)


if __name__ == '__main__':
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
