#!/usr/bin/env python3
"""A full training step of a graph larger than one plan should hold, on one
CUDA card: the port's counterpart of ``bench/bench_sharded_huge.py``.

    python3 pyg_lib_tpu_torch/tools/sharded_huge.py    # needs one card

The bench's graph and knobs (``testing.huge_graph``: 2,000,000 nodes,
30,009,772 edges at seed 0, F=128 f32): ``PYGT_HUGE_SPLITS`` row splits
(default 8), ``PYGT_HUGE_RANGE_SPLIT`` column ranges a split (default 1;
then ``chunk='auto'``, else 512), ``PYGT_HUGE_GRAPH`` ``uniform`` or
``powerlaw`` (Zipf(1.2) columns) and ``PYGT_HUGE_DEDUP`` (default
``off``). The step is the value and gradient of
``(spmm_sharded(x, graph, 'mean', 'bf16')**2).sum()``: the first one
untimed (``first_step_s``), then the second (``step_s``, host clock to a
synchronize). Prints the card's name and power limit (``nvidia-smi``),
then one JSON line with the bench's fields; ``traffic_gbps`` is its
formula, ``2 (E·F·4 + E·4 + N·F·4)`` bytes over the step.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the card's name)

F = 128


def main():
    import torch

    from pyg_lib_tpu_torch import _build, ops
    from pyg_lib_tpu_torch.testing import HUGE_NODES, huge_graph

    if not torch.cuda.is_available():
        raise SystemExit('sharded_huge: no CUDA device is available')
    smi = chip_smoke.card()
    print(smi, flush=True)
    _build.build()
    splits = int(os.environ.get('PYGT_HUGE_SPLITS', 8))
    rs = int(os.environ.get('PYGT_HUGE_RANGE_SPLIT', 1))
    family = os.environ.get('PYGT_HUGE_GRAPH', 'uniform')
    dedup = os.environ.get('PYGT_HUGE_DEDUP', 'off')
    n = HUGE_NODES
    rowptr, col = huge_graph(family)
    e = int(rowptr[-1])

    t0 = time.perf_counter()
    graph = ops.build_spmm_graph_sharded(
        rowptr, col, splits, chunk=512 if rs == 1 else 'auto',
        range_split=rs, dedup=dedup)
    build_s = time.perf_counter() - t0
    del rowptr, col
    dev = graph.deg.device
    x = torch.randn((n, F), generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev, requires_grad=True)

    def step():
        loss = (ops.spmm_sharded(x, graph, reduce='mean',
                                 precision='bf16')**2).sum()
        (grad, ) = torch.autograd.grad(loss, x)
        return float(loss), float(grad[0, 0])

    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    first_s, step_s = times
    print(json.dumps({
        'config': f'31M sharded={splits} rs={rs} bf16 {family} '
                  f'dedup={dedup}',
        'step_s': step_s,
        'first_step_s': first_s,
        'plan_build_s': build_s,
        'traffic_gbps': 2 * (e * F * 4 + e * 4 + n * F * 4) / step_s / 1e9,
        'card': smi,
    }), flush=True)


if __name__ == '__main__':
    main()
