#!/usr/bin/env python3
"""The port's headline: ``spmm``'s useful-bytes rate on one CUDA card.

    python3 pyg_lib_tpu_torch/tools/headline.py    # needs one card

On ``bench.py``'s two graphs at its size (262,144 nodes, about 4.2M edges,
F=512, f32): ``child_headline``'s uniform graph over the plain chunked
plan (kernel K1) and ``child_realistic``'s Zipf(1.2) graph built
``dedup='auto'`` (K2h forward). The rate is ``bench.py``'s, useful bytes
``E·F·4 + E·4 + N·F·4`` (x rows read once per edge, the column ids, the
output written once) over the time of one ``spmm`` call (CUDA events,
mean of 20 calls after a warm-up), and that rate over the H100's 3.35
TB/s as ``vs_baseline``, bench.py's name for the ratio. It is no roofline
share and can pass 1: a dedup plan reads each repeated x row once, and
the 50 MB L2 serves repeats, so the card moves fewer bytes than the
useful ones counted. Each result is first held against
``torch.sparse.mm`` on the same CSR within ``1e-5 * sum|terms| + 1e-5``.

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line per graph.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the card's name and the CUDA-event timer)

N, E, F = 262_144, 4_194_304, 512
HBM_BYTES_PER_S = 3.35e12
TOL = 1e-5


def main():
    import numpy as np
    import torch

    from pyg_lib_tpu_torch import _build, ops
    from pyg_lib_tpu_torch.testing import powerlaw_graph, uniform_graph

    if not torch.cuda.is_available():
        raise SystemExit('headline: no CUDA device is available')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card(), flush=True)
    _build.build()
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N, F), generator=gen, device=dev)
    for name, make, dedup in (('uniform', uniform_graph, 'off'),
                              ('powerlaw', powerlaw_graph, 'auto')):
        rowptr, col = make(N, E)
        graph = ops.build_spmm_graph(rowptr, col, dedup=dedup)
        e = int(rowptr[-1])
        a = torch.sparse_csr_tensor(
            torch.from_numpy(rowptr), torch.from_numpy(col.astype(np.int64)),
            torch.ones(e), (N, N)).to(dev)
        got = ops.spmm(x, graph)
        ref = torch.sparse.mm(a, x)
        bound = torch.sparse.mm(a, x.abs()) * TOL + TOL
        err = float((got - ref).abs().max())
        if not bool(((got - ref).abs() <= bound).all()):
            raise AssertionError(f'spmm on {name} disagrees with '
                                 f'torch.sparse.mm: max_abs_err {err}')
        del got, ref, bound, a
        ms = chip_smoke.cuda_ms(lambda: ops.spmm(x, graph), iters=20)
        useful = e * F * 4 + e * 4 + N * F * 4
        gbps = useful / ms / 1e6
        print(json.dumps({
            'metric': 'spmm_effective_bandwidth', 'graph': name,
            'plan': type(graph.fwd).__name__, 'value': gbps, 'unit': 'GB/s',
            'vs_baseline': gbps * 1e9 / HBM_BYTES_PER_S, 'ms': ms,
            'nodes': N, 'edges': e, 'features': F, 'precision': 'f32',
            'max_abs_err': err}), flush=True)
        del graph
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
