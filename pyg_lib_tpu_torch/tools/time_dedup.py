#!/usr/bin/env python3
"""Time versions of K2 and K2h (``csrc/spmm_dedup.cu``) against each other.

    python3 pyg_lib_tpu_torch/tools/time_dedup.py A.cu B.cu B.cu A.cu

Each argument is a source with the C interface of ``csrc/spmm_dedup.cu``
(``pygt_dedup_sum``), built by ``_build.build_variants`` (as the package's
own sources, all in parallel, into ``_build/``). On
``chip_smoke.py``'s power-law graph (``bench.py``'s ``child_realistic``
generator, 262,144 nodes, 4,194,304 edges) built ``dedup='auto'``,
``dedup_sum`` runs at F=512 f32 through each source in the order given, so
listing them as ``A B B A`` interleaves two versions on one card: the
forward plan (K2h) and its transpose (K2), each held against
``dedup_sum_plain`` within ``1e-5 * sum|terms| + 1e-5`` and timed by CUDA
events (mean of 20 calls after 3). Prints the card's name and power limit,
each build's registers and spills, then one line per argument. Needs
one card.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import ab  # noqa: E402  (what the A B B A tools share)
import chip_smoke  # noqa: E402  (the card and the bench sizes)
from pyg_lib_tpu_torch.testing import (  # noqa: E402
    check_sum, cuda_ms, powerlaw_graph)

F = 512


def main(paths):
    import torch

    from pyg_lib_tpu_torch import _build, ops
    from pyg_lib_tpu_torch.ops.kernels import spmm_dedup

    if not torch.cuda.is_available():
        raise SystemExit('no CUDA card')
    print(chip_smoke.card(), flush=True)
    libs = ab.build(paths)
    rp, cl = powerlaw_graph(chip_smoke.N_NODES, chip_smoke.N_EDGES)
    graph = ops.build_spmm_graph(rp, cl, dedup='auto')
    dev = torch.device('cuda')
    x = torch.randn((chip_smoke.N_NODES, F),
                    generator=torch.Generator(dev).manual_seed(0), device=dev)
    plans = {'K2h': graph.fwd, 'K2': graph.bwd}
    refs = {kid: (spmm_dedup.dedup_sum_plain(x, plan),
                  spmm_dedup.dedup_sum_plain(x.abs(), plan))
            for kid, plan in plans.items()}
    for p in paths:
        # The wrapper takes its library from _build's table of loaded ones.
        _build._loaded['spmm_dedup'] = libs[p]
        line = []
        for kid, plan in plans.items():
            e = check_sum(f'{p} {kid}', spmm_dedup.dedup_sum(x, plan),
                          *refs[kid])
            ms = cuda_ms(lambda: spmm_dedup.dedup_sum(x, plan), iters=20,
                         warmup=3)
            line.append(f'{kid} {ms:.3f} ms (max_abs_err {e:.3g})')
        print(f'{p}: ' + ', '.join(line), flush=True)


if __name__ == '__main__':
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1:])
