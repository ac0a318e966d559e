#!/usr/bin/env python3
"""Pad chunks and hub rows of the huge graph's sharded plans, timed on one
CUDA card.

    python3 pyg_lib_tpu_torch/tools/huge_pads.py    # needs one card

On ``bench/bench_sharded_huge.py``'s Zipf(1.2) graph
(``testing.huge_graph('powerlaw')``: 2,000,000 nodes, 30,009,772 edges at
seed 0), F=128, built as ``chip_smoke.py --sharded`` builds S4
(``dedup='off'``) and S5 (``dedup='auto', minmax='auto'``), 8 row splits:

* each padded split beside the same split without the pad chunks the
  sharded builder appended: K1 on S4's last backward split (bf16), K2h on
  the S5 forward split and K5 on the S5 min/max split with the most pads
  (f32 x; K2h in bf16). Padded and unpadded agree bit for bit (K1, K5) or
  within ``1e-5 * sum|terms| + 1e-5`` of ``dedup_sum_plain`` (K2h, whose
  blocks split the chunk list by its length);
* the first backward split (the hub rows, up to 5,646,299 slots) in bf16
  and f32: K1 on S4's plan, K2 on S5's.

Times are CUDA events (``testing.cuda_ms``: mean of 10 calls after 2).
Prints the card's name and power limit, then one line a reading.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the card and the sizes)
from pyg_lib_tpu_torch.testing import check_sum, cuda_ms  # noqa: E402

F = chip_smoke.HUGE_F
SPLITS = chip_smoke.HUGE_SPLITS


def unpadded(plan):
    """A dedup or dedup min/max ``plan`` without the pad chunks the sharded
    builder appended: the trailing edgeless chunks of its last tile, less
    one where that tile has no other chunk (an edgeless tile's own)."""
    from pyg_lib_tpu_torch import ops

    rows = plan.edge_meta[:, 0, :]
    empty = ((rows < 0) if isinstance(plan, ops.DedupSpmmPlan) else
             (rows >= 128)).all(1) & (plan.chunk_tile == plan.chunk_tile[-1])
    c = plan.num_chunks - int(empty.flip(0).int().cumprod(0).sum())
    if c == 0 or int(plan.chunk_tile[c - 1]) != int(plan.chunk_tile[-1]):
        c += 1
    return plan._replace(uniq_cols=plan.uniq_cols[:c * plan.uc],
                         edge_meta=plan.edge_meta[:c],
                         chunk_tile=plan.chunk_tile[:c])


def pads(label, plans, bare, call, same, first=0):
    """Of splits ``first``, ``first + 1``, ... the one with the most pad
    chunks, padded and bare: ``same`` holds the two outputs to each
    other, then both are timed."""
    i = max(range(len(plans)),
            key=lambda j: plans[j].num_chunks - bare[j].num_chunks)
    same(call(plans[i]), call(bare[i]), bare[i])
    ms = (cuda_ms(lambda: call(plans[i])),
          cuda_ms(lambda: call(bare[i])))
    print(f'{label} split {first + i}: {ms[0]:.3f} ms with '
          f'{plans[i].num_chunks - bare[i].num_chunks} pad chunks (of '
          f'{plans[i].num_chunks}), {ms[1]:.3f} ms without', flush=True)


def main(device='cuda'):
    import importlib

    import torch

    from pyg_lib_tpu_torch import _build, ops
    from pyg_lib_tpu_torch.testing import HUGE_NODES, huge_graph

    tspmm = importlib.import_module('pyg_lib_tpu_torch.ops.spmm')
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('huge_pads: no CUDA device is available')
        print(chip_smoke.card(), flush=True)
        _build.build()
    n = HUGE_NODES
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((n, F), generator=gen, device=dev)
    xb = x.to(torch.bfloat16)
    rp, cl = huge_graph('powerlaw')

    def bits_equal(a, b, _):
        a, b = (a if isinstance(a, tuple) else (a, )), (
            b if isinstance(b, tuple) else (b, ))
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            raise AssertionError('padded and bare splits disagree')

    def near_plain(a, b, plan):
        ref = ops.dedup_sum_plain(xb, plan)
        mag = ops.dedup_sum_plain(xb.abs(), plan)
        for got in (a, b):
            check_sum('K2h', got, ref, mag)

    g4 = ops.build_spmm_graph_sharded(rp, cl, SPLITS, chunk=512, device=dev)
    t_ptr, t_col = tspmm._transpose_csr(rp, cl, n)
    last = tspmm._split_csrs(t_ptr, t_col, n, SPLITS)[-1]
    del t_ptr, t_col
    pads('K1 S4 backward (bf16)', g4.bwd[-1:],
         [ops.build_spmm_plan(*last, chunk=512, device=dev)],
         lambda p: ops.spmm_chunked(xb, p), bits_equal, first=SPLITS - 1)
    hub = {'K1 (S4)': lambda v: ops.spmm_chunked(v, g4.bwd[0])}
    hub_ms = {k: [cuda_ms(lambda: fn(v), iters=5)
                  for v in (xb, x)] for k, fn in hub.items()}
    del g4
    torch.cuda.empty_cache()

    g5 = ops.build_spmm_graph_sharded(rp, cl, SPLITS, dedup='auto',
                                      minmax='auto', device=dev)
    if isinstance(g5.fwd[0], ops.DedupSpmmPlan):
        pads('K2h S5 forward (bf16)', g5.fwd, [unpadded(p) for p in g5.fwd],
             lambda p: ops.dedup_sum(xb, p), near_plain)
    if g5.mm is not None and isinstance(g5.mm[0], ops.DedupMinmaxPlan):
        pads('K5 S5 min/max', g5.mm, [unpadded(p) for p in g5.mm],
             lambda p: ops.dedup_minmax(x, p), bits_equal)
    plan = g5.bwd[0]
    if isinstance(plan, ops.DedupSpmmPlan):
        hub_ms[f'{"K2h" if plan.num_hot else "K2"} (S5)'] = [
            cuda_ms(lambda: ops.dedup_sum(v, plan), iters=5)
            for v in (xb, x)]
    print(f'first backward split (the hub rows), F={F}: ' + '; '.join(
        f'{k} bf16 {v[0]:.3f} ms, f32 {v[1]:.3f} ms'
        for k, v in hub_ms.items()), flush=True)


if __name__ == '__main__':
    main()
