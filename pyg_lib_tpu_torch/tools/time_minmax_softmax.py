#!/usr/bin/env python3
"""Time versions of K5 (``csrc/spmm_dedup_minmax.cu``) and K6
(``csrc/segment_softmax.cu``) against each other.

    python3 pyg_lib_tpu_torch/tools/time_minmax_softmax.py A.cu B.cu B.cu A.cu

Each argument is a source with the C interface of ``spmm_dedup_minmax.cu``
(``pygt_dedup_max``) or ``segment_softmax.cu`` (``pygt_segment_softmax``),
either the current one (called through the wrapper, with its derived
tables) or the first one (no derived tables: K5 with its ``[N, F]`` key
table, zero-filled in the call, K6 with ``tile_ptr``; called directly;
the two callers of the first interfaces can go once no A/B against it is
needed), optionally followed by ``@NAME=VALUE`` pairs joined by ``,``
that set constants of the wrapper module for that argument's calls
(``K5_SEG`` of ``spmm_dedup_minmax.py``; ``K6_UNITS_PER_SM`` and
``K6_MIN_STRETCH`` of ``segment_softmax.py``). The sources are built by
``_build.build_variants``, all in parallel. On ``chip_smoke.py``'s graphs,
in the order given, so that ``A B B A`` interleaves two versions on one
card:

* K5 on the power-law graph's min/max plan (the plan ``minmax='auto'``
  builds) at F=512 and F=47: the first K5 source's values and positions
  are held against ``dedup_minmax_plain`` bit for bit, every other
  source's against the first one's;
* K6 on the uniform graph's forward plan, padded ``[E_pad, 4]`` logits in
  f32 and bf16, and through ``edge_perm`` on the power-law graph's
  transpose CSR (hub rows up to 810,552 edges) at F=4: each source held
  against ``segment_softmax_plain`` by ``testing.check_softmax``.

Times are CUDA events, the mean of 20 calls after 3 (5 after 1 on the hub
rows). Prints the card's name and power limit, each build's registers and
spills, then per argument one line of times and one of device time by
kernel for one call of each case (``torch.profiler``: K5's zero-fill,
merge and decode, K6's passes). Needs one card.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import ab  # noqa: E402  (what the A B B A tools share)
import chip_smoke  # noqa: E402  (the bench sizes and the profiler reader)
from pyg_lib_tpu_torch.testing import (  # noqa: E402
    check_exact, check_softmax, cuda_ms, powerlaw_graph, uniform_graph)

HEADS = chip_smoke.HEADS


def _exports():
    from pyg_lib_tpu_torch.ops.kernels import (segment_softmax,
                                               spmm_dedup_minmax)

    return {'dedup_max': ('K5', spmm_dedup_minmax),
            'segment_softmax': ('K6', segment_softmax)}


def _k5_call(lib, nparams):
    """K5 through ``lib``: the current interface through the wrapper, the
    first one (14 parameters, an ``[N, F]`` key table) directly, its
    zero-fill included."""
    import torch

    from pyg_lib_tpu_torch import _build
    from pyg_lib_tpu_torch.ops.kernels import spmm_dedup_minmax

    if nparams != 14:
        _build._loaded['spmm_dedup_minmax'] = lib
        return spmm_dedup_minmax.dedup_minmax

    def launch(fn, x, plan, negate=False):
        shape = (plan.num_rows, x.shape[1])
        keys = torch.zeros(shape, dtype=torch.int64, device=x.device)
        vals = torch.empty(shape, dtype=torch.float32, device=x.device)
        pos = torch.empty(shape, dtype=torch.int32, device=x.device)
        err = fn(x.data_ptr(), plan.uniq_cols.data_ptr(),
                 plan.edge_meta.data_ptr(), plan.chunk_tile.data_ptr(),
                 plan.num_chunks, plan.ec, plan.uc, int(negate),
                 keys.data_ptr(), vals.data_ptr(), pos.data_ptr(),
                 plan.num_rows, x.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        return err, (vals, pos)

    vp, i = ctypes.c_void_p, ctypes.c_int
    return ab.direct(lib.pygt_dedup_max,
                     [vp, vp, vp, vp, i, i, i, i, vp, vp, vp, i, i, vp],
                     launch)


def _k6_call(lib, nparams):
    """K6 through ``lib``: the current interface through the wrapper, the
    first one (9 parameters, ``tile_ptr``) directly."""
    import torch

    from pyg_lib_tpu_torch import _build
    from pyg_lib_tpu_torch.ops.kernels import segment_softmax
    from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import DTYPE_CODE

    if nparams != 9:
        _build._loaded['segment_softmax'] = lib
        return segment_softmax.segment_softmax_planned

    def launch(fn, src, plan, idx=None):
        out = torch.empty_like(src)
        err = fn(src.data_ptr(), DTYPE_CODE[src.dtype],
                 None if idx is None else idx.data_ptr(),
                 plan.tile_ptr.data_ptr(), out.data_ptr(),
                 plan.tile_ptr.shape[0], plan.col_padded.shape[0],
                 src.shape[1], torch.cuda.current_stream().cuda_stream)
        return err, out

    vp, i = ctypes.c_void_p, ctypes.c_int
    return ab.direct(lib.pygt_segment_softmax,
                     [vp, i, vp, vp, vp, i, i, i, vp], launch)


def main(args):
    import torch

    from pyg_lib_tpu_torch import ops
    from pyg_lib_tpu_torch.ops.kernels.plan_cache import plan_for_ptr

    if not torch.cuda.is_available():
        raise SystemExit('no CUDA card')
    print(chip_smoke.card(), flush=True)
    exports = _exports()
    specs = [ab.parse(a, exports) for a in args]
    libs = ab.build(s[0] for s in specs)
    kinds = {s[1] for s in specs}
    dev = torch.device('cuda')
    n = chip_smoke.N_NODES
    gen = torch.Generator(dev).manual_seed(0)
    rp_p, cl_p = powerlaw_graph(n, chip_smoke.N_EDGES)
    k5_cases, k6_cases = [], []
    if 'K5' in kinds:
        rp_d, cl_d = ops.dedup_pairs(rp_p, cl_p)
        ec, uc = ops.estimate_minmax_config(rp_d, cl_d)
        mm = ops.build_dedup_minmax_plan(rp_d, cl_d, ec=ec, uc=uc,
                                         _pre_deduped=True)
        print(f'DedupMinmaxPlan chunks={mm.num_chunks} ec={mm.ec} '
              f'uc={mm.uc} edges={int((mm.edge_meta[:, 0, :] < 128).sum())}'
              f' largest tile {int(torch.bincount(mm.chunk_tile).max())} '
              f'chunks', flush=True)
        x = torch.randn((n, chip_smoke.F_BENCH), generator=gen, device=dev)
        for f in (chip_smoke.F_BENCH, chip_smoke.DIMS[-1]):
            xf = x if f == x.shape[1] else x[:, :f].contiguous()
            ref = chip_smoke.by_columns(ops.dedup_minmax_plain, xf, mm)
            k5_cases.append((f'powerlaw mm F={f}', xf, mm, ref))
    if 'K6' in kinds:
        rp_u, cl_u = uniform_graph(n, chip_smoke.N_EDGES)
        plan_u = ops.build_spmm_plan(rp_u, cl_u, chunk=512,
                                     with_edge_maps=True)
        t_rp = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(cl_p, minlength=n), out=t_rp[1:])
        plan_t = plan_for_ptr(torch.tensor(t_rp, device=dev))
        logits = torch.randn((plan_u.col_padded.shape[0], HEADS),
                             generator=gen, device=dev)
        src_t = torch.randn((int(t_rp[-1]), HEADS), generator=gen,
                            device=dev)
        for label, src, plan, idx, hub in (
                ('uniform fwd padded F=4 f32', logits, plan_u, None, False),
                ('uniform fwd padded F=4 bf16', logits.to(torch.bfloat16),
                 plan_u, None, False),
                (f'powerlaw transpose CSR edge_perm F=4 (rows up to '
                 f'{int(np.diff(t_rp).max())})', src_t, plan_t,
                 plan_t.edge_perm, True)):
            k6_cases.append((label, src, plan, idx, hub,
                             ops.segment_softmax_plain(src, plan, idx)))
    torch.cuda.empty_cache()
    firsts = {}
    for arg, (path, kid, nparams, module, attrs) in zip(args, specs):
        lib = libs[path]
        saved = ab.set_constants(module, attrs)
        line, prof = [], []
        if kid == 'K5':
            k5 = _k5_call(lib, nparams)
            for label, xf, plan, ref in k5_cases:
                got = k5(xf, plan)
                first = firsts.setdefault(label, got)
                check_exact(f'{arg} K5 {label} against ' + (
                    'dedup_minmax_plain' if first is got else
                    'the first K5 source'), got, ref if first is got else
                    first)
                ms = cuda_ms(lambda: k5(xf, plan), 20, 3)
                line.append(f'K5 {label} {ms:.3f} ms')
                _, _, top = chip_smoke.device_time_by_kernel(
                    lambda: k5(xf, plan))
                prof.append(f'{label}: ' + '; '.join(
                    f'{name} {t:.3f}' for name, t in top))
                del got
        else:
            k6 = _k6_call(lib, nparams)
            for label, src, plan, idx, hub, ref in k6_cases:
                e, _ = check_softmax(f'{arg} K6 {label}', k6(src, plan, idx),
                                     ref, plan, idx)
                ms = cuda_ms(lambda: k6(src, plan, idx),
                             *((5, 1) if hub else (20, 3)))
                line.append(f'K6 {label} {ms:.3f} ms (max_abs_err {e:.3g})')
                _, _, top = chip_smoke.device_time_by_kernel(
                    lambda: k6(src, plan, idx))
                prof.append(f'{label}: ' + '; '.join(
                    f'{name} {t:.3f}' for name, t in top))
        ab.set_constants(module, saved)
        print(f'{arg}: ' + ', '.join(line), flush=True)
        print('  by kernel (ms): ' + ' | '.join(prof), flush=True)


if __name__ == '__main__':
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1:])
