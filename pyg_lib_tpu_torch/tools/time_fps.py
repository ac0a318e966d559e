#!/usr/bin/env python3
"""Time versions of F1 (``csrc/fps.cu``) against each other.

    python3 pyg_lib_tpu_torch/tools/time_fps.py A.cu B.cu B.cu A.cu
    python3 pyg_lib_tpu_torch/tools/time_fps.py A.cu \\
        pyg_lib_tpu_torch/csrc/fps.cu@S_THREADS=128 ... A.cu

Each argument is a source with the C interface of ``csrc/fps.cu`` or of
its one-block design before the tiers (``pygt_fps`` with eight
parameters: ``git show <commit>:pyg_lib_tpu_torch/csrc/fps.cu``, kept
under ``_ab/``), built by ``_build.build_variants`` (all in parallel,
into ``_build/``). ``path@NAME=VALUE,...`` sets the wrapper's
``S_THREADS``, ``C_THREADS`` or ``G_THREADS`` for that source; these are
also the source's ``F1_S_THREADS``, ``F1_C_THREADS`` and
``F1_G_THREADS``, so the tool builds a copy of the source with them set
(under ``_build/fps-variants/``). Listing sources
as ``A B B A`` interleaves two versions on one card.

On ``chip_smoke.py``'s F1 shapes (``f1_shapes``: PointNet++'s SA1 and
SA2 clouds, one and eight clouds of 100,000 points at ratio 0.1, one of
1,000,000 at ratio 0.01), each source's picks are held against
``fps_plain``'s (computed once a shape on the card) bit for bit, and
timed by CUDA events (mean of 20 calls after 3 on PointNet++'s clouds,
of 3 after 1 on the large ones) beside its latency floor (the source's
``pygt_fps_floor``). Every source is timed the same way, through its C
interface alone (``bare``: each call copies the table to the card, makes
the output and calls the C function, with no checks); a source with the
current interface is also timed through the wrapper ``fps_kernel``, whose
checks, plan and occupancy lookup add the difference. On PointNet++'s
clouds, where the host work may outlast the kernel, the line also gives
the profiler's device time of the kernel
(``chip_smoke.device_time_by_kernel``, over 20 calls). For tiers C and G
it gives the clusters the card holds at once. ``--shapes``
takes a comma-separated subset of ``sa1,sa2,big,batch,huge``. Prints the
card's name and power limit, each build's registers and spills, then one
line per argument. Needs one card.
"""

import argparse
import ctypes
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import ab  # noqa: E402  (what the A B B A tools share)
import chip_smoke  # noqa: E402  (the F1 shapes and the profiler reader)
from pyg_lib_tpu_torch.testing import cuda_ms  # noqa: E402

SHAPES = ('sa1', 'sa2', 'big', 'batch', 'huge')
MACROS = {'S_THREADS': 'F1_S_THREADS', 'C_THREADS': 'F1_C_THREADS',
          'G_THREADS': 'F1_G_THREADS'}
EARLIER_THREADS = 512  # the one-block design's block


def variant(path, attrs):
    """``path`` itself, or a copy of it with the thread counts of
    ``attrs`` compiled in (``_build/fps-variants/``)."""
    macros = {MACROS[k]: v for k, v in attrs.items() if k in MACROS}
    if not macros:
        return path
    from pyg_lib_tpu_torch import _build

    text = Path(path).read_text()
    for name, value in macros.items():
        text, n = re.subn(rf'#define {name} \d+', f'#define {name} {value}',
                          text)
        if n != 1:
            raise SystemExit(f'{path} defines no {name}')
    out = _build.BUILD_DIR / 'fps-variants'
    out.mkdir(parents=True, exist_ok=True)
    tag = '-'.join(f'{k}{v}' for k, v in sorted(macros.items()))
    copy = out / f'{Path(path).stem}-{tag}.cu'
    copy.write_text(text)
    return str(copy)


def bare(lib, params):
    """F1 and its floor through the C interface of ``lib`` (``params``: 8
    for the one-block design, else the current one) with no wrapper:
    ``(fps(pos, clouds), floor(clouds, dev))``. The current interface
    takes the plan the wrapper would give (the module's constants, so
    ``@S_THREADS=...`` holds here too)."""
    import torch

    from pyg_lib_tpu_torch.ops.kernels import fps
    from pyg_lib_tpu_torch.ops.kernels.fps import _table

    vp, i = ctypes.c_void_p, ctypes.c_int

    def run_now(f, pos, clouds):
        dev = pos.device
        plan = fps._batch_plan(clouds, pos.shape[1])
        scratch = torch.empty(pos.shape[0] if plan.tier == 'G' else 0,
                              dtype=torch.float32, device=dev)
        out = torch.empty(int(clouds[:, 2].sum()), dtype=torch.int32,
                          device=dev)
        table = _table(clouds, dev)
        return f(pos.data_ptr(), pos.shape[1], table.data_ptr(),
                 clouds.shape[0], out.data_ptr(), scratch.data_ptr(),
                 fps.TIERS[plan.tier], plan.cluster, plan.threads,
                 plan.items, plan.smem_bytes,
                 torch.cuda.current_stream(dev).cuda_stream), out

    if params != 8:
        return (ab.direct(lib.pygt_fps, [vp, i, vp, i, vp, vp, i, i, i, i, i,
                                         vp], run_now), fps.fps_floor)

    def run(f, pos, clouds):
        dev = pos.device
        n, m = clouds[:, 1], clouds[:, 2]
        items = next((k for k in (1, 2, 4, 8, 16)
                      if EARLIER_THREADS * k >= n.max()), 16)
        scratch = torch.empty(
            pos.shape[0] if n.max() > EARLIER_THREADS * items else 0,
            dtype=torch.float32, device=dev)
        out = torch.empty(int(m.sum()), dtype=torch.int32, device=dev)
        table = _table(clouds, dev)
        return f(pos.data_ptr(), pos.shape[1], table.data_ptr(),
                 clouds.shape[0], out.data_ptr(), scratch.data_ptr(), items,
                 torch.cuda.current_stream(dev).cuda_stream), out

    def run_floor(f, clouds, dev):
        out = torch.empty(int(clouds[:, 2].sum()), dtype=torch.int32,
                          device=dev)
        table = _table(clouds, dev)
        return f(table.data_ptr(), clouds.shape[0], out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream), out

    return (ab.direct(lib.pygt_fps, [vp, i, vp, i, vp, vp, i, vp], run),
            ab.direct(lib.pygt_fps_floor, [vp, i, vp, vp], run_floor))


def device_ms(run, pts, clouds, calls=20):
    """The kernel's device ms a call: the profiler's time of the
    kernels named ``fps`` over ``calls`` calls."""
    _, _, top = chip_smoke.device_time_by_kernel(
        lambda: [run(pts, clouds) for _ in range(calls)])
    return sum(ms for name, ms in top if 'fps' in name) / calls


def main(args):
    import torch

    from pyg_lib_tpu_torch import _build
    from pyg_lib_tpu_torch.ops.kernels import fps

    if not torch.cuda.is_available():
        raise SystemExit('no CUDA card')
    parsed = [ab.parse(a, {'fps': ('F1', fps)}) for a in args.sources]
    built = {a: variant(path, attrs)
             for a, (path, _, _, _, attrs) in zip(args.sources, parsed)}
    print(chip_smoke.card(), flush=True)
    libs = ab.build(list(built.values()))
    dev = torch.device('cuda')
    pos, ptr, _ = chip_smoke.cloud_batch(dev)
    big = torch.randn((chip_smoke.BIG_CLOUD, 3),
                      generator=torch.Generator().manual_seed(13))
    shapes = [s for key, s in zip(SHAPES, chip_smoke.f1_shapes(dev, pos, ptr,
                                                               big))
              if key in args.shapes]
    refs = [fps.fps_plain(pts, clouds) for _, pts, clouds, _ in shapes]
    torch.cuda.synchronize()
    for a, (path, _, params, _, attrs) in zip(args.sources, parsed):
        lib = libs[built[a]]
        run, floor = bare(lib, params)
        wrapped = params != 8
        if wrapped:
            _build._loaded['fps'] = lib
            fps._active.clear()  # occupancy is the library's
        saved = ab.set_constants(fps, attrs)
        try:
            line = []
            for (label, pts, clouds, cheap), ref in zip(shapes, refs):
                calls = [run] + [fps.fps_kernel] * wrapped
                for call in calls:
                    if not chip_smoke.torch_equal(call(pts, clouds), ref):
                        raise AssertionError(f'{a} differs from fps_plain '
                                             f'on {label}')
                iters, warmup = (20, 3) if cheap else (3, 1)
                ms = [cuda_ms(lambda: call(pts, clouds), iters=iters,
                              warmup=warmup)
                      for call in calls]
                floor_ms = cuda_ms(
                    lambda: floor(clouds, dev), iters=iters, warmup=warmup)
                note = f'floor {floor_ms:.3f}'
                if wrapped:
                    note += f', wrapper {ms[1]:.3f}'
                if cheap:
                    note += f', device {device_ms(run, pts, clouds):.3f}'
                if wrapped:
                    plan = fps._batch_plan(clouds, pts.shape[1])
                    note += (f', tier {plan.tier} C={plan.cluster} '
                             f'{plan.threads} threads')
                    if plan.tier != 'S':
                        note += (', ' + str(fps.active_clusters(
                            plan, pts.shape[1], dev)) + ' clusters at once')
                line.append(f'{label}: {ms[0]:.3f} ms ({note})')
        finally:
            ab.set_constants(fps, saved)
        print(f'{a}: ' + '; '.join(line), flush=True)


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('sources', nargs='+')
    p.add_argument('--shapes', type=lambda s: s.split(','),
                   default=list(SHAPES))
    a = p.parse_args()
    if set(a.shapes) - set(SHAPES):
        raise SystemExit(f'--shapes takes {",".join(SHAPES)}')
    main(a)
