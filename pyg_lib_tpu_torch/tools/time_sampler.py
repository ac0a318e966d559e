"""Time versions of the host engine's homogeneous sampler
(``csrc/host/sampler.cpp``) on a uniform graph of ogbn-products' shape,
as the products cell samples it: batches of 1,024 seeds, fanouts
[15, 10, 5], ``csc=True``. A B B A, in one process::

    python3 pyg_lib_tpu_torch/tools/time_sampler.py _ab/A.cpp \\
        pyg_lib_tpu_torch/csrc/host/sampler.cpp [--threads 4] \\
        [--batches 32] [--nodes N --edges E]

Each source is built alone with the engine's flags (its own directory
first on the include path, then ``csrc/host``) into
``_build/sampler-variants/``. For each source, one thread samples
``--batches`` batches, the sources taking turns batch by batch; then
``--threads`` threads sample and pad as many, source after source in
A B B A order, each batch as the loader makes it (a source with
``pygt_result_pad`` copies no tuple out). Printed a batch (medians, ms):
``call`` (``pygt_neighbor_sample``), ``copy`` (the seven arrays of the
tuple copied out, as ``neighbor_sample_cpp`` does), ``pad`` (the padded
batch: the engine's ``pygt_result_pad`` where the source has it, else
``pad_sample_output`` over the tuple), and with threads the wall time a
batch. Every source's samples must equal the first one's.

``--loader N`` then runs the port's ``NeighborLoader`` as the products
cell builds it (4 workers, lookahead 4, ``csc=True``, 100 f32 features,
onto the card when there is one) for ``N`` batches with nothing to
consume them, its workers' spans recorded: the host's own rate, each
phase's median, the ``sampler.sample`` spans by ``path``, and a digest
of the ``sampler.pad`` counters of batches 8 to ``N`` (the same batches
give the same digest, whichever version of the port makes them).
"""

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pyg_lib_tpu_torch import _build  # noqa: E402
from pyg_lib_tpu_torch.sampler import padding  # noqa: E402

NODES, EDGES = 2449029, 123718280
BATCH, FANOUTS = 1024, [15, 10, 5]


def build(path: str) -> ctypes.CDLL:
    """``path`` as a library of its own (cached by content and flags)."""
    src = Path(path).resolve()
    h = hashlib.sha256(' '.join(_build.HOST_FLAGS).encode())
    for p in [src] + sorted(_build.HOST.glob('*.h')):
        h.update(p.read_bytes())
    out = _build.BUILD_DIR / 'sampler-variants' / f'{h.hexdigest()[:16]}.so'
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._gxx(), *_build.HOST_FLAGS, f'-I{src.parent}',
                        f'-I{_build.HOST}', '-o', str(out), str(src)],
                       check=True)
    lib = ctypes.CDLL(str(out))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.pygt_neighbor_sample.restype = ctypes.c_void_p
    lib.pygt_neighbor_sample.argtypes = [
        i64p, i64p, i64, i64p, i64, i64p, i64, ctypes.c_void_p, i64p, i64p,
        i64p, i32, i32, i32, i32, i32, i32, ctypes.c_uint64]
    lib.pygt_result_sizes.argtypes = [ctypes.c_void_p, i64p]
    lib.pygt_result_copy.argtypes = [ctypes.c_void_p] + [i64p] * 7
    lib.pygt_result_free.argtypes = [ctypes.c_void_p]
    lib.has_pad = hasattr(lib, 'pygt_result_pad')
    if lib.has_pad:
        i32p, u8p = ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_uint8)
        lib.pygt_result_pad.restype = i32
        lib.pygt_result_pad.argtypes = [ctypes.c_void_p, i64, i64, i64p,
                                        i32p, u8p, i32p, i32p, i32p, i64p,
                                        u8p]
    return lib


def ptr(a, typ=ctypes.c_int64):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def graph(n: int, e: int, seed: int = 0):
    """The benchmark's uniform graph in numpy: row degrees uniform in
    ``[0, 2e/n)``, scaled to about ``e`` edges, uniform columns."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max(2 * e // n, 1), n)
    deg = (deg * (e / max(int(deg.sum()), 1))).astype(np.int64)
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    return rowptr, rng.integers(0, n, int(rowptr[-1]), dtype=np.int64)


def one(lib, rowptr, col, seeds, stream, budget, check=True):
    """One batch: (call s, copy s, pad s, the tuple's arrays). Without
    ``check`` a source with ``pygt_result_pad`` copies nothing out, as
    the loader's padded path."""
    fan = np.asarray(FANOUTS, np.int64)
    t0 = time.perf_counter()
    h = lib.pygt_neighbor_sample(
        ptr(rowptr), ptr(col), len(rowptr) - 1, ptr(seeds), len(seeds),
        ptr(fan), len(fan), None, None, None, None, 0, 1, 0, 0, 1, 0,
        stream)
    t1 = time.perf_counter()
    sizes = np.zeros(5, np.int64)
    lib.pygt_result_sizes(h, ptr(sizes))
    ne, nn, nei, nph, neph = map(int, sizes)
    arrs = [np.empty(k if check or not lib.has_pad else 0, np.int64)
            for k in (ne, ne, nei, nn, nn, nph, neph)]
    lib.pygt_result_copy(h, *[ptr(a) if len(a) else None for a in arrs])
    t2 = time.perf_counter()
    rows, cols, eids, nodes, _, nph_a, eph_a = arrs
    if lib.has_pad:
        bn, be = budget
        out = [np.empty(bn, np.int64), None, np.empty(bn, bool),
               np.empty(bn + 1, np.int32), np.empty(be, np.int32),
               np.empty(be, np.int32), np.empty(be, np.int64),
               np.empty(be, bool)]
        i32, u8 = ctypes.c_int32, ctypes.c_uint8
        rc = lib.pygt_result_pad(h, bn, be, ptr(out[0]), None,
                                 ptr(out[2], u8), ptr(out[3], i32),
                                 ptr(out[4], i32), ptr(out[5], i32),
                                 ptr(out[6]), ptr(out[7], u8))
        assert rc == 0, rc
    else:
        padding.pad_sample_output((cols, rows, nodes, eids, nph_a.tolist(),
                                   eph_a.tolist()), *budget, BATCH)
    t3 = time.perf_counter()
    lib.pygt_result_free(h)
    return t1 - t0, t2 - t1, t3 - t2, arrs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('sources', nargs='+')
    ap.add_argument('--threads', type=int, default=4)
    ap.add_argument('--batches', type=int, default=32)
    ap.add_argument('--nodes', type=int, default=NODES)
    ap.add_argument('--edges', type=int, default=EDGES)
    ap.add_argument('--loader', type=int, default=0)
    args = ap.parse_args(argv)
    libs = [build(s) for s in args.sources]
    t0 = time.perf_counter()
    rowptr, col = graph(args.nodes, args.edges)
    train = np.random.default_rng(1).permutation(args.nodes)
    print(f'graph: {args.nodes} nodes, {len(col)} edges in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    budget = padding.budget_for(BATCH, FANOUTS)
    seeds = [np.ascontiguousarray(train[i * BATCH % (args.nodes - BATCH):]
                                  [:BATCH]) for i in range(args.batches)]
    for lib in libs:  # warm-up, and each source's samples against A's
        one(lib, rowptr, col, seeds[0], 7, budget)
    times = {s: [] for s in args.sources}
    for i in range(args.batches):
        order = list(zip(args.sources, libs))
        got = {}
        for src, lib in (order if i % 2 == 0 else order[::-1]):
            *t, got[src] = one(lib, rowptr, col, seeds[i], 1000 + i, budget)
            times[src].append(t)
        ref = got[args.sources[0]]
        for src in args.sources[1:]:
            if not all(np.array_equal(a, b) for a, b in zip(got[src], ref)):
                raise SystemExit(f'{src}: batch {i} differs from '
                                 f'{args.sources[0]}\'s')
    edges = len(ref[0])
    for src in args.sources:
        call, copy, pad = (statistics.median(v) * 1e3
                           for v in zip(*times[src]))
        print(f'1 thread  {src}: call {call:.1f}, copy {copy:.1f}, pad '
              f'{pad:.1f} ms a batch ({edges} edges in the last)',
              flush=True)
    if args.threads > 1:
        order = list(zip(args.sources, libs))
        for src, lib in order + order[::-1]:
            calls = []

            def work(k):
                for i in range(k, args.batches, args.threads):
                    calls.append(one(lib, rowptr, col, seeds[i], 2000 + i,
                                     budget, check=False)[0])

            t0 = time.perf_counter()
            ts = [threading.Thread(target=work, args=(k, ))
                  for k in range(args.threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            wall = (time.perf_counter() - t0) / args.batches * 1e3
            print(f'{args.threads} threads {src}: call '
                  f'{statistics.median(calls) * 1e3:.1f} ms, wall '
                  f'{wall:.1f} ms a batch', flush=True)
    if args.loader:
        loader_rate(rowptr, col, train, args.loader)


def loader_rate(rowptr, col, train, batches: int) -> None:
    """``--loader``: the products cell's ``NeighborLoader`` alone."""
    import torch

    from pyg_lib_tpu_torch import profiling
    from pyg_lib_tpu_torch.loader import NeighborLoader

    n = len(rowptr) - 1
    x = np.random.default_rng(2).standard_normal((n, 100), np.float32)
    y = np.zeros(n, np.int64)
    dev = 'cuda' if torch.cuda.is_available() else 'cpu'
    ldr = NeighborLoader(rowptr, col, x, y, train[:BATCH * (batches + 4)],
                         BATCH, FANOUTS, num_workers=4, lookahead=4, rng=3,
                         device=dev, csc=True)
    profiling.clear_spans()
    it = iter(ldr)
    next(it)
    # The workers record the batches submitted under a profiler session.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        wall = (time.perf_counter() - t0) / batches * 1e3
    it.close()
    by = {}
    for sp in profiling.spans():
        by.setdefault(sp.name, []).append(sp)
    paths = dict(Counter(sp.attrs.get('path')
                         for sp in by.get('sampler.sample', [])))
    pads = sorted((sp.attrs['batch'], sp.attrs['nodes'], sp.attrs['edges'],
                   sp.attrs['max_row_reads'])
                  for sp in by.get('sampler.pad', [])
                  if 8 <= sp.attrs['batch'] - ldr.rng < batches)
    digest = hashlib.sha1(repr(pads).encode()).hexdigest()[:12]
    phases = ', '.join(
        f'{k} {statistics.median(sp.seconds for sp in v) * 1e3:.1f}'
        for k, v in sorted(by.items()))
    print(f'loader on {dev}, {batches} batches: {wall:.1f} ms a batch; '
          f'{phases} ms (medians); sampler.sample by path {paths}; pad '
          f'counters of batches 8-{batches - 1}: {len(pads)}, digest '
          f'{digest}', flush=True)


if __name__ == '__main__':
    main()
