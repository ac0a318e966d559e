#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check it.

    python3 chip_smoke.py    # needs one card

The main path is planned full-graph aggregation: ``build_spmm_graph``
builds the plans on the host, ``spmm`` runs them, and its backward runs
the same kernels over the transpose plan. The script:

1. prints the card's name and power limit and builds every kernel from
   ``pyg_lib_tpu_torch/csrc`` with ``nvcc`` (one process per source);
2. holds K1, K2 and K2h against their plain PyTorch versions on the card
   at small shapes (F=47 and 128; f32, bf16 and int8; weighted or not;
   int8, bf16 and f32 ``hot_w``);
3. builds the two graphs of ``bench.py`` (262,144 nodes, about 4.2M
   edges; uniform with the chunked plan, Zipf(1.2) with ``dedup='auto'``),
   checks each kernel against its plain version at the main path's
   shapes, and then, with every launch count set to 0, trains a
   [512, 512, 47] GCN for a few steps on each graph: that run is the main
   path, and each kernel must have launched in it;
4. holds the GCN forward and the ``spmm`` gradient against the same
   computation through the plain versions;
5. times each kernel at the main path's shapes beside its plain version,
   ``torch.sparse.mm`` on the same graph (timed here only, never used by
   the port) and its bound, and times ``spmm`` by ``bench.py``'s
   useful-bytes metric.

It prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. It imports nothing of JAX or of ``pyg_lib_tpu``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
# A kernel and its plain version sum the same f32 terms in another order:
# |kernel - plain| <= SUM_RTOL * Σ|terms| + SUM_ATOL, elementwise.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-5
# The GCN output passes two such sums and two matmuls.
GCN_RTOL = 1e-4  # of max|plain output|
N_NODES, N_EDGES, F_BENCH = 262_144, 4_194_304, 512
DIMS = [512, 512, 47]
HOT_COLUMNS = 4096  # hot level of the power-law forward plan
STEPS = 3


def uniform_graph(n, e):
    """``bench.py`` ``child_headline``'s generator (seed 0)."""
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 2 * e // n, size=n)
    deg = (deg * (e / max(deg.sum(), 1))).astype(np.int64)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, n, size=int(rowptr[-1])).astype(np.int32)
    return rowptr, col


def powerlaw_graph(n, e):
    """``bench.py`` ``child_realistic``'s generator (seed 0)."""
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, n + 1)**1.2
    p /= p.sum()
    row = rng.integers(0, n, e)
    col = rng.choice(n, e, p=p)
    order = np.argsort(row, kind='stable')
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=rowptr[1:])
    return rowptr, col[order].astype(np.int64)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pyg_lib_tpu_torch import _build, ops
    from pyg_lib_tpu_torch.models import GCN
    from pyg_lib_tpu_torch.ops.kernels import spmm_chunked, spmm_dedup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f'kernel build: {time.perf_counter() - t0:.1f} s '
          f'({", ".join(_build.sources())})', flush=True)
    for name in _build.sources():
        log = (_build.BUILD_DIR / f'{name}.log').read_text()
        regs = [int(w) for w in re.findall(r'Used (\d+) registers', log)]
        spills = len(re.findall(r'[1-9]\d* bytes spill stores', log))
        print(f'  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} '
              f'registers, {spills} with spill stores', flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {'K1': 0.0, 'K2': 0.0, 'K2h': 0.0}

    def plain(xm, plan, scale=None):
        if isinstance(plan, ops.DedupSpmmPlan):
            return ops.dedup_sum_plain(xm, plan, scale)
        return ops.spmm_chunked_plain(xm, plan, scale)

    def kernel(xm, plan, scale=None):
        if isinstance(plan, ops.DedupSpmmPlan):
            return ops.dedup_sum(xm, plan, scale)
        return ops.spmm_chunked(xm, plan, scale)

    def abs_plan(plan):
        """The plan with |weights|: its plain sum of |x| is Σ|terms|."""
        if not isinstance(plan, ops.DedupSpmmPlan) or not plan.weighted:
            return plan
        meta = plan.edge_meta.clone()
        meta[:, 2, :] = meta[:, 2, :].view(torch.float32).abs().view(
            torch.int32)
        hot_w = None if plan.hot_w is None else plan.hot_w.abs()
        return plan._replace(edge_meta=meta, hot_w=hot_w)

    def check(label, kid, xm, plan, scale=None):
        got = kernel(xm, plan, scale)
        torch.cuda.synchronize()
        ref = plain(xm, plan, scale)
        xa = xm.abs() if xm.dtype != torch.int8 else xm.abs().to(torch.int8)
        bound = plain(xa, abs_plan(plan),
                      None if scale is None else scale.abs())
        err = (got - ref).abs()
        tol = SUM_RTOL * bound + SUM_ATOL
        worst = float((err - tol).max())
        e = float(err.max())
        errs[kid] = max(errs[kid], e)
        print(f'  {kid} {label}: max_abs_err {e:.3g} (tolerance '
              f'{SUM_RTOL:g} * sum|terms| + {SUM_ATOL:g})', flush=True)
        if not torch.isfinite(got).all() or worst > 0:
            raise AssertionError(f'{kid} {label} disagrees with its plain '
                                 f'version: max_abs_err {e}')
        return e

    def modes(x):
        xq, scale = ops.quantize_columns(x)
        return [('f32', x, None), ('bf16', x.to(torch.bfloat16), None),
                ('int8', xq, scale)]

    # -- 2. kernel checks at small shapes -------------------------------
    print('kernel checks (small plans):', flush=True)
    rp_u, cl_u = uniform_graph(1000, 16000)
    rp_p, cl_p = powerlaw_graph(3000, 40000)
    rng = np.random.default_rng(1)
    w_p = rng.normal(size=cl_p.shape[0]).astype(np.float32)
    k1_plans = [('uniform', ops.build_spmm_plan(rp_u, cl_u, chunk=128)),
                ('powerlaw', ops.build_spmm_plan(rp_p, cl_p, chunk=256))]
    plain_dedup = ops.build_dedup_plan(rp_p, cl_p, ec=256, hot='off')
    hot_i8 = ops.build_dedup_plan(rp_p, cl_p, ec=256)
    if hot_i8.hot_w is None or hot_i8.hot_w.dtype != torch.int8:
        raise AssertionError('small power-law plan has no int8 hot level')
    k2_plans = [
        ('K2', 'plain', plain_dedup),
        ('K2', 'weighted', ops.build_dedup_plan(rp_p, cl_p, ec=256,
                                                hot='off', edge_weight=w_p)),
        ('K2h', 'hot int8', hot_i8),
        ('K2h', 'hot bf16', hot_i8._replace(
            hot_w=hot_i8.hot_w.to(torch.bfloat16))),
        ('K2h', 'hot f32 weighted', ops.build_dedup_plan(
            rp_p, cl_p, ec=256, edge_weight=w_p)),
    ]
    for f in (47, 128):
        x = torch.randn((3000, f), generator=gen, device=dev)
        for mode, xm, scale in modes(x):
            for gname, plan in k1_plans:
                check(f'{gname} F={f} {mode}', 'K1', xm[:1000] if
                      gname == 'uniform' else xm, plan, scale)
            for kid, pname, plan in k2_plans:
                check(f'{pname} F={f} {mode}', kid, xm, plan, scale)

    # -- 3. the slice at bench scale ------------------------------------
    t0 = time.perf_counter()
    rp_u, cl_u = uniform_graph(N_NODES, N_EDGES)
    g_u = ops.build_spmm_graph(rp_u, cl_u)
    t_u = time.perf_counter() - t0
    t0 = time.perf_counter()
    rp_p, cl_p = powerlaw_graph(N_NODES, N_EDGES)
    g_p = ops.build_spmm_graph(rp_p, cl_p, dedup='auto')
    t_p = time.perf_counter() - t0
    e_u, e_p = int(rp_u[-1]), int(rp_p[-1])
    print(f'graphs: uniform E={e_u} E_pad={g_u.fwd.col_padded.numel()} '
          f'{type(g_u.fwd).__name__} ({t_u:.1f} s); powerlaw E={e_p} fwd '
          f'{type(g_p.fwd).__name__} chunks={g_p.fwd.num_chunks} '
          f'uc={g_p.fwd.uc} hot={g_p.fwd.num_hot} '
          f'hot_w={g_p.fwd.hot_w.dtype}, bwd {type(g_p.bwd).__name__} '
          f'chunks={g_p.bwd.num_chunks} uc={g_p.bwd.uc} '
          f'hot={g_p.bwd.num_hot} ({t_p:.1f} s)', flush=True)
    if not (isinstance(g_u.fwd, ops.SpmmPlan)
            and isinstance(g_u.bwd, ops.SpmmPlan)
            and isinstance(g_p.fwd, ops.DedupSpmmPlan)
            and g_p.fwd.num_hot == HOT_COLUMNS
            and g_p.fwd.hot_w.dtype == torch.int8
            and isinstance(g_p.bwd, ops.DedupSpmmPlan)
            and g_p.bwd.num_hot == 0):
        raise AssertionError('bench graphs did not get the expected plans')
    graphs = {'uniform': g_u, 'powerlaw': g_p}
    sides = [('K1', 'uniform fwd', g_u.fwd), ('K1', 'uniform bwd', g_u.bwd),
             ('K2h', 'powerlaw fwd', g_p.fwd),
             ('K2', 'powerlaw bwd', g_p.bwd)]

    print('kernel checks (main-path shapes):', flush=True)
    main_errs = {'K1': 0.0, 'K2': 0.0, 'K2h': 0.0}
    for f in (F_BENCH, DIMS[-1]):
        x = torch.randn((N_NODES, f), generator=gen, device=dev)
        for kid, label, plan in sides:
            e = check(f'{label} F={f} f32', kid, x, plan)
            main_errs[kid] = max(main_errs[kid], e)
        del x
    torch.cuda.empty_cache()

    # The main path: a few GCN training steps on each graph, counted.
    x = torch.randn((N_NODES, DIMS[0]), generator=gen, device=dev)
    labels = torch.randint(0, DIMS[-1], (N_NODES, ), generator=gen,
                           device=dev)
    cpu_gen = torch.Generator().manual_seed(0)
    models = {k: GCN(DIMS, generator=cpu_gen, device=dev) for k in graphs}
    spmm_chunked.spmm_chunked.launches = 0
    spmm_dedup.dedup_sum.launches = 0
    spmm_dedup.dedup_sum.hot_launches = 0
    step_ms = {}
    for gname, graph in graphs.items():
        model = models[gname]
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        for step in range(STEPS):
            if step == 1:  # the first step pays cuBLAS and allocator set-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(x, graph), labels)
            loss.backward()
            opt.step()
            if not torch.isfinite(loss):
                raise AssertionError(f'GCN loss on {gname} is not finite')
        torch.cuda.synchronize()
        step_ms[gname] = (time.perf_counter() - t0) * 1e3 / (STEPS - 1)
    launches = {'K1': spmm_chunked.spmm_chunked.launches,
                'K2': spmm_dedup.dedup_sum.launches,
                'K2h': spmm_dedup.dedup_sum.hot_launches}
    print(f'main path: {STEPS} GCN {DIMS} training steps per graph; ms per '
          f'step after the first {step_ms}; launches {launches}', flush=True)
    for kid, n in launches.items():
        if n <= 0:
            raise AssertionError(f'{kid} never launched on the main path')

    # Where a training step's time goes: device time by kernel over one
    # profiled step, against the unprofiled step time above.
    for gname, graph in graphs.items():
        model = models[gname]

        def step():
            model.zero_grad()
            torch.nn.functional.cross_entropy(model(x, graph),
                                              labels).backward()

        busy_ms, top = device_time_by_kernel(step)
        if busy_ms == 0.0:
            print(f'profile {gname}: the profiler saw no device time (not '
                  f'measured)', flush=True)
            continue
        print(f'profile {gname} step: device busy {busy_ms:.3f} ms of '
              f'{step_ms[gname]:.3f} ms, idle share '
              f'{1 - busy_ms / step_ms[gname]:.3f}; by kernel (ms): '
              + '; '.join(f'{name} {ms:.3f}' for name, ms in top[:8]),
              flush=True)

    # -- 4. GCN forward and spmm gradient against the plain path --------
    def plain_gcn(params, x, graph):
        inv = torch.rsqrt(graph.deg.clamp(min=1.0))[:, None]
        layers = params['layers']
        for i, layer in enumerate(layers):
            h = x @ layer['w']
            x = plain(h * inv, graph.fwd) * inv + h * inv**2 + layer['b']
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x

    fwd_ms = {}
    with torch.no_grad():
        for gname, graph in graphs.items():
            params = models[gname].params()
            out = models[gname](x, graph)
            ref = plain_gcn(params, x, graph)
            if out.shape != (N_NODES, DIMS[-1]) or not torch.isfinite(
                    out).all():
                raise AssertionError(f'GCN output on {gname} is malformed')
            e = float((out - ref).abs().max())
            tol = GCN_RTOL * float(ref.abs().max())
            print(f'GCN forward {gname}: max_abs_err {e:.3g} (tolerance '
                  f'{GCN_RTOL:g} * max|plain| = {tol:.3g})', flush=True)
            if e > tol:
                raise AssertionError(f'GCN forward on {gname} disagrees')
            fwd_ms[gname] = {
                'kernel': cuda_ms(lambda: models[gname](x, graph)),
                'plain': cuda_ms(lambda: plain_gcn(params, x, graph)),
            }
            del out, ref
    print(f'GCN forward ms: {fwd_ms}', flush=True)
    del x, labels
    torch.cuda.empty_cache()

    for gname, graph in graphs.items():
        x = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev,
                        requires_grad=True)
        cot = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev)
        (gk, ) = torch.autograd.grad((ops.spmm(x, graph) * cot).sum(), x)
        (gp, ) = torch.autograd.grad((plain(x, graph.fwd) * cot).sum(), x)
        bound = plain(cot.abs(), abs_plan(graph.bwd))
        err = (gk - gp).abs()
        e = float(err.max())
        print(f'spmm grad {gname}: max_abs_err {e:.3g} (tolerance '
              f'{SUM_RTOL:g} * sum|terms| + {SUM_ATOL:g})', flush=True)
        if float((err - SUM_RTOL * bound - SUM_ATOL).max()) > 0:
            raise AssertionError(f'spmm gradient on {gname} disagrees')
        del x, cot, gk, gp, bound, err
        torch.cuda.empty_cache()

    # -- 5. timing ------------------------------------------------------
    csr = {}
    for gname, (rp, cl) in {'uniform': (rp_u, cl_u),
                            'powerlaw': (rp_p, cl_p)}.items():
        a = torch.sparse_csr_tensor(
            torch.from_numpy(rp), torch.from_numpy(cl.astype(np.int64)),
            torch.ones(cl.shape[0]), (N_NODES, N_NODES)).to(dev)
        csr[gname] = (a, a.t().to_sparse_csr())
    x = torch.randn((N_NODES, F_BENCH), generator=gen, device=dev)
    print('spmm (bench.py useful bytes: E*F*4 + E*4 + N*F*4):', flush=True)
    for gname, graph in graphs.items():
        e = e_u if gname == 'uniform' else e_p
        useful = e * F_BENCH * 4 + e * 4 + N_NODES * F_BENCH * 4
        lib_ms = cuda_ms(lambda: torch.sparse.mm(csr[gname][0], x))
        for prec in (None, 'bf16'):
            ms = cuda_ms(lambda: ops.spmm(x, graph, precision=prec))
            print(f'  {gname} precision={prec}: {ms:.3f} ms, '
                  f'{useful / ms / 1e6:.1f} GB/s, bound '
                  f'{useful / HBM_BYTES_PER_S * 1e3:.3f} ms; '
                  f'torch.sparse.mm f32 {lib_ms:.3f} ms', flush=True)

    rows = []
    sources = {'K1': ('pyg_lib_tpu_torch/csrc/spmm_chunked.cu',
                      'pyg_lib_tpu/ops/pallas/spmm_chunked.py:279'),
               'K2': ('pyg_lib_tpu_torch/csrc/spmm_dedup.cu',
                      'pyg_lib_tpu/ops/pallas/spmm_dedup.py:527'),
               'K2h': ('pyg_lib_tpu_torch/csrc/spmm_dedup.cu',
                       'pyg_lib_tpu/ops/pallas/spmm_dedup.py:542')}
    timed = [('K1', 'uniform fwd', g_u.fwd, csr['uniform'][0]),
             ('K2h', 'powerlaw fwd', g_p.fwd, csr['powerlaw'][0]),
             ('K2', 'powerlaw bwd', g_p.bwd, csr['powerlaw'][1])]
    for kid, label, plan, lib in timed:
        nbytes, flops = work(plan, F_BENCH)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        row = {
            'name': kid, 'route': 'cuda', 'source': sources[kid][0],
            'replaces': sources[kid][1], 'launches': launches[kid],
            'max_abs_err': main_errs[kid],
            'ms': cuda_ms(lambda: kernel(x, plan)),
            'plain_ms': cuda_ms(lambda: plain(x, plan), iters=3),
            'bound_ms': bound_ms,
            'bound_by': ('bytes' if nbytes / HBM_BYTES_PER_S >=
                         flops / F32_FLOPS else 'operations'),
            'library_ms': cuda_ms(lambda: torch.sparse.mm(lib, x)),
        }
        print(f'  {kid} {label} F={F_BENCH} f32: {row["ms"]:.3f} ms, plain '
              f'{row["plain_ms"]:.3f} ms, torch.sparse.mm '
              f'{row["library_ms"]:.3f} ms, bound {bound_ms:.3f} ms '
              f'({row["bound_by"]}: {nbytes / 1e9:.3f} GB, '
              f'{flops / 1e9:.3f} GFLOP)', flush=True)
        rows.append(row)
    return smi, errs, rows


def work(plan, f):
    """Bytes (each input read once, the output written once) and f32
    operations that one kernel call on ``plan`` at width ``f`` needs."""
    import torch

    from pyg_lib_tpu_torch.ops import DedupSpmmPlan

    x_bytes = N_NODES * f * 4
    out_bytes = plan.num_rows * f * 4
    if not isinstance(plan, DedupSpmmPlan):
        # col_padded, and row 0 of tile_ptr (TR + 1 lanes of each tile)
        tables = plan.col_padded.numel() * 4 + plan.tile_ptr.shape[0] * 129 * 4
        return x_bytes + tables + out_bytes, plan.num_edges * f
    used_rows = 3 if plan.weighted else 2  # edge_meta rows that carry data
    tables = (plan.uniq_cols.numel() * 4 +
              plan.num_chunks * used_rows * plan.ec * 4 +
              plan.chunk_tile.numel() * 4)
    cold = int((plan.edge_meta[:, 0, :] >= 0).sum())
    flops = cold * f * (2 if plan.weighted else 1)
    if plan.num_hot:
        tables += (plan.hot_cols.numel() * 4 +
                   plan.hot_w.numel() * plan.hot_w.element_size())
        flops += int(torch.count_nonzero(plan.hot_w)) * f * 2
    return x_bytes + tables + out_bytes, flops


def device_time_by_kernel(fn):
    """Run ``fn`` once under ``torch.profiler``; return the device's busy
    ms and ``[(kernel name, ms)]`` summed by name, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r'^void |\(anonymous namespace\)::', '', ev.key)
        name = name.split('(')[0][:60]
        by_name[name] = by_name.get(name, 0.0) + ev.self_device_time_total
    top = sorted(((k, v / 1e3) for k, v in by_name.items()),
                 key=lambda kv: -kv[1])
    return sum(ms for _, ms in top), top


def cuda_ms(fn, iters=10, warmup=2):
    """Mean ms per call of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


if __name__ == '__main__':
    import torch

    t_start = time.perf_counter()
    smi, errs, rows = main()
    print(f'small-plan max_abs_err: {errs}; total '
          f'{time.perf_counter() - t_start:.1f} s', flush=True)
    print(json.dumps({'kernels': rows}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
