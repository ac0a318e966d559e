#!/usr/bin/env python3
"""Time versions of K1 (``csrc/spmm_chunked.cu``), K3
(``csrc/segment_csr.cu``), K4 (``csrc/segment_minmax.cu``) and K7
(``csrc/spmm_range_fused.cu``) against each other.

    python3 pyg_lib_tpu_torch/tools/time_segment.py A.cu B.cu B.cu A.cu

Each argument is a source with the C interface of ``spmm_chunked.cu``
(``pygt_spmm_chunked``: K1 and its ``msgs_padded`` entry K1m, with or
without its piece table),
``segment_csr.cu`` (``pygt_segment_sum_csr``, with or without its
scratch arguments), ``segment_minmax.cu`` (``pygt_segment_max``, with or
without its piece table) or ``spmm_range_fused.cu``
(``pygt_spmm_range_fused``: K7, with or without its piece table),
optionally followed by ``@NAME=VALUE`` pairs joined by ``,`` that set
constants of the wrapper module for that argument's calls
(``UNITS_PER_SM`` of ``segment_csr.py``, ``K4_LONG`` of
``segment_minmax.py``, which must equal the source's ``LONG``,
``K7_LONG`` of ``spmm_range_fused.py`` and ``K1_LONG`` of
``spmm_chunked.py``: ``@K7_LONG=1073741824`` cuts no run, and a K7 source
without the piece table needs it, as a K1 source without one needs
``@K1_LONG=1073741824``). A source
may include headers kept beside it, which it reads before those of
``csrc``. The sources are built by ``_build.build_variants``, all in
parallel. On ``chip_smoke.py``'s graphs, F=512 f32 unless a label says
otherwise, in the order given, so that ``A B B A`` interleaves two
versions on one card:

* K1 on the uniform graph's forward and backward plans (F=512 and F=47;
  bf16, and int8 with its column scale, at F=512) and on the power-law
  graph's chunked forward plan (F=512; no row there is cut), K1m on the
  forward plan's padded messages (F=512, and GAT's F=48 and F=4), and K1 per
  range of the ``range_split=4`` graph (partial sums added); K7 on the
  ``range_split=4, range_fused`` graph's forward and backward plans
  (F=512 and F=47; the forward also at the R-GCN's F=128 and F=349), on
  the weighted fused graph's forward plan, and on the power-law graph's
  ``range_split=4, range_fused`` transpose plan (hub rows) at F=349. Each
  is held against its plain version within ``1e-5 * sum|terms| + 1e-5``,
  and every source's output against the first K1 (or K7) source's with
  the same wrapper constants, bit for bit. Beside each time, the share
  of its gather floor: E*F*elem bytes (one x row per real edge) over
  3.35 TB/s;
* K3 on the uniform graph's CSR (its ``[E, 512]`` messages) and on the
  power-law graph's transpose CSR (hub rows up to 810,552 edges), each
  held against ``segment_sum_csr_plain`` within
  ``1e-5 * sum|terms| + 1e-5``;
* K4 through ``col_padded`` on the uniform forward plan and on the
  power-law graph's chunked forward plan (the SAGE max-pool's; both also
  at F=47) and transpose plan, and through ``edge_perm`` on the uniform CSR's
  plan and on the power-law transpose CSR's plan, each held against
  ``segment_max_plain`` bit for bit.

Times are CUDA events, the mean of 20 calls after 3 (5 after 1 on the
plans with hub rows). Prints the card's name and power limit, each
build's registers and spills, the library calls' times
(``torch.segment_reduce`` on the CSRs, ``torch.sparse.mm`` on the
uniform CSR and its weighted copy), then one line per argument. Needs
one card.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import ab  # noqa: E402  (what the A B B A tools share)
import chip_smoke  # noqa: E402  (the bench sizes, graphs and plain versions)
from pyg_lib_tpu_torch.testing import (  # noqa: E402
    abs_plan, check_exact, check_sum, cuda_ms, powerlaw_graph, uniform_graph)

F = 512


def _exports():
    from pyg_lib_tpu_torch.ops.kernels import (segment_csr, segment_minmax,
                                               spmm_chunked, spmm_range_fused)

    return {'segment_sum_csr': ('K3', segment_csr),
            'segment_max': ('K4', segment_minmax),
            'spmm_chunked': ('K1', spmm_chunked),
            'spmm_range_fused': ('K7', spmm_range_fused)}


def _k4_call(lib, nparams):
    """K4 through ``lib``: the current interface through the wrapper, the
    first one (10 parameters, no piece table) directly."""
    import torch

    from pyg_lib_tpu_torch import _build
    from pyg_lib_tpu_torch.ops.kernels import segment_minmax

    if nparams != 10:
        _build._loaded['segment_minmax'] = lib
        return segment_minmax.segment_max_kernel

    def launch(fn, src, plan, idx):
        shape = (plan.num_rows, src.shape[1])
        vals = torch.empty(shape, dtype=torch.float32, device=src.device)
        pos = torch.empty(shape, dtype=torch.int32, device=src.device)
        err = fn(src.data_ptr(), idx.data_ptr(), plan.tile_ptr.data_ptr(), 0,
                 vals.data_ptr(), pos.data_ptr(), plan.tile_ptr.shape[0],
                 plan.num_rows, src.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        return err, (vals, pos)

    vp, i = ctypes.c_void_p, ctypes.c_int
    return ab.direct(lib.pygt_segment_max,
                     [vp, vp, vp, i, vp, vp, i, i, i, vp], launch)


def _k3_call(lib, nparams):
    """K3 through ``lib``: the current interface through the wrapper, the
    first one (8 parameters, no scratch) directly."""
    import torch

    from pyg_lib_tpu_torch import _build
    from pyg_lib_tpu_torch.ops.kernels import segment_csr

    if nparams != 8:
        _build._loaded['segment_csr'] = lib
        return segment_csr.segment_sum_csr_kernel

    def launch(fn, src, ptr):
        out = torch.empty((ptr.shape[0] - 1, src.shape[1]), dtype=src.dtype,
                          device=src.device)
        err = fn(src.data_ptr(), 0, ptr.data_ptr(), src.shape[0],
                 out.data_ptr(), ptr.shape[0] - 1, src.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        return err, out

    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return ab.direct(lib.pygt_segment_sum_csr,
                     [vp, i, vp, i64, vp, i64, i, vp], launch)


def _k1_lib_of(lib, nparams):
    """``lib`` as K1's wrapper calls it: the current interface as it is;
    the one before the piece table (10 parameters, every row walked whole)
    behind a shim that drops the piece arguments, and refuses a call that
    has pieces to add."""
    import types

    if nparams != 10:
        return lib
    fn = lib.pygt_spmm_chunked
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, vp]
    fn.restype = ctypes.c_int

    def call(*a):  # a[11]: the number of pieces; a[15]: the stream
        if a[11]:
            raise SystemExit('K1 before its piece table cuts no row: give '
                             'it @K1_LONG=1073741824')
        return fn(*a[:9], a[15])

    call.argtypes = fn.argtypes  # the wrapper sets none on a shim
    return types.SimpleNamespace(pygt_spmm_chunked=call)


def _k7_lib_of(lib, nparams):
    """``lib`` as K7's wrapper calls it: the current interface as it is;
    the one before the piece table (14 parameters, every run walked whole)
    behind a shim that drops the piece arguments, and refuses a call that
    has pieces to add."""
    import types

    if nparams != 14:
        return lib
    fn = lib.pygt_spmm_range_fused
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, i, vp, vp, vp, vp, i, i, vp, vp, i, i, i, vp]
    fn.restype = ctypes.c_int

    def call(*a):  # a[15]: the number of pieces; a[19]: the stream
        if a[15]:
            raise SystemExit('K7 before its piece table cuts no run: give '
                             'it @K7_LONG=1073741824')
        return fn(*a[:13], a[19])

    call.argtypes = fn.argtypes  # the wrapper sets none on a shim
    return types.SimpleNamespace(pygt_spmm_range_fused=call)


def _sum_cases(x, gen):
    """K1's and K7's cases on chip_smoke.py's uniform graph: ({kernel id:
    [(label, call, plain call, bytes of its gather floor)]}, (rowptr, col,
    edge weights of the weighted graph)). A call goes through the wrapper,
    so it launches the library loaded last as ``spmm_chunked`` (or
    ``spmm_range_fused``); a plain call gives ``(ref, Σ|terms|)``."""
    import torch

    from pyg_lib_tpu_torch import ops

    n = chip_smoke.N_NODES
    rp, cl = uniform_graph(n, chip_smoke.N_EDGES)
    e = int(rp[-1])
    g_u = ops.build_spmm_graph(rp, cl, with_edge_maps=True, minmax='auto')
    g_uf, g_ur, g_w, w = chip_smoke.range_graphs(rp, cl)
    rp_p, cl_p = powerlaw_graph(n, chip_smoke.N_EDGES)
    g_pf = ops.build_spmm_graph(rp_p, cl_p, range_split=4, range_fused=True)
    g_pp = ops.build_spmm_plan(rp_p, cl_p)
    x47 = x[:, :47].contiguous()
    x128 = x[:, :128].contiguous()
    x349 = x[:, :349].contiguous()
    xb = x.to(torch.bfloat16)
    xq, scale = ops.quantize_columns(x)
    msgs = torch.randn((g_u.fwd.col_padded.numel(), F), generator=gen,
                       device=x.device)
    msgs.mul_(g_u.fwd.valid_mask[:, None])

    def ref(fn, src, plan, sc=None):
        def go():
            out = chip_smoke.by_columns(fn, src, plan)
            mag = chip_smoke.by_columns(fn, src.abs(), abs_plan(plan))
            if sc is not None:
                out, mag = out * sc, mag * sc.abs()
            return out, mag
        return go

    def k1(label, xm, plan, sc=None):
        return (label, lambda: ops.spmm_chunked(xm, plan, sc),
                ref(ops.spmm_chunked_plain, xm, plan, sc),
                e * xm.shape[1] * xm.element_size())

    def k1m(m):
        f = m.shape[1]
        return (f'K1m uniform fwd msgs_padded{"" if f == F else f" F={f}"}',
                lambda: ops.segment_sum_chunked(m, g_u.fwd),
                ref(ops.segment_sum_chunked_plain, m, g_u.fwd), e * f * 4)

    def k7(label, xm, plan):
        return (label, lambda: ops.fused_range_sum(xm, plan),
                ref(ops.fused_range_plain, xm, plan),
                e * xm.shape[1] * xm.element_size())

    return {
        'K1': [k1('uniform fwd', x, g_u.fwd), k1('uniform bwd', x, g_u.bwd),
               k1('uniform fwd F=47', x47, g_u.fwd),
               k1('uniform bwd F=47', x47, g_u.bwd),
               k1('uniform fwd bf16', xb, g_u.fwd),
               k1('uniform fwd int8+scale', xq, g_u.fwd, scale),
               k1('power-law fwd', x, g_pp),
               # GAT's widths: 4 heads of 128 and of 12 channels, and the
               # heads alone (the softmax backward's row sums).
               k1m(msgs), k1m(msgs[:, :48].contiguous()),
               k1m(msgs[:, :4].contiguous()),
               ('per range (range_split=4)',
                lambda: chip_smoke.kernel(x, g_ur.fwd),
                ref(chip_smoke.plain, x, g_ur.fwd), e * F * 4)],
        'K7': [k7('S=4f fwd', x, g_uf.fwd), k7('S=4f bwd', x, g_uf.bwd),
               k7('S=4f fwd F=47', x47, g_uf.fwd),
               k7('S=4f bwd F=47', x47, g_uf.bwd),
               k7('weighted fused fwd', x, g_w.fwd),
               # The R-GCN's widths, and hub rows: the power-law graph's
               # transpose (rows up to 810,552 edges).
               k7('S=4f fwd F=128', x128, g_uf.fwd),
               k7('S=4f fwd F=349', x349, g_uf.fwd),
               k7('power-law S=4f bwd F=349', x349, g_pf.bwd)],
    }, (rp, cl, w)


def main(args):
    import torch

    from pyg_lib_tpu_torch import _build, ops
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
    x = torch.randn((n, F), generator=gen, device=dev)
    sums, sum_refs, firsts = {}, {}, {}
    if kinds & {'K1', 'K7'}:
        sums, (rp_u, cl_u, w_u) = _sum_cases(x, gen)
        for kid in kinds & {'K1', 'K7'}:
            for label, _, plain, _ in sums[kid]:
                sum_refs[kid, label] = plain()
        rp_t = torch.from_numpy(rp_u)
        cl_t = torch.from_numpy(cl_u.astype(np.int64))
        a = torch.sparse_csr_tensor(rp_t, cl_t, torch.ones(cl_u.shape[0]),
                                    (n, n)).to(dev)
        a_w = torch.sparse_csr_tensor(rp_t, cl_t, torch.from_numpy(w_u),
                                      (n, n)).to(dev)
        ms = [cuda_ms(lambda: torch.sparse.mm(m, x), 20, 3)
              for m in (a, a_w)]
        print(f'torch.sparse.mm uniform CSR {ms[0]:.3f} ms, weighted CSR '
              f'{ms[1]:.3f} ms', flush=True)
        del a, a_w
    csrs, k4_cases = {}, []
    if kinds & {'K3', 'K4'}:
        rp_u, cl_u = uniform_graph(n, chip_smoke.N_EDGES)
        rp_p, cl_p = powerlaw_graph(n, chip_smoke.N_EDGES)
        t_rp = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(cl_p, minlength=n), out=t_rp[1:])
        g_u = ops.build_spmm_graph(rp_u, cl_u, with_edge_maps=True,
                                   minmax='auto')
        g_p = ops.build_spmm_graph(rp_p, cl_p, with_edge_maps=True)
        ptr_u = torch.tensor(rp_u, device=dev)
        ptr_t = torch.tensor(t_rp, device=dev)
        csrs = {'uniform': (ptr_u, x[torch.tensor(cl_u.astype(np.int64),
                                                  device=dev)]),
                'powerlaw-T': (ptr_t, torch.randn((int(t_rp[-1]), F),
                                                  generator=gen, device=dev))}
        x47 = x[:, :47].contiguous()  # the SAGE max-pool's last layer
        # (label, src, plan, idx, hub rows)
        k4_cases = [('col_padded uniform', x, g_u.fwd, g_u.fwd.col_padded,
                     False),
                    ('col_padded uniform F=47', x47, g_u.fwd,
                     g_u.fwd.col_padded, False),
                    ('col_padded powerlaw', x, g_p.fwd, g_p.fwd.col_padded,
                     False),
                    ('col_padded powerlaw F=47', x47, g_p.fwd,
                     g_p.fwd.col_padded, False),
                    ('col_padded powerlaw-T', x, g_p.bwd, g_p.bwd.col_padded,
                     True)]
        for name, (ptr, msgs) in csrs.items():
            plan = plan_for_ptr(ptr)
            k4_cases.append((f'edge_perm {name}', msgs, plan, plan.edge_perm,
                             name != 'uniform'))
    k3_refs, k4_refs, lib_line = {}, {}, []
    for name, (ptr, msgs) in csrs.items():
        if 'K3' in kinds:
            k3_refs[name] = tuple(chip_smoke.by_columns(
                ops.segment_sum_csr_plain, m, ptr) for m in (msgs, msgs.abs()))
        for red in ('sum', 'max'):
            ms = cuda_ms(lambda: torch.segment_reduce(
                msgs, red, offsets=ptr, axis=0), iters=5, warmup=1)
            lib_line.append(f'{name} {red} {ms:.3f} ms')
    if lib_line:
        print('torch.segment_reduce: ' + ', '.join(lib_line), flush=True)
    if 'K4' in kinds:
        for label, src, plan, idx, _ in k4_cases:
            k4_refs[label] = chip_smoke.by_columns(ops.segment_max_plain,
                                                   src, plan, idx)
    torch.cuda.empty_cache()
    for arg, (path, kid, nparams, module, attrs) in zip(args, specs):
        lib = libs[path]
        line = []
        saved = ab.set_constants(module, attrs)
        if kid in ('K1', 'K7'):
            if kid == 'K1':
                _build._loaded['spmm_chunked'] = _k1_lib_of(lib, nparams)
            else:
                _build._loaded['spmm_range_fused'] = _k7_lib_of(lib, nparams)
            for label, call, _, floor in sums[kid]:
                got = call()
                check_sum(f'{arg} {kid} {label}', got, *sum_refs[kid, label])
                first = firsts.setdefault(
                    (kid, label, tuple(sorted(attrs.items()))), got)
                if not torch.equal(got.view(torch.int32),
                                   first.view(torch.int32)):
                    raise AssertionError(f'{arg} {kid} {label} differs from '
                                         f'the first {kid} source with its '
                                         f'constants bit for bit')
                ms = cuda_ms(call, 20, 3)
                share = floor / chip_smoke.HBM_BYTES_PER_S * 1e3 / ms
                line.append(f'{kid} {label} {ms:.3f} ms ({share:.0%} of its '
                            f'gather floor)')
                del got
        elif kid == 'K3':
            k3 = _k3_call(lib, nparams)
            for name, (ptr, msgs) in csrs.items():
                e = check_sum(f'{arg} K3 {name}', k3(msgs, ptr),
                              *k3_refs[name])
                iters = (20, 3) if name == 'uniform' else (5, 1)
                ms = cuda_ms(lambda: k3(msgs, ptr), *iters)
                line.append(f'K3 {name} {ms:.3f} ms (max_abs_err {e:.3g})')
        else:
            k4 = _k4_call(lib, nparams)
            for label, src, plan, idx, hub in k4_cases:
                check_exact(f'{arg} K4 {label}', k4(src, plan, idx),
                            k4_refs[label])
                ms = cuda_ms(lambda: k4(src, plan, idx),
                             *((5, 1) if hub else (20, 3)))
                line.append(f'K4 {label} {ms:.3f} ms')
        ab.set_constants(module, saved)
        print(f'{arg}: ' + ', '.join(line), flush=True)


if __name__ == '__main__':
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1:])
