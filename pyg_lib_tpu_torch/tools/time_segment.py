#!/usr/bin/env python3
"""Time versions of K3 (``csrc/segment_csr.cu``) and K4
(``csrc/segment_minmax.cu``) against each other.

    python3 pyg_lib_tpu_torch/tools/time_segment.py A.cu B.cu B.cu A.cu

Each argument is a source with the C interface of ``segment_csr.cu``
(``pygt_segment_sum_csr``, with or without its scratch arguments) or of
``segment_minmax.cu`` (``pygt_segment_max``, with or without its piece
table), optionally followed by ``@NAME=VALUE`` pairs joined by ``,``
that set constants of the wrapper module for that argument's calls
(``UNITS_PER_SM`` of ``segment_csr.py``, ``K4_LONG`` of
``segment_minmax.py``, which must equal the source's ``LONG``). The
sources are built by ``_build.build_variants``, all in parallel. On ``chip_smoke.py``'s
graphs at F=512 f32, in the order given, so that ``A B B A`` interleaves
two versions on one card:

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
plans with hub rows). Prints the card's name and power limit,
``torch.segment_reduce``'s times on the CSRs, then one line per argument.
Needs one card.
"""

import ctypes
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the bench graphs and the CUDA-event timer)

F = 512


def _parse(arg):
    """``path[@NAME=VALUE,...]`` -> (path, kernel id, parameter count of
    its C function, {module constant: value})."""
    from pyg_lib_tpu_torch.ops.kernels import segment_csr, segment_minmax

    path, _, pairs = arg.partition('@')
    m = re.search(r'int pygt_segment_(sum_csr|max)\(([^)]*)\)',
                  Path(path).read_text())
    if m is None:
        raise SystemExit(f'{path} exports neither K3 nor K4')
    kid, module = (('K3', segment_csr) if m.group(1) == 'sum_csr' else
                   ('K4', segment_minmax))
    attrs = {}
    for pair in filter(None, pairs.split(',')):
        name, _, value = pair.partition('=')
        if not hasattr(module, name):
            raise SystemExit(f'{arg}: the {kid} wrapper has no {name}')
        attrs[name] = int(value)
    return path, kid, m.group(2).count(',') + 1, attrs


def _direct(fn, argtypes, launch):
    """An earlier interface (no scratch tables), called without the
    wrapper: ``launch(fn, *args)`` returns ``(error, result)``."""
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        err, out = launch(fn, *args)
        if err:
            raise RuntimeError(f'launch failed: CUDA error {err}')
        return out

    return call


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
    return _direct(lib.pygt_segment_max, [vp, vp, vp, i, vp, vp, i, i, i, vp],
                   launch)


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
    return _direct(lib.pygt_segment_sum_csr, [vp, i, vp, i64, vp, i64, i, vp],
                   launch)


def main(args):
    import torch

    from pyg_lib_tpu_torch import _build, ops
    from pyg_lib_tpu_torch.ops.kernels import segment_csr, segment_minmax
    from pyg_lib_tpu_torch.ops.kernels.plan_cache import plan_for_ptr

    if not torch.cuda.is_available():
        raise SystemExit('no CUDA card')
    print(chip_smoke.card(), flush=True)
    specs = [_parse(a) for a in args]
    built = _build.build_variants(s[0] for s in specs)
    for path, so in built.items():
        log = so.with_suffix('.log').read_text()
        regs = re.findall(r'Used (\d+) registers', log)
        spills = re.findall(r'[1-9]\d* bytes spill stores', log)
        print(f'built {path}: registers {"/".join(regs)}, {len(spills)} '
              f'kernels with spill stores', flush=True)
    libs = {k: ctypes.CDLL(str(v)) for k, v in built.items()}
    dev = torch.device('cuda')
    n = chip_smoke.N_NODES
    rp_u, cl_u = chip_smoke.uniform_graph(n, chip_smoke.N_EDGES)
    rp_p, cl_p = chip_smoke.powerlaw_graph(n, chip_smoke.N_EDGES)
    t_rp = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(cl_p, minlength=n), out=t_rp[1:])
    g_u = ops.build_spmm_graph(rp_u, cl_u, with_edge_maps=True,
                               minmax='auto')
    g_p = ops.build_spmm_graph(rp_p, cl_p, with_edge_maps=True)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((n, F), generator=gen, device=dev)
    ptr_u = torch.tensor(rp_u, device=dev)
    ptr_t = torch.tensor(t_rp, device=dev)
    csrs = {'uniform': (ptr_u, x[torch.tensor(cl_u.astype(np.int64),
                                              device=dev)]),
            'powerlaw-T': (ptr_t, torch.randn((int(t_rp[-1]), F),
                                              generator=gen, device=dev))}
    x47 = x[:, :47].contiguous()  # the SAGE max-pool's last layer
    # (label, src, plan, idx, hub rows)
    k4_cases = [('col_padded uniform', x, g_u.fwd, g_u.fwd.col_padded, False),
                ('col_padded uniform F=47', x47, g_u.fwd, g_u.fwd.col_padded,
                 False),
                ('col_padded powerlaw', x, g_p.fwd, g_p.fwd.col_padded,
                 False),
                ('col_padded powerlaw F=47', x47, g_p.fwd, g_p.fwd.col_padded,
                 False),
                ('col_padded powerlaw-T', x, g_p.bwd, g_p.bwd.col_padded,
                 True)]
    for name, (ptr, msgs) in csrs.items():
        plan = plan_for_ptr(ptr)
        k4_cases.append((f'edge_perm {name}', msgs, plan, plan.edge_perm,
                         name != 'uniform'))
    kinds = {s[1] for s in specs}
    k3_refs, k4_refs, lib_line = {}, {}, []
    for name, (ptr, msgs) in csrs.items():
        if 'K3' in kinds:
            ref = chip_smoke.by_columns(ops.segment_sum_csr_plain, msgs, ptr)
            mag = chip_smoke.by_columns(ops.segment_sum_csr_plain,
                                        msgs.abs(), ptr)
            k3_refs[name] = (ref, 1e-5 * mag + 1e-5)
            del mag
        for red in ('sum', 'max'):
            ms = chip_smoke.cuda_ms(lambda: torch.segment_reduce(
                msgs, red, offsets=ptr, axis=0), iters=5, warmup=1)
            lib_line.append(f'{name} {red} {ms:.3f} ms')
    print('torch.segment_reduce: ' + ', '.join(lib_line), flush=True)
    if 'K4' in kinds:
        for label, src, plan, idx, _ in k4_cases:
            k4_refs[label] = chip_smoke.by_columns(ops.segment_max_plain,
                                                   src, plan, idx)
    torch.cuda.empty_cache()
    for arg, (path, kid, nparams, attrs) in zip(args, specs):
        lib = libs[path]
        line = []
        module = segment_csr if kid == 'K3' else segment_minmax
        saved = {k: getattr(module, k) for k in attrs}
        for k, v in attrs.items():
            setattr(module, k, v)
        if kid == 'K3':
            k3 = _k3_call(lib, nparams)
            for name, (ptr, msgs) in csrs.items():
                got = k3(msgs, ptr)
                ref, tol = k3_refs[name]
                err = (got - ref).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f'{arg} K3 {name} disagrees with '
                                         f'segment_sum_csr_plain: '
                                         f'{float(err.max())}')
                iters = (20, 3) if name == 'uniform' else (5, 1)
                ms = chip_smoke.cuda_ms(lambda: k3(msgs, ptr), *iters)
                line.append(f'K3 {name} {ms:.3f} ms (max_abs_err '
                            f'{float(err.max()):.3g})')
                del got, err
        else:
            k4 = _k4_call(lib, nparams)
            for label, src, plan, idx, hub in k4_cases:
                got = k4(src, plan, idx)
                ref = k4_refs[label]
                if not (torch.equal(got[0].view(torch.int32),
                                    ref[0].view(torch.int32))
                        and torch.equal(got[1], ref[1])):
                    raise AssertionError(f'{arg} K4 {label} differs from '
                                         f'segment_max_plain')
                ms = chip_smoke.cuda_ms(lambda: k4(src, plan, idx),
                                        *((5, 1) if hub else (20, 3)))
                line.append(f'K4 {label} {ms:.3f} ms')
                del got
        for k, v in saved.items():
            setattr(module, k, v)
        print(f'{arg}: ' + ', '.join(line), flush=True)


if __name__ == '__main__':
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1:])
