"""The benchmark's run: one cell, one seed, one process.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell's file ``workloads/<cell>.json``
names its configuration ``configs/<config>.json``, which names its
training loop ``families/<family>.py`` and its plain reference
``reference/<reference>.py``; each metric of ``BENCHMARK.json`` that the
cell reports is read by ``metrics/<metric>.py``.

A run:

1. set-up: imports, the card, the family's data, plans or loader; then
   the first three steps, whose losses, first gradient (from Adam's first
   moment) and parameter change the comparison keeps, and the warm-up
   steps. ``setup_s`` ends here;
2. the window: steps for ``--seconds`` by the host clock, a CUDA event
   after each, then one synchronize; with ``--trace 1`` a traced window
   of the workload's ``trace_steps`` steps follows;
3. the peak memory is read, the program's state freed, and the reference
   follows the first three steps from the same inputs and initial
   weights; each number compared is printed beside its limit, on standard
   error and last in the result line, which goes last to standard
   output.
"""

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pyg_lib_tpu')
CHECKED_STEPS = 3


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = BENCH / kind / f'{name}.json'
    if not path.exists():
        raise FileNotFoundError(f'no {kind[:-1]} named {name!r} ({path})')
    return json.loads(path.read_text())


def spec() -> dict:
    """``BENCHMARK.json`` of the checkout."""
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on. A metric with a
    ``workloads`` key belongs to the cells it lists; an end-to-end metric
    without one to every cell, a per-layer one to every cell that reports
    the end-to-end metric it moves."""
    e2e = [m for m in bench['end_to_end']
           if cell in m.get('workloads', [cell])]
    if not trace:
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if cell in m.get('workloads', [cell] if m['moves'] in names
                             else [])]


def reader(name: str):
    """The ``read(rec)`` function of ``metrics/<name>.py``."""
    path = BENCH / 'metrics' / f'{name}.py'
    mod_name = 'bench_metric_' + ''.join(
        c if c.isalnum() else '_' for c in name)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


class Clock:
    """Host-clock seconds by name, added up over ``with clock(name)``."""

    def __init__(self):
        self.s = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def first_steps(cell, device) -> dict:
    """The first :data:`CHECKED_STEPS` steps, with what the comparison
    keeps of them: each loss, the first gradient as Adam got it (its first
    moment after one step over ``1 - beta1``) and the parameters' change
    over the three steps, read before a fourth."""
    import torch
    beta1 = cell.opt.param_groups[0]['betas'][0]
    losses, grads = [], None
    for k in range(CHECKED_STEPS):
        losses.append(cell.step(keep=True))
        cell.capture(k)
        if k == 0:
            # A step that left Adam without state gave it no gradient.
            grads = [(cell.opt.state[p]['exp_avg'] / (1 - beta1)).clone()
                     if 'exp_avg' in cell.opt.state.get(p, {}) else
                     torch.zeros_like(p) for p in cell.leaves]
    change = [(p.detach() - p0).clone()
              for p, p0 in zip(cell.leaves, cell.init)]
    _sync(device)
    return {'losses': [float(v) for v in torch.stack(losses).cpu()],
            'grads': grads, 'change': change}


def window(cell, seconds: float, device) -> dict:
    """Steps until ``seconds`` have passed by the host clock, then one
    synchronize. On the card a CUDA event after each step gives the
    intervals between step ends, without a synchronize in between."""
    import torch
    cuda = device.type == 'cuda'
    events, losses, host_ends = [], [], []
    _sync(device)
    if cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    while True:
        losses.append(cell.step())
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            host_ends.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    if cuda:
        intervals = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        ends = [t0] + host_ends
        intervals = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    loss = torch.stack(losses).float().cpu()
    return {'window_s': window_s, 'steps': len(losses),
            'intervals_ms': intervals,
            'failed': int((~torch.isfinite(loss)).sum())}


def cell_files(name: str, overrides=None, workload=None):
    """The cell's workload file and its configuration; ``overrides`` and
    ``workload`` (tests only) are merged into the configuration and the
    workload."""
    wl = load_json('workloads', name)
    wl.update(workload or {})
    cfg = load_json('configs', wl['config'])
    for k, v in (overrides or {}).items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    return wl, cfg


def set_precision(cfg: dict) -> None:
    """The configuration's f32 matrix products: TF32 on or off."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg['tf32'])
    torch.backends.cudnn.allow_tf32 = bool(cfg['tf32'])
    torch.set_float32_matmul_precision('high' if cfg['tf32'] else 'highest')


def checked_run(name: str, seed: int, device, clock, between=None,
                overrides=None, workload=None) -> dict:
    """The sequence that every comparison follows, in a run and in a
    calibration: the cell built from the seed, its first
    :data:`CHECKED_STEPS` steps, then ``between(cell, wl)`` (a run's
    warm-up, window and metrics), then the program's state freed and the
    plain reference over the inputs the cell hands it. Returns ``wl``,
    ``cfg``, ``prog``, ``inputs``, ``ref``, ``ref_mod``, ``record`` (the
    family's), ``output_leaves`` (how many of the last leaves are the
    output layer's) and ``between`` (what ``between`` returned)."""
    import torch

    wl, cfg = cell_files(name, overrides, workload)
    set_precision(cfg)
    family = importlib.import_module(f"benchmark.families.{cfg['family']}")
    with clock('cell_s'):
        cell = family.Cell(cfg, wl, seed, device, clock)
    with clock('first_steps_s'):
        prog = first_steps(cell, device)
    got = between(cell, wl) if between is not None else None
    inputs = cell.reference_inputs()
    record, output_leaves = cell.record(), cell.output_leaves
    cell.close()
    del cell
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    ref_mod = importlib.import_module(
        f"benchmark.reference.{cfg['reference']}")
    ref = ref_mod.run(inputs, cfg)
    return {'wl': wl, 'cfg': cfg, 'prog': prog, 'inputs': inputs,
            'ref': ref, 'ref_mod': ref_mod, 'record': record,
            'output_leaves': output_leaves, 'between': got}


def readings_of(run: dict) -> dict:
    """The numbers compared in ``run`` (a :func:`checked_run`): the
    training readings and the reference's own checks of the inputs."""
    from benchmark import compare
    readings = compare.training_readings(run['prog'], run['ref'],
                                         run['output_leaves'])
    if hasattr(run['ref_mod'], 'checks'):
        readings.update(run['ref_mod'].checks(run['inputs'], run['cfg']))
    return readings


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides=None, workload=None,
             bench=None) -> dict:
    """One run of cell ``name``; returns the result line's dict and, under
    ``'stderr'``, the lines of the numbers compared. ``overrides`` and
    ``workload`` (tests only) are merged into the configuration and the
    workload."""
    import torch

    from benchmark import compare
    from benchmark import trace as tracing
    from benchmark.roofline import counts

    bench = spec() if bench is None else bench
    clock = Clock()
    clock.s['start_s'] = time.perf_counter() - t_start

    def measure(cell, wl):
        with clock('warmup_s'):
            for _ in range(int(wl.get('warmup_steps', 0))):
                cell.step()
            _sync(device)
        setup_s = time.perf_counter() - t_start
        win = window(cell, seconds, device)
        first = CHECKED_STEPS + int(wl.get('warmup_steps', 0))
        last = first + win['steps']
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == 'cuda' else 0)
        rec = {'setup_s': setup_s, 'clock': clock.s, 'peak_bytes': peak,
               'window_s': win['window_s'], 'steps': win['steps'],
               'intervals_ms': win['intervals_ms'], 'window': (first, last),
               'window_flops': sum(cell.step_flops(k)
                                   for k in range(first, last)),
               'peaks': counts.PEAKS, 'trace': None}
        if trace:
            n = int(wl['trace_steps'])

            def run_steps():
                for _ in range(n):
                    cell.step()
                return n

            summary = tracing.traced_window(run_steps)
            # A retried trace ran its steps again: count the last attempt's.
            end = last + n * summary['attempts']
            summary['agg_least_s'] = sum(cell.step_agg_least_s(k)
                                         for k in range(end - n, end))
            rec['trace'] = summary
        rec['cell'] = cell.record()
        metrics = {}
        for m in cell_metrics(bench, name, trace):
            value = reader(m['name'])(rec)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        return rec, win, metrics

    run = checked_run(name, seed, device, clock, measure, overrides,
                      workload)
    rec, win, metrics = run['between']
    correct, checks = compare.judge(readings_of(run), run['wl']['limits'])

    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else 'cpu'),
           'count': 1, 'memory_peak_bytes': int(rec['peak_bytes'])}
    out = {'correct': bool(correct), 'attempted': win['steps'],
           'failed': win['failed'], 'metrics': metrics, 'device': dev}
    if rec['trace'] is not None:
        dev['busy_s'] = rec['trace']['busy_s']
        dev['window_s'] = rec['trace']['window_s']
        out['breakdown'] = rec['trace']['breakdown']
    out['checks'] = {k: {'value': clean(v['value']), 'limit': v['limit']}
                     for k, v in checks.items()}
    phases = {**clock.s, **{k: v for k, v in rec['cell'].items()
                            if isinstance(v, float)}}
    out['stderr'] = ['set-up phases (s): ' + ', '.join(
        f'{k} {v:.3f}' for k, v in phases.items())] + list(
            compare.check_lines(checks))
    return out


def parse(argv):
    p = argparse.ArgumentParser(description='Run one benchmark cell.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch

    bench = spec()
    chips = next((w['chips'] for w in bench['workloads']
                  if w['name'] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'no CUDA card, or fewer than the {chips} this cell needs '
              f'(torch.cuda.is_available()={torch.cuda.is_available()}, '
              f'device_count={torch.cuda.device_count()})', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device, t_start, bench=bench)
    found = forbidden_modules()
    if found:
        print(f'the run loaded {found}: the port and the benchmark may '
              f'import neither JAX nor the JAX package', file=sys.stderr)
        return 3
    lines = out.pop('stderr')
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


def clean(value):
    """``value`` for the JSON line: a non-finite float as its string."""
    return value if not isinstance(value, float) or math.isfinite(value) \
        else repr(value)
