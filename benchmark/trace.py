"""The traced window: ``torch.profiler`` over a few steps, read back from
its exported Chrome trace.

* Device work is the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
  events; a ``record_function`` range shown on the device is no work.
  Busy time is the union of their intervals (a copy on a side stream may
  overlap a kernel).
* A short spin kernel opens the window, because the profiler was seen to
  lose the first kernel of a window; it and everything before it are
  dropped.
* The trace is whole only if it holds at least as many launches of each
  aggregation kernel as the wrappers' launch counters grew by over the
  same window (``kernels.json``); otherwise :func:`traced_window` tries
  again and, after the last attempt, raises.
"""

import importlib
import json
import os
import re
import tempfile
import time
from pathlib import Path

DEVICE_WORK = ('kernel', 'gpu_memcpy', 'gpu_memset')
KERNELS = json.loads((Path(__file__).parent / 'kernels.json').read_text())
SPIN = 'spin_kernel'


class TraceIncomplete(RuntimeError):
    """The trace lost device events: its kernel counts fall short of the
    wrappers' launch counters."""


def short_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces, template arguments
    and parameters, at most 60 characters."""
    name = re.sub(r'^void |\(anonymous namespace\)::', '', name)
    name = name.split('(')[0]
    name = re.sub(r'<.*', '', name)
    return name.split('::')[-1][:60] or name[:60]


def read_counters() -> dict:
    """The wrappers' launch counters, by kernel ID."""
    out = {}
    for kid, (module, fn, attr) in KERNELS['counters'].items():
        out[kid] = int(getattr(getattr(importlib.import_module(module), fn),
                               attr))
    return out


def kernel_id(name: str):
    """The aggregation kernel ID whose names ``name`` holds, or None."""
    for kid, names in KERNELS['aggregation'].items():
        if any(n in name for n in names):
            return kid
    return None


def load_events(path: str):
    """``(device, host)`` events of an exported trace: device work as
    ``(cat, name, start_us, dur_us)`` sorted by start, and the host's
    ``user_annotation`` ranges as ``(name, start_us, dur_us)``."""
    with open(path) as fh:
        trace = json.load(fh)
    dev, host = [], []
    for ev in trace['traceEvents']:
        if ev.get('ph') != 'X':
            continue
        cat = ev.get('cat')
        if cat in DEVICE_WORK:
            dev.append((cat, ev['name'], float(ev['ts']), float(ev['dur'])))
        elif cat == 'user_annotation':
            host.append((ev['name'], float(ev['ts']), float(ev['dur'])))
    dev.sort(key=lambda v: v[2])
    return dev, host


def after_spin(dev):
    """The device events after the opening spin kernel (all of them if
    the trace lost it)."""
    spin = [i for i, ev in enumerate(dev) if SPIN in ev[1]]
    return dev[spin[0] + 1:] if spin else dev


def busy_intervals(dev):
    """The union of the events' intervals, as merged ``[start, end]``
    pairs in us."""
    merged = []
    for _, _, start, dur in dev:
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(dev, host, window_us: float, top: int = 10) -> dict:
    """What the readers and the result line take from one window's
    events: busy seconds, the aggregation kernels' seconds and counts by
    ID, the first kernel's counts for the completeness check, and the
    breakdown (the longest device operations by name, and the longest idle
    gaps named by the benchmark's host range they fell in)."""
    merged = busy_intervals(dev)
    busy_us = sum(b - a for a, b in merged)
    by_name, agg_us, agg_n = {}, {}, {}
    for _, name, _, dur in dev:
        short = short_name(name)
        by_name[short] = by_name.get(short, 0.0) + dur
        kid = kernel_id(name)
        if kid is not None:
            agg_us[kid] = agg_us.get(kid, 0.0) + dur
    first = {c['kernel']: sum(1 for ev in dev if c['kernel'] in ev[1])
             for c in KERNELS['completeness']}
    for kid, names in KERNELS['aggregation'].items():
        agg_n[kid] = sum(1 for ev in dev if any(n in ev[1] for n in names))
    gaps = []
    for (_, a_end), (b_start, _) in zip(merged, merged[1:]):
        gaps.append((b_start - a_end, a_end))
    gaps.sort(reverse=True)
    named = []
    for length, at in gaps[:top]:
        inside = [h for h in host if h[1] <= at <= h[1] + h[2]]
        # the innermost (shortest) range the gap opened in
        label = min(inside, key=lambda h: h[2])[0] if inside else 'none'
        named.append([f'host in {label}', length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        'busy_s': busy_us / 1e6,
        'window_s': window_us / 1e6,
        'agg_device_s': {k: v / 1e6 for k, v in agg_us.items()},
        'agg_count': agg_n,
        'first_kernel_count': first,
        'breakdown': {'device_ops': [[n, v / 1e6] for n, v in ops],
                      'idle_gaps': named},
    }


def check_complete(summary: dict, counted: dict) -> list:
    """The completeness check's shortfalls: ``[(kernel, in trace,
    launched)]`` where the trace holds fewer launches than the
    counters."""
    short = []
    for c in KERNELS['completeness']:
        launched = sum(counted.get(k, 0) for k in c['counters'])
        seen = summary['first_kernel_count'].get(c['kernel'], 0)
        if seen < launched:
            short.append((c['kernel'], seen, launched))
    return short


def traced_window(run_steps, attempts: int = 3) -> dict:
    """Run ``run_steps()`` (which enqueues the window's steps) under
    ``torch.profiler``, opened by a spin kernel and closed by a
    synchronize; read the trace back. Retries a trace that lost events,
    and raises :class:`TraceIncomplete` after ``attempts``. Returns
    :func:`summarize`'s dict with ``launches`` (the counters' growth) and
    ``steps`` (what ``run_steps`` returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    last = None
    for attempt in range(attempts):
        torch.cuda.synchronize()
        before = read_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = run_steps()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        after = read_counters()
        counted = {k: after[k] - before[k] for k in after}
        with tempfile.TemporaryDirectory(prefix='bench_trace_') as tmp:
            path = os.path.join(tmp, 'trace.json')
            prof.export_chrome_trace(path)
            dev, host = load_events(path)
        summary = summarize(after_spin(dev), host, window_s * 1e6)
        summary['launches'] = counted
        summary['steps'] = steps
        summary['attempts'] = attempt + 1
        last = check_complete(summary, counted)
        if not last:
            return summary
    raise TraceIncomplete(
        f'the trace lost device events in {attempts} attempts: '
        + ', '.join(f'{k} {s} in the trace of {n} launched'
                    for k, s, n in last))
