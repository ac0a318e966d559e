"""The port's profiling helpers (``pyg_lib_tpu_torch.profiling``) on the
CPU: the counterparts of ``tests/test_home_profiling.py``'s roofline,
measure and trace tests. On the CPU there is no roofline (the JAX package
makes one up), so ``measure`` gives rates without shares; the H100's peaks
are checked with the card's name put in place. ``metrics`` keeps the
names it had. The span recorder opens no range and records no step's span
without a profiler session, and under one its ranges fall inside its spans
on the exported trace's clock.
"""

import glob
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from pyg_lib_tpu_torch import home, metrics, ops, profiling
from pyg_lib_tpu_torch.models import gcn_forward_spmm, init_gcn
from pyg_lib_tpu_torch.ops.kernels.gather_rows import gather_rows

STEP_SPANS = ('model.dense', 'model.aggregate', 'model.combine', 'ops.spmm',
              'ops.spmm.backward')


def test_roofline_and_measure():
    assert profiling.device_roofline() is None
    x = torch.randn(512, 512, generator=torch.Generator().manual_seed(0))
    res = profiling.measure(lambda a: a * 2.0, x, iters=3,
                            bytes_accessed=2 * x.numel() * 4,
                            flops=x.numel())
    assert res['seconds'] > 0 and res['gbps'] > 0 and res['tflops'] > 0
    assert set(res) == {'seconds', 'gbps', 'tflops'}  # no roofline here
    calls = []
    res = profiling.measure(lambda: calls.append(1), iters=4, warmup=2)
    assert len(calls) == 6 and set(res) == {'seconds'}


def test_the_roofline_is_the_h100s_with_its_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda i=0: 'NVIDIA H100 80GB HBM3')
    monkeypatch.setattr(
        subprocess, 'run', lambda *a, **k: subprocess.CompletedProcess(
            a, 0, 'NVIDIA H100 80GB HBM3, 700.00 W\n'))
    roof = profiling.device_roofline()
    assert roof.device == 'NVIDIA H100 80GB HBM3, 700.00 W'
    assert (roof.hbm_gbps, roof.f32_tflops, roof.tensor_bf16_tflops) == (
        3350.0, 67.0, 989.0)
    assert roof.balance_flop_per_byte() == pytest.approx(989e12 / 3350e9)
    assert metrics.device_roofline is profiling.device_roofline
    assert metrics.Roofline is profiling.Roofline
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i=0: 'A100')
    assert profiling.device_roofline() is None


def test_measure_gives_the_shares_on_the_card(monkeypatch):
    # A stand-in for the card: CUDA events timed on the host clock.
    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self, stream=None):
            import time
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    roof = profiling.Roofline('NVIDIA H100 80GB HBM3, 700.00 W', 3350.0,
                              67.0, 989.0)
    monkeypatch.setattr(profiling, '_on_card', lambda args: True)
    monkeypatch.setattr(torch.cuda, 'Event', Event)
    monkeypatch.setattr(profiling, 'device_roofline', lambda: roof)
    res = profiling.measure(lambda: None, iters=2, bytes_accessed=10**9,
                            flops=10**12)
    assert res['hbm_fraction'] == pytest.approx(res['gbps'] / 3350.0)
    assert res['tensor_core_fraction'] == pytest.approx(res['tflops'] /
                                                        989.0)
    assert 'f32_fraction' not in res
    assert res['roofline_of'] == roof.device


def test_trace_context(tmp_path, monkeypatch):
    with profiling.trace(str(tmp_path / 'tr')) as d:
        torch.zeros(8).add_(1)
    assert os.path.isdir(d)
    (path, ) = glob.glob(os.path.join(d, 'trace-*.json'))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name', '').startswith('aten::add_') for e in events)
    # The default directory: <home>/traces.
    monkeypatch.setattr(home, '_home_dir', str(tmp_path / 'home'))
    with profiling.trace() as d:
        pass
    assert d == str(tmp_path / 'home' / 'traces')
    assert glob.glob(os.path.join(d, 'trace-*.json'))


def count_ranges(monkeypatch):
    """Count the ``record_function`` ranges opened, by every name the
    program could reach it under."""
    opened = []
    real = torch.autograd.profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(profiling, 'record_function', counted)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', counted)
    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    return opened


def gcn_graph():
    rng = np.random.default_rng(0)
    n = 300
    rowptr = np.concatenate([[0], np.cumsum(rng.integers(0, 12, n))])
    col = rng.integers(0, n, int(rowptr[-1]))
    return ops.build_spmm_graph(rowptr, col, dedup='auto', device='cpu')


def gcn_step(graph):
    params = init_gcn([8, 16, 4], torch.Generator().manual_seed(0),
                      device='cpu')
    for layer in params['layers']:
        for p in layer.values():
            p.requires_grad_()
    x = torch.randn(graph.deg.shape[0], 8,
                    generator=torch.Generator().manual_seed(1))
    gcn_forward_spmm(params, x, graph).square().mean().backward()


def test_without_a_session_spans_record_only_set_up(monkeypatch):
    opened = count_ranges(monkeypatch)
    profiling.clear_spans()
    graph = gcn_graph()
    setup = profiling.spans()
    assert [s.name for s in setup] == ['plan.gate', 'plan.gate',
                                       'plan.build']
    assert [s.attrs['side'] for s in setup[:2]] == ['fwd', 'bwd']
    assert all(s.parent == 'plan.build' and s.attrs['gain'] > 0
               for s in setup[:2])
    assert setup[2].parent is None and setup[2].seconds > 0
    gcn_step(graph)
    m = metrics.Metrics(sink=lambda rec: None)
    with m.phase('step'):
        gcn_step(graph)
    assert profiling.spans() == setup
    assert opened == []
    assert m.summary()['phase_share']['step'] > 0


def test_a_span_times_its_block_and_records_under_recording():
    profiling.clear_spans()
    with profiling.span('outer', k=1) as outer:
        assert not outer.recording
    assert outer.seconds >= 0 and profiling.spans() == []
    with profiling.recording(True):
        with profiling.span('outer', k=1) as outer:
            with profiling.span('inner') as inner:
                inner.attrs['n'] = 3
    with profiling.span('after'):
        pass
    got = profiling.spans()
    assert [(s.name, s.parent, s.attrs) for s in got] == [
        ('inner', 'outer', {'n': 3}), ('outer', None, {'k': 1})]
    assert got[0].seconds == inner.seconds and got[1].seconds == outer.seconds
    assert got[1].start_ns <= got[0].start_ns <= got[0].end_ns <= \
        got[1].end_ns
    profiling.clear_spans()
    assert profiling.spans() == []


def test_step_ranges_lie_inside_their_spans_on_the_trace_clock(
        tmp_path, monkeypatch):
    graph = gcn_graph()
    opened = count_ranges(monkeypatch)
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gcn_step(graph)
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as fh:
        tr = json.load(fh)
    base = tr['baseTimeNanoseconds']
    recorded = profiling.spans()
    assert sorted(opened) == sorted(s.name for s in recorded)
    for name in STEP_SPANS:
        ranges = sorted((ev['ts'] * 1e3 + base, ev['dur'] * 1e3)
                        for ev in tr['traceEvents']
                        if ev.get('ph') == 'X' and ev['name'] == name
                        and ev.get('cat') == 'user_annotation')
        mine = sorted((s for s in recorded if s.name == name),
                      key=lambda s: s.start_ns)
        assert len(ranges) == len(mine) == 2, name  # one a layer
        for (start, dur), s in zip(ranges, mine):
            assert s.start_ns - 1e6 <= start, name
            assert start + dur <= s.end_ns + 1e6, name
    layers = [s.attrs['layer'] for s in recorded if s.name == 'model.dense']
    assert layers == [0, 1]
    for name, plan in (('ops.spmm', graph.fwd),
                       ('ops.spmm.backward', graph.bwd)):
        assert {s.attrs['plan'] for s in recorded if s.name == name} == {
            type(plan).__name__}
    assert {s.parent for s in recorded if s.name == 'ops.spmm'} == {
        'model.aggregate'}


def test_the_gather_backward_span_records_its_path_and_sizes():
    # On the CPU the backward runs on the calling thread, so recording()
    # reaches it; a CPU x keeps PyTorch's backward, the 'plain' path.
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((50, 8), generator=gen, requires_grad=True)
    row = torch.randint(0, 51, (300,), generator=gen)  # 50: a pad entry
    profiling.clear_spans()
    with profiling.recording(True):
        out = gather_rows(x, row)
        assert profiling.spans() == []  # the forward records none
        out.sum().backward()
    sp = profiling.spans()
    assert [(s.name, s.attrs) for s in sp] == [
        ('ops.gather.backward', {'path': 'plain', 'edge_slots': 300,
                                 'rows': 50})]
    assert sp[0].seconds > 0
    assert torch.equal(x.grad, torch.zeros_like(x).index_put_(
        (row.clamp(max=49),), torch.ones(300, 8), accumulate=True))
