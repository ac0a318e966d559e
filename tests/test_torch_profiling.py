"""The port's profiling helpers (``pyg_lib_tpu_torch.profiling``) on the
CPU: the counterparts of ``tests/test_home_profiling.py``'s roofline,
measure and trace tests. On the CPU there is no roofline (the JAX package
makes one up), so ``measure`` gives rates without shares; the H100's peaks
are checked with the card's name put in place. ``metrics`` keeps the
names it had.
"""

import glob
import json
import os
import subprocess

import pytest
import torch

from pyg_lib_tpu_torch import home, metrics, profiling


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
