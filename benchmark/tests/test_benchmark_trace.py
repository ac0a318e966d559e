"""The trace's reading: busy time as a union, the aggregation kernels by
ID, the idle gaps named by the host range they opened in, and the check
that a trace holds every launch the wrappers counted. The traced run
itself needs the card (marked ``cuda``)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, trace

DEV = [
    ('kernel', 'void chunked_sum_kernel<float, 4, 2, true>(float const*)',
     100.0, 10.0),
    ('gpu_memcpy', 'Memcpy HtoD (Pinned -> Device)', 105.0, 10.0),
    ('kernel', 'void cold_chunks_kernel<float, 4>(float const*)', 130.0,
     5.0),
    ('kernel', 'void (anonymous namespace)::hot_rows_f4_kernel<4>(float)',
     135.0, 5.0),
    ('kernel', 'ampere_sgemm_128x64_nn', 150.0, 20.0),
]
HOST = [('bench.forward', 90.0, 50.0), ('bench.loader_wait', 114.0, 20.0),
        ('bench.backward', 140.0, 40.0)]


def test_summarize_unions_busy_time_and_sorts_kernels():
    s = trace.summarize(DEV, HOST, window_us=100.0)
    # busy: [100, 115] + [130, 140] + [150, 170] = 45 us
    assert s['busy_s'] == pytest.approx(45e-6)
    assert s['window_s'] == pytest.approx(100e-6)
    assert s['agg_device_s'] == pytest.approx({'K1': 10e-6, 'K2': 5e-6,
                                               'K2h': 5e-6})
    ops = dict(s['breakdown']['device_ops'])
    assert ops['ampere_sgemm_128x64_nn'] == pytest.approx(20e-6)
    assert ops['chunked_sum_kernel'] == pytest.approx(10e-6)
    gaps = s['breakdown']['idle_gaps']
    # gaps: 115 -> 130 (15 us, in loader_wait) and 140 -> 150 (10 us)
    assert gaps[0] == ['host in bench.loader_wait', pytest.approx(15e-6)]
    assert gaps[1] == ['host in bench.backward', pytest.approx(10e-6)]


def test_check_complete_finds_lost_launches():
    s = trace.summarize(DEV, HOST, window_us=100.0)
    assert trace.check_complete(s, {'K1': 1, 'K2': 0, 'K2h': 1}) == []
    assert trace.check_complete(s, {'K1': 2, 'K2': 0, 'K2h': 1}) == [
        ('chunked_sum_kernel', 1, 2)]
    assert trace.check_complete(s, {'K2': 1, 'K2h': 1}) == [
        ('cold_chunks_kernel', 1, 2)]


def test_events_after_the_spin_kernel():
    dev = [('kernel', 'first', 0.0, 1.0),
           ('kernel', 'void at::cuda::spin_kernel(long)', 1.0, 1.0)] + DEV
    assert trace.after_spin(dev) == DEV
    assert trace.after_spin(DEV) == DEV


def test_load_events_reads_the_chrome_trace(tmp_path):
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'traceEvents': [
        {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 5, 'dur': 2},
        {'ph': 'X', 'cat': 'gpu_user_annotation', 'name': 'r', 'ts': 1,
         'dur': 9},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'bench.forward',
         'ts': 1, 'dur': 9},
        {'ph': 'i', 'cat': 'kernel', 'name': 'x', 'ts': 1}]}))
    dev, host = trace.load_events(str(path))
    assert dev == [('kernel', 'k', 5.0, 2.0)]
    assert host == [('bench.forward', 1.0, 9.0)]


@pytest.mark.cuda
def test_a_traced_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    root = os.path.dirname(os.path.dirname(harness.__file__))
    proc = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'gcn-arxiv.uniform',
         '--seed', '5', '--seconds', '2', '--trace', '1'],
        capture_output=True, text=True, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['correct']
    assert 0 < out['device']['busy_s'] <= out['device']['window_s']
    assert 0 < out['metrics']['kernels.agg_roofline']['value'] <= 100
