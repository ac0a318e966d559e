"""Every cell resolves by name to its configuration, its training loop,
its reference and its metrics' readers, and ``BENCHMARK.json`` keeps to
the benchmark's contract as far as a file can show."""

import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent
SPEC = json.loads((BENCH.parent / 'BENCHMARK.json').read_text())
CELLS = sorted(p.stem for p in (BENCH / 'workloads').glob('*.json'))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves_by_name(cell):
    wl = harness.load_json('workloads', cell)
    assert wl['name'] == cell
    cfg = harness.load_json('configs', wl['config'])
    family = importlib.import_module(f"benchmark.families.{cfg['family']}")
    assert hasattr(family, 'Cell')
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    assert hasattr(ref, 'run')
    for trace in (False, True):
        for m in harness.cell_metrics(SPEC, cell, trace):
            assert callable(harness.reader(m['name']))
    for name, lim in wl['limits'].items():
        assert set(lim) <= {'max', 'min'} and len(lim) == 1, name


def test_benchmark_cells_have_files_and_readers():
    names = {w['name'] for w in SPEC['workloads']}
    assert names <= set(CELLS)
    for w in SPEC['workloads']:
        wl = harness.load_json('workloads', w['name'])
        assert (w['config'], w['traffic']) == (wl['config'], wl['traffic'])
        assert w['chips'] == 1
    for c in SPEC['configs']:
        cfg = json.loads((BENCH.parent / c['file']).read_text())
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced']
    for m in SPEC['end_to_end'] + SPEC['per_layer']:
        assert (BENCH / 'metrics' / f"{m['name']}.py").exists(), m['name']


def test_benchmark_json_keeps_the_contract_shape():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert 1 <= SPEC['run_seconds'] <= 51
    e2e = {m['name'] for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e
    for m in SPEC['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in SPEC['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e
    for item in (SPEC['configs'] + SPEC['workloads'] + SPEC['end_to_end'] +
                 SPEC['per_layer']):
        assert NAME.match(item['name']), item['name']
    for w in SPEC['workloads']:
        assert len(w['why']) <= 200
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one
        assert len(harness.cell_metrics(SPEC, w['name'], False)) >= 2
        assert harness.cell_metrics(SPEC, w['name'], True)
    assert len(json.dumps(SPEC)) < 64 * 1024
