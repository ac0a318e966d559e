"""A cell's set-up and steps load no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``pyg_lib_tpu`` (the port's own name
begins with the last, so names are compared whole)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(harness.__file__).resolve().parents[1]
SCRIPT = '''
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import harness
out = harness.run_cell({cell!r}, 11, 0.1, False, torch.device('cpu'),
                       time.perf_counter(), overrides={overrides!r})
print(json.dumps({{'correct': out['correct'],
                  'forbidden': harness.forbidden_modules(),
                  'port': 'pyg_lib_tpu_torch' in sys.modules}}))
'''


@pytest.mark.parametrize('cell, overrides', [
    ('gcn-arxiv.uniform', {'dataset': {'num_nodes': 2000,
                                       'num_edges': 20000,
                                       'num_train': 500}}),
    ('sage-products.uniform', {
        'dataset': {'num_nodes': 2000, 'num_edges': 20000,
                    'num_train': 500}, 'batch_size': 32, 'num_workers': 2}),
])
def test_a_run_loads_no_jax(cell, overrides):
    code = SCRIPT.format(root=str(ROOT), cell=cell, overrides=overrides)
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got['port'] and got['correct']
    assert got['forbidden'] == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'pyg_lib_tpu_torch_fake', object())
    assert 'pyg_lib_tpu' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jax.numpy', object())
    assert 'jax' in harness.forbidden_modules()
