"""Whole runs of each cell at a tiny size on the CPU (the kernels' plain
versions), past the harness's look for a card: the port agrees with the
plain reference, and a run whose timed path is broken underneath comes
out not correct, once for each fault a training step can have. The
control (the reference in TF32 in the program's place) fails the cell's
limits too. The products cell also runs with weighted, disjoint sampling,
a traffic the family and its reference take as data."""

import time

import pytest
import torch

from benchmark import compare, harness
from benchmark.families import gcn_fullbatch, sage_minibatch

CPU = torch.device('cpu')
TINY = {'dataset': {'num_nodes': 3000, 'num_edges': 40000,
                    'num_train': 1500}}
SAGE_TINY = {**TINY, 'batch_size': 64, 'num_workers': 2}
WEIGHTED = {'edge_weight': [0.05, 1.0], 'disjoint': True,
            'limits': {**harness.load_json(
                'workloads', 'sage-products.uniform')['limits'],
                'tree_breaks': {'max': 0}, 'weight_lift': {'min': 0.05}}}
# case: (cell, configuration overrides, workload overrides)
CELLS = {'gcn-arxiv.uniform': ('gcn-arxiv.uniform', TINY, None),
         'sage-products.uniform': ('sage-products.uniform', SAGE_TINY, None),
         'sage-products.weighted-disjoint': ('sage-products.uniform',
                                             SAGE_TINY, WEIGHTED)}


def run(case, seed=2**31 + 7):
    cell, overrides, workload = CELLS[case]
    return harness.run_cell(cell, seed, 0.2, False, CPU, time.perf_counter(),
                            overrides=overrides, workload=workload)


@pytest.mark.parametrize('case', sorted(CELLS))
def test_port_agrees_with_the_reference(case):
    out = run(case)
    assert out['correct'], out['stderr']
    assert out['attempted'] >= 1 and out['failed'] == 0
    assert {'setup_s', 'step_ms'} <= set(out['metrics'])
    assert list(out)[-2:] == ['checks', 'stderr']


def _stale(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, 'step',
                        lambda self, closure=None: None)


def _half(monkeypatch):
    gcn_loss, sage_loss = gcn_fullbatch.loss_fn, sage_minibatch.loss_fn
    monkeypatch.setattr(
        gcn_fullbatch, 'loss_fn',
        lambda logits, train, y: gcn_loss(logits, train[:len(train) // 2],
                                          y[:len(y) // 2]))
    monkeypatch.setattr(
        sage_minibatch, 'loss_fn',
        lambda logits, y, s: sage_loss(logits, y, s // 2))


def _altered(monkeypatch):
    from pyg_lib_tpu_torch.models import gnn

    def alter(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            return torch.cat([out[:128] * 2, out[128:]])
        return wrapped

    monkeypatch.setattr(gnn, 'spmm', alter(gnn.spmm))
    monkeypatch.setattr(gnn, 'segment_mean_csr', alter(gnn.segment_mean_csr))


FAULTS = {'stale': _stale, 'half': _half, 'altered': _altered}


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('case', ['gcn-arxiv.uniform',
                                  'sage-products.uniform'])
def test_a_broken_step_is_not_correct(case, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(case)
    assert not out['correct'], out['stderr']


def _checked(case, seed=5):
    cell, overrides, workload = CELLS[case]
    return harness.checked_run(cell, seed, CPU, harness.Clock(),
                               overrides=overrides, workload=workload)


@pytest.mark.parametrize('case', sorted(CELLS))
def test_the_tf32_control_fails_the_limits(case):
    r = _checked(case)
    control = compare.training_readings(
        r['ref_mod'].run(r['inputs'], r['cfg'], tf32=True), r['ref'],
        r['output_leaves'])
    limits = {k: v for k, v in r['wl']['limits'].items() if k in control}
    correct, checks = compare.judge(control, limits)
    assert not correct, checks


@pytest.mark.parametrize('case', ['sage-products.uniform',
                                  'sage-products.weighted-disjoint'])
def test_the_sampler_checks_see_a_wrong_batch(case):
    r = _checked(case)
    ref_mod, inputs, cfg = r['ref_mod'], r['inputs'], r['cfg']
    assert all(v == 0 for k, v in ref_mod.checks(inputs, cfg).items()
               if k != 'weight_lift')
    b = inputs['batches'][0]
    b['edge_id'] = b['edge_id'].copy()
    b['edge_id'][:5] += 1  # five edges that the graph does not have
    b['x'] = b['x'].clone()
    b['x'][3, 0] += 1.0
    got = ref_mod.checks(inputs, cfg)
    assert got['bad_edges'] >= 5 and got['feature_misses'] == 1
