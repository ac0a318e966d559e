"""The port's loaders (``pyg_lib_tpu_torch.loader``) against the JAX
package's on the CPU: for the same graph, features and ``rng``,
``NeighborLoader`` and ``HeteroNeighborLoader`` give the JAX loaders'
batches bit for bit (probed buckets, explicit budgets, disjoint sampling,
biased by ``edge_weight``, node-temporal with ``'last'``, several
epochs), resume from ``state_dict`` at the same batches, and count their
buckets alike. On the CPU the batches stay host tensors; on the card
(``tests/test_torch_cuda.py``) they equal these. Under a profiler session
the workers record each batch's phases as spans, with its padding's
counters, and the consumer its waits; without one they record nothing.
"""

import glob
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from pyg_lib_tpu import loader as jloader
from pyg_lib_tpu_torch import loader, profiling
from pyg_lib_tpu_torch.sampler import _cpp
from test_torch_sampler import H_COL, H_ROWPTR, graph


@pytest.fixture(autouse=True)
def jax_engine_loaded():
    # The JAX loader's threads race to load its engine: while one thread
    # loads it, another finds it marked as tried but not loaded and
    # samples with numpy (pyg_lib_tpu/sampler/_cpp.py get_lib). Loading
    # it first keeps the reference on its engine throughout.
    from pyg_lib_tpu.sampler import _cpp as jcpp
    assert jcpp.get_lib() is not None


def data(n=400, f=6, seed=0):
    rowptr, col = graph(seed, n=n, max_deg=20)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.int64)
    return rowptr, col, x, y


def same_batch(got, ref):
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, v in ref.items():
        a, b = got[k], np.asarray(v)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == b.shape and np.array_equal(a, b), k
        if a.ndim:
            assert a.dtype == b.dtype, k


def batches(ldr, epochs=1):
    return [b for _ in range(epochs) for b in ldr]


_W = np.random.default_rng(9)
CONFIGS = {
    'probed': dict(),
    'weighted_disjoint': dict(disjoint=True, edge_weight=_W.uniform(
        0.05, 1.0, len(data()[1]))),
    'temporal_last': dict(disjoint=True, temporal_strategy='last',
                          node_time=_W.integers(0, 100, 400)),
    'explicit': dict(max_nodes=160, max_edges=200),
    'buckets': dict(buckets=[(200, 300), (4000, 6000)]),
    'disjoint': dict(disjoint=True),
    'replace': dict(replace=True, num_workers=3, lookahead=1),
    'numpy': dict(impl='numpy'),
    'csc': dict(csc=True),
}


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_neighbor_loader_equals_the_jax_package(config):
    rowptr, col, x, y = data()
    seeds = np.arange(0, 400, 3)
    kw = dict(batch_size=16, num_neighbors=[5, 3], rng=21, drop_last=False,
              **CONFIGS[config])
    got = loader.NeighborLoader(rowptr, col, x, y, seeds, device='cpu', **kw)
    ref = jloader.NeighborLoader(rowptr, col, x, y, seeds, **kw)
    assert got.buckets == ref.buckets and len(got) == len(ref) == 9
    got_b, ref_b = batches(got, 2), batches(ref, 2)
    assert len(got_b) == len(ref_b) == 18
    for a, b in zip(got_b, ref_b):
        same_batch(a, b)
    assert got.bucket_counts == ref.bucket_counts
    assert sum(got.bucket_counts) == 18
    assert [t['num_edges'] for t in got.timings] == [
        int(b['rowptr'][-1]) for b in got_b[9:]]


def test_neighbor_loader_resumes_where_the_jax_package_does():
    rowptr, col, x, y = data(seed=3)
    seeds = np.arange(400)
    kw = dict(batch_size=32, num_neighbors=[4, 4], rng=5)
    got = loader.NeighborLoader(rowptr, col, x, y, seeds, device='cpu', **kw)
    it = iter(got)
    next(it)
    state = got.state_dict()  # saved in the middle of epoch 0
    assert state == {'epoch': 0, 'rng': 5}
    list(it)
    assert got.state_dict() == {'epoch': 1, 'rng': 5}
    epoch1 = batches(got)
    again = loader.NeighborLoader(rowptr, col, x, y, seeds, device='cpu',
                                  **kw)
    again.load_state_dict({'epoch': 1, 'rng': 5})
    ref = jloader.NeighborLoader(rowptr, col, x, y, seeds, **kw)
    ref.load_state_dict({'epoch': 1, 'rng': 5})
    for a, b, c in zip(epoch1, batches(again), batches(ref)):
        same_batch(a, c)
        same_batch(b, c)
    with pytest.raises(ValueError, match='rng=5'):
        again.load_state_dict({'epoch': 0, 'rng': 6})


def test_neighbor_loader_batches_feed_sage_forward():
    from pyg_lib_tpu_torch.models import SAGE, sage_forward

    rowptr, col, x, y = data(seed=4)
    ldr = loader.NeighborLoader(rowptr, col, x, y, np.arange(64), 16,
                                [5, 5], device='cpu', rng=1)
    model = SAGE([6, 8, 5], generator=torch.Generator().manual_seed(0),
                 device='cpu')
    for batch in ldr:
        out = sage_forward(model.params(), batch['x'], batch['rowptr'],
                           batch['row'])
        n = batch['num_seeds']
        loss = torch.nn.functional.cross_entropy(out[:n], batch['y'][:n])
        loss.backward()
        assert torch.isfinite(loss)
        # The seeds are the first nodes; pad nodes are masked.
        assert batch['node_mask'][:n].all()


@pytest.mark.parametrize('disjoint', [False, True])
def test_hetero_loader_equals_the_jax_package(disjoint):
    rng = np.random.default_rng(2)
    x_dict = {t: rng.normal(size=(n, 4)).astype(np.float32)
              for t, n in (('paper', 120), ('author', 80), ('field', 15))}
    y_dict = {'paper': rng.integers(0, 3, 120)}
    budgets = {'paper': 512, 'author': 256, 'field': 128}
    kw = dict(batch_size=8, num_neighbors_dict={k: [3, 2] for k in H_ROWPTR},
              node_budgets=budgets, max_edges=2000, rng=4, disjoint=disjoint)
    seeds = np.arange(0, 120, 4)
    got = loader.HeteroNeighborLoader(H_ROWPTR, H_COL, x_dict, y_dict,
                                      'paper', seeds, device='cpu', **kw)
    ref = jloader.HeteroNeighborLoader(H_ROWPTR, H_COL, x_dict, y_dict,
                                       'paper', seeds, **kw)
    got_b, ref_b = batches(got, 2), batches(ref, 2)
    assert len(got_b) == len(ref_b) == 6
    for a, b in zip(got_b, ref_b):
        same_batch(a, b)
    state = got.state_dict()
    assert state == ref.state_dict() == {'epoch': 2, 'rng': 4}


def test_loader_workers_lose_no_count():
    # More sampling threads than cores, switching often: every batch is
    # counted once in bucket_counts and once in the engine's calls.
    rowptr, col, x, y = data(n=300, seed=5)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ldr = loader.NeighborLoader(rowptr, col, x, y, np.arange(300), 4,
                                    [3, 3], buckets=[(8, 8), (64, 64),
                                                     (400, 400)],
                                    num_workers=16, lookahead=24,
                                    device='cpu')
        before = _cpp.calls['neighbor_sample']
        done = []
        t = threading.Thread(target=lambda: done.append(batches(ldr, 3)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(done[0]) == 225
    assert sum(ldr.bucket_counts) == 225
    assert _cpp.calls['neighbor_sample'] - before == 225


def test_a_kept_padded_batch_outlives_later_batches():
    # As the benchmark's tap keeps one: the batch's PaddedBatch, held
    # while 4 workers make 8 more, still holds its first bytes.
    class Tapped(loader.NeighborLoader):
        padded = []

        def _pad_to_bucket(self, out, num_seeds, disjoint):
            b, bi = super()._pad_to_bucket(out, num_seeds, disjoint)
            self.padded.append(b)
            return b, bi

    rowptr, col, x, y = data(seed=7)
    ldr = Tapped(rowptr, col, x, y, np.arange(400), 16, [5, 3], csc=True,
                 num_workers=4, lookahead=4, rng=2, device='cpu')
    it = iter(ldr)
    next(it)
    kept = ldr.padded[0]
    first = {k: v.copy() for k, v in vars(kept).items()
             if isinstance(v, np.ndarray)}
    for _ in range(8):
        next(it)
    it.close()
    assert len(ldr.padded) >= 9
    for k, v in first.items():
        assert np.array_equal(getattr(kept, k), v), k


def test_loader_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rowptr, col, x, y = data()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        loader.NeighborLoader(rowptr, col, x, y, np.arange(10), 5, [2],
                              max_nodes=64, max_edges=64)


HETERO_X = {t: np.random.default_rng(2).normal(size=(n, 4)).astype(np.float32)
            for t, n in (('paper', 120), ('author', 80), ('field', 15))}


def span_loader(kind):
    """A loader of 2 workers, and the slots of each batch's bucket
    (``'csc'``: the neighbour loader sampling with ``csc=True``)."""
    if kind == 'hetero':
        budgets = {'paper': 512, 'author': 256, 'field': 128}
        ldr = loader.HeteroNeighborLoader(
            H_ROWPTR, H_COL, HETERO_X, None, 'paper', np.arange(0, 120, 4),
            8, {k: [3, 2] for k in H_ROWPTR}, budgets, 2000, num_workers=2,
            rng=4, device='cpu')
        return ldr, lambda tm: (sum(budgets.values()), 2000)
    rowptr, col, x, y = data(seed=6)
    ldr = loader.NeighborLoader(rowptr, col, x, y, np.arange(0, 400, 2), 16,
                                [5, 3], num_workers=2, rng=11, device='cpu',
                                csc=kind == 'csc')
    return ldr, lambda tm: ldr.buckets[tm['bucket']]


@pytest.mark.parametrize('kind', ['neighbor', 'hetero', 'csc'])
def test_loader_records_its_phases_only_under_a_session(kind, monkeypatch):
    ldr, slots = span_loader(kind)
    opened = []
    monkeypatch.setattr(profiling, 'record_function',
                        lambda name: opened.append(name))
    profiling.clear_spans()
    batches(ldr)  # no session: timings, and no span or range
    assert profiling.spans() == [] and opened == []
    monkeypatch.undo()
    assert all(t['sample_ms'] >= 0 and t['gather_ms'] >= 0
               for t in ldr.timings)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = batches(ldr)  # epoch 1
    nb = len(ldr)
    ids = [ldr.rng + nb + i for i in range(nb)]
    by = {}
    for s in profiling.spans():
        by.setdefault(s.name, {})[s.attrs['batch']] = s
    assert set(by) == {'sampler.sample', 'sampler.pad', 'loader.gather',
                       'loader.starve'}
    main = threading.get_native_id()
    for name in ('sampler.sample', 'sampler.pad', 'loader.gather'):
        assert sorted(by[name]) == ids, name
        assert all(s.thread != main for s in by[name].values()), name
    assert sorted(by['loader.starve']) == ids
    assert {s.thread for s in by['loader.starve'].values()} == {main}
    for i, (tm, batch) in enumerate(zip(ldr.timings, got)):
        for key, name in (('sample_ms', 'sampler.sample'),
                          ('pad_ms', 'sampler.pad'),
                          ('gather_ms', 'loader.gather')):
            assert tm[key] == by[name][ids[i]].seconds * 1e3, key
        pad = by['sampler.pad'][ids[i]].attrs
        node_slots, edge_slots = slots(tm)
        assert pad['edges'] == tm['num_edges'] == int(
            batch['edge_mask'].sum() if kind == 'hetero' else
            batch['rowptr'][-1])
        assert pad['nodes'] == tm['num_nodes']
        assert (pad['node_slots'], pad['edge_slots']) == (
            node_slots, edge_slots) == (len(batch['x']), len(batch['row']))
        assert pad['max_row_reads'] == np.bincount(batch['row']).max()
        if kind != 'hetero':
            assert pad['bucket'] == tm['bucket']
            # The engine wrote the csc batch padded; a tuple went through
            # pad_sample_output otherwise.
            sample = by['sampler.sample'][ids[i]].attrs
            assert sample['path'] == ('padded' if kind == 'csc' else
                                      'tuple')
            assert sample['edges'] == tm['num_edges']


def test_the_exported_trace_shows_the_workers_spans(tmp_path):
    ldr, _ = span_loader('neighbor')
    profiling.clear_spans()
    with profiling.trace(str(tmp_path)) as d:
        batches(ldr)
    (path, ) = glob.glob(os.path.join(d, 'trace-*.json'))
    with open(path) as fh:
        events = json.load(fh)['traceEvents']
    mine = [ev for ev in events if ev.get('cat') == 'program_span']
    assert sorted({ev['name'] for ev in mine}) == [
        'loader.gather', 'sampler.pad', 'sampler.sample']
    assert len(mine) == 3 * len(ldr)
    rows = {ev['tid'] for ev in mine}
    assert threading.get_native_id() not in rows
    named = {ev['tid'] for ev in events if ev.get('ph') == 'M'
             and ev.get('name') == 'thread_name'
             and ev['args']['name'].startswith('spans of thread')}
    assert named == rows
    # the consumer's waits are the profiler's own ranges
    assert sum(ev.get('cat') == 'user_annotation'
               and ev['name'] == 'loader.starve' for ev in events) == len(ldr)
