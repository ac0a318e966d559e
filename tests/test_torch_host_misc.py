"""The rest of the port's host layer against the JAX package on the CPU:
``classes`` (``HashMap``, ``DeviceHashMap``, the stateful samplers,
``MetapathTracker``), ``datasets`` and ``home``, ``metrics``, ``entry``
and the examples (the host layer's three, and full-batch and planned
GCN, weighted-disjoint and temporal GraphSAGE); and the host engine's
build (``_build.build_host``): it writes only under
``pyg_lib_tpu_torch/``, and a failed ``g++`` raises.

Lookups, samples, readers and generators must equal the JAX package's bit
for bit. The ``entry()`` forward with the JAX weights (through
``sage_params_from_jax``) and each example's first loss with the JAX
example's weights are held within ``1e-4 * max|JAX|`` (PERF.md §2's model
tolerance: two aggregations and matmuls in another order).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyg_lib_tpu_torch
from pyg_lib_tpu import classes as jclasses
from pyg_lib_tpu import datasets as jdatasets
from pyg_lib_tpu import sampler as jsampler
from pyg_lib_tpu_torch import _build, classes, datasets, home
from pyg_lib_tpu_torch.metrics import Metrics, device_roofline
from test_torch_sampler import GRAPH, H_COL, H_ROWPTR, H_SEEDS, equal

REPO = Path(__file__).resolve().parents[1]
MODEL_RTOL = 1e-4


def close(got, ref, rtol=MODEL_RTOL):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


# -- classes ------------------------------------------------------------------


@pytest.mark.parametrize('keys', [np.array([40, 3, 17, -5, 2**40, 9]),
                                  np.arange(0, 3000, 7)[::-1],
                                  np.zeros(0, np.int64)])
def test_hash_maps_equal_the_jax_package(keys):
    queries = np.concatenate([keys, [1, -6, 2**41, 3], keys[::2]]).astype(
        np.int64)
    ref = np.asarray(jclasses.HashMap(keys).get(queries))
    got = classes.HashMap(keys).get(queries)
    dev = classes.DeviceHashMap(keys, device='cpu').get(
        torch.from_numpy(queries))
    assert got.dtype == np.int64 and np.array_equal(got, ref)
    assert dev.dtype == torch.int64 and np.array_equal(dev.numpy(), ref)
    assert np.array_equal(np.asarray(jclasses.DeviceHashMap(keys).get(
        queries)), ref)


def test_device_hash_map_refuses_bad_keys_and_pickles():
    import pickle

    with pytest.raises(ValueError, match='unique'):
        classes.DeviceHashMap([1, 2, 1], device='cpu')
    with pytest.raises(ValueError, match='1-D'):
        classes.DeviceHashMap(np.zeros((2, 2)), device='cpu')
    m = pickle.loads(pickle.dumps(classes.DeviceHashMap([5, 1, 9],
                                                        device='cpu')))
    assert m.get([9, 2]).tolist() == [2, -1] and len(m) == 3


@pytest.mark.parametrize('impl', ['numpy', 'cpp'])
def test_stateful_samplers_equal_the_jax_package(impl):
    rowptr, col, seed = GRAPH
    weight = np.random.default_rng(4).random(len(col))
    got = classes.NeighborSampler(rowptr, col, edge_weight=weight).sample(
        [4, 2], seed, rng=8)
    ref = jclasses.NeighborSampler(rowptr, col, edge_weight=weight).sample(
        [4, 2], seed, rng=8)
    assert equal(got, ref)
    fanouts = {k: [2, 2] for k in H_ROWPTR}
    types = ['paper', 'author', 'field']
    for disjoint in (False, True):
        got = classes.HeteroNeighborSampler(
            types, list(H_ROWPTR), H_ROWPTR, H_COL).sample(
                fanouts, H_SEEDS, disjoint=disjoint, rng=3)
        ref = jclasses.HeteroNeighborSampler(
            types, list(H_ROWPTR), H_ROWPTR, H_COL).sample(
                fanouts, H_SEEDS, disjoint=disjoint, rng=3)
        assert equal(got, ref)


def test_metapath_tracker_equals_the_jax_package():
    fanouts = {k: [3, 2] for k in H_ROWPTR}
    got = classes.MetapathTracker(list(H_ROWPTR), fanouts, ['paper'])
    ref = jclasses.MetapathTracker(list(H_ROWPTR), fanouts, ['paper'])
    for t in (got, ref):
        mp = t.init_batch(0, 'paper', 16)
        t.report_sample_size(0, mp, 5)
    assert got.n_metapaths == ref.n_metapaths
    assert got.metapath_tree == ref.metapath_tree
    assert got.expected_sample_size == ref.expected_sample_size
    assert got.reported_sample_size == ref.reported_sample_size


# -- datasets, home -----------------------------------------------------------


def test_generators_equal_the_jax_package():
    assert equal(datasets.sbm_graph(300, seed=2), jdatasets.sbm_graph(
        300, seed=2))
    assert equal(datasets.powerlaw_graph(500, 8, seed=3),
                 jdatasets.powerlaw_graph(500, 8, seed=3))
    assert equal(datasets.clustered_graph(600, 6, seed=4),
                 jdatasets.clustered_graph(600, 6, seed=4))
    src, dst = np.random.default_rng(5).integers(0, 50, (2, 300))
    assert equal(datasets.to_csr(src, dst, 50), jdatasets.to_csr(src, dst,
                                                                 50))


def _write_inputs(tmp_path):
    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, 40, (2, 120))
    w = rng.random(120)
    paths = []
    p = tmp_path / 'g.npz'
    np.savez(p, edge_index=np.stack([src, dst]), edge_weight=w)
    paths.append(p)
    p = tmp_path / 'saved.npz'
    datasets.save_csr(str(p), *datasets.to_csr(src, dst, 40)[:2],
                      x=rng.normal(size=(40, 3)))
    paths.append(p)
    p = tmp_path / 'g.mtx'
    p.write_text('%%MatrixMarket matrix coordinate real symmetric\n'
                 '% a comment\n40 40 120\n' + ''.join(
                     f'{a + 1} {b + 1} {c}\n' for a, b, c in zip(src, dst,
                                                                 w)))
    paths.append(p)
    p = tmp_path / 'g.csv'
    p.write_text('# src,dst,w\n' + ''.join(f'{a},{b},{c}\n'
                                           for a, b, c in zip(src, dst, w)))
    paths.append(p)
    p = tmp_path / 'g.txt'
    p.write_text(''.join(f'{a} {b}\n' for a, b in zip(src, dst)))
    paths.append(p)
    return paths


def test_readers_equal_the_jax_package(tmp_path):
    for path in _write_inputs(tmp_path):
        assert equal(datasets.load_csr(str(path)),
                     jdatasets.load_csr(str(path))), path.name
    with pytest.raises(ValueError, match='unsupported'):
        datasets.load_csr(str(tmp_path / 'g.bin'))


def test_get_sparse_matrix_reads_the_home_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(home, '_home_dir', None)
    monkeypatch.setenv('PYG_LIB_TPU_HOME', str(tmp_path / 'cache'))
    assert home.get_home_dir() == str(tmp_path / 'cache')
    src, dst = np.random.default_rng(7).integers(0, 30, (2, 90))
    rp, cl, _ = datasets.to_csr(src, dst, 30)
    datasets.save_csr(str(tmp_path / 'cache' / 'toy.npz'), rp, cl)
    got = datasets.get_sparse_matrix('Group', 'toy')
    assert equal(got, (rp, cl))
    with pytest.raises(FileNotFoundError, match='nothing is downloaded'):
        datasets.get_sparse_matrix('Group', 'absent')
    home.set_home_dir(str(tmp_path / 'other'))
    assert home.get_home_dir() == str(tmp_path / 'other')


# -- metrics ------------------------------------------------------------------


def test_metrics_windows_on_the_cpu_carry_no_roofline():
    recs = []
    m = Metrics(sink=recs.append, every=2, edges_per_step=100,
                bytes_per_step=10**6, flops_per_step=10**6)
    for i in range(5):
        with m.phase('sample'):
            pass
        m.step(loss=torch.tensor(float(i)), acc=0.5)
    assert [r['step'] for r in recs] == [2, 4]
    assert recs[0]['loss'] == 0.5 and recs[1]['loss'] == 2.5
    assert recs[0]['acc'] == 0.5 and 'sample' in recs[0]['phases_ms']
    assert 'gbps' in recs[0] and 'tflops' in recs[0]
    assert not {'hbm_fraction', 'f32_fraction', 'roofline_of'} & set(
        recs[0])
    assert m.summary()['steps'] == 5
    assert device_roofline() is None
    with pytest.raises(ValueError):
        Metrics(every=0)


def test_metrics_roofline_is_the_h100s_with_its_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda i=0: 'NVIDIA H100 80GB HBM3')
    monkeypatch.setattr(subprocess, 'run', lambda *a, **k: (_ for _ in ()
                                                            ).throw(OSError))
    roof = device_roofline()
    assert roof.device == 'NVIDIA H100 80GB HBM3'
    assert (roof.hbm_gbps, roof.f32_tflops) == (3350.0, 67.0)
    recs = []
    m = Metrics(sink=recs.append, every=1, bytes_per_step=10**9)
    m.step()
    assert recs[0]['roofline_of'] == roof.device
    assert recs[0]['hbm_fraction'] == pytest.approx(
        recs[0]['gbps'] / 3350.0, rel=1e-3)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i=0: 'A100')
    assert device_roofline() is None


# -- entry --------------------------------------------------------------------


def _f32_tree(tree):
    return {'layers': [{k: np.asarray(v, np.float32) for k, v in l.items()}
                       for l in tree['layers']]}


def test_entry_equals_the_jax_entry():
    sys.path.insert(0, str(REPO))
    import __graft_entry__

    from pyg_lib_tpu_torch.entry import entry, example_batch
    from pyg_lib_tpu_torch.models import sage_params_from_jax

    jfn, jargs = __graft_entry__.entry()
    fn, args = entry(device='cpu')
    for a, b in zip(args[1:], jargs[1:]):
        assert equal(a.numpy(), np.asarray(b))
    params = _f32_tree(jargs[0])
    ref = jfn(jax.tree.map(jnp.asarray, params), *jargs[1:])
    got = fn(sage_params_from_jax(params, 'cpu'), *args[1:])
    assert got.shape == (64, 7)
    close(got.numpy(), ref)
    # The port's own weights give a finite output of the same shape.
    assert torch.isfinite(fn(*args)).all()
    ref_b = __graft_entry__._example_batch(3)
    got_b = example_batch(3, device='cpu')
    assert equal({k: v.numpy() for k, v in got_b.items()},
                 {k: np.asarray(v) for k, v in ref_b.items()})


# -- examples: the first loss from the JAX example's weights ------------------


def _sage_first_loss(params):
    from pyg_lib_tpu.models import sage_forward

    data = jdatasets.sbm_graph(num_nodes=1000, p_in=0.03, p_out=0.002,
                               seed=1)
    train_idx = np.nonzero(data['train_mask'])[0]
    seeds = np.random.default_rng(0).choice(train_idx, size=64,
                                            replace=False)
    out = jsampler.neighbor_sample(data['rowptr'], data['col'], seeds,
                                   [10, 5], rng=0)
    b = jsampler.padding.pad_sample_output(out, 4096, 8192, 64)
    x = np.zeros((4096, data['x'].shape[1]), np.float32)
    x[:b.num_nodes] = data['x'][b.node_id[:b.num_nodes]]
    labels = np.zeros(4096, np.int32)
    labels[:b.num_nodes] = data['y'][b.node_id[:b.num_nodes]]
    logp = jax.nn.log_softmax(sage_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(b.rowptr), jnp.asarray(b.row)))
    return float(-jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                      axis=1)[:64, 0].mean())


def _rgcn_first_loss(params):
    from examples.train_rgcn_hetero import make_hetero_data
    from pyg_lib_tpu.models import rgcn_forward

    paper, (ap_rp, ap_col), (pa_rp, pa_col), n_auth = make_hetero_data()
    rowptr_d = {('paper', 'cites', 'paper'): paper['rowptr'],
                ('author', 'writes', 'paper'): ap_rp,
                ('paper', 'rev_writes', 'author'): pa_rp}
    col_d = {('paper', 'cites', 'paper'): paper['col'],
             ('author', 'writes', 'paper'): ap_col,
             ('paper', 'rev_writes', 'author'): pa_col}
    x_author = np.random.default_rng(1).normal(
        size=(n_auth, paper['x'].shape[1])).astype(np.float32)
    train_idx = np.nonzero(paper['train_mask'])[0]
    seeds = np.random.default_rng(0).choice(train_idx, size=32,
                                            replace=False)
    out = jsampler.hetero_neighbor_sample(
        rowptr_d, col_d, {'paper': seeds}, {k: [5, 5] for k in rowptr_d},
        rng=0)
    budgets = {'paper': 2048, 'author': 1024}
    hb = jsampler.padding.pad_hetero_sample_output(out, budgets, 8192)
    x = np.zeros((hb.num_flat_nodes, paper['x'].shape[1]), np.float32)
    po, ao = hb.type_offset['paper'], hb.type_offset['author']
    x[po:po + 2048] = paper['x'][hb.node_id['paper']]
    x[ao:ao + 1024] = x_author[hb.node_id['author']]
    x[po:po + 2048][~hb.node_mask['paper']] = 0
    x[ao:ao + 1024][~hb.node_mask['author']] = 0
    labels = paper['y'][hb.node_id['paper']][:32]
    logp = jax.nn.log_softmax(rgcn_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(hb.row), jnp.asarray(hb.col), jnp.asarray(hb.rel_ptr)))
    return float(-jnp.take_along_axis(
        logp[po:po + 32], jnp.asarray(labels)[:, None], axis=1).mean())


def _node2vec_first_loss(params):
    from pyg_lib_tpu.models import node2vec_loss

    data = jdatasets.sbm_graph(num_nodes=600, seed=0)
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 600, 256)
    walks = jsampler.random_walk(data['rowptr'], data['col'], seeds,
                                 walk_length=10, rng=0)
    neg = rng.integers(0, 600, (256, 5))
    return float(node2vec_loss(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(walks), jnp.asarray(neg)))


def _jax_params(name):
    from pyg_lib_tpu import models

    key = jax.random.PRNGKey(0)
    if name == 'train_sage_minibatch':
        return _f32_tree(models.init_sage(key, [16, 64, 4]))
    if name == 'train_rgcn_hetero':
        return _f32_tree(models.init_rgcn(key, [16, 64, 4], 3))
    return {'emb': np.asarray(models.init_node2vec(key, 600, 32)['emb'],
                              np.float32)}


@pytest.mark.parametrize('name,first_loss', [
    ('train_sage_minibatch', _sage_first_loss),
    ('train_rgcn_hetero', _rgcn_first_loss),
    ('train_node2vec', _node2vec_first_loss)])
def test_examples_first_loss_equals_the_jax_examples(name, first_loss):
    import importlib

    sys.path.insert(0, str(REPO))
    example = importlib.import_module(f'pyg_lib_tpu_torch.examples.{name}')
    params = _jax_params(name)
    _, losses = example.main(steps=1, verbose=False, device='cpu',
                             params=params)
    ref = first_loss(params)
    assert abs(losses[0] - ref) <= MODEL_RTOL * abs(ref)


def test_examples_train_on_the_cpu():
    from pyg_lib_tpu_torch.examples import (train_node2vec,
                                            train_rgcn_hetero,
                                            train_sage_minibatch)

    acc, losses = train_sage_minibatch.main(steps=30, verbose=False,
                                            device='cpu')
    assert acc > 0.6 and losses[-1] < losses[0]
    acc, losses = train_rgcn_hetero.main(steps=30, verbose=False,
                                         device='cpu')
    assert acc > 0.6 and losses[-1] < losses[0]
    agree, losses = train_node2vec.main(steps=60, verbose=False,
                                        device='cpu')
    assert agree > 0.6 and losses[-1] < losses[0]


# -- the examples of the last slice -------------------------------------------


def _gcn_first_loss(params, spmm):
    from pyg_lib_tpu import ops as jops
    from pyg_lib_tpu.models import gcn_forward, gcn_forward_spmm

    d = jdatasets.sbm_graph(num_nodes=1000 if spmm else 400, seed=0)
    x, y = jnp.asarray(d['x']), jnp.asarray(d['y'])
    p = jax.tree.map(jnp.asarray, params)
    if spmm:
        logits = gcn_forward_spmm(p, x, jops.build_spmm_graph(d['rowptr'],
                                                              d['col']))
    else:
        logits = gcn_forward(p, x, jnp.asarray(d['rowptr']),
                             jnp.asarray(d['col']))
    nll = -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None],
                               axis=1)[:, 0]
    train = d['train_mask']
    return float(jnp.where(train, nll, 0.0).sum() / train.sum())


def _loader_first_loss(params, temporal):
    from examples.train_temporal_sage import time_sort_neighborhoods
    from pyg_lib_tpu import loader as jloader
    from pyg_lib_tpu.models import sage_forward
    from pyg_lib_tpu.sampler import _cpp as jcpp

    # Loaded before the JAX loader's threads race to load it (the loser
    # would sample with numpy; see tests/test_torch_loader.py).
    assert jcpp.get_lib() is not None
    d = jdatasets.sbm_graph(num_nodes=2000 if temporal else 3000,
                            num_classes=4, seed=3 if temporal else 1)
    col, kw = d['col'], dict(edge_weight=np.random.default_rng(0).uniform(
        0.05, 1.0, size=len(d['col'])), num_neighbors=[10, 5])
    if temporal:
        node_time = np.random.default_rng(0).integers(0, 100, 2000)
        col = time_sort_neighborhoods(d['rowptr'], d['col'], node_time)
        kw = dict(node_time=node_time, temporal_strategy='last',
                  num_neighbors=[8, 4])
    ldr = jloader.NeighborLoader(d['rowptr'], col, d['x'], d['y'],
                                 np.nonzero(d['train_mask'])[0],
                                 batch_size=64, num_workers=2, rng=0,
                                 disjoint=True, **kw)
    batch = next(iter(ldr))
    logp = jax.nn.log_softmax(sage_forward(
        jax.tree.map(jnp.asarray, params), batch['x'], batch['rowptr'],
        batch['row']))
    nll = -jnp.take_along_axis(logp, batch['y'][:, None].astype(jnp.int32),
                               axis=1)[:, 0]
    mask = batch['node_mask'] & (jnp.arange(nll.shape[0])
                                 < batch['num_seeds'])
    return float((nll * mask).sum() / jnp.maximum(mask.sum(), 1))


LAST_EXAMPLES = {  # name: (JAX init, main's arguments, JAX first loss)
    'train_gcn': ('init_gcn', [16, 32, 4], dict(epochs=1),
                  lambda p: _gcn_first_loss(p, False)),
    'train_gcn_fullgraph_spmm': ('init_gcn', [16, 64, 4],
                                 dict(num_nodes=1000, epochs=1),
                                 lambda p: _gcn_first_loss(p, True)),
    'train_sage_weighted_disjoint': ('init_sage', [16, 64, 4],
                                     dict(steps=1),
                                     lambda p: _loader_first_loss(p, False)),
    'train_temporal_sage': ('init_sage', [16, 64, 4], dict(steps=1),
                            lambda p: _loader_first_loss(p, True)),
}


@pytest.mark.parametrize('name', list(LAST_EXAMPLES))
def test_last_examples_first_loss_equals_the_jax_examples(name):
    import importlib

    from pyg_lib_tpu import models

    sys.path.insert(0, str(REPO))
    init, dims, kw, first_loss = LAST_EXAMPLES[name]
    params = _f32_tree(getattr(models, init)(jax.random.PRNGKey(0), dims))
    example = importlib.import_module(f'pyg_lib_tpu_torch.examples.{name}')
    _, losses = example.main(verbose=False, device='cpu', params=params,
                             **kw)
    ref = first_loss(params)
    assert len(losses) == 1
    assert abs(losses[0] - ref) <= MODEL_RTOL * abs(ref)


def test_last_examples_train_on_the_cpu():
    from pyg_lib_tpu_torch.examples import (train_gcn,
                                            train_gcn_fullgraph_spmm,
                                            train_sage_weighted_disjoint,
                                            train_temporal_sage)

    # tests/test_end_to_end.py's full-batch GCN, and its bar.
    acc, losses = train_gcn.main(num_nodes=200, epochs=60, verbose=False,
                                 device='cpu')
    assert acc > 0.85 and losses[-1] < losses[0]
    acc, losses = train_gcn_fullgraph_spmm.main(num_nodes=600, epochs=20,
                                                verbose=False, device='cpu')
    assert acc > 0.85 and losses[-1] < losses[0]
    for example in (train_sage_weighted_disjoint, train_temporal_sage):
        acc, losses = example.main(epochs=2, verbose=False, device='cpu')
        assert acc > 0.85 and losses[-1] < losses[0]


def test_time_sort_equals_the_jax_example():
    sys.path.insert(0, str(REPO))
    from examples.train_temporal_sage import time_sort_neighborhoods as ref
    from pyg_lib_tpu_torch.examples.train_temporal_sage import \
        time_sort_neighborhoods

    rng = np.random.default_rng(4)
    for n, span in ((300, 100), (50, 3), (1, 5)):
        deg = rng.integers(0, 30, n)
        rowptr = np.zeros(n + 1, np.int64)
        rowptr[1:] = np.cumsum(deg)
        col = rng.integers(0, n, int(rowptr[-1]))
        node_time = rng.integers(-span, span, n)  # many ties
        got = time_sort_neighborhoods(rowptr, col, node_time, 'cpu')
        assert got.dtype == col.dtype
        assert np.array_equal(got, ref(rowptr, col, node_time))
        row = np.repeat(np.arange(n), deg)
        assert np.array_equal(got, col[np.lexsort((node_time[col], row))])


def test_last_examples_need_a_card_unless_told(monkeypatch):
    from pyg_lib_tpu_torch.examples import (train_gcn,
                                            train_gcn_fullgraph_spmm,
                                            train_sage_weighted_disjoint,
                                            train_temporal_sage)

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: train_gcn.main(epochs=1, verbose=False),
                 lambda: train_gcn_fullgraph_spmm.main(epochs=1,
                                                       verbose=False),
                 lambda: train_sage_weighted_disjoint.main(steps=1,
                                                           verbose=False),
                 lambda: train_temporal_sage.main(steps=1, verbose=False),
                 lambda: train_temporal_sage.time_sort_neighborhoods(
                     np.zeros(2, np.int64), np.zeros(0, np.int64),
                     np.zeros(1, np.int64))):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()


# -- the host engine's build --------------------------------------------------


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    find_gxx = _build._gxx
    fake = tmp_path / 'g++'
    fake.write_text('#!/bin/sh\necho "error: the stand-in refuses"\n'
                    'exit 1\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, '_gxx', lambda: str(fake))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'out')
    with pytest.raises(RuntimeError, match='the stand-in refuses'):
        _build.build_host()
    assert not list((tmp_path / 'out').glob('host-*.so'))
    assert 'refuses' in (tmp_path / 'out' / 'host.log').read_text()
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match=r'g\+\+ was not found'):
        find_gxx()


def test_the_host_build_writes_only_under_the_port(tmp_path):
    # A copy of the port beside an empty pyg_lib_tpu/: sampling builds the
    # engine into the copy's _build/, and pyg_lib_tpu/ stays empty.
    root = tmp_path / 'repo'
    shutil.copytree(REPO / 'pyg_lib_tpu_torch', root / 'pyg_lib_tpu_torch',
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    (root / 'pyg_lib_tpu').mkdir()
    code = ('import numpy as np\n'
            'from pyg_lib_tpu_torch import sampler\n'
            'from pyg_lib_tpu_torch.testing import cycle_graph\n'
            'rp, cl = cycle_graph(8)\n'
            'out = sampler.neighbor_sample(rp, cl, np.array([0]), [2])\n'
            'assert sampler._cpp.calls["neighbor_sample"] == 1\n')
    env = dict(os.environ, PYTHONPATH=str(root), PYTHONDONTWRITEBYTECODE='1')
    res = subprocess.run([sys.executable, '-c', code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert not any((root / 'pyg_lib_tpu').iterdir())
    built = list((root / 'pyg_lib_tpu_torch' / '_build').glob('host-*.so'))
    assert len(built) == 1
    assert _build.HOST == REPO / 'pyg_lib_tpu_torch' / 'csrc' / 'host'
    assert pyg_lib_tpu_torch.__file__.startswith(str(REPO))


def test_host_layer_entry_points_need_a_card_unless_told(monkeypatch):
    from pyg_lib_tpu_torch.entry import entry, example_batch
    from pyg_lib_tpu_torch.examples import (train_node2vec,
                                            train_rgcn_hetero,
                                            train_sage_minibatch)
    from pyg_lib_tpu_torch.loader import HeteroNeighborLoader

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: classes.DeviceHashMap([1, 2]), entry,
                 lambda: example_batch(1),
                 lambda: HeteroNeighborLoader(H_ROWPTR, H_COL, {}, None,
                                              'paper', [0], 1, {}, {}, 8),
                 lambda: train_sage_minibatch.main(steps=1, verbose=False),
                 lambda: train_rgcn_hetero.main(steps=1, verbose=False),
                 lambda: train_node2vec.main(steps=1, verbose=False)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
