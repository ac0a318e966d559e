"""The slice as a whole: the port's full-graph GCN against the JAX
package's ``gcn_forward_spmm`` on the CPU, and the port's import hygiene.

Weights come from the JAX package's ``init_gcn`` and reach the port through
``gcn_params_from_jax``; features come from ``np.random.default_rng``.
Tolerance: f32 rtol 1e-5 / atol 1e-4, as for ``spmm`` (summation order of
the aggregations and of the 128- and 64-deep matmuls only).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyg_lib_tpu_torch
from pyg_lib_tpu import ops as jops
from pyg_lib_tpu.models import gnn as jgnn
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.examples.train_pointcloud import \
    main as train_pointcloud_example
from pyg_lib_tpu_torch.examples.train_rgcn_fullgraph_spmm import \
    main as train_rgcn_example
from pyg_lib_tpu_torch.models import (
    GAT, GCN, GIN, RGCN, SAGE, EdgeConv, PointNetSA, RGCNBatch,
    build_rgcn_graphs, build_rgcn_planned, edgeconv_params_from_jax,
    gat_params_from_jax, gcn_forward_spmm, gcn_params_from_jax,
    gin_params_from_jax, init_edgeconv, init_gin, init_node2vec,
    init_pointnet_sa, init_rgcn, init_rgcn_spmm, node2vec_params_from_jax,
    pointnet_sa_params_from_jax, rgcn_params_from_jax,
    rgcn_spmm_params_from_jax, sage_params_from_jax)
from pyg_lib_tpu_torch.ops.kernels.plan_cache import plan_for_ptr
from test_torch_spmm import (ATOL, RTOL, features, powerlaw_graph,
                             uniform_graph)

REPO = Path(__file__).resolve().parents[1]
DIMS = [128, 64, 7]

# (graph, build_spmm_graph's dedup, forward plan the JAX package builds).
# 2,100 rows are 17 tiles, enough for 'auto' to give the power-law
# forward side a hot level.
CASES = {
    'uniform': (lambda: uniform_graph(20, 300, 4000), 'off', 'SpmmPlan'),
    'powerlaw_auto': (lambda: powerlaw_graph(21, 2100, 12000), 'auto',
                      'DedupSpmmPlan'),
    'powerlaw_on': (lambda: powerlaw_graph(22, 300, 4000), 'on',
                    'DedupSpmmPlan'),
}


def _jax_params(seed):
    # init_gcn's biases follow the default float type, float64 under the
    # suite's x64 mode: hand both packages the same f32 arrays.
    tree = jgnn.init_gcn(jax.random.PRNGKey(seed), DIMS)
    return {'layers': [{k: np.asarray(v, np.float32) for k, v in l.items()}
                       for l in tree['layers']]}


def _graphs(case):
    make, dedup, plan_type = CASES[case]
    rowptr, col = make()
    graph_j = jops.build_spmm_graph(rowptr, col, dedup=dedup)
    graph_t = ops.build_spmm_graph(rowptr, col, dedup=dedup, device='cpu')
    assert type(graph_j.fwd).__name__ == type(graph_t.fwd).__name__ \
        == plan_type
    return rowptr.shape[0] - 1, graph_j, graph_t


@pytest.mark.parametrize('case', list(CASES))
def test_gcn_forward_matches_jax(case):
    n, graph_j, graph_t = _graphs(case)
    if case == 'powerlaw_auto':
        assert graph_t.fwd.num_hot == graph_j.fwd.num_hot > 0
    tree = _jax_params(0)
    x = features(23, n, DIMS[0])
    ref = jgnn.gcn_forward_spmm(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x), graph_j)
    got = gcn_forward_spmm(gcn_params_from_jax(tree, device='cpu'),
                           torch.from_numpy(x), graph_t)
    assert got.shape == (n, DIMS[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('case', ['uniform', 'powerlaw_auto'])
def test_gcn_weight_grads_match_jax(case):
    # The backward runs spmm's transpose plans (K1 or K2 on the card).
    n, graph_j, graph_t = _graphs(case)
    tree = _jax_params(1)
    x = features(24, n, DIMS[0])
    cot = features(25, n, DIMS[-1])

    def loss_j(params):
        return (jgnn.gcn_forward_spmm(params, jnp.asarray(x), graph_j) *
                cot).sum()

    gref = jax.grad(loss_j)(jax.tree.map(jnp.asarray, tree))
    params = gcn_params_from_jax(tree, device='cpu')
    leaves = [p for layer in params['layers'] for p in layer.values()]
    for p in leaves:
        p.requires_grad_()
    loss = (gcn_forward_spmm(params, torch.from_numpy(x), graph_t) *
            torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, leaves)
    refs = [np.asarray(g) for layer in gref['layers']
            for g in (layer['w'], layer['b'])]
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_gcn_module_trains_on_cpu():
    rowptr, col = powerlaw_graph(26, 300, 4000)
    graph = ops.build_spmm_graph(rowptr, col, dedup='on', device='cpu')
    model = GCN(DIMS, generator=torch.Generator().manual_seed(0),
                device='cpu')
    same = GCN(DIMS, generator=torch.Generator().manual_seed(0),
               device='cpu')
    for a, b in zip(model.parameters(), same.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    limit = (6.0 / (DIMS[0] + DIMS[1]))**0.5
    assert float(model.w[0].detach().abs().max()) <= limit
    x = torch.from_numpy(features(27, 300, DIMS[0]))
    labels = torch.from_numpy(
        np.random.default_rng(28).integers(0, DIMS[-1], 300))
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x, graph), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_package_imports_neither_jax_nor_reference():
    code = ('import sys, pyg_lib_tpu_torch, pyg_lib_tpu_torch.ops, '
            'pyg_lib_tpu_torch.models, pyg_lib_tpu_torch.testing, '
            'pyg_lib_tpu_torch.ops.segment_csr, '
            'pyg_lib_tpu_torch.ops.kernels.plan_cache, '
            'pyg_lib_tpu_torch.ops.kernels.segment_csr, '
            'pyg_lib_tpu_torch.ops.kernels.segment_minmax, '
            'pyg_lib_tpu_torch.ops.kernels.spmm_dedup_minmax, '
            'pyg_lib_tpu_torch.ops.softmax, '
            'pyg_lib_tpu_torch.ops.kernels.segment_softmax, '
            'pyg_lib_tpu_torch.ops.kernels.spmm_range_fused, '
            'pyg_lib_tpu_torch.ops.scatter, '
            'pyg_lib_tpu_torch.ops.segment_coo, '
            'pyg_lib_tpu_torch.ops.composite, '
            'pyg_lib_tpu_torch.ops.scatter_reduce, '
            'pyg_lib_tpu_torch.ops.matmul, '
            'pyg_lib_tpu_torch.examples.train_rgcn_fullgraph_spmm, '
            'pyg_lib_tpu_torch.sampler, pyg_lib_tpu_torch.sampler._cpp, '
            'pyg_lib_tpu_torch.sampler.padding, '
            'pyg_lib_tpu_torch.partition, pyg_lib_tpu_torch.classes, '
            'pyg_lib_tpu_torch.loader, pyg_lib_tpu_torch.entry, '
            'pyg_lib_tpu_torch.metrics, pyg_lib_tpu_torch.datasets, '
            'pyg_lib_tpu_torch.home, '
            'pyg_lib_tpu_torch.examples.train_sage_minibatch, '
            'pyg_lib_tpu_torch.examples.train_rgcn_hetero, '
            'pyg_lib_tpu_torch.examples.train_node2vec; '
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pyg_lib_tpu')); "
            'assert not bad, bad')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split('.')[0])
    return roots


def test_sources_import_neither_jax_nor_reference():
    files = sorted((REPO / 'pyg_lib_tpu_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    names = {p.name for p in files}
    assert {'segment_csr.py', 'segment_minmax.py', 'spmm_dedup_minmax.py',
            'plan_cache.py', 'gnn.py', 'softmax.py', 'segment_softmax.py',
            'spmm_range_fused.py', 'scatter.py', 'segment_coo.py',
            'composite.py', 'scatter_reduce.py', 'matmul.py',
            'train_rgcn_fullgraph_spmm.py', 'headline.py', '_cpp.py',
            '_numpy_impl.py', '_hetero_impl.py', 'padding.py', 'loader.py',
            'entry.py', 'metrics.py', 'datasets.py', 'home.py',
            'train_sage_minibatch.py', 'train_rgcn_hetero.py',
            'train_node2vec.py'} <= names and len(files) > 40
    assert {'partition', 'classes', 'sampler'} <= {
        p.parent.name for p in files if p.name == '__init__.py'}
    for path in files:
        bad = _imported_roots(path) & {'jax', 'jaxlib', 'pyg_lib_tpu'}
        assert not bad, f'{path.relative_to(REPO)} imports {bad}'


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rowptr, col = uniform_graph(29, 50, 300)
    rel = ('a', 'r', 'a')
    rels, cols, types = {rel: rowptr}, {rel: col}, {'a': 50}
    layer = {'w': np.zeros((1, 8, 4), np.float32), 'b': np.zeros(4),
             'w_self': np.zeros((8, 4), np.float32)}
    rgcn_spmm_tree = {'layers': [layer]}
    rgcn_tree = {'layers': [{'w_rel': layer['w'], 'w_root': layer['w_self'],
                             'b': layer['b']}]}
    for build in (lambda: ops.build_spmm_graph(rowptr, col),
                  lambda: ops.build_spmm_plan(rowptr, col),
                  lambda: ops.build_dedup_plan(rowptr, col),
                  lambda: ops.build_dedup_minmax_plan(rowptr, col),
                  lambda: ops.build_spmm_graph(rowptr, col, minmax='on'),
                  lambda: plan_for_ptr(rowptr),
                  lambda: GCN(DIMS), lambda: SAGE(DIMS),
                  lambda: gcn_params_from_jax(_jax_params(2)),
                  lambda: sage_params_from_jax(_jax_params(2)),
                  lambda: ops.build_spmm_graph(rowptr, col, range_split=2),
                  lambda: ops.build_spmm_graph(rowptr, col, range_split=2,
                                               range_fused=True),
                  lambda: ops.build_fused_range_plan(rowptr, col, 50, 2),
                  lambda: ops.build_weighted_fused_graph(
                      rowptr, col, 50, [(0, 50)], np.ones(len(col))),
                  lambda: GAT([8, 8, 4]),
                  lambda: gat_params_from_jax(_jax_params(2)),
                  lambda: build_rgcn_graphs(rels, cols, types),
                  lambda: build_rgcn_planned(rels, cols, types),
                  lambda: build_rgcn_planned(rels, cols, types,
                                             chunk='auto',
                                             range_sliced=True),
                  lambda: RGCN([8, 8, 4], 1), lambda: RGCNBatch([8, 8, 4], 2),
                  lambda: init_rgcn([8, 4], 2),
                  lambda: init_rgcn_spmm([8, 4], 2),
                  lambda: rgcn_params_from_jax(rgcn_tree),
                  lambda: rgcn_spmm_params_from_jax(rgcn_spmm_tree),
                  lambda: train_rgcn_example(epochs=1),
                  lambda: GIN([8, 4]), lambda: EdgeConv([3, 4]),
                  lambda: PointNetSA(0, [4]), lambda: init_gin([8, 4]),
                  lambda: init_edgeconv([3, 4]),
                  lambda: init_pointnet_sa(0, [4]),
                  lambda: init_node2vec(5, 4),
                  lambda: gin_params_from_jax({'layers': []}),
                  lambda: edgeconv_params_from_jax({'layers': []}),
                  lambda: pointnet_sa_params_from_jax({'mlp': []}),
                  lambda: node2vec_params_from_jax(
                      {'emb': np.zeros((2, 2))}),
                  lambda: train_pointcloud_example(steps=1)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()
    assert pyg_lib_tpu_torch.cuda_version() == ''


def test_spmm_refuses_mixed_devices_and_unported_options():
    rowptr, col = uniform_graph(30, 50, 300)
    graph = ops.build_spmm_graph(rowptr, col, device='cpu')
    with pytest.raises(ValueError, match='is on'):
        ops.spmm(torch.zeros((50, 4), device='meta'), graph)
    for bad in (torch.zeros((49, 4)), torch.zeros(50)):
        with pytest.raises(ValueError, match=r'x must be \[50, F\]'):
            ops.spmm(bad, graph)
    with pytest.raises(ValueError, match='reduce must be'):
        ops.spmm(torch.zeros((50, 4)), graph, reduce='prod')
    # range_split, range_fused and the plans' pad_to_chunks are ported
    # (tests/test_torch_range.py, tests/test_torch_sharded.py), and reorder
    # (tests/test_torch_partition.py), which refuses an unknown value as
    # the JAX package does.
    with pytest.raises(ValueError, match='reorder must be'):
        ops.build_spmm_graph(rowptr, col, device='cpu', reorder='rcm')
    plan = ops.build_dedup_plan(rowptr, col, pad_to_chunks=4, device='cpu')
    assert plan.num_chunks >= 4


def test_chip_smoke_fails_without_a_card(tmp_path):
    # Without CUDA (here) and away from the package, it prints no result.
    alone = tmp_path / 'chip_smoke.py'
    alone.write_text((REPO / 'chip_smoke.py').read_text())
    for script in (REPO / 'chip_smoke.py', alone):
        res = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
