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
from pyg_lib_tpu_torch import models, ops
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
            'pyg_lib_tpu_torch.examples.train_node2vec, '
            'pyg_lib_tpu_torch.parallel, pyg_lib_tpu_torch.parallel.halo, '
            'pyg_lib_tpu_torch.parallel.mesh, '
            'pyg_lib_tpu_torch.parallel.train, '
            'pyg_lib_tpu_torch.parallel.launch, '
            'pyg_lib_tpu_torch.parallel._collectives, '
            'pyg_lib_tpu_torch.sampler.dist, '
            'pyg_lib_tpu_torch.sampler.dist_service, '
            'pyg_lib_tpu_torch.sampler.transport, '
            'pyg_lib_tpu_torch.sampler.serve, '
            'pyg_lib_tpu_torch.examples.train_dist_fullgraph, '
            'pyg_lib_tpu_torch.examples.train_dist_sampled, '
            'pyg_lib_tpu_torch.checkpoint, pyg_lib_tpu_torch.profiling, '
            'pyg_lib_tpu_torch.utils, '
            'pyg_lib_tpu_torch.examples.train_gcn, '
            'pyg_lib_tpu_torch.examples.train_gcn_fullgraph_spmm, '
            'pyg_lib_tpu_torch.examples.train_sage_weighted_disjoint, '
            'pyg_lib_tpu_torch.examples.train_temporal_sage; '
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
            'train_rgcn_fullgraph_spmm.py', '_cpp.py',
            '_numpy_impl.py', '_hetero_impl.py', 'padding.py', 'loader.py',
            'entry.py', 'metrics.py', 'datasets.py', 'home.py',
            'train_sage_minibatch.py', 'train_rgcn_hetero.py',
            'train_node2vec.py', 'halo.py', 'mesh.py', 'train.py',
            'launch.py', '_collectives.py', 'dist.py', 'dist_service.py',
            'transport.py', 'serve.py', 'train_dist_fullgraph.py',
            'train_dist_sampled.py', 'checkpoint.py', 'profiling.py',
            'train_gcn.py', 'train_gcn_fullgraph_spmm.py',
            'train_sage_weighted_disjoint.py', 'train_temporal_sage.py'
            } <= names and len(files) > 40
    assert {'partition', 'classes', 'sampler', 'parallel'} <= {
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


def test_chip_smoke_device_events_keep_only_the_given_categories(
        monkeypatch):
    # The smoke's profiles count as busy only the trace's categories of
    # device work; a record_function range is none of them. On the CPU
    # the trace has no device work, so the operators' category stands in.
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('a_range'):
            torch.ones(64).sum()
    monkeypatch.setattr(chip_smoke, 'DEVICE_WORK', ('cpu_op', ))
    events = chip_smoke.device_events(prof)
    names = [name for _, name, _, _ in events]
    assert 'aten::sum' in names and 'a_range' not in names
    assert {cat for cat, _, _, _ in events} == {'cpu_op'}
    starts = [start for _, _, start, _ in events]
    assert starts == sorted(starts)
    assert all(dur >= 0 for _, _, _, dur in events)


# -- the functional initialisers and the package's surface -------------------

INITS = {  # name: (JAX call, port call), both with dims [12, 8, 4]
    'init_gcn': (lambda k: jgnn.init_gcn(k, [12, 8, 4]),
                 lambda g: models.init_gcn([12, 8, 4], g, 'cpu')),
    'init_sage': (lambda k: jgnn.init_sage(k, [12, 8, 4]),
                  lambda g: models.init_sage([12, 8, 4], g, 'cpu')),
    'init_gat': (lambda k: jgnn.init_gat(k, [12, 8, 4], heads=2),
                 lambda g: models.init_gat([12, 8, 4], 2, g, 'cpu')),
    'init_gat_spmm': (lambda k: jgnn.init_gat_spmm(k, [12, 8, 4], heads=2),
                      lambda g: models.init_gat_spmm([12, 8, 4], 2, g,
                                                     'cpu')),
}


def _init_forwards(name, tree, x, rowptr, row, col, pkg):
    """The forward that takes ``name``'s tree, in ``pkg`` (``jgnn`` or the
    port's ``models``), over a CSR batch (or its planned graph)."""
    if name == 'init_gcn':
        return pkg.gcn_forward(tree, x, rowptr, row)
    if name == 'init_sage':
        return pkg.sage_forward(tree, x, rowptr, row)
    if name == 'init_gat':
        return pkg.gat_forward(tree, x, rowptr, row, col)
    graph = (jops if pkg is jgnn else ops).build_spmm_graph(
        rowptr, row, with_edge_maps=True,
        **({} if pkg is jgnn else {'device': 'cpu'}))
    return pkg.gat_forward_spmm(tree, x, graph)


@pytest.mark.parametrize('name', list(INITS))
def test_init_trees_match_the_jax_packages(name):
    jax_init, port_init = INITS[name]
    with jax.enable_x64(False):  # the JAX package's default float type
        ref = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3)))
    got = port_init(torch.Generator().manual_seed(3))
    assert got.keys() == ref.keys() and len(got['layers']) == 2
    if name == 'init_gat':
        assert got['heads'] == ref['heads'] == 2
    for g, r in zip(got['layers'], ref['layers']):
        assert g.keys() == r.keys()
        for k, v in g.items():
            assert tuple(v.shape) == r[k].shape and v.dtype == torch.float32
            assert r[k].dtype == np.float32
            if k == 'b':
                assert not v.any()
                continue
            fan_in, fan_out = v.shape[-2:]
            limit = (6.0 / (fan_in + fan_out))**0.5
            assert v.abs().max() <= limit and v.std() > limit / 4
    # One tree through both packages: the same forward output.
    rowptr, col = uniform_graph(31, 40, 200)
    row = np.repeat(np.arange(40), np.diff(rowptr))
    x = features(32, 40, 12)
    tree = jax.tree.map(lambda v: v.numpy() if isinstance(v, torch.Tensor)
                        else v, got)
    want = _init_forwards(name, jax.tree.map(jnp.asarray, tree),
                          jnp.asarray(x), jnp.asarray(rowptr),
                          jnp.asarray(col), jnp.asarray(row), jgnn)
    out = _init_forwards(name, got, torch.from_numpy(x),
                         torch.from_numpy(rowptr), torch.from_numpy(col),
                         torch.from_numpy(row), models)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_init_gat_spmm_refuses_a_width_heads_do_not_divide():
    with pytest.raises(ValueError, match='not divisible by heads=3'):
        jgnn.init_gat_spmm(jax.random.PRNGKey(0), [12, 8, 4], heads=3)
    with pytest.raises(ValueError, match='not divisible by heads=3'):
        models.init_gat_spmm([12, 8, 4], 3, device='cpu')


def _public(module, prefix):
    """The names ``module`` defines itself (and its ``__all__``)."""
    names = set(getattr(module, '__all__', ()))
    names |= {n for n, v in vars(module).items() if not n.startswith('_')
              and getattr(v, '__module__', '').startswith(prefix)}
    return names


# Names of the JAX package the port covers under another name, or leaves
# out on purpose (ROADMAP.md: not a module to port).
RENAMED = {'tpu_version': 'cuda_version'}
NOT_PORTED = {'register_plan_pytree'}  # utils/pytree.py: JAX pytrees


@pytest.mark.parametrize('module', ['', '.models', '.utils', '.testing',
                                    '.checkpoint', '.profiling'])
def test_the_port_exports_every_name_of_the_jax_package(module):
    import importlib

    ref = importlib.import_module('pyg_lib_tpu' + module)
    got = importlib.import_module('pyg_lib_tpu_torch' + module)
    port = lambda names: {RENAMED.get(n, n) for n in names} - NOT_PORTED
    want = _public(ref, 'pyg_lib_tpu')
    if module == '':  # and the subpackages the JAX package imports
        want |= {n for n, v in vars(ref).items() if not n.startswith('_')
                 and type(v).__name__ == 'module'
                 and v.__name__.startswith('pyg_lib_tpu.')}
    if module == '.utils':
        want |= {'register_plan_pytree'}
    missing = {n for n in port(want) if not hasattr(got, n)}
    assert not missing, missing
    listed = port(getattr(ref, '__all__', want))
    assert not listed - set(got.__all__), listed - set(got.__all__)


def test_utils_match_the_jax_package():
    from pyg_lib_tpu import utils as jutils
    from pyg_lib_tpu_torch import utils

    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for dim in (0, 1, -1):
        front = utils.move_dim_front(torch.from_numpy(x), dim)
        ref = np.asarray(jutils.move_dim_front(jnp.asarray(x), dim))
        assert np.array_equal(front.numpy(), ref)
        back = utils.move_dim_back(front, dim)
        assert np.array_equal(back.numpy(), np.asarray(
            jutils.move_dim_back(jnp.asarray(ref), dim)))
        assert np.array_equal(back.numpy(), x)
    for t in (torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16),
              torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=bool)):
        a = jnp.zeros(2, str(t.dtype).split('.')[1])
        assert utils.is_floating(t) == jutils.is_floating(a)
    # Sorted ids with a leading gap (-1) and trailing padding (R), as
    # indptr_to_index gives them, and the round trip.
    indptr = np.array([2, 2, 5, 9, 9, 12], np.int64)
    ids = utils.indptr_to_index(torch.from_numpy(indptr), 14)
    assert np.array_equal(ids.numpy(), np.asarray(jutils.indptr_to_index(
        jnp.asarray(indptr), 14)))
    for index, size in ((ids, 5), (torch.tensor([0, 0, 3, 3, 3]), 4),
                        (torch.tensor([], dtype=torch.int64), 3),
                        (torch.tensor([-1, 0, 1, 7, 7]), 3)):
        got = utils.index_to_indptr(index, size)
        ref = np.asarray(jutils.index_to_indptr(jnp.asarray(index.numpy()),
                                                size))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    assert np.array_equal(utils.index_to_indptr(ids, 5).numpy()[1:],
                          indptr[1:] - indptr[0])


def test_testing_helpers_match_the_jax_package():
    from pyg_lib_tpu import testing as jtesting
    from pyg_lib_tpu_torch import testing

    assert testing.SEED == jtesting.SEED == 12345

    @testing.withSeed
    def draw():
        return np.random.rand(3), torch.rand(3)

    a, b = draw(), draw()
    assert np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])
    np.random.seed(1)
    assert np.array_equal(draw()[0], np.random.RandomState(12345).rand(3))
    testing.assert_allclose(torch.tensor([1.0, 2.0]), [1.0, 2.0 + 1e-7])
    testing.assert_allclose(torch.tensor([1.0], dtype=torch.bfloat16),
                            torch.tensor([1.0]))
    with pytest.raises(AssertionError):
        testing.assert_allclose(torch.tensor([1.0]), np.array([1.1]))
    assert np.array_equal(testing.cycle_graph(7)[1],
                          jtesting.cycle_graph(7)[1])
