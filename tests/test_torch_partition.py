"""The port's partitioner (``pyg_lib_tpu_torch.partition``) and the
cluster-reordered ``spmm`` (``build_spmm_graph(reorder=...)``) against the
JAX package on the CPU.

``metis`` (k-way and recursive, weighted, both ``impl``s),
``cluster_reorder``, ``edge_cut`` and the two mesh partitions must equal
the JAX package's bit for bit. ``spmm`` over a reordered graph (sum, mean,
max and min, values and gradients) is held against the JAX ``spmm`` over
the JAX package's reordered graph at f32 rtol 1e-5 / atol 1e-4 (the
summation order only, as in ``test_torch_spmm.py``); the relabelling
itself (``perm``, ``rank``) is equal bit for bit.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu import partition as jpartition
from pyg_lib_tpu.datasets import clustered_graph
from pyg_lib_tpu_torch import ops, partition
from pyg_lib_tpu_torch.sampler import _cpp
from test_torch_spmm import ATOL, RTOL, _csr, features, powerlaw_graph


def shuffled_clusters(seed=0, n=1500, clusters=12, deg=8):
    """A planted-partition graph with its labels shuffled, so that the
    clusters are there to be found again."""
    rp, cl, _ = clustered_graph(n, clusters, avg_degree=deg, seed=seed)
    rank = np.random.default_rng(seed + 1).permutation(n)
    row = np.repeat(np.arange(n), np.diff(rp))
    return _csr(rank[row], rank[cl], n)


GRAPHS = {
    'clustered': shuffled_clusters,
    'powerlaw': lambda: powerlaw_graph(4, 1200, 9000),
    'cycle': lambda: (np.arange(0, 2 * 300 + 1, 2, dtype=np.int64),
                      np.stack([(np.arange(300) - 1) % 300,
                                (np.arange(300) + 1) % 300], 1).reshape(-1)),
}


@pytest.mark.parametrize('graph', sorted(GRAPHS))
@pytest.mark.parametrize('impl', ['numpy', 'cpp'])
@pytest.mark.parametrize('k,recursive', [(2, False), (7, False), (8, True),
                                         (5, True)])
def test_metis_equals_the_jax_package(graph, impl, k, recursive):
    rowptr, col = GRAPHS[graph]()
    got = partition.metis(rowptr, col, k, recursive=recursive, seed=3,
                          impl=impl)
    ref = jpartition.metis(rowptr, col, k, recursive=recursive, seed=3,
                           impl=impl)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert set(np.unique(got)) <= set(range(k))


@pytest.mark.parametrize('impl', ['numpy', 'cpp'])
def test_weighted_metis_and_edge_cut_equal_the_jax_package(impl):
    rowptr, col = GRAPHS['clustered']()
    rng = np.random.default_rng(6)
    nw = rng.random(len(rowptr) - 1) + 0.5
    ew = rng.random(len(col))
    got = partition.metis(rowptr, col, 6, node_weight=nw, edge_weight=ew,
                          impl=impl)
    ref = jpartition.metis(rowptr, col, 6, node_weight=nw, edge_weight=ew,
                           impl=impl)
    assert np.array_equal(got, ref)
    calls = _cpp.calls['edge_cut']
    for w in (None, ew):
        assert (partition.edge_cut(rowptr, col, got, w) ==
                jpartition.edge_cut(rowptr, col, ref, w))
    assert _cpp.calls['edge_cut'] == calls + 2
    # A partition from the grower cuts fewer edges than a random one.
    rand = np.random.default_rng(7).integers(0, 6, len(rowptr) - 1)
    assert partition.edge_cut(rowptr, col, got) < partition.edge_cut(
        rowptr, col, rand)


def test_metis_refuses_an_unknown_impl_and_takes_one_part():
    rowptr, col = GRAPHS['cycle']()
    assert (partition.metis(rowptr, col, 1) == 0).all()
    with pytest.raises(ValueError, match='impl must be'):
        partition.metis(rowptr, col, 4, impl='fast')


@pytest.mark.parametrize('block_rows', [None, 97])
@pytest.mark.parametrize('with_edge_perm', [True, False])
@pytest.mark.parametrize('col_dtype', [None, np.int32])
def test_cluster_reorder_equals_the_jax_package(block_rows, with_edge_perm,
                                                col_dtype):
    rowptr, col = GRAPHS['clustered']()
    part = partition.metis(rowptr, col, 12)
    got = partition.cluster_reorder(rowptr, col, part, block_rows,
                                    with_edge_perm, col_dtype)
    ref = jpartition.cluster_reorder(rowptr, col, part, block_rows,
                                     with_edge_perm, col_dtype)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    new_rp, new_col, node_perm, _ = got
    # The relabelled graph is the same graph: edge (perm[r], perm[c]).
    rank = np.argsort(node_perm)
    old = set(zip(np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr)),
                  col))
    new = {(node_perm[r], node_perm[c]) for r, c in zip(
        np.repeat(np.arange(len(new_rp) - 1), np.diff(new_rp)), new_col)}
    assert old == new and (rank[node_perm] == np.arange(len(rank))).all()


@pytest.mark.parametrize('devices', [1, 3, 4, 8])
def test_mesh_partitions_equal_the_jax_package(devices):
    rowptr, col = GRAPHS['powerlaw']()
    got = partition.mesh_edge_partition(rowptr, col, devices)
    ref = jpartition.mesh_edge_partition(rowptr, col, devices)
    got_b = partition.mesh_edge_partition_blocked(rowptr, col, devices)
    ref_b = jpartition.mesh_edge_partition_blocked(rowptr, col, devices)
    for a, b in list(zip(got, ref)) + list(zip(got_b, ref_b)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _jax_graph(rowptr, col, reorder, **kw):
    return jops.build_spmm_graph(rowptr, col, reorder=reorder, **kw)


REORDERS = ['on', 'auto', 16]


@pytest.mark.parametrize('graph', ['clustered', 'powerlaw'])
@pytest.mark.parametrize('reorder', REORDERS)
@pytest.mark.parametrize('kw', [{}, {'dedup': 'auto'},
                                {'minmax': 'on'}, {'chunk': 'auto'}],
                         ids=['chunked', 'dedup', 'minmax', 'auto_chunk'])
def test_reordered_spmm_equals_the_jax_package(graph, reorder, kw):
    rowptr, col = GRAPHS[graph]()
    n = len(rowptr) - 1
    ref_g = _jax_graph(rowptr, col, reorder, **kw)
    got_g = ops.build_spmm_graph(rowptr, col, reorder=reorder, device='cpu',
                                 **kw)
    assert (got_g.perm is None) == (ref_g.perm is None)
    if got_g.perm is not None:
        assert np.array_equal(got_g.perm.numpy(), np.asarray(ref_g.perm))
        assert np.array_equal(got_g.rank.numpy(), np.asarray(ref_g.rank))
    x, cot = features(9, n, 12), features(10, n, 12)
    for reduce in ('sum', 'mean', 'max', 'min'):
        if reduce in ('max', 'min') and kw.get('dedup') == 'auto' and (
                not isinstance(got_g.fwd, ops.SpmmPlan)):
            continue  # a dedup plan carries no min/max schedule
        ref = jops.spmm(jnp.asarray(x), ref_g, reduce=reduce)
        ref_grad = jax.grad(lambda a: (jops.spmm(a, ref_g, reduce=reduce) *
                                       cot).sum())(jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        out = ops.spmm(xt, got_g, reduce=reduce)
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('reduce', ['sum', 'mean', 'max'])
def test_reordered_spmm_equals_the_unreordered(reduce):
    rowptr, col = GRAPHS['clustered']()
    x = features(10, len(rowptr) - 1, 8)
    plain = ops.build_spmm_graph(rowptr, col, device='cpu')
    reordered = ops.build_spmm_graph(rowptr, col, reorder='on', device='cpu')
    assert reordered.perm is not None
    cot = torch.from_numpy(features(11, len(rowptr) - 1, 8))
    outs = []
    for g in (plain, reordered):
        xt = torch.tensor(x, requires_grad=True)
        out = ops.spmm(xt, g, reduce=reduce)
        (out * cot).sum().backward()
        outs.append((out.detach().numpy(), xt.grad.numpy()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_auto_keeps_the_original_labels_of_a_uniform_graph():
    # A uniform graph has no clusters to recover: 'auto' declines.
    rowptr, col = _csr(*np.random.default_rng(11).integers(0, 1500,
                                                          (2, 9000)), 1500)
    assert ops.build_spmm_graph(rowptr, col, reorder='auto',
                                device='cpu').perm is None
    assert _jax_graph(rowptr, col, 'auto').perm is None


def test_permute_rows_backward_is_the_inverse_gather():
    from pyg_lib_tpu_torch.ops.spmm import _permute_rows
    perm = torch.tensor([2, 0, 3, 1])
    inv = torch.argsort(perm)
    x = torch.arange(8.0).reshape(4, 2).requires_grad_()
    y = _permute_rows(x, perm, inv)
    assert torch.equal(y, x.detach()[perm])
    g = torch.randn(4, 2)
    y.backward(g)
    assert torch.equal(x.grad, g[inv])


@pytest.mark.parametrize('model', ['SAGE', 'sage_maxpool_forward_spmm',
                                   'gat_forward_spmm', 'sddmm'])
def test_what_reads_the_plan_refuses_a_reordered_graph(model):
    # These read graph.fwd's rows and columns themselves, which a reordered
    # graph holds in the relabelled ids: they must raise, not give rows in
    # the wrong order. GAT and sddmm need edge maps, which reorder refuses,
    # so their graph is a reordered one's relabelling put on an edge-map
    # graph by hand.
    from pyg_lib_tpu_torch import models
    rowptr, col = GRAPHS['clustered']()
    n = len(rowptr) - 1
    x = torch.from_numpy(features(12, n, 8))
    reordered = ops.build_spmm_graph(rowptr, col, reorder='on', device='cpu')
    assert reordered.perm is not None
    gen = torch.Generator().manual_seed(0)
    sage = models.SAGE([8, 6, 3], generator=gen, device='cpu')
    if model in ('gat_forward_spmm', 'sddmm'):
        reordered = ops.build_spmm_graph(
            rowptr, col, with_edge_maps=True, device='cpu')._replace(
                perm=reordered.perm, rank=reordered.rank)
    call = {
        'SAGE': lambda: sage(x, reordered),
        'sage_maxpool_forward_spmm': lambda: models.sage_maxpool_forward_spmm(
            sage.params(), x, reordered),
        'gat_forward_spmm': lambda: models.gat_forward_spmm(
            models.GAT([8, 3], heads=1, generator=gen,
                       device='cpu').params(), x, reordered),
        'sddmm': lambda: ops.sddmm(x, x, reordered),
    }[model]
    with pytest.raises(ValueError, match='cluster-reordered'):
        call()


def test_gcn_over_a_reordered_graph_equals_the_unreordered():
    # GCN aggregates through spmm, which permutes, and reads deg, which a
    # reordered graph keeps in the original order.
    from pyg_lib_tpu_torch import models
    rowptr, col = GRAPHS['clustered']()
    x = torch.from_numpy(features(13, len(rowptr) - 1, 8))
    gcn = models.GCN([8, 6, 3], generator=torch.Generator().manual_seed(1),
                     device='cpu')
    reordered = ops.build_spmm_graph(rowptr, col, reorder='on', device='cpu')
    assert reordered.perm is not None
    np.testing.assert_allclose(
        gcn(x, reordered).detach().numpy(),
        gcn(x, ops.build_spmm_graph(rowptr, col, device='cpu')).detach()
        .numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('kw', [{}, {'dedup': 'on', 'minmax': 'on'}],
                         ids=['chunked', 'dedup'])
def test_chip_smoke_plain_kernels_cover_reordered_spmm(kw):
    # chip_smoke.py holds path C's reordered spmm against the same graph
    # under plain_kernels(): every kernel wrapper that spmm reaches must be
    # replaced there (a wrong name or signature shows here, on the CPU,
    # where the replacements run too), and the sums must not change.
    import chip_smoke
    from pyg_lib_tpu_torch.ops.kernels import spmm_chunked, spmm_dedup
    rowptr, col = GRAPHS['clustered']()
    n = len(rowptr) - 1
    g = ops.build_spmm_graph(rowptr, col, reorder='on', device='cpu', **kw)
    assert g.perm is not None
    cot = torch.from_numpy(features(15, n, 5))
    wrappers = (spmm_chunked.spmm_chunked, spmm_dedup.dedup_sum)
    for reduce in ('sum', 'mean', 'max', 'min'):
        outs = []
        for plain in (False, True):
            xt = torch.tensor(features(14, n, 5), requires_grad=True)
            with (chip_smoke.plain_kernels() if plain else
                  contextlib.nullcontext()):
                if plain:
                    assert (spmm_chunked.spmm_chunked,
                            spmm_dedup.dedup_sum) != wrappers
                out = ops.spmm(xt, g, reduce=reduce)
                (out * cot).sum().backward()
            outs.append((out.detach().numpy(), xt.grad.numpy()))
        for a, b in zip(*outs):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert (spmm_chunked.spmm_chunked, spmm_dedup.dedup_sum) == wrappers


def test_reorder_refuses_what_the_jax_package_refuses():
    rowptr, col = GRAPHS['cycle']()
    with pytest.raises(ValueError, match='reorder must be'):
        ops.build_spmm_graph(rowptr, col, reorder='rcm', device='cpu')
    with pytest.raises(ValueError, match='square'):
        ops.build_spmm_graph(rowptr, col, reorder='on', num_cols=400,
                             device='cpu')
    with pytest.raises(ValueError, match='with_edge_maps'):
        ops.build_spmm_graph(rowptr, col, reorder='on', with_edge_maps=True,
                             device='cpu')
