"""The port's distributed sampling (``sampler.dist``, ``dist_service``,
``transport``, ``serve``, ``loader.DistNeighborLoader``) against the JAX
package's on the CPU: one counterpart of each test of
``test_dist_service.py`` and ``test_serve_tcp.py``.

The protocol functions, both coordinators and the loader's batches must
equal the JAX package's bit for bit (the same seeds; both packages'
C++ engines). ``collective_feature_fetch`` runs on 8 gloo ranks
(``parallel.spawn``) against JAX's on the 8-device virtual mesh, within
f32 rtol 1e-6 (a sum of one row and zeros: exact in practice). The rank
bodies import only torch and the port; JAX is imported inside the tests.
"""

import os
import secrets
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pyg_lib_tpu_torch import parallel, sampler
from pyg_lib_tpu_torch.loader import DistNeighborLoader
from pyg_lib_tpu_torch.sampler.dist import (dist_neighbor_sample,
                                            hetero_relabel_neighborhood,
                                            merge_sampler_outputs,
                                            relabel_neighborhood)
from pyg_lib_tpu_torch.sampler.dist_service import (
    DistNeighborSampler, HeteroDistNeighborSampler, collective_feature_fetch,
    hetero_collective_feature_fetch, partition_graph, partition_hetero_graph)
from pyg_lib_tpu_torch.sampler.serve import load_partition_payload
from pyg_lib_tpu_torch.sampler.transport import (SamplingService,
                                                 serve_partition)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def jax_engine_loaded():
    # The JAX package samples with numpy where its engine is not loaded;
    # the port always uses its engine. Load the JAX engine first.
    from pyg_lib_tpu.sampler import _cpp as jcpp
    assert jcpp.get_lib() is not None


def equal(a, b) -> bool:
    """Equal to the bit, through tuples, lists and dicts (arrays also in
    shape and dtype kind)."""
    if isinstance(a, (tuple, list)):
        return (type(b) in (tuple, list) and len(a) == len(b)
                and all(equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype.kind == b.dtype.kind
            and np.array_equal(a, b))


def _random_csr(rng, n, max_deg):
    deg = rng.integers(0, max_deg + 1, size=n)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, n, size=int(rowptr[-1]))
    return rowptr, col.astype(np.int64)


def _hetero(seed):
    rng = np.random.default_rng(seed)
    num_nodes = {'u': 40, 'v': 30}
    rels = [('u', 'r1', 'v'), ('v', 'r2', 'u')]
    rowptr_d, col_d = {}, {}
    for (s, r, d) in rels:  # src-major CSRs (library convention)
        deg = rng.integers(0, 4, size=num_nodes[s])
        rp = np.zeros(num_nodes[s] + 1, np.int64)
        rp[1:] = np.cumsum(deg)
        rowptr_d[(s, r, d)] = rp
        col_d[(s, r, d)] = rng.integers(0, num_nodes[d], size=int(rp[-1]))
    return num_nodes, rels, rowptr_d, col_d


def test_partition_book_owner_roundtrip():
    from pyg_lib_tpu.sampler import dist_service as jds

    rng = np.random.default_rng(0)
    rowptr, col = _random_csr(rng, 100, 5)
    g = partition_graph(rowptr, col, 4)
    ref = jds.partition_graph(rowptr, col, 4)
    assert equal(tuple(g.book), tuple(ref.book)) and g.num_nodes == 100
    assert equal(g.rowptr_parts, ref.rowptr_parts)
    assert equal(g.col_parts, ref.col_parts)
    ids = rng.integers(0, 100, size=50)
    assert equal(g.book.owner(ids), ref.book.owner(ids))
    for v, p in zip(ids, g.book.owner(ids)):
        assert g.book.bounds[p] <= v < g.book.bounds[p + 1]
    np.testing.assert_array_equal(np.concatenate(g.col_parts), col)


@pytest.mark.parametrize('impl', ['cpp', 'numpy'])
def test_protocol_functions_equal_the_jax_package(impl):
    """One hop of each partition, the merge and the relabel, as
    ``DistNeighborSampler`` calls them, against the JAX functions."""
    from pyg_lib_tpu.sampler import dist as jdist

    rng = np.random.default_rng(3)
    rowptr, col = _random_csr(rng, 120, 9)
    g = partition_graph(rowptr, col, 3)
    seeds = rng.choice(120, size=20, replace=False).astype(np.int64)
    owner = g.book.owner(seeds)
    orders = np.zeros(len(seeds), np.int64)
    outs, refs = [], []
    for p in range(3):
        mask = owner == p
        orders[mask] = np.arange(int(mask.sum()))
        local = seeds[mask] - g.book.bounds[p]
        kw = dict(replace=p == 1, rng=11 + p, impl=impl)
        outs.append(dist_neighbor_sample(g.rowptr_parts[p], g.col_parts[p],
                                         local, 4, **kw))
        refs.append(jdist.dist_neighbor_sample(
            g.rowptr_parts[p], g.col_parts[p], local, 4, **kw))
        assert equal(outs[-1], refs[-1])
    args = ([o[0] for o in outs], [o[1] for o in outs],
            [o[2] for o in outs], owner, orders, 3, 4)
    merged = merge_sampler_outputs(*args)
    assert equal(merged, jdist.merge_sampler_outputs(*args))
    batch = np.arange(len(seeds))
    assert equal(merge_sampler_outputs(*args, batch=batch, disjoint=True),
                 jdist.merge_sampler_outputs(*args, batch=batch,
                                             disjoint=True))
    for csc in (False, True):
        got = relabel_neighborhood(seeds, merged[0], merged[3], 120,
                                   csc=csc)
        assert equal(got, jdist.relabel_neighborhood(
            seeds, merged[0], merged[3], 120, csc=csc))
    with pytest.raises(ValueError, match='Batch'):
        relabel_neighborhood(seeds, merged[0], merged[3], 120,
                             disjoint=True)


def test_dist_sampler_full_fanout_matches_local_sampler():
    from pyg_lib_tpu.sampler import dist_service as jds

    rng = np.random.default_rng(1)
    rowptr, col = _random_csr(rng, 60, 4)
    g = partition_graph(rowptr, col, 3)
    seeds = np.array([5, 41, 17], np.int64)
    row, col_out, node_id, nph = DistNeighborSampler(g, rng=7).sample(
        seeds, [-1, -1])
    ref = sampler.neighbor_sample(rowptr, col, seeds, [-1, -1], rng=7)
    assert equal((row, col_out, node_id), ref[:3]) and nph == list(ref[4])
    jref = jds.DistNeighborSampler(jds.partition_graph(rowptr, col, 3),
                                   rng=7).sample(seeds, [-1, -1])
    assert equal((row, col_out, node_id, nph), jref)


@pytest.mark.parametrize('replace', [False, True])
def test_dist_sampler_finite_fanout_equals_the_jax_package(replace):
    from pyg_lib_tpu.sampler import dist_service as jds

    rng = np.random.default_rng(2)
    rowptr, col = _random_csr(rng, 200, 8)
    g = partition_graph(rowptr, col, 4)
    jg = jds.partition_graph(rowptr, col, 4)
    seeds = np.array([0, 100, 150], np.int64)
    ds = DistNeighborSampler(g, rng=3, replace=replace)
    jds_ = jds.DistNeighborSampler(jg, rng=3, replace=replace)
    for hops in ([3, 2], [2, 2, 1]):  # the coordinator's step advances
        got, ref = ds.sample(seeds, hops), jds_.sample(seeds, hops)
        assert equal(got, ref)
    row, col_out, node_id, nph = got
    assert nph[0] == 3 and len(row) == len(col_out)
    assert (np.asarray(col_out) < len(node_id)).all()
    for r, c in zip(row, col_out):
        assert node_id[c] in col[rowptr[node_id[r]]:rowptr[node_id[r] + 1]]


def test_hetero_dist_sampler_full_fanout_matches_local():
    from pyg_lib_tpu.sampler import dist_service as jds

    num_nodes, rels, rowptr_d, col_d = _hetero(5)
    seeds = {'v': np.array([3, 17], np.int64)}
    for nn in ({k: [-1, -1] for k in rels}, {k: [2, 1] for k in rels}):
        got = HeteroDistNeighborSampler(partition_hetero_graph(
            rowptr_d, col_d, num_nodes, 3), rng=2).sample(seeds, nn)
        ref = jds.HeteroDistNeighborSampler(jds.partition_hetero_graph(
            rowptr_d, col_d, num_nodes, 3), rng=2).sample(seeds, nn)
        assert equal(got, ref)
    full = {k: [-1, -1] for k in rels}
    row_d, col_out_d, node_id = HeteroDistNeighborSampler(
        partition_hetero_graph(rowptr_d, col_d, num_nodes, 3),
        rng=2).sample(seeds, full)
    local = sampler.hetero_neighbor_sample(rowptr_d, col_d, seeds, full)
    assert equal((row_d, col_out_d, node_id), local[:3])


def test_dist_sampler_duplicate_frontier_rows():
    # 0 -> 5, 5 -> 7 on 8 nodes.
    rowptr = np.array([0, 1, 1, 1, 1, 1, 2, 2, 2], np.int64)
    col = np.array([5, 7], np.int64)
    s = DistNeighborSampler(partition_graph(rowptr, col, 2), rng=0,
                            replace=True)
    row, c, node_id, per_hop = s.sample(np.array([0], np.int64), [2, 1])
    np.testing.assert_array_equal(node_id, [0, 5, 7])
    np.testing.assert_array_equal(row, [0, 0, 1])
    np.testing.assert_array_equal(c, [1, 1, 2])
    assert per_hop == [1, 1, 1]


def test_hetero_relabel_shared_dst_cursor():
    from pyg_lib_tpu.sampler import dist as jdist

    node_types = ['A', 'B', 'T']
    edge_types = [('A', 'r1', 'T'), ('B', 'r2', 'T')]
    seed = {'A': np.array([0]), 'B': np.array([0]),
            'T': np.zeros(0, np.int64)}
    sampled = {'A': np.zeros(0, np.int64), 'B': np.zeros(0, np.int64),
               'T': np.array([3, 4, 7, 8], np.int64)}
    counts = {('A', 'r1', 'T'): [[2]], ('B', 'r2', 'T'): [[2]]}
    args = (node_types, edge_types, seed, sampled, counts,
            {'A': 1, 'B': 1, 'T': 10})
    rows, cols = hetero_relabel_neighborhood(*args)
    assert equal((rows, cols), jdist.hetero_relabel_neighborhood(*args))
    np.testing.assert_array_equal(cols[('A', 'r1', 'T')], [0, 1])
    np.testing.assert_array_equal(cols[('B', 'r2', 'T')], [2, 3])


def test_hetero_dist_sampler_shared_dst_type():
    rowptr_d = {('A', 'r1', 'T'): np.array([0, 2], np.int64),
                ('B', 'r2', 'T'): np.array([0, 2], np.int64)}
    col_d = {('A', 'r1', 'T'): np.array([3, 4], np.int64),
             ('B', 'r2', 'T'): np.array([7, 8], np.int64)}
    g = partition_hetero_graph(rowptr_d, col_d, {'A': 1, 'B': 1, 'T': 10},
                               1)
    rows, cols, node_id = HeteroDistNeighborSampler(g, rng=0).sample(
        {'A': np.array([0]), 'B': np.array([0])},
        {('A', 'r1', 'T'): [2], ('B', 'r2', 'T'): [2]})
    np.testing.assert_array_equal(np.sort(node_id['T']), [3, 4, 7, 8])
    np.testing.assert_array_equal(
        np.sort(node_id['T'][cols[('A', 'r1', 'T')]]), [3, 4])
    np.testing.assert_array_equal(
        np.sort(node_id['T'][cols[('B', 'r2', 'T')]]), [7, 8])


def test_dist_sampler_full_fanout_fuzz_matches_local():
    from pyg_lib_tpu.sampler import dist_service as jds

    for trial in range(5):
        rng = np.random.default_rng(100 + trial)
        n = int(rng.integers(40, 200))
        e = int(rng.integers(n, 6 * n))
        rowptr, col = _random_csr(rng, n, e)
        parts = int(rng.integers(2, 5))
        seeds = np.unique(rng.integers(0, n, size=4)).astype(np.int64)
        hops = [[-1, -1], [-1, -1, -1]][trial % 2]
        got = DistNeighborSampler(partition_graph(rowptr, col, parts),
                                  rng=7).sample(seeds, hops)
        ref = sampler.neighbor_sample(rowptr, col, seeds, hops, rng=7)
        msg = f'trial {trial}: n={n} e={e} parts={parts}'
        assert equal(got[:3], ref[:3]) and got[3] == list(ref[4]), msg
        assert equal(got, jds.DistNeighborSampler(
            jds.partition_graph(rowptr, col, parts), rng=7).sample(
                seeds, hops)), msg


def _fetch_rank(rank, world, x, ids, xs, hids):
    mesh = parallel.make_mesh((world, ), ('data', ), device='cpu')
    n_local = x.shape[0] // world
    mine = slice(rank * n_local, (rank + 1) * n_local)
    out = collective_feature_fetch(mesh, torch.from_numpy(x[mine]),
                                   torch.from_numpy(ids))
    shards = {t: torch.from_numpy(v[rank * (len(v) // world):
                                    (rank + 1) * (len(v) // world)])
              for t, v in xs.items()}
    hout = hetero_collective_feature_fetch(
        mesh, shards, {t: torch.from_numpy(v) for t, v in hids.items()})
    return out.numpy(), {t: v.numpy() for t, v in hout.items()}


def test_collective_feature_fetch_8_ranks():
    import jax
    import jax.numpy as jnp

    from pyg_lib_tpu.parallel import make_mesh as jmesh
    from pyg_lib_tpu.sampler import dist_service as jds

    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 16)).astype(np.float32)  # 8 rows a rank
    ids = rng.integers(0, 64, size=24).astype(np.int32)
    xs = {'a': rng.normal(size=(64, 8)).astype(np.float32),
          'b': rng.normal(size=(32, 8)).astype(np.float32)}
    hids = {'a': rng.integers(0, 64, size=16).astype(np.int32),
            'b': rng.integers(0, 32, size=8).astype(np.int32)}
    ranks = parallel.spawn(_fetch_rank, 8, 'gloo', x, ids, xs, hids)
    mesh = jmesh((8, ), ('data', ), devices=jax.devices()[:8])
    ref = np.asarray(jds.collective_feature_fetch(
        mesh, jnp.asarray(x), jnp.asarray(ids), axis='data'))
    href = jds.hetero_collective_feature_fetch(
        mesh, {t: jnp.asarray(v) for t, v in xs.items()},
        {t: jnp.asarray(v) for t, v in hids.items()})
    for out, hout in ranks:
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        np.testing.assert_allclose(out, x[ids], rtol=1e-6)
        for t in hids:
            np.testing.assert_allclose(hout[t], np.asarray(href[t]),
                                       rtol=1e-6)
            np.testing.assert_allclose(hout[t], xs[t][hids[t]], rtol=1e-6)


def test_dist_neighbor_loader_equals_the_jax_package():
    from pyg_lib_tpu import loader as jloader
    from pyg_lib_tpu.sampler import dist_service as jds

    rng = np.random.default_rng(8)
    rowptr, col = _random_csr(rng, 300, 12)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = rng.integers(0, 4, 300)
    seeds = np.arange(0, 300, 4)
    for kw in (dict(), dict(max_nodes=120, max_edges=150, replace=True)):
        kw = dict(batch_size=16, num_neighbors=[4, 2], rng=13,
                  drop_last=False, **kw)
        got = DistNeighborLoader(partition_graph(rowptr, col, 3), x, y,
                                 seeds, device='cpu', **kw)
        ref = jloader.DistNeighborLoader(jds.partition_graph(rowptr, col, 3),
                                         x, y, seeds, **kw)
        assert got.buckets == ref.buckets and len(got) == len(ref) == 5
        for _ in range(2):  # two epochs
            for a, b in zip(list(got), list(ref)):
                assert a.keys() == b.keys()
                for k in b:
                    assert equal(torch.as_tensor(a[k]).numpy(),
                                 np.asarray(b[k])), k
        assert got.bucket_counts == ref.bucket_counts
        assert all(t['sample_ms'] >= 0 for t in got.timings)
    with pytest.raises(TypeError, match='DistGraph'):
        DistNeighborLoader((rowptr, col), x, y, seeds, 16, [2],
                           device='cpu')


# ------------------------------------------------- process transport -------


def _graph(seed, n, e):
    rng = np.random.default_rng(seed)
    deg = rng.multinomial(e, np.ones(n) / n)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    return rowptr, rng.integers(0, n, size=e).astype(np.int64), rng


def test_sampling_service_matches_inprocess_and_survives_errors():
    """Transported runs equal in-process ones bit for bit; a failed
    request is reported, and the servers keep serving with every
    partition's replies drained."""
    from pyg_lib_tpu.sampler import dist_service as jds

    rowptr, col, rng = _graph(3, 200, 1600)
    graph = partition_graph(rowptr, col, 3)
    seeds = rng.choice(200, size=32, replace=False).astype(np.int64)
    local = DistNeighborSampler(graph, rng=5)
    ref = local.sample(seeds, [4, 3])
    assert equal(ref, jds.DistNeighborSampler(
        jds.partition_graph(rowptr, col, 3), rng=5).sample(seeds, [4, 3]))
    good = ('sample', np.array([0], np.int64), 1, 7, False, 'auto')
    with SamplingService.spawn(graph) as svc:
        remote = DistNeighborSampler(graph, rng=5, service=svc)
        assert equal(remote.sample(seeds, [4, 3]), ref)
        # the second batch advances the coordinator's step identically
        assert equal(remote.sample(seeds[:8], [2]),
                     local.sample(seeds[:8], [2]))
        with pytest.raises(RuntimeError, match='partition 0 failed'):
            svc.scatter({0: ('bogus_op', ), 1: good})
        out = svc.scatter({0: good, 1: ('sample', np.array([0], np.int64),
                                        1, 9, False, 'auto')})
        assert out[0][0][0] == 0 and out[1][0][0] == 0
        assert len(out[0][2]) == 2


def test_sampling_service_hetero_matches_inprocess():
    rng = np.random.default_rng(4)
    n_a, n_b, e = 60, 90, 700
    deg = rng.multinomial(e, np.ones(n_a) / n_a)
    rowptr = np.zeros(n_a + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, n_b, size=e).astype(np.int64)
    k = ('a', 'to', 'b')
    graph = partition_hetero_graph({k: rowptr}, {k: col},
                                   {'a': n_a, 'b': n_b}, 2)
    seeds = {'a': rng.choice(n_a, size=10, replace=False).astype(np.int64)}
    ref = HeteroDistNeighborSampler(graph, rng=1).sample(seeds, {k: [3, 2]})
    with SamplingService.spawn(graph) as svc:
        got = HeteroDistNeighborSampler(graph, rng=1, service=svc).sample(
            seeds, {k: [3, 2]})
    assert equal(got, ref)


def test_transport_requires_authkey_for_connect():
    with pytest.raises(ValueError, match='authkey'):
        SamplingService.connect([('127.0.0.1', 1)])
    with pytest.raises(ValueError, match='authkey'):
        serve_partition(('127.0.0.1', 1), {})


def test_load_partition_payload_roundtrip(tmp_path):
    rowptr = np.array([0, 2, 3], np.int64)
    col = np.array([1, 0, 1], np.int64)
    np.savez(tmp_path / 'homo.npz', rowptr=rowptr, col=col)
    p = load_partition_payload(str(tmp_path / 'homo.npz'))
    np.testing.assert_array_equal(p['rowptr'], rowptr)
    np.savez(tmp_path / 'het.npz', rowptr__a__to__b=rowptr, col__a__to__b=col)
    p = load_partition_payload(str(tmp_path / 'het.npz'))
    np.testing.assert_array_equal(p['hetero'][('a', 'to', 'b')][1], col)
    np.savez(tmp_path / 'bad.npz', junk=col)
    with pytest.raises(ValueError, match='no rowptr'):
        load_partition_payload(str(tmp_path / 'bad.npz'))


def test_serve_cli_tcp_matches_inprocess(tmp_path):
    from multiprocessing.connection import Client

    rowptr, col, rng = _graph(6, 150, 1200)
    graph = partition_graph(rowptr, col, 2)
    # A random key may begin and end with whitespace bytes: the servers
    # must take the file's bytes as they are (this one always does).
    key = b'\r' + secrets.token_bytes(30) + b'\n'
    keyfile = tmp_path / 'cluster.key'
    keyfile.write_bytes(key)
    procs, addrs = [], []
    for p in range(2):
        np.savez(tmp_path / f'part{p}.npz', rowptr=graph.rowptr_parts[p],
                 col=graph.col_parts[p])
        # Port 0: each server binds a port the system picks and prints
        # it, so no other process can take it between a pick and a bind.
        procs.append(subprocess.Popen([
            sys.executable, '-m', 'pyg_lib_tpu_torch.sampler.serve',
            '--partition', str(tmp_path / f'part{p}.npz'), '--host',
            '127.0.0.1', '--port', '0', '--authkey-file', str(keyfile)
        ], cwd=REPO, env=dict(os.environ), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        for pr in procs:
            # A server prints its port once it listens; one silent for 60 s
            # is killed, which ends its output.
            timer = threading.Timer(60, pr.kill)
            timer.start()
            out = []
            try:
                for line in pr.stdout:
                    out.append(line)
                    if line.startswith('serving on 127.0.0.1:'):
                        break
            finally:
                timer.cancel()
            if not out or not out[-1].startswith('serving on 127.0.0.1:'):
                pytest.fail(f'server did not come up: {"".join(out)}')
            addrs.append(('127.0.0.1', int(out[-1].rsplit(':', 1)[1])))
        svc = SamplingService.connect(addrs, authkey=key)
        svc.disconnect()  # servers loop back to accept
        with pytest.raises(Exception):
            Client(addrs[0], authkey=b'not-the-cluster-key!')
        svc = SamplingService.connect(addrs, authkey=key)
        seeds = rng.choice(150, size=16, replace=False).astype(np.int64)
        ref = DistNeighborSampler(graph, rng=9).sample(seeds, [3, 2])
        got = DistNeighborSampler(graph, rng=9, service=svc).sample(
            seeds, [3, 2])
        assert equal(got, ref)
        svc.close()  # ('stop',): the servers exit cleanly
        for pr in procs:
            assert pr.wait(timeout=30) == 0
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
