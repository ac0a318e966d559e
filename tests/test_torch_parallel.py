"""The port's distribution layer (``pyg_lib_tpu_torch.parallel``) against
the JAX package's on the CPU.

The port runs gloo ranks (``parallel.spawn``: spawned processes, a
``file://`` rendezvous in a temporary directory); the JAX package runs on
the 8-device virtual mesh of ``tests/conftest.py``. Each spawn runs many
checks, and the rank bodies import only torch and the port (JAX is
imported inside the test functions, in the pytest process).

Tolerances (f32): the aggregations and their gradients with respect to
``x`` within rtol 1e-5, atol 1e-5; the train steps' loss, gradients and
parameters within 1e-5 (the gradients within 1e-5 of their largest);
``remat`` and ``param_spec`` against the plain replicated step within
1e-6; ``accum_steps`` against the big batch within rtol 1e-6 (the JAX
test's) for the loss and 1e-6 for the weights.
"""

import functools

import numpy as np
import pytest
import torch

from pyg_lib_tpu_torch import parallel, partition
from pyg_lib_tpu_torch.entry import example_batch
from pyg_lib_tpu_torch.models import sage_forward, sage_params_from_jax

TOL = 1e-5


def _graph(seed, n, e):
    rng = np.random.default_rng(seed)
    deg = rng.multinomial(e, np.ones(n) / n)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, n, size=e).astype(np.int64)
    return rowptr, col


def _halo_rank(rank, world, rowptr, col, x, cot):
    """Both aggregations' rows of this rank and their gradients with
    respect to its rows of ``x`` for the loss ``sum(out * cot)``."""
    mesh = parallel.make_mesh((world, ), ('data', ), device='cpu')
    part = partition.mesh_edge_partition(rowptr, col, world)
    bpart = partition.mesh_edge_partition_blocked(rowptr, col, world)
    npd = part.nodes_per_device
    mine = slice(rank * npd, (rank + 1) * npd)
    out = {}
    for name, fn, args in (
            ('halo', parallel.halo_exchange_aggregate,
             (part.src_ids[rank], part.rowptr[rank])),
            ('ring', parallel.ring_halo_aggregate,
             (bpart.rowptr_blk[rank], bpart.src_blk[rank]))):
        xr = torch.from_numpy(x[mine]).requires_grad_()
        agg = fn(mesh, xr, *(torch.from_numpy(a) for a in args))
        (agg * torch.from_numpy(cot[mine])).sum().backward()
        out[name] = agg.detach().numpy()
        out[name + '_grad'] = xr.grad.numpy()
    try:
        parallel.make_mesh((world - 1, ), ('data', ), device='cpu')
    except ValueError as e:
        out['mesh_error'] = str(e)
    if not torch.cuda.is_available():
        # The default device is the card, as for every entry point.
        try:
            parallel.make_mesh((world, ), ('data', ))
        except RuntimeError as e:
            out['default_device_error'] = str(e)
    return out


def test_halo_and_ring_match_jax_on_8_ranks():
    import jax
    import jax.numpy as jnp

    from pyg_lib_tpu import parallel as jpar
    from pyg_lib_tpu import partition as jpart

    d, n, e, f = 8, 61, 600, 16  # 61 nodes: 3 pad rows on the last rank
    rowptr, col = _graph(0, n, e)
    rng = np.random.default_rng(1)
    n_pad = -(-n // d) * d
    x = rng.normal(size=(n_pad, f)).astype(np.float32)
    cot = rng.normal(size=(n_pad, f)).astype(np.float32)
    ranks = parallel.spawn(_halo_rank, d, 'gloo', rowptr, col, x, cot)

    mesh = jpar.make_mesh((d, ), ('data', ), devices=jax.devices()[:d])
    part = jpart.mesh_edge_partition(rowptr, col, d)
    bpart = jpart.mesh_edge_partition_blocked(rowptr, col, d)
    refs = {
        'halo': lambda x: jpar.halo_exchange_aggregate(
            mesh, x, jnp.asarray(part.src_ids), jnp.asarray(part.rowptr)),
        'ring': lambda x: jpar.ring_halo_aggregate(
            mesh, x, jnp.asarray(bpart.rowptr_blk),
            jnp.asarray(bpart.src_blk)),
    }
    dense = np.zeros((n_pad, f), np.float32)
    np.add.at(dense, np.repeat(np.arange(n), np.diff(rowptr)), x[col])
    for name, fn in refs.items():
        ref = np.asarray(fn(jnp.asarray(x)))
        ref_grad = np.asarray(jax.grad(
            lambda x: jnp.sum(fn(x) * jnp.asarray(cot)))(jnp.asarray(x)))
        got = np.concatenate([r[name] for r in ranks])
        got_grad = np.concatenate([r[name + '_grad'] for r in ranks])
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, dense, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_grad, ref_grad, rtol=TOL, atol=TOL)
    # The gradient reaches every source: rows no edge reads get zero.
    assert np.abs(got_grad[:n]).sum() > 0 and not got_grad[n:].any()
    with pytest.raises(ValueError) as err:
        jpar.make_mesh((d - 1, ), ('data', ), devices=jax.devices()[:d])
    assert ranks[0]['mesh_error'] == str(err.value)
    if not torch.cuda.is_available():
        assert "device='cpu'" in ranks[0]['default_device_error']


def _masked_loss(params, batch):
    """The dry run's loss: a masked mean of the nodes' NLL, as (sum,
    count)."""
    total, count = 0.0, 0.0
    for g in range(batch['x'].shape[0]):
        logits = sage_forward(params, batch['x'][g], batch['rowptr'][g],
                              batch['row'][g])
        nll = torch.nn.functional.cross_entropy(
            logits, batch['label'][g].long(), reduction='none')
        mask = batch['node_mask'][g].to(nll.dtype)
        total = total + (nll * mask).sum()
        count = count + mask.sum()
    return total, count


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for layer in tree['layers']
                           for _, v in sorted(layer.items())])


def _flat_torch(mesh, params):
    params = parallel.train.full_params(mesh, params)
    return _flat({'layers': [{k: v.detach().numpy() for k, v in l.items()}
                             for l in params['layers']]})


def _train_rank(rank, world, tree, batch, lin):
    torch.manual_seed(0)
    adam = functools.partial(torch.optim.Adam, lr=1e-3)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}

    def run(mesh, spec=None, **kw):
        params = sage_params_from_jax(tree, device='cpu')
        step = parallel.make_train_step(_masked_loss, adam, mesh,
                                        batch_spec=('data', ),
                                        param_spec=spec, **kw)
        params, opt, loss = step(params, None, batch)
        return float(loss), _flat_torch(mesh, params), [
            g.numpy() for g in step.grads], params

    # The masked-mean step over 4 data ranks, one graph each.
    mesh = parallel.make_mesh((world, 1), device='cpu')
    out['loss'], out['params'], out['grads'], _ = run(mesh)
    out['remat'] = run(mesh, remat=True)[:3]
    # The same step with the 64-wide weights sharded over 'model' of a
    # 2 x 2 mesh, against the replicated step on that mesh.
    mesh2 = parallel.make_mesh((2, 2), device='cpu')
    spec = {'layers': [{'w_self': (None, 'model'), 'w_nbr': (None, 'model'),
                        'b': ('model', )},
                       {'w_self': ('model', None), 'w_nbr': ('model', None),
                        'b': None}]}
    out['replicated'] = run(mesh2)[:3]
    *out['sharded'], params = run(mesh2, spec)
    from torch.distributed.tensor import DTensor, Shard
    w = params['layers'][0]['w_self']
    out['sharded_placement'] = (isinstance(w, DTensor) and
                                tuple(w.to_local().shape) == (32, 32) and
                                isinstance(w.placements[1], Shard))

    # accum_steps=2 over microbatches against one step over the batch
    # (a linear model, mean squared error: a scalar loss).
    x, y, w0 = (torch.from_numpy(a) for a in lin)
    sgd = functools.partial(torch.optim.SGD, lr=0.1)

    def mse(params, batch):
        bx, by = batch
        return ((bx @ params['w'] - by)**2).mean()

    big = parallel.make_train_step(mse, sgd, mesh, batch_spec=('data', ))
    acc = parallel.make_train_step(mse, sgd, mesh, batch_spec=(None, 'data'),
                                   accum_steps=2, remat=True, donate=True)
    p1, _, l1 = big({'w': w0.clone()}, None, (x, y))
    p2, _, l2 = acc({'w': w0.clone()}, None,
                    (x.reshape(2, 16, -1), y.reshape(2, 16, -1)))
    out['accum'] = (float(l1), float(l2), p1['w'].numpy(), p2['w'].numpy())
    try:
        acc({'w': w0.clone()}, None, (x.reshape(4, 8, -1),
                                      y.reshape(4, 8, -1)))
    except ValueError as e:
        out['accum_error'] = str(e)
    return out


def test_train_steps_match_jax_on_4_ranks():
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from pyg_lib_tpu.models import gnn as jgnn
    from pyg_lib_tpu.parallel import make_train_step as jstep

    tree = jgnn.init_sage(jax.random.PRNGKey(0), [32, 64, 7])
    tree = {'layers': [{k: np.asarray(v, np.float32) for k, v in l.items()}
                       for l in tree['layers']]}
    batch = {k: v.numpy() for k, v in example_batch(
        num_graphs=4, device='cpu').items()}
    counts = batch['node_mask'].sum(axis=1)
    assert len(set(counts.tolist())) > 1, counts  # the means differ
    rng = np.random.default_rng(0)
    lin = (rng.normal(size=(32, 16)).astype(np.float32),
           rng.normal(size=(32, 4)).astype(np.float32),
           rng.normal(size=(16, 4)).astype(np.float32))
    ranks = parallel.spawn(_train_rank, 4, 'gloo', tree, batch, lin)

    def loss_fn(params, batch):
        logits = jax.vmap(lambda x, rp, rw: jgnn.sage_forward(
            params, x, rp, rw))(batch['x'], batch['rowptr'], batch['row'])
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, batch['label'][..., None],
                                   axis=-1)[..., 0]
        mask = batch['node_mask']
        return (nll * mask).sum() / jnp.maximum(mask.sum(), 1)

    mesh = Mesh(np.array(jax.devices()[:4]), ('data', ))
    jparams = jax.tree.map(jnp.asarray, tree)
    jbatch = jax.tree.map(jnp.asarray, batch)
    opt = optax.adam(1e-3)
    p_ref, _, l_ref = jstep(loss_fn, opt, mesh, batch_spec=P('data'))(
        jparams, opt.init(jparams), jbatch)
    g_ref = jax.grad(loss_fn)(jparams, jbatch)
    g_ref = [np.asarray(layer[k]) for layer in g_ref['layers']
             for k in ('w_self', 'w_nbr', 'b')]
    for r in ranks:
        assert abs(r['loss'] - float(l_ref)) <= TOL
        np.testing.assert_allclose(r['params'], _flat(p_ref), rtol=0,
                                   atol=TOL)
        for g, ref in zip(r['grads'], g_ref):
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=TOL * np.abs(ref).max())
        # Every rank holds the same parameters and loss, bit for bit.
        assert np.array_equal(r['params'], ranks[0]['params'])
        for other in ('remat', 'sharded'):
            base = 'loss', 'params', 'grads'
            got = dict(zip(base, r[other]))
            ref = (dict(zip(base, (r['loss'], r['params'], r['grads'])))
                   if other == 'remat' else dict(zip(base, r['replicated'])))
            assert abs(got['loss'] - ref['loss']) <= 1e-6
            np.testing.assert_allclose(got['params'], ref['params'], rtol=0,
                                       atol=1e-6)
            for a, b in zip(got['grads'], ref['grads']):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert r['sharded_placement']

    # accum_steps against the big batch, and against JAX's big step.
    x, y, w0 = lin

    def mse(params, batch):
        bx, by = batch
        return jnp.mean((bx @ params['w'] - by)**2)

    sgd = optax.sgd(0.1)
    jw = {'w': jnp.asarray(w0)}
    p_big, _, l_big = jstep(mse, sgd, mesh, batch_spec=P('data'))(
        jw, sgd.init(jw), (jnp.asarray(x), jnp.asarray(y)))
    for r in ranks:
        l1, l2, w1, w2 = r['accum']
        assert abs(l1 - l2) <= 1e-6 * abs(l1)  # JAX's test: rtol 1e-6
        assert abs(l1 - float(l_big)) <= TOL * abs(l1)
        np.testing.assert_allclose(w2, w1, rtol=0, atol=1e-6)
        np.testing.assert_allclose(w1, np.asarray(p_big['w']), rtol=0,
                                   atol=TOL)
        assert 'accum_steps=2' in r['accum_error']
    with pytest.raises(ValueError, match='accum_steps'):
        parallel.make_train_step(mse, sgd, None, accum_steps=0)


def test_port_parallel_and_sampler_cover_the_jax_package():
    from pyg_lib_tpu import parallel as jparallel
    from pyg_lib_tpu import sampler as jsampler
    from pyg_lib_tpu.sampler import dist_service as jds

    from pyg_lib_tpu_torch import sampler
    from pyg_lib_tpu_torch.sampler import dist_service

    assert set(jparallel.__all__) <= set(parallel.__all__)
    assert set(jsampler.__all__) <= set(sampler.__all__)
    assert set(jds.__all__) <= set(dist_service.__all__)


def _failing_rank(rank, world, how):
    """Rank 1 fails (raises, or exits without a word); the others wait in
    a collective that can never complete."""
    import os

    import torch.distributed as dist

    if rank == 1:
        if how == 'raise':
            raise ValueError('rank 1 gives up')
        os._exit(3)
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)


@pytest.mark.parametrize('how', ['raise', 'exit'])
def test_spawn_raises_for_a_failing_rank_without_hanging(how):
    import time

    t0 = time.monotonic()
    with pytest.raises(parallel.launch.RankError) as err:
        parallel.spawn(_failing_rank, 3, 'gloo', how, timeout=120)
    assert time.monotonic() - t0 < 60
    if how == 'raise':  # the first failure's traceback, not the others'
        assert 'rank 1 of 3 failed' in str(err.value)
        assert 'ValueError: rank 1 gives up' in str(err.value)
    with pytest.raises(ValueError, match='world_size'):
        parallel.spawn(_failing_rank, 0)
