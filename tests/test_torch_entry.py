"""The port's multi-chip dry run (``entry.dryrun_multichip``) and its
distributed examples on gloo ranks on the CPU, against the JAX package.

``run_dryrun_multichip(8)`` runs the dry run in 8 ranks, each checking
its own steps; its two aggregations on ``cycle_graph(64)`` must equal the
JAX package's ``halo_exchange_aggregate`` and ``ring_halo_aggregate`` on
the 8-device virtual mesh of ``tests/conftest.py`` for the same features
(f32, rtol 1e-5, atol 1e-5). The examples run at a small size and must
learn their graph.
"""

import numpy as np

from pyg_lib_tpu_torch.entry import run_dryrun_multichip
from pyg_lib_tpu_torch.examples import (train_dist_fullgraph,
                                        train_dist_sampled)


def test_dryrun_multichip_8_ranks_matches_jax():
    import jax
    import jax.numpy as jnp

    from pyg_lib_tpu import parallel as jpar
    from pyg_lib_tpu import partition as jpart
    from pyg_lib_tpu.testing import cycle_graph

    ranks = run_dryrun_multichip(8, 'gloo', device='cpu')
    assert len(ranks) == 8
    line = ranks[0]['line']
    assert line.startswith('dryrun_multichip(8): train step loss=')
    assert 'verified on 64 nodes' in line
    # The ranks run one program: the same losses everywhere.
    assert len({(r['loss'], r['dist_loss']) for r in ranks}) == 1
    assert all(np.isfinite([r['loss'], r['dist_loss']]).all() for r in ranks)
    # ... and the same all-reduced, full-size gradients.
    for r in ranks:
        for g, g0 in zip(r['grads'], ranks[0]['grads']):
            np.testing.assert_array_equal(g, g0)
    assert all(np.isfinite(g).all() for g in ranks[0]['grads'])

    rowptr, col = cycle_graph(64)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(64, 16)).astype(
        np.float32))
    mesh = jpar.make_mesh((8, ), ('data', ), devices=jax.devices()[:8])
    part = jpart.mesh_edge_partition(rowptr, col, 8)
    bpart = jpart.mesh_edge_partition_blocked(rowptr, col, 8)
    refs = {
        'halo': jpar.halo_exchange_aggregate(
            mesh, x, jnp.asarray(part.src_ids), jnp.asarray(part.rowptr)),
        'ring': jpar.ring_halo_aggregate(
            mesh, x, jnp.asarray(bpart.rowptr_blk),
            jnp.asarray(bpart.src_blk)),
    }
    for name, ref in refs.items():
        got = np.concatenate([r[name] for r in ranks])
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_dist_examples_learn_on_the_cpu():
    for aggregate in ('ring', 'halo'):
        out = train_dist_fullgraph.main(ranks=2, device='cpu', epochs=15,
                                        num_nodes=400, aggregate=aggregate,
                                        verbose=False)
        assert out['loss'] < 0.5 and out['acc'] > 0.8, (aggregate, out)
    out = train_dist_sampled.main(ranks=2, device='cpu', steps=12,
                                  num_nodes=400, verbose=False)
    assert out['losses'][-1] < out['losses'][0]
