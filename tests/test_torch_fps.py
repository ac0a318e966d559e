"""F1's planner (``_f1_plan`` in ``ops/kernels/fps.py``) on the CPU, and
the port's ``fps`` against the JAX package's on a cloud whose equal maxima
lie far apart.

The planner is pure Python: it picks F1's tier for a batch (S, one block
a cloud with its points in registers, at D = 3 only; C, a thread-block
cluster with its slices in shared memory; G, the cluster streaming its
slices), the cluster size, the threads, the points a tier-S thread
holds, and the dynamic shared memory a block. Its boundaries are checked here against
the rules they come from, the module's constants. The JAX comparison
uses ``fps``'s plain version, which F1 equals bit for bit on the card
(``tests/test_torch_cuda.py``): duplicates at ``i`` and ``i + 10,000`` of
20,000 points make every step's maxima come in pairs half a cloud apart,
in different blocks of a cluster on the card, and the lower index must
win as in ``_fps_one``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.ops.kernels import fps
from pyg_lib_tpu_torch.ops.kernels.fps import _batch_plan, _f1_plan


def _s_limit(d):
    """The most points tier S takes at ``d`` coordinates: a block's
    threads times the most register points a thread may hold, at the one
    D held in registers; none at any other D."""
    if d != fps.REG_D:
        return 0
    return fps.S_THREADS * max(k for k in fps.ITEMS
                               if k * (d + 1) <= fps.S_REGS)


def _ceil(a, b):
    return -(-a // b)


def _extra(d):
    """The shared floats of the runtime-D form (any D but REG_D): the
    winner's coordinates."""
    return 0 if d == fps.REG_D else 4 * d


def _fits(n, d, c):
    return 4 * (d + 1) * _ceil(n, c) + _extra(d) <= fps.SMEM_MAX


@pytest.mark.parametrize('d', [1, 3, 6])
def test_tier_s_ends_where_tier_c_starts(d):
    last = _s_limit(d)
    if d == fps.REG_D:
        assert last == fps.S_THREADS * 16
        assert _f1_plan(last, d) == ('S', 1, fps.S_THREADS, 16, 0)
    else:  # no tier S: the smallest cloud already takes a cluster
        assert last == 0
        assert _f1_plan(fps.S_THREADS * 16, d).tier == 'C'
    nxt = _f1_plan(last + 1, d)
    assert nxt == ('C', min(c for c in fps.CLUSTERS if _fits(last + 1, d, c)),
                   fps.C_THREADS, 0,
                   4 * (d + 1) * _ceil(last + 1, nxt.cluster) + _extra(d))


@pytest.mark.parametrize('n', [1, 255, 256, 257, 1024, 3000])
def test_tier_s_takes_the_fewest_items(n):
    plan = _f1_plan(n, 3)
    assert plan.tier == 'S' and plan.cluster == 1
    assert fps.S_THREADS * plan.items >= n
    assert plan.items == fps.ITEMS[0] or (
        fps.S_THREADS * fps.ITEMS[fps.ITEMS.index(plan.items) - 1] < n)


@pytest.mark.parametrize('d', [1, 3, 6, 12])
@pytest.mark.parametrize('n', [5000, 20000, 50000, 100000, 100003, 200000])
def test_tier_c_takes_the_smallest_cluster_that_fits(n, d):
    plan = _f1_plan(n, d)
    if n <= _s_limit(d):
        assert plan.tier == 'S'
        return
    fitting = [c for c in fps.CLUSTERS if _fits(n, d, c)]
    if not fitting:
        assert plan == ('G', 16, fps.G_THREADS, 0, _extra(d))
        return
    c = fitting[0]
    assert plan == ('C', c, fps.C_THREADS, 0,
                    4 * (d + 1) * _ceil(n, c) + _extra(d))


def test_the_first_cloud_of_tier_g():
    # At D = 3 a 16-block cluster holds 16 slices of SMEM_MAX / 16 B.
    last = 16 * (fps.SMEM_MAX // 16)
    plan = _f1_plan(last, 3)
    assert plan.tier == 'C' and plan.cluster == 16
    assert plan.smem_bytes <= fps.SMEM_MAX
    plan = _f1_plan(last + 1, 3)
    assert plan == ('G', 16, fps.G_THREADS, 0, 0)
    assert _f1_plan(1_000_000, 3).tier == 'G'


def test_shared_memory_never_exceeds_a_block():
    for d in range(1, 17):
        for n in np.unique(np.geomspace(1, 3e6, 400).astype(np.int64)):
            plan = _f1_plan(int(n), d)
            assert 0 <= plan.smem_bytes <= fps.SMEM_BLOCK == 232_448
            assert plan.tier in ('S', 'C', 'G')
            assert (plan.cluster == 1) == (plan.tier == 'S')
            assert (plan.items > 0) == (plan.tier == 'S')
            assert plan.tier != 'S' or d == fps.REG_D


def test_a_batch_takes_its_largest_clouds_plan():
    clouds = np.array([[0, 1, 1, 0], [1, 1024, 512, 3],
                       [1025, 100000, 10000, 0], [101025, 10, 5, 0]])
    assert _batch_plan(clouds, 3) == _f1_plan(100000, 3)
    assert _batch_plan(clouds[:2], 3) == _f1_plan(1024, 3)
    assert _batch_plan(clouds[:2], 3).tier == 'S'


def test_a_cluster_the_card_cannot_hold_raises(monkeypatch):
    # The occupancy answer is asked once per plan and kept; 0 raises.
    plan = _f1_plan(100000, 3)
    monkeypatch.setitem(fps._active, (0, 3, plan), 0)
    with pytest.raises(RuntimeError, match='holds no cluster'):
        fps.active_clusters(plan, 3, torch.device('cuda', 0))
    monkeypatch.setitem(fps._active, (0, 3, plan), 7)
    assert fps.active_clusters(plan, 3, torch.device('cuda', 0)) == 7


@pytest.mark.parametrize('random_start', [True, False])
def test_fps_equal_maxima_far_apart_matches_jax(random_start):
    pts = np.random.default_rng(9).normal(size=(10000, 3)).astype(
        np.float32)
    pts = np.concatenate([pts, pts])
    ptr = np.array([0, 20000])
    ref = jops.fps(jnp.asarray(pts), jnp.asarray(ptr), 0.01, random_start,
                   7)
    got = ops.fps(torch.from_numpy(pts), torch.from_numpy(ptr), 0.01,
                  random_start, 7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # Every pick after the first lies in the first copy: the lower index
    # wins each tie between twins.
    picks = got.numpy()
    assert len(set(picks.tolist())) == picks.shape[0]
    assert (picks[1:] < 10000).all()
