"""The port's point-cloud and clustering ops against the JAX package's on
the CPU: ``fps`` (the plain version of kernel F1), ``knn``, ``radius``,
``nearest``, ``grid_cluster``, ``graclus_cluster`` and ``edge_sample``.

Inputs come from ``np.random.default_rng``. Every result is an index set,
so it must equal the JAX package's exactly: the same picks, neighbours and
order (F1's plain version sums each squared distance left to right as
XLA's reduction does; the distances are f32 in both, the JAX dot at
HIGHEST precision, and the inputs keep every neighbour's distance far
from the k-th one or the radius, except duplicate points, whose equal
distances both order by index). ``graclus_cluster`` and ``edge_sample``
draw from the same numpy generator in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import ops


def _pts(seed, n, d=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _same(got, ref, dtype=torch.int64):
    assert got.dtype == dtype
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _both(name, arrays, *args, **kwargs):
    """The op of ``name`` on JAX arrays and on tensors of ``arrays`` (None
    stays None)."""
    ref = getattr(jops, name)(*[None if a is None else jnp.asarray(a)
                                for a in arrays], *args, **kwargs)
    got = getattr(ops, name)(*[None if a is None else torch.from_numpy(
        np.asarray(a)) for a in arrays], *args, **kwargs)
    return got, ref


@pytest.mark.parametrize('case', ['line', 'batched', 'empty clouds',
                                  'tiny clouds', 'duplicates', 'ratio 1',
                                  'D=5'])
@pytest.mark.parametrize('random_start', [True, False])
def test_fps_matches_jax(case, random_start):
    ptr, ratio = None, 0.5
    if case == 'line':
        pts, ratio = np.arange(10, dtype=np.float32)[:, None], 0.3
    elif case == 'batched':
        pts, ptr = _pts(0, 300), np.array([0, 100, 300])
    elif case == 'empty clouds':
        pts, ptr = _pts(1, 90), np.array([0, 0, 40, 40, 90, 90])
    elif case == 'tiny clouds':
        pts, ptr = _pts(2, 4), np.array([0, 1, 3, 4])
    elif case == 'duplicates':
        pts = np.repeat(_pts(3, 60), 3, axis=0)
        ptr, ratio = np.array([0, 90, 180]), 0.8
    elif case == 'ratio 1':
        pts, ptr, ratio = _pts(4, 200), np.array([0, 77, 200]), 1.0
    else:
        pts, ptr = _pts(5, 150, 5), np.array([0, 150])
    got, ref = _both('fps', [pts, ptr], ratio, random_start, 7)
    _same(got, ref, torch.int32)


def test_fps_line_points():
    pts = torch.arange(10, dtype=torch.float32)[:, None]
    idx = ops.fps(pts, None, ratio=0.3, random_start=False)
    assert idx.tolist() == [0, 9, 4]
    assert ops.fps(pts[:0], None).shape == (0, )


def test_fps_kernel_on_the_cpu_is_its_plain_version():
    pts = torch.from_numpy(_pts(6, 500))
    clouds = np.array([[0, 200, 100, 5], [200, 300, 30, 0]])
    before = ops.fps_kernel.launches
    got = ops.fps_kernel(pts, clouds)
    assert ops.fps_kernel.launches == before
    assert torch.equal(got, ops.fps_plain(pts, clouds))
    assert got.dtype == torch.int32 and got.shape == (130, )
    assert got[0] == 5 and got[100] == 200


@pytest.mark.parametrize('cosine', [False, True])
@pytest.mark.parametrize('k', [1, 3, 30])
def test_knn_matches_jax(cosine, k):
    x, y = _pts(7, 60, 4), _pts(8, 25, 4)
    if cosine:
        x[0] = 0.0  # a zero-norm row: similarity 0, never NaN
        y[1] = 0.0
    ptr_x, ptr_y = np.array([0, 10, 10, 60]), np.array([0, 5, 9, 25])
    for ptrs in ([None, None], [ptr_x, ptr_y]):
        ref = jops.knn(jnp.asarray(x), jnp.asarray(y), k,
                       *[None if p is None else jnp.asarray(p) for p in ptrs],
                       cosine=cosine)
        got = ops.knn(torch.from_numpy(x), torch.from_numpy(y), k,
                      *[None if p is None else torch.from_numpy(p)
                        for p in ptrs], cosine=cosine)
        _same(got, ref)
        assert not np.isnan(got.numpy()).any()


def test_knn_duplicates_keep_the_lower_index_first():
    x = np.repeat(_pts(9, 20), 4, axis=0)
    got, ref = _both('knn', [x, x], 6)
    _same(got, ref)
    # a point's 3 copies and itself: the 4 lowest indices of its group
    first = got[1].reshape(80, 6)[:, :4]
    np.testing.assert_array_equal(
        first.numpy(), np.repeat(np.arange(20) * 4, 4)[:, None] + np.arange(4))


def test_knn_errors():
    x = torch.from_numpy(_pts(10, 5))
    with pytest.raises(ValueError, match='k >= 1'):
        ops.knn(x, x, 0)
    with pytest.raises(ValueError, match='batch count'):
        ops.knn(x, x, 1, torch.tensor([0, 2, 5]), torch.tensor([0, 5]))
    assert ops.knn(x[:0], x, 2).shape == (2, 0)


@pytest.mark.parametrize('ignore_same_index', [False, True])
@pytest.mark.parametrize('cap', [3, 100])
def test_radius_matches_jax(ignore_same_index, cap):
    x = _pts(11, 80, 2)
    ptr = np.array([0, 30, 30, 80])
    for y, ptr_y in ((x, ptr), (_pts(12, 20, 2), np.array([0, 8, 12, 20]))):
        got = ops.radius(torch.from_numpy(x), torch.from_numpy(y), 0.7,
                         torch.from_numpy(ptr), torch.from_numpy(ptr_y), cap,
                         ignore_same_index=ignore_same_index)
        ref = jops.radius(jnp.asarray(x), jnp.asarray(y), 0.7,
                          jnp.asarray(ptr), jnp.asarray(ptr_y), cap,
                          ignore_same_index=ignore_same_index)
        _same(got, ref)


def test_radius_cap_duplicates_and_blocks(monkeypatch):
    x = np.zeros((10, 2), np.float32)
    got, ref = _both('radius', [x, x[:1]], 1.0, max_num_neighbors=4)
    _same(got, ref)
    assert got[1].tolist() == [0, 1, 2, 3]  # the cap keeps the first by index
    # Query blocks of a few rows give the same pairs as one block.
    geo = __import__('sys').modules['pyg_lib_tpu_torch.ops.geometry']
    x = _pts(13, 70)
    full = ops.radius(torch.from_numpy(x), torch.from_numpy(x), 0.9,
                      max_num_neighbors=16)
    monkeypatch.setattr(geo, 'TILE_ELEMENTS', 7 * 70)
    blocked = ops.radius(torch.from_numpy(x), torch.from_numpy(x), 0.9,
                         max_num_neighbors=16)
    assert torch.equal(full, blocked)
    _same(blocked, jops.radius(jnp.asarray(x), jnp.asarray(x), 0.9,
                               max_num_neighbors=16))


def test_radius_errors_and_empty():
    x = torch.from_numpy(_pts(14, 5))
    with pytest.raises(ValueError, match='non-negative'):
        ops.radius(x, x, -1.0)
    assert ops.radius(x[:0], x, 1.0).shape == (2, 0)
    assert ops.radius(x, x, 0.0).shape[1] == 5  # each point itself


def test_nearest_matches_jax():
    x, y = _pts(15, 30), _pts(16, 12)
    y[3] = y[2]  # a tie: the lower index wins
    got, ref = _both('nearest', [x, y])
    _same(got, ref)
    ptr_x, ptr_y = np.array([0, 0, 10, 30]), np.array([0, 4, 8, 12])
    got, ref = _both('nearest', [x, y, ptr_x, ptr_y])
    _same(got, ref)


def test_nearest_errors():
    x = torch.from_numpy(_pts(17, 4))
    with pytest.raises(ValueError, match='batch count'):
        ops.nearest(x, x, torch.tensor([0, 2, 4]), torch.tensor([0, 4]))
    with pytest.raises(ValueError, match='empty reference'):
        ops.nearest(x, x, torch.tensor([0, 2]), torch.tensor([0, 0]))
    assert ops.nearest(x[:0], x).shape == (0, )


def test_grid_cluster_matches_jax():
    pos = _pts(18, 100)
    size = np.array([0.3, 0.5, 0.25], np.float32)
    got, ref = _both('grid_cluster', [pos, size])
    _same(got, ref)
    start, end = np.array([-1, -1, -1], np.float32), np.ones(3, np.float32)
    got, ref = _both('grid_cluster', [pos, size, start, end])
    _same(got, ref)
    simple = np.array([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9], [0.95, 0.95]],
                      np.float32)
    got = ops.grid_cluster(torch.from_numpy(simple), torch.tensor([0.5, 0.5]))
    assert got.tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize('weighted', [False, True])
def test_graclus_cluster_matches_jax(weighted):
    rng = np.random.default_rng(19)
    n = 60
    rowptr = np.concatenate([[0], np.cumsum(rng.integers(0, 5, n))])
    col = rng.integers(0, n, int(rowptr[-1]))
    w = rng.random(col.shape[0]).astype(np.float32) if weighted else None
    got, ref = _both('graclus_cluster', [rowptr, col, w], seed=4)
    _same(got, ref)


def test_edge_sample_matches_jax():
    rowptr = np.array([0, 4, 4, 10, 13])
    for kwargs in ({'count': 2}, {'factor': 0.5}, {'count': 9}):
        got, ref = _both('edge_sample', [np.array([0, 1, 2, 3, 2]), rowptr],
                         seed=5, **kwargs)
        _same(got, ref)
    assert ops.edge_sample(torch.tensor([1]),
                           torch.from_numpy(rowptr)).shape == (0, )
