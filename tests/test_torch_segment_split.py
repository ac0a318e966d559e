"""K3's and K4's schedules on the CUDA card, run on the CPU: the merge-path
split of K3 and its ordered merge of partial rows, and K4's pieces of long
rows and their merge, against the plain versions and the JAX package.

Inputs come from ``np.random.default_rng``. The CSRs are ragged, with a
leading gap, trailing pad positions, empty rows and a hub row. Tolerances:

* K3's schedule against ``segment_sum_csr_plain``: both sum the same f32
  terms in another order, so ``|split - plain| <= 1e-5 * Σ|terms| + 1e-5``
  (a bf16 result adds one bf16 step, ``2**-8 * |plain|``);
* against the JAX package's CPU ``segment_sum_csr``: f32 rtol 1e-5 /
  atol 1e-4, for the summation order only;
* K4's schedule against ``segment_max_plain``: values and positions bit
  for bit (``-0.0`` and ``+0.0`` told apart).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyg_lib_tpu import ops as jops
from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.ops.kernels import segment_csr as k3
from pyg_lib_tpu_torch.ops.kernels import segment_minmax as k4
from test_torch_spmm import ATOL, RTOL, np_of

SUM_RTOL, SUM_ATOL = 1e-5, 1e-5


def _indptr(kind):
    """Row pointers: a ragged CSR (geometric degrees, a third of the rows
    empty), the same with a hub row of 5,000 edges, and rows that are all
    empty but one."""
    rng = np.random.default_rng({'ragged': 0, 'hub': 1, 'sparse': 2}[kind])
    n = 300
    deg = rng.geometric(0.1, n) - 1
    deg[rng.random(n) < 0.33] = 0
    if kind == 'hub':
        deg[137] = 5000
    if kind == 'sparse':
        deg[:] = 0
        deg[250] = 40
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    return ptr


LAYOUTS = ['ragged', 'hub', 'sparse']


def _k3_case(kind, f=5, dtype=torch.float32):
    """(src, indptr): 4 leading positions of no row, 7 trailing ones."""
    ptr = _indptr(kind) + 4
    e = int(ptr[-1]) + 7
    src = np.random.default_rng(9).normal(size=(e, f)).astype(np.float32)
    return torch.tensor(src).to(dtype), torch.tensor(ptr)


@pytest.mark.parametrize('kind', LAYOUTS)
@pytest.mark.parametrize('units', [1, 3, 16, 97, 400])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k3_split_matches_plain(kind, units, dtype):
    src, ptr = _k3_case(kind, dtype=dtype)
    got = k3.segment_sum_csr_split(src, ptr, units)
    ref = k3.segment_sum_csr_plain(src, ptr)
    mag = k3.segment_sum_csr_plain(src.float().abs(), ptr)
    assert got.dtype == dtype and got.shape == ref.shape
    tol = SUM_RTOL * mag + SUM_ATOL
    if dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * ref.float().abs()
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.parametrize('kind', LAYOUTS)
@pytest.mark.parametrize('units', [7, 64])
def test_k3_split_matches_jax(kind, units):
    src, ptr = _k3_case(kind, f=47)
    ref = jops.segment_sum_csr(jnp.asarray(src.numpy()), ptr.numpy())
    got = k3.segment_sum_csr_split(src, ptr, units)
    np.testing.assert_allclose(np_of(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _merge_walk(start, d):
    """The merge path walked one item at a time up to diagonal ``d``:
    a row end is taken once all of its edges are."""
    rows, i, j = len(start) - 1, 0, 0
    for _ in range(d):
        if i < rows and start[i + 1] <= j:
            i += 1
        else:
            j += 1
    return i, j


@pytest.mark.parametrize('kind', LAYOUTS)
def test_k3_split_points_follow_the_merge_path(kind):
    _, ptr = _k3_case(kind)
    units = 23
    split = k3.k3_split(ptr, int(ptr[-1]) + 7, units)
    start = split.start.tolist()
    for w in range(units + 1):
        d = int(split.i[w] + split.j[w])
        assert (int(split.i[w]), int(split.j[w])) == _merge_walk(start, d)
    # Equal stretches: diagonals differ by at most one item.
    lens = (split.i + split.j).diff()
    assert int(lens.max() - lens.min()) <= 1


def test_k3_codes_start_each_shared_row_once():
    _, ptr = _k3_case('hub')
    split = k3.k3_split(ptr, int(ptr[-1]) + 7, 200)
    codes = k3.k3_partial_codes(split)
    starts = codes[codes >= 0]
    # The hub row spans many warps: one run start, many continuations.
    assert starts.unique().numel() == starts.numel()
    hub = 137
    assert int((codes == hub).sum()) == 1
    assert int((codes == -2 - hub).sum()) > 10


def test_k3_units_fill_the_card_and_keep_small_inputs_small():
    assert k3.k3_units(262_144, 4_064_071, 132) == 132 * k3.UNITS_PER_SM
    assert k3.k3_units(10, 20, 132) == 1
    assert k3.k3_units(0, 0, 132) == 1


# -- K4 -----------------------------------------------------------------------


def _k4_case(kind, mode, values, f=6):
    ptr = _indptr(kind)
    e = int(ptr[-1])
    col = np.random.default_rng(3).integers(0, ptr.shape[0] - 1, e)
    plan = ops.build_spmm_plan(ptr, col, chunk=128, with_edge_maps=True,
                               device='cpu')
    rows, idx = {'padded': (plan.col_padded.shape[0], None),
                 'col_padded': (plan.num_rows, plan.col_padded),
                 'edge_perm': (max(e, 1), plan.edge_perm)}[mode]
    rng = np.random.default_rng(4)
    if values == 'ties':  # both zeros, repeats, -inf (whole rows of it)
        v = rng.choice(np.float32([-2.0, -0.0, 0.0, 1.0, -np.inf]),
                       size=(rows, f))
        v[::7] = -np.inf
    else:
        v = rng.normal(size=(rows, f)).astype(np.float32)
    return torch.tensor(v), plan, idx


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize('kind', LAYOUTS)
@pytest.mark.parametrize('mode', ['padded', 'col_padded', 'edge_perm'])
@pytest.mark.parametrize('values', ['normal', 'ties'])
@pytest.mark.parametrize('negate', [False, True])
@pytest.mark.parametrize('long', [1, 3, 16, k4.K4_LONG])
def test_k4_split_matches_plain_bit_for_bit(kind, mode, values, negate, long,
                                            monkeypatch):
    # A short cut puts most rows in pieces: every slot its own piece at 1.
    monkeypatch.setattr(k4, 'K4_LONG', long)
    src, plan, idx = _k4_case(kind, mode, values)
    got = k4.segment_max_split(src, plan, idx, negate)
    ref = k4.segment_max_plain(src, plan, idx, negate)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.equal(_bits(g), _bits(r))


def test_k4_split_cuts_the_hub_row():
    _, plan, _ = _k4_case('hub', 'padded', 'normal')
    bounds = plan.tile_ptr[:, 0, :129].long()
    assert int((bounds[:, 1:] - bounds[:, :-1]).max()) > k4.K4_LONG


@pytest.mark.parametrize('long', [3, 64, k4.K4_LONG])
def test_k4_pieces_cover_each_long_row_in_order(long, monkeypatch):
    monkeypatch.setattr(k4, 'K4_LONG', long)
    _, plan, _ = _k4_case('hub', 'padded', 'normal')
    lo, n = k4._row_bounds(plan.tile_ptr, plan.num_rows)
    cut = k4.k4_pieces(plan)
    assert cut.rows[:, 0].tolist() == torch.nonzero(n > long).reshape(
        -1).tolist()
    for r, first, count in cut.rows.tolist():
        pc = cut.pieces[first:first + count]
        assert (pc[:, 0] == r).all()
        # Consecutive pieces of `long` slots (the last may be shorter)
        # from the row's first slot to its end.
        assert int(pc[0, 1]) == int(lo[r]) and int(pc[-1, 2]) == int(lo[r] +
                                                                    n[r])
        assert torch.equal(pc[1:, 1], pc[:-1, 2])
        size = pc[:, 2] - pc[:, 1]
        assert (size[:-1] == long).all() and 0 < int(size[-1]) <= long
    assert int(cut.rows[:, 2].sum()) == cut.pieces.shape[0]


def test_k4_long_matches_the_kernel_source():
    src = (Path(k4.__file__).parents[2] / 'csrc' /
           'segment_minmax.cu').read_text()
    assert f'constexpr int LONG = {k4.K4_LONG};' in src


def test_k4_merge_is_associative_and_keeps_the_first_winner():
    rng = np.random.default_rng(8)
    vals = torch.tensor(rng.choice(np.float32([-1.0, -0.0, 0.0, 2.0,
                                               -np.inf]), size=(3, 4000)))
    # Distinct slots: row k holds slots 3m + k.
    pos = torch.tensor(3 * rng.integers(0, 50, (3, 4000)) +
                       np.arange(3)[:, None], dtype=torch.int32)
    none = torch.tensor(rng.random((3, 4000)) < 0.2)
    pos = torch.where(none, torch.tensor(k4.POS_NONE, dtype=torch.int32),
                      pos)
    vals = torch.where(none, torch.tensor(float('-inf')), vals)
    a, b, c = ((vals[k], pos[k]) for k in range(3))
    left = k4.k4_merge(*k4.k4_merge(*a, *b), *c)
    right = k4.k4_merge(*a, *k4.k4_merge(*b, *c))
    swapped = k4.k4_merge(*k4.k4_merge(*c, *a), *b)
    for x, y, z in zip(left, right, swapped):
        assert torch.equal(_bits(x), _bits(y)) and torch.equal(_bits(x),
                                                               _bits(z))
    # The result is the first slot among the taken ones holding the
    # maximum, with that slot's own bits.
    taken = pos < k4.POS_NONE
    best = torch.where(taken, vals, torch.tensor(float('-inf'))).amax(0)
    first = torch.where(taken & (vals == best), pos,
                        torch.tensor(k4.POS_NONE, dtype=torch.int32)).amin(0)
    assert torch.equal(left[1], first)
    hit = first < k4.POS_NONE
    at = (taken & (pos == first)).int().argmax(0)
    own = vals.gather(0, at[None])[0]
    assert torch.equal(_bits(left[0][hit]), _bits(own[hit]))
