"""The kernel-against-plain contract of ``pyg_lib_tpu_torch.testing``, on
the CPU: each check passes a sound pair (a plain version against itself),
raises on the benchmark's ``altered`` fault (the first 128 rows doubled)
and on a NaN, and its bf16 and depth terms widen the bound by exactly
their formula."""

import pytest
import torch

from pyg_lib_tpu_torch import ops
from pyg_lib_tpu_torch.testing import (K6_ATOL, K6_RTOL, SUM_ATOL, SUM_RTOL,
                                       check_exact, check_plan, check_softmax,
                                       check_sum, powerlaw_graph)


def _case():
    rowptr, col = powerlaw_graph(600, 9000)
    plan = ops.build_spmm_plan(rowptr, col, chunk=128, with_edge_maps=True,
                               device='cpu')
    x = torch.randn((600, 16), generator=torch.Generator().manual_seed(0))
    ref = ops.spmm_chunked_plain(x, plan)
    mag = ops.spmm_chunked_plain(x.abs(), plan)
    return plan, x, ref, mag


def _altered(t):
    t = t.clone()
    t[:128] *= 2
    return t


def _nan(t):
    t = t.clone()
    t[3, 1] = float('nan')
    return t


def _sum(fault):
    plan, x, ref, mag = _case()
    if fault is None:
        # A plain version against itself, through the dispatch of a kernel.
        return check_plan('K1', ops.spmm_chunked_plain, ops.spmm_chunked_plain,
                          x, plan)
    return check_sum('K1', fault(ref), ref, mag)


def _exact(fault):
    plan, x, _, _ = _case()
    ref = ops.segment_max_plain(x, plan, plan.col_padded)
    got = tuple(t.clone() for t in ref)
    if fault is _altered:
        got = (_altered(got[0]), got[1])
    elif fault is _nan:
        got = (_nan(got[0]), got[1])
    elif fault == 'zero sign':  # -0.0 where the plain version has +0.0
        got[0][0, 0], ref[0][0, 0] = -0.0, 0.0
    return check_exact('K4', got, ref)


def _softmax(fault):
    plan, _, _, _ = _case()
    src = torch.randn((plan.col_padded.shape[0], 4),
                      generator=torch.Generator().manual_seed(1))
    ref = ops.segment_softmax_plain(src, plan)
    got = ref if fault is None else fault(ref)
    return check_softmax('K6', got, ref, plan)


@pytest.mark.parametrize('check', ['sum', 'exact', 'softmax'])
@pytest.mark.parametrize('fault', [None, 'altered', 'nan'])
def test_the_contract_passes_a_sound_pair_and_raises_on_faults(check,
                                                               fault):
    run = {'sum': _sum, 'exact': _exact, 'softmax': _softmax}[check]
    fault = {None: None, 'altered': _altered, 'nan': _nan}[fault]
    if fault is None:
        run(None)
    else:
        with pytest.raises(AssertionError):
            run(fault)


@pytest.mark.parametrize('term', ['none', 'bf16', 'depth', 'extra'])
def test_each_term_widens_the_sum_bound_by_its_formula(term):
    _, _, ref, mag = _case()
    ref64, mag64 = ref.double(), mag.double()
    depth = torch.arange(ref.shape[0], dtype=torch.float64) % 7 + 3
    extra = 0.25 * mag64
    kw, wide = {}, 0.0
    if term == 'bf16':
        kw, wide = {'bf16': True}, 2.0**-8 * ref64.abs()
    elif term == 'depth':
        kw, wide = {'depth': depth}, 2.0**-24 * depth[:, None] * mag64
    elif term == 'extra':
        kw, wide = {'extra': extra}, extra
    base = SUM_RTOL * mag64 + SUM_ATOL
    # Just inside the bound passes; just outside it raises, and so does an
    # error between the bound with the term and the one without it.
    inside = ref64 + 0.99 * (base + wide)
    assert check_sum('in', inside, ref, mag, **kw) == pytest.approx(
        float((inside - ref64).abs().max()))
    with pytest.raises(AssertionError):
        check_sum('out', ref64 + 1.01 * (base + wide), ref, mag, **kw)
    if term != 'none':
        with pytest.raises(AssertionError):
            check_sum('without the term', ref64 + base + 0.5 * wide, ref,
                      mag)


def test_zero_signs_count_in_the_exact_check():
    with pytest.raises(AssertionError):
        _exact('zero sign')


def test_softmax_bound_follows_the_row_length():
    plan, _, _, _ = _case()
    src = torch.randn((plan.col_padded.shape[0], 4),
                      generator=torch.Generator().manual_seed(2))
    ref = ops.segment_softmax_plain(src, plan)
    slot, row = ops.kernels.spmm_chunked._padded_rows(plan.tile_ptr)
    n = torch.zeros(ref.shape[0])
    n[slot] = torch.bincount(row, minlength=plan.num_rows)[row].float()
    bound = (K6_RTOL + n[:, None] * 2.0**-23) * ref.abs() + K6_ATOL
    bound *= plan.valid_mask[:, None]  # pad slots stay 0
    assert check_softmax('K6', ref + 0.25 * bound, ref, plan)[0] > 0
    bad = ref.clone()
    at = int(n.argmax())
    bad[at, 0] += 2 * bound[at, 0]
    with pytest.raises(AssertionError):
        check_softmax('K6', bad, ref, plan)
