"""The roofline's and the model's counts against cases worked by hand."""

import numpy as np
import pytest

from benchmark.roofline import counts


def test_aggregation_work_counts_each_input_once():
    # 3 rows, 5 edges over 2 distinct sources, F = 4: sources 2*4*4 = 32
    # bytes, index 4*(5 + 3 + 1) = 36, output 3*4*4 = 48.
    nbytes, flops = counts.aggregation_work(3, 5, 2, 4)
    assert nbytes == 32 + 36 + 48
    assert flops == 5 * 4
    assert counts.aggregation_work(3, 5, 2, 4, weighted=True)[1] == 40


def test_least_seconds_takes_the_larger_bound():
    peaks = {'hbm_bytes_per_s': 100.0, 'f32_flops_per_s': 10.0}
    assert counts.least_seconds(1000, 50, peaks) == 10.0  # bytes bound
    assert counts.least_seconds(100, 500, peaks) == 50.0  # flops bound


def test_peaks_are_the_h100_data_sheet():
    assert counts.PEAKS['hbm_bytes_per_s'] == 3.35e12
    assert counts.PEAKS['f32_flops_per_s'] == 6.7e13


def test_csr_sides():
    # rows: 0 <- {1, 1}, 1 <- {}, 2 <- {0}; 3 columns
    rowptr = np.array([0, 2, 2, 3])
    col = np.array([1, 1, 0])
    fwd, bwd = counts.csr_sides(rowptr, col, 3)
    assert fwd == (3, 3, 2)  # sources 0 and 1
    assert bwd == (3, 3, 2)  # the transpose reads rows 0 and 2


def test_gcn_step_flops_by_hand():
    # n = 10, e = 20, dims [4, 3, 2]
    # layer 0 (4 -> 3): gemm 2*10*4*3 = 240; fwd 240 + 60, bwd 240 + 60
    # layer 1 (3 -> 2): gemm 120; fwd 120 + 40, bwd 120 + 40 + 120
    assert counts.gcn_step_flops(10, 20, [4, 3, 2]) == (
        300 + 300 + 160 + 280)


def test_sage_step_flops_by_hand():
    # n = 10, e = 20, dims [4, 3, 2]
    # layer 0: gemms 4*10*4*3 = 480; fwd 480 + 80, bwd 480
    # layer 1: gemms 4*10*3*2 = 240; fwd 240 + 60, bwd 240 + 240 + 60
    assert counts.sage_step_flops(10, 20, [4, 3, 2]) == (
        560 + 480 + 300 + 540)


@pytest.mark.parametrize('f', [40, 256])
def test_arxiv_aggregation_reads_below_the_gathered_bytes(f):
    # The least time counts each referenced row once: on any graph with
    # repeated sources it is below E*F*4 over the HBM rate.
    rng = np.random.default_rng(0)
    n, e = 1000, 20000
    rowptr = np.linspace(0, e, n + 1).astype(np.int64)
    col = rng.integers(0, n, e)
    fwd, _ = counts.csr_sides(rowptr, col, n)
    nbytes, _ = counts.aggregation_work(*fwd, f)
    assert nbytes < e * f * 4
