"""The frozen generators: the same seed gives the same inputs, another
seed other inputs, and the distributions are the ones the traffic files
name."""

import numpy as np
import pytest
import torch

from benchmark.data import graphs

CPU = torch.device('cpu')
BIG_SEED = 2**31 + 12345  # seeds may pass 32 signed bits


@pytest.mark.parametrize('kind', ['uniform', 'powerlaw'])
def test_same_seed_same_graph(kind):
    spec = {'generator': kind}
    a = graphs.make_graph(spec, 500, 8000, graphs.generator(BIG_SEED, CPU))
    b = graphs.make_graph(spec, 500, 8000, graphs.generator(BIG_SEED, CPU))
    c = graphs.make_graph(spec, 500, 8000, graphs.generator(7, CPU))
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not np.array_equal(a[1], c[1])


@pytest.mark.parametrize('kind', ['uniform', 'powerlaw'])
def test_graph_is_a_csr_of_about_e_edges(kind):
    n, e = 2000, 50000
    rowptr, col = graphs.make_graph({'generator': kind}, n, e,
                                    graphs.generator(3, CPU))
    assert rowptr.dtype == np.int64 and col.dtype == np.int64
    assert rowptr.shape == (n + 1, ) and rowptr[0] == 0
    assert np.all(np.diff(rowptr) >= 0) and rowptr[-1] == len(col)
    assert 0.95 * e <= len(col) <= e
    assert col.min() >= 0 and col.max() < n


def test_powerlaw_columns_are_skewed_and_uniform_ones_not():
    n, e = 2000, 200000
    _, zc = graphs.make_graph({'generator': 'powerlaw', 'exponent': 1.2}, n,
                              e, graphs.generator(5, CPU))
    _, uc = graphs.make_graph({'generator': 'uniform'}, n, e,
                              graphs.generator(5, CPU))
    zcount, ucount = np.bincount(zc, minlength=n), np.bincount(uc,
                                                               minlength=n)
    assert zcount.argmax() == 0
    # Zipf(1.2): p(0) = 1 / sum_k k^-1.2, about 0.22 at n = 2000.
    p0 = 1 / np.sum(np.arange(1, n + 1)**-1.2)
    assert abs(zcount[0] / e - p0) < 0.01
    assert ucount.max() < 3 * e / n


def test_node_data_and_weights():
    g = graphs.generator(BIG_SEED, CPU)
    x, y, train = graphs.node_data(1000, 16, 40, 300, g)
    assert x.shape == (1000, 16) and x.dtype == torch.float32
    assert y.min() >= 0 and y.max() < 40
    assert len(torch.unique(train)) == 300 and torch.all(train[1:] >
                                                        train[:-1])
    w = graphs.edge_weights(10000, 0.05, 1.0, g)
    assert w.dtype == np.float64 and w.min() >= 0.05 and w.max() < 1.0


def test_glorot_bounds_and_one_draw():
    ws = graphs.glorot([(100, 256), (256, 47)], graphs.generator(1, CPU))
    assert [tuple(w.shape) for w in ws] == [(100, 256), (256, 47)]
    for w, (a, b) in zip(ws, [(100, 256), (256, 47)]):
        assert w.abs().max() <= (6 / (a + b))**0.5
    again = graphs.glorot([(100, 256), (256, 47)], graphs.generator(1, CPU))
    assert all(torch.equal(u, v) for u, v in zip(ws, again))


def test_unknown_generator_raises():
    with pytest.raises(ValueError, match='unknown graph generator'):
        graphs.make_graph({'generator': 'rmat'}, 10, 10,
                          graphs.generator(0, CPU))
