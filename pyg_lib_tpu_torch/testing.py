"""Test fixtures (counterpart of ``pyg_lib_tpu.testing``)."""

import numpy as np

__all__ = ['cycle_graph']


def cycle_graph(num_nodes: int = 6):
    """Cycle-graph fixture: every node has exactly two neighbours
    ``(v±1) % n`` so expected outputs are hand-computable.

    Returns CSR ``(rowptr, col)`` as numpy int64.
    """
    n = num_nodes
    rowptr = np.arange(0, 2 * n + 1, 2, dtype=np.int64)
    col = np.empty(2 * n, dtype=np.int64)
    for v in range(n):
        col[2 * v] = (v - 1) % n
        col[2 * v + 1] = (v + 1) % n
    return rowptr, col
