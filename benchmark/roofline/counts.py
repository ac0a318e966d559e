"""Operations and bytes that the benchmark's cells need, counted from the
shapes and the graphs the benchmark made, never from the program's plans.

* An aggregation call ``out[r] = sum_{e in row r} src[s_e]`` at width
  ``F`` needs each source row that some edge references read once, the
  index arrays read once (4 bytes an edge and a row), and each output row
  written once, f32; and one add an edge and a feature (two when the
  edges carry weights). Its least time is the larger of the bytes over
  the HBM rate and the adds over the f32 rate. A kernel that reads a row
  again reads it from a cache or pays for it, so no kernel can beat this.
* A model step counts its GEMMs (2mnk each) and one add an edge and a
  feature for each aggregation pass, forward and backward, over the real
  nodes and edges; elementwise work is left out.
"""

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).parent / 'peaks.json').read_text())


def aggregation_work(num_rows: int, num_edges: int, num_sources: int,
                     f: int, weighted: bool = False):
    """``(bytes, flops)`` of one aggregation call: ``num_sources``
    referenced source rows of ``f`` f32 values read once, 4 bytes an edge
    and a row of index, ``num_rows`` output rows written once."""
    nbytes = 4 * (num_sources * f + num_edges + num_rows + 1 +
                  num_rows * f)
    flops = num_edges * f * (2 if weighted else 1)
    return nbytes, flops


def least_seconds(nbytes: float, flops: float, peaks=PEAKS) -> float:
    """The least time the chip could take: the larger of the two
    bounds."""
    return max(nbytes / peaks['hbm_bytes_per_s'],
               flops / peaks['f32_flops_per_s'])


def csr_sides(rowptr: np.ndarray, col: np.ndarray, num_cols: int):
    """The forward and the transpose aggregation of a CSR graph, as
    ``(num_rows, num_edges, num_sources)``: the forward's sources are the
    distinct columns, the transpose's the rows that hold an edge."""
    num_rows = len(rowptr) - 1
    e = int(rowptr[-1])
    used_cols = int(np.count_nonzero(np.bincount(col[:e],
                                                 minlength=num_cols)))
    used_rows = int(np.count_nonzero(np.diff(rowptr)))
    return (num_rows, e, used_cols), (num_cols, e, used_rows)


def gcn_step_flops(n: int, e: int, dims) -> int:
    """A full-batch GCN step over ``n`` nodes and ``e`` edges: per layer
    ``h = x @ W`` and one aggregation of ``h`` forward; ``x.T @ dh``, the
    transpose aggregation and, past the first layer, ``dh @ W.T``
    backward."""
    total = 0
    for layer, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        gemm = 2 * n * a * b
        total += gemm + e * b  # forward
        total += gemm + e * b + (gemm if layer else 0)  # backward
    return total


def sage_step_flops(n: int, e: int, dims) -> int:
    """A GraphSAGE (mean) step over a batch of ``n`` real nodes and ``e``
    real edges: per layer two GEMMs and the aggregation of the layer's
    input forward; the two weight gradients and, past the first layer,
    the two input gradients and the scatter of the messages' gradient
    backward."""
    total = 0
    for layer, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        gemms = 4 * n * a * b
        total += gemms + e * a  # forward
        total += gemms + ((gemms + e * a) if layer else 0)  # backward
    return total
