"""Plain reference of a full-batch GCN step: the same equations as the
port's ``gcn_forward_spmm``, aggregating straight from the CSR with
``index_add_``, then Adam written out.

Per layer ``h = x @ W``, ``x' = D^-1/2 A D^-1/2 h + D^-1 h + b`` with
``A`` the CSR (``out[r] = sum_{e in row r} h[col_e]``) and ``D`` its row
degree clamped at 1, relu between layers; the loss is the mean
cross-entropy over the training nodes.
"""

import torch

from benchmark.reference.common import (ALTERED_ROWS, cross_entropy,
                                        matmul, precision, train_three)


def aggregate(h, row, col, n, fault=None):
    """``out[r] = sum_{e: row_e = r} h[col_e]``."""
    out = torch.zeros((n, h.shape[1]), dtype=h.dtype, device=h.device)
    out = out.index_add(0, row, h[col])
    if fault == 'altered':
        out = torch.cat([out[:ALTERED_ROWS] * 2, out[ALTERED_ROWS:]])
    return out


def run(inputs: dict, cfg: dict, tf32: bool = False, fault=None) -> dict:
    """Three steps from ``inputs`` (``rowptr``, ``col`` on the host;
    ``x``, ``y``, ``train`` and ``init``, the initial leaves ``[w0, b0,
    w1, b1, ...]``, on one device). In f64, or in f32 with TF32 products
    for the control (``tf32``). ``fault`` plants one of the faults a
    training step can have: ``'half'`` takes the loss over half the
    training nodes, ``'altered'`` doubles the first tile of rows of every
    aggregation (:data:`ALTERED_ROWS`),
    ``'stale'`` leaves the parameters unchanged."""
    dtype = precision(tf32)
    x, y, train = inputs['x'].to(dtype), inputs['y'], inputs['train']
    dev = x.device
    rowptr = torch.as_tensor(inputs['rowptr'], device=dev)
    col = torch.as_tensor(inputs['col'], device=dev)
    n = rowptr.shape[0] - 1
    deg = (rowptr[1:] - rowptr[:-1]).to(dtype)
    row = torch.repeat_interleave(torch.arange(n, device=dev),
                                  rowptr[1:] - rowptr[:-1])
    inv = deg.clamp(min=1.0).rsqrt()[:, None]
    if fault == 'half':
        train = train[:len(train) // 2]

    def loss_of(leaves, k):
        h_in = x
        layers = len(leaves) // 2
        for i in range(layers):
            w, b = leaves[2 * i], leaves[2 * i + 1]
            h = matmul(h_in, w, tf32)
            agg = aggregate(h * inv, row, col, n, fault)
            h_in = agg * inv + h * inv * inv + b
            if i < layers - 1:
                h_in = torch.relu(h_in)
        return cross_entropy(h_in[train], y[train])

    return train_three(inputs['init'], loss_of, cfg,
                       update=fault != 'stale', dtype=dtype)
