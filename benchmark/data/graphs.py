"""The benchmark's graph and feature generators, made from ``--seed``.

Frozen here so that the yardstick does not move when the program does.
They are rewritten from ``pyg_lib_tpu_torch.testing.uniform_graph`` and
``powerlaw_graph`` (not imported from them): the same distributions,
drawn with a ``torch.Generator`` on the given device in a few large
calls, so that a graph of a hundred million edges takes well under a
second on the card. The CSR comes back to the host as numpy int64,
because the program's plan builders and sampler take host arrays.

* ``uniform``: row degrees uniform in ``[0, 2e/n)``, scaled to about
  ``e`` edges, columns uniform over the ``n`` nodes;
* ``powerlaw``: ``e`` edges with rows uniform and columns Zipf(s) over
  the nodes (node 0 the most popular), sorted by row.

A CSR row ``r`` lists the sources whose messages row ``r`` sums
(``out[r] = sum x[col]``), so ``powerlaw`` skews the sources: a few
nodes feed many rows, as highly cited papers do.
"""

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any int that fits
    in 64 bits, negative ones wrapped)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**64 - 1))
    return g


def uniform_graph(n: int, e: int, g: torch.Generator):
    """``(rowptr, col)``: row degrees uniform in ``[0, 2e/n)`` scaled to
    about ``e`` edges, uniform columns."""
    dev = g.device
    deg = torch.randint(0, max(2 * e // n, 1), (n, ), generator=g,
                        device=dev, dtype=torch.int64)
    deg = (deg.double() * (e / max(int(deg.sum()), 1))).long()
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg, 0, out=rowptr[1:])
    col = torch.randint(0, n, (int(rowptr[-1]), ), generator=g, device=dev,
                        dtype=torch.int64)
    return rowptr.cpu().numpy(), col.cpu().numpy()


def zipf_cdf(n: int, s: float, device) -> torch.Tensor:
    """The CDF of ``p(k) ∝ (k + 1)^-s`` over ``k in [0, n)``, f64."""
    p = torch.arange(1, n + 1, dtype=torch.float64, device=device).pow(-s)
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


def powerlaw_graph(n: int, e: int, g: torch.Generator, s: float = 1.2):
    """``(rowptr, col)``: ``e`` edges, rows uniform, columns Zipf(``s``),
    sorted by row (stable)."""
    dev = g.device
    row = torch.randint(0, n, (e, ), generator=g, device=dev,
                        dtype=torch.int64)
    u = torch.rand(e, generator=g, device=dev, dtype=torch.float64)
    col = torch.searchsorted(zipf_cdf(n, s, dev), u).clamp_(max=n - 1)
    row, order = torch.sort(row, stable=True)
    col = col[order]
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(row, minlength=n), 0, out=rowptr[1:])
    return rowptr.cpu().numpy(), col.cpu().numpy()


GRAPHS = {'uniform': uniform_graph, 'powerlaw': powerlaw_graph}


def make_graph(spec: dict, n: int, e: int, g: torch.Generator):
    """The graph a traffic file's ``graph`` entry names:
    ``{"generator": "uniform"}`` or ``{"generator": "powerlaw",
    "exponent": 1.2}``."""
    kind = spec['generator']
    if kind not in GRAPHS:
        raise ValueError(f'unknown graph generator {kind!r}; known: '
                         f'{sorted(GRAPHS)}')
    if kind == 'powerlaw':
        return powerlaw_graph(n, e, g, float(spec.get('exponent', 1.2)))
    return uniform_graph(n, e, g)


def node_data(n: int, num_features: int, num_classes: int, num_train: int,
              g: torch.Generator):
    """Features ``[n, F]`` standard normal f32, labels ``[n]`` int64 in
    ``[0, classes)`` and ``num_train`` distinct training nodes (sorted),
    all on the generator's device."""
    dev = g.device
    x = torch.randn((n, num_features), generator=g, device=dev,
                    dtype=torch.float32)
    y = torch.randint(0, num_classes, (n, ), generator=g, device=dev,
                      dtype=torch.int64)
    train = torch.randperm(n, generator=g, device=dev)[:num_train]
    return x, y, torch.sort(train).values


def edge_weights(e: int, lo: float, hi: float, g: torch.Generator):
    """``[e]`` f64 weights uniform in ``[lo, hi)``, on the host (the
    sampler reads f64 host weights)."""
    w = torch.rand(e, generator=g, device=g.device, dtype=torch.float64)
    return (w * (hi - lo) + lo).cpu().numpy()


def glorot(shapes, g: torch.Generator):
    """One tensor per ``(fan_in, fan_out)`` of ``shapes``, uniform in
    ``±sqrt(6 / (fan_in + fan_out))``, drawn in one call."""
    total = sum(a * b for a, b in shapes)
    flat = torch.rand(total, generator=g, device=g.device,
                      dtype=torch.float32)
    out, at = [], 0
    for a, b in shapes:
        limit = (6.0 / (a + b))**0.5
        out.append(((2 * flat[at:at + a * b] - 1) * limit).view(a, b))
        at += a * b
    return out
