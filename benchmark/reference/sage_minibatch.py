"""Plain reference of a mini-batch GraphSAGE step, and the checks of each
batch against the graph it was sampled from.

The batch is judged first, from the graph, the features and the labels
the benchmark made:

* ``bad_edges``: sampled edges that are not edges of the graph (the CSR
  row of the destination lists its sources, as ``csc=True`` reads it), or
  whose local ends are out of range;
* ``fanout_misses``: local nodes whose count of sampled in-edges is not
  ``min(fanout of its hop, its degree)`` (0 at the last hop), plus a
  count of nodes per hop that does not add up;
* ``duplicate_edges``: an edge sampled twice for one destination (the
  sampling is without replacement);
* ``node_misses``: a node sampled twice (twice in one tree, when
  disjoint), or a seed that is no training node, or one that an earlier
  batch of the three already had, or a batch of the wrong size;
* ``tree_breaks`` (disjoint only): an edge between two trees, or a seed
  that does not head its own tree;
* ``feature_misses``, ``label_misses``: rows of the features and labels on
  the card that differ from the benchmark's by even a bit;
* ``weight_lift`` (weighted only): the mean weight of the sampled edges
  above the mean weight of their destinations' whole neighbourhoods, over
  the destinations that had more neighbours than their fanout: biased
  sampling lifts it, unbiased sampling leaves it near 0.

Then the step: per layer ``x' = x W_self + mean_{e -> r} x[src_e] W_nbr +
b`` over the batch's real nodes and edges (the reference gathers ``x`` by
the batch's global ids itself), relu between layers, the mean
cross-entropy over the seeds, Adam written out.
"""

import numpy as np
import torch

from benchmark.reference.common import (ALTERED_ROWS, cross_entropy,
                                        matmul, precision, train_three)


def batch_checks(b: dict, graph: dict, cfg: dict, seen_seeds: set,
                 disjoint: bool) -> dict:
    """The counts above for one captured batch ``b`` (host arrays: the
    padded ``node_id``, ``row``, ``col``, ``edge_id``, ``batch`` or None,
    ``num_nodes``, ``num_edges``, ``num_seeds``, ``nodes_per_hop``, and
    the card's ``x`` and ``y`` rows of the real nodes), sampled into
    disjoint trees where ``disjoint``."""
    rowptr, colg = graph['rowptr'], graph['col']
    fanouts = cfg['num_neighbors']
    n, e, s = b['num_nodes'], b['num_edges'], b['num_seeds']
    gid = b['node_id'][:n].astype(np.int64)
    src = b['row'][:e].astype(np.int64)
    dst = b['col'][:e].astype(np.int64)
    eid = b['edge_id'][:e].astype(np.int64)
    out = {}

    in_range = (src >= 0) & (src < n) & (dst >= 0) & (dst < n) & \
        (eid >= 0) & (eid < len(colg))
    gsrc = gid[np.where(in_range, src, 0)]
    gdst = gid[np.where(in_range, dst, 0)]
    ok = in_range & (eid >= rowptr[gdst]) & (eid < rowptr[gdst + 1]) & \
        (colg[np.where(in_range, eid, 0)] == gsrc)
    out['bad_edges'] = int(np.count_nonzero(~ok))

    per_hop = np.asarray(b['nodes_per_hop'], np.int64)
    bounds = np.cumsum(per_hop)
    hop = np.searchsorted(bounds, np.arange(n), side='right')
    indeg = np.bincount(dst[in_range], minlength=n)[:n]
    deg = rowptr[gid + 1] - rowptr[gid]
    fan = np.asarray(list(fanouts) + [0], np.int64)[np.minimum(
        hop, len(fanouts))]
    expect = np.minimum(fan, deg)
    out['fanout_misses'] = int(np.count_nonzero(indeg != expect)) + int(
        bounds[-1] != n if len(bounds) else n != 0)

    pairs = np.unique(np.stack([dst, eid]), axis=1)
    out['duplicate_edges'] = int(e - pairs.shape[1])

    seeds = gid[:s]
    trees = b['batch'][:n].astype(np.int64) if disjoint else None
    if trees is None:
        dup_nodes = n - len(np.unique(gid))
    else:
        dup_nodes = n - np.unique(np.stack([trees, gid]), axis=1).shape[1]
    misses = dup_nodes + int(s != cfg['batch_size'])
    misses += int(np.count_nonzero(~np.isin(seeds, graph['train'])))
    misses += len(seeds) - len(np.unique(seeds))
    misses += sum(int(v) in seen_seeds for v in np.unique(seeds))
    seen_seeds.update(int(v) for v in seeds)
    out['node_misses'] = int(misses)

    if trees is not None:
        breaks = np.count_nonzero(trees[src[in_range]] != trees[dst[in_range]])
        breaks += np.count_nonzero(trees[:s] != np.arange(s))
        out['tree_breaks'] = int(breaks)

    x_ref = torch.from_numpy(graph['x'][gid])
    out['feature_misses'] = int(
        (b['x'].view(torch.int32) != x_ref.view(torch.int32)).any(1).sum())
    y_ref = torch.from_numpy(graph['y'][gid])
    out['label_misses'] = int((b['y'].long() != y_ref).sum())

    if graph.get('weight') is not None:
        w = graph['weight']
        picked = ok & (deg[np.where(in_range, dst, 0)] > fan[np.where(
            in_range, dst, 0)])
        d = gdst[picked]
        nb_mean = (graph['cum_weight'][rowptr[d + 1]] -
                   graph['cum_weight'][rowptr[d]]) / (rowptr[d + 1] -
                                                      rowptr[d])
        out['weight_lift'] = float(np.mean(w[eid[picked]]) - np.mean(nb_mean))
    return out


def run(inputs: dict, cfg: dict, tf32: bool = False, fault=None) -> dict:
    """Three steps on the captured batches ``inputs['batches']`` from
    ``inputs['init']`` (``[w_self0, w_nbr0, b0, ...]``), on
    ``inputs['device']``, in f64, or in f32 with TF32 products for the
    control (``tf32``). ``fault``: ``'half'`` takes the loss over half
    the seeds, ``'altered'`` doubles the first tile of rows of every
    aggregation (:data:`ALTERED_ROWS`),
    ``'stale'`` leaves the parameters unchanged."""
    graph, dev = inputs['graph'], inputs['device']
    dtype = precision(tf32)
    steps = []
    for b in inputs['batches']:
        n, e, s = b['num_nodes'], b['num_edges'], b['num_seeds']
        gid = b['node_id'][:n].astype(np.int64)
        src = torch.from_numpy(b['row'][:e].astype(np.int64)).to(dev)
        dst = torch.from_numpy(b['col'][:e].astype(np.int64)).to(dev)
        count = torch.bincount(dst, minlength=n).clamp(min=1)
        steps.append({
            'x': torch.from_numpy(graph['x'][gid]).to(dev, dtype),
            'y': torch.from_numpy(graph['y'][gid[:s]]).to(dev),
            'src': src, 'dst': dst, 'count': count[:, None].to(dtype),
            'n': n,
            's': s // 2 if fault == 'half' else s})

    def loss_of(leaves, k):
        st = steps[k]
        h = st['x']
        layers = len(leaves) // 3
        for i in range(layers):
            ws, wn, bias = leaves[3 * i:3 * i + 3]
            agg = torch.zeros((st['n'], h.shape[1]), dtype=h.dtype,
                              device=h.device).index_add(0, st['dst'],
                                                         h[st['src']])
            agg = agg / st['count']
            if fault == 'altered':
                agg = torch.cat([agg[:ALTERED_ROWS] * 2,
                                 agg[ALTERED_ROWS:]])
            h = matmul(h, ws, tf32) + matmul(agg, wn, tf32) + bias
            if i < layers - 1:
                h = torch.relu(h)
        return cross_entropy(h[:st['s']], st['y'][:st['s']])

    return train_three(inputs['init'], loss_of, cfg, steps=len(steps),
                       update=fault != 'stale', dtype=dtype)


def checks(inputs: dict, cfg: dict) -> dict:
    """The batch checks of all captured batches (sampled into disjoint
    trees where ``inputs['disjoint']``), summed (``weight_lift``
    averaged)."""
    seen = set()
    total = {}
    per = [batch_checks(b, inputs['graph'], cfg, seen, inputs['disjoint'])
           for b in inputs['batches']]
    for k in per[0]:
        vals = [p[k] for p in per]
        total[k] = (sum(vals) / len(vals) if k == 'weight_lift' else
                    int(sum(vals)))
    return total
