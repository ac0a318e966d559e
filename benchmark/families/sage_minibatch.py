"""Mini-batch GraphSAGE training from the port's ``NeighborLoader``.

Set-up makes the graph (its CSR read as in-neighbour lists: the sampler's
``csc=True``), the features, the labels, the training seeds, the edge
weights where the traffic asks for them and the initial weights from the
seed, then builds the loader, which probes its padding buckets. A step
takes the next batch from the loader (``loader.wait_ms`` times that
wait), runs ``sage_forward`` over the padded batch, the mean
cross-entropy over its seeds, the backward and one ``torch.optim.Adam``
step. An epoch that runs out starts the next, as a user's loop does.

The loader is the program's ``NeighborLoader``; the subclass below only
hands the benchmark the host arrays of each padded batch (global node
and edge ids, nodes per hop), which the reference judges.
"""

import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.data import graphs
from benchmark.roofline import counts


def loss_fn(logits, y, num_seeds: int):
    """The mean cross-entropy over the batch's seeds, its first
    ``num_seeds`` nodes."""
    return torch.nn.functional.cross_entropy(logits[:num_seeds],
                                             y[:num_seeds].long())


def tapped_loader(base):
    """A subclass of the program's ``NeighborLoader`` class ``base`` whose
    batches also carry ``bench_padded`` (the host ``PaddedBatch``) and
    ``bench_timing`` (the loader's timing dict of that batch)."""

    class Tapped(base):
        _local = threading.local()

        def _pad_to_bucket(self, out, num_seeds, disjoint):
            b, bi = super()._pad_to_bucket(out, num_seeds, disjoint)
            self._local.padded = b
            return b, bi

        def _make_batch(self, seed_ids, stream):
            batch, timing = super()._make_batch(seed_ids, stream)
            batch['bench_padded'] = self._local.padded
            batch['bench_timing'] = timing
            return batch, timing

    return Tapped


class Cell:
    output_leaves = 3  # the last layer's w_self, w_nbr and b

    def __init__(self, cfg: dict, wl: dict, seed: int, device, clock):
        from pyg_lib_tpu_torch.loader import NeighborLoader
        from pyg_lib_tpu_torch.models import gnn

        self.gnn = gnn
        ds = cfg['dataset']
        dims = cfg['dims']
        g = graphs.generator(seed, device)
        with clock('data_s'):
            self.rowptr, self.col = graphs.make_graph(
                wl['graph'], ds['num_nodes'], ds['num_edges'], g)
            x, y, train = graphs.node_data(ds['num_nodes'],
                                           ds['num_features'],
                                           ds['num_classes'],
                                           ds['num_train'], g)
            self.x, self.y = x.cpu().numpy(), y.cpu().numpy()
            self.train = train.cpu().numpy()
            del x, y, train
            w = wl.get('edge_weight')
            self.weight = (None if w is None else graphs.edge_weights(
                len(self.col), w[0], w[1], g))
            ws = graphs.glorot([(a, b) for a, b in zip(dims[:-1], dims[1:])
                                for _ in (0, 1)], g)
            self.init = []
            for i, width in enumerate(dims[1:]):
                self.init += [ws[2 * i], ws[2 * i + 1],
                              torch.zeros(width, device=device)]
        self.disjoint = bool(wl['disjoint'])
        kwargs = {'disjoint': self.disjoint, 'csc': True}
        if self.weight is not None:
            kwargs['edge_weight'] = self.weight
        with clock('loader.build_s'):
            self.loader = tapped_loader(NeighborLoader)(
                self.rowptr, self.col, self.x, self.y, self.train,
                cfg['batch_size'], cfg['num_neighbors'],
                num_workers=cfg['num_workers'], lookahead=cfg['lookahead'],
                rng=seed, device=device, **kwargs)
        self.it = iter(self.loader)
        self.leaves = [p.clone().requires_grad_() for p in self.init]
        self.tree = {'layers': [
            {'w_self': a, 'w_nbr': b, 'b': c} for a, b, c in zip(
                self.leaves[0::3], self.leaves[1::3], self.leaves[2::3])]}
        self.opt = torch.optim.Adam(self.leaves, lr=cfg['lr'],
                                    betas=tuple(cfg['betas']),
                                    eps=cfg['eps'])
        self.cfg, self.device = cfg, device
        self.waits, self.batches, self.kept, self.captured = [], [], None, []

    def _next(self):
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            return next(self.it)

    def step(self, keep: bool = False):
        """One training step on the next batch, enqueued; returns the loss
        (on the card). ``keep`` holds the batch for :meth:`capture`."""
        t0 = time.perf_counter()
        with record_function('bench.loader_wait'):
            batch = self._next()
        self.waits.append(time.perf_counter() - t0)
        tm = batch['bench_timing']
        self.batches.append((tm['num_nodes'], tm['num_edges'],
                             tm['sample_ms']))
        self.opt.zero_grad()
        with record_function('bench.forward'):
            logits = self.gnn.sage_forward(self.tree, batch['x'],
                                           batch['rowptr'], batch['row'],
                                           aggr=self.cfg['aggr'])
            loss = loss_fn(logits, batch['y'], batch['num_seeds'])
        with record_function('bench.backward'):
            loss.backward()
        with record_function('bench.optimizer'):
            self.opt.step()
        self.kept = batch if keep else None
        return loss.detach()

    def capture(self, k: int) -> None:
        """Keep on the host what the reference judges of the batch of
        step ``k`` (the one :meth:`step` kept)."""
        batch, b = self.kept, self.kept['bench_padded']
        n = b.num_nodes
        self.captured.append({
            'node_id': b.node_id, 'row': b.row, 'col': b.col,
            'edge_id': b.edge_id, 'batch': b.batch, 'num_nodes': n,
            'num_edges': b.num_edges, 'num_seeds': batch['num_seeds'],
            'nodes_per_hop': list(b.num_sampled_nodes_per_hop),
            'x': batch['x'][:n].cpu(), 'y': batch['y'][:n].cpu()})
        self.kept = None

    def step_flops(self, k: int) -> int:
        n, e, _ = self.batches[k]
        return counts.sage_step_flops(n, e, self.cfg['dims'])

    def step_agg_least_s(self, k: int) -> float:
        n, e, _ = self.batches[k]
        return sum(counts.least_seconds(*counts.aggregation_work(n, e, e, f))
                   for f in self.cfg['dims'][:-1])

    def record(self) -> dict:
        return {'waits_s': self.waits, 'batches': self.batches}

    def close(self) -> None:
        """Stop the loader's threads and free the program's state."""
        self.it.close()
        del self.it, self.loader, self.tree, self.leaves, self.opt

    def reference_inputs(self) -> dict:
        graph = {'rowptr': self.rowptr, 'col': self.col, 'x': self.x,
                 'y': self.y, 'train': self.train, 'weight': self.weight}
        if self.weight is not None:
            graph['cum_weight'] = np.concatenate(
                [[0.0], np.cumsum(self.weight)])
        return {'graph': graph, 'batches': self.captured,
                'disjoint': self.disjoint, 'init': self.init,
                'device': self.device}
