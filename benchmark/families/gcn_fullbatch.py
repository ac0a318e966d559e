"""Full-batch GCN training over the port's planned SpMM.

Set-up makes the graph, the features, the labels, the training nodes
and the initial weights from the seed (on the card), then builds the
plans with ``ops.build_spmm_graph`` as a user would (``plan.build_s``).
A step is ``gcn_forward_spmm`` over the whole graph, the mean
cross-entropy over the training nodes, the backward (the transpose
plan's aggregation) and one ``torch.optim.Adam`` step.
"""

import time

import torch
from torch.profiler import record_function

from benchmark.data import graphs
from benchmark.roofline import counts


def loss_fn(logits, train, y_train):
    """The mean cross-entropy over the training nodes."""
    return torch.nn.functional.cross_entropy(logits[train], y_train)


class Cell:
    output_leaves = 2  # the last layer's weight and bias, the last leaves

    def __init__(self, cfg: dict, wl: dict, seed: int, device, clock):
        from pyg_lib_tpu_torch import ops
        from pyg_lib_tpu_torch.models import gnn

        self.gnn = gnn
        ds = cfg['dataset']
        dims = cfg['dims']
        g = graphs.generator(seed, device)
        with clock('data_s'):
            self.rowptr, self.col = graphs.make_graph(
                wl['graph'], ds['num_nodes'], ds['num_edges'], g)
            self.x, self.y, self.train = graphs.node_data(
                ds['num_nodes'], ds['num_features'], ds['num_classes'],
                ds['num_train'], g)
            ws = graphs.glorot(list(zip(dims[:-1], dims[1:])), g)
            self.init = []
            for w, width in zip(ws, dims[1:]):
                self.init += [w, torch.zeros(width, device=device)]
        t0 = time.perf_counter()
        self.graph = ops.build_spmm_graph(self.rowptr, self.col,
                                          chunk=cfg['plan']['chunk'],
                                          dedup=cfg['plan']['dedup'],
                                          device=device)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        self.plan_build_s = time.perf_counter() - t0
        self.plans = {side: type(getattr(self.graph, side)).__name__
                      for side in ('fwd', 'bwd')}
        self.leaves = [p.clone().requires_grad_() for p in self.init]
        self.tree = {'layers': [{'w': w, 'b': b} for w, b in zip(
            self.leaves[0::2], self.leaves[1::2])]}
        self.opt = torch.optim.Adam(self.leaves, lr=cfg['lr'],
                                    betas=tuple(cfg['betas']),
                                    eps=cfg['eps'])
        self.y_train = self.y[self.train]
        n, e = ds['num_nodes'], int(self.rowptr[-1])
        self.flops_per_step = counts.gcn_step_flops(n, e, dims)
        fwd, bwd = counts.csr_sides(self.rowptr, self.col, n)
        self.agg_least_per_step = sum(
            counts.least_seconds(*counts.aggregation_work(*side, f))
            for f in dims[1:] for side in (fwd, bwd))

    def step(self, keep: bool = False):
        """One training step, enqueued; returns the loss (on the card).
        ``keep`` is for the families that keep a batch."""
        self.opt.zero_grad()
        with record_function('bench.forward'):
            logits = self.gnn.gcn_forward_spmm(self.tree, self.x, self.graph)
            loss = loss_fn(logits, self.train, self.y_train)
        with record_function('bench.backward'):
            loss.backward()
        with record_function('bench.optimizer'):
            self.opt.step()
        return loss.detach()

    def step_flops(self, k: int) -> int:
        return self.flops_per_step

    def step_agg_least_s(self, k: int) -> float:
        return self.agg_least_per_step

    def record(self) -> dict:
        return {'plan.build_s': self.plan_build_s, 'plans': self.plans}

    def capture(self, k: int) -> None:
        """Nothing to keep: every step reads the same inputs."""

    def close(self) -> None:
        """Free the program's state: plans, leaves and Adam's moments."""
        del self.graph, self.tree, self.leaves, self.opt

    def reference_inputs(self) -> dict:
        return {'rowptr': self.rowptr, 'col': self.col, 'x': self.x,
                'y': self.y, 'train': self.train, 'init': self.init}
