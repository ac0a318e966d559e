"""The port's counterpart of the repository's ``__graft_entry__.entry``: a
GraphSAGE forward over one padded mini-batch from the port's own sampler.

    fn, args = entry()          # on the CUDA card
    out = fn(*args)             # [64, 7]

``example_batch`` samples from the cycle-graph fixture exactly as the JAX
entry does (the same seeds, the same engine streams, the same features
from numpy), so the batch equals the JAX one bit for bit; only the
weights differ (``SAGE`` from a ``torch.Generator``, where the JAX entry
draws from ``jax.random``).

``dryrun_multichip(n)`` is the counterpart of the repository's
``__graft_entry__.dryrun_multichip``, run in every rank of a process group
of ``n`` ranks: a data- and tensor-parallel GraphSAGE train step, both
halo aggregations on ``cycle_graph(8n)``, and the distributed sampling
protocol with the collective feature fetch. ``run_dryrun_multichip(n,
backend)`` starts the ranks and runs it.
"""

import functools
from typing import Dict, List

import numpy as np
import torch

from pyg_lib_tpu_torch import sampler
from pyg_lib_tpu_torch.models import SAGE, sage_forward
from pyg_lib_tpu_torch.testing import cycle_graph
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['dryrun_multichip', 'entry', 'example_batch',
           'run_dryrun_multichip']

DIMS = [32, 64, 7]


def example_batch(num_graphs: int, max_nodes: int = 64, max_edges: int = 128,
                  feat: int = 32, seed: int = 0, device=None
                  ) -> Dict[str, torch.Tensor]:
    """``num_graphs`` padded mini-batches sampled from ``cycle_graph(32)``
    (4 seeds, fanouts [4, 4]), stacked, on ``device`` (default: the CUDA
    card): ``x``, ``rowptr``, ``row``, ``node_mask`` and ``label``."""
    device = _resolve_device(device)
    rowptr, col = cycle_graph(32)
    rng = np.random.default_rng(seed)
    xs, rps, rows, masks, labels = [], [], [], [], []
    for g in range(num_graphs):
        seeds = rng.choice(32, size=4, replace=False)
        out = sampler.neighbor_sample(rowptr, col, seeds, [4, 4],
                                      rng=seed + g)
        b = sampler.padding.pad_sample_output(out, max_nodes, max_edges,
                                              num_seeds=4)
        xs.append(rng.normal(size=(max_nodes, feat)).astype(np.float32))
        rps.append(b.rowptr)
        rows.append(b.row)
        masks.append(b.node_mask)
        labels.append(rng.integers(0, 7, size=max_nodes))
    return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in (
        ('x', xs), ('rowptr', rps), ('row', rows), ('node_mask', masks),
        ('label', [a.astype(np.int32) for a in labels]))}


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is ``sage_forward`` at ``[32, 64, 7]``
    (mean aggregation, kernel K3 on the card) over one padded batch of
    :func:`example_batch`, with weights from ``torch.Generator`` seed 0,
    on ``device`` (default: the CUDA card)."""
    device = _resolve_device(device)
    batch = example_batch(num_graphs=1, device=device)
    model = SAGE(DIMS, generator=torch.Generator().manual_seed(0),
                 device=device)
    params = {'layers': [{k: v.detach() for k, v in layer.items()}
                         for layer in model.params()['layers']]}

    def forward(params, x, rowptr, row):
        return sage_forward(params, x, rowptr, row)

    return forward, (params, batch['x'][0], batch['rowptr'][0],
                     batch['row'][0])


def _tp_spec(w: torch.Tensor):
    """The dry run's tensor sharding: the 64-wide side of a weight matrix
    over ``model``, everything else replicated."""
    if w.dim() == 2 and w.shape[1] == DIMS[1]:
        return (None, 'model')
    if w.dim() == 2 and w.shape[0] == DIMS[1]:
        return ('model', None)
    return None


def dryrun_multichip(n_devices: int, device=None) -> Dict:
    """Run in every rank of a default process group of ``n_devices``
    ranks (``parallel.spawn``): ``__graft_entry__.dryrun_multichip`` step
    by step, on ``device`` (default: the CUDA card).

    1. A ``dp x tp`` mesh (``dp = max(n // 2, 1)``); ONE GraphSAGE
       ``[32, 64, 7]`` train step (Adam 1e-3) with a batch of ``2 * dp``
       padded graphs split over ``data`` and the 64-wide weights sharded
       over ``model``; the loss is the masked mean over the global batch.
    2. ``halo_exchange_aggregate`` and ``ring_halo_aggregate`` on
       ``cycle_graph(8n)`` over the 1-D mesh, each checked against the
       sums of every node's two neighbours.
    3. The distributed protocol (sample -> merge -> relabel) on a
       partitioned random graph, ``collective_feature_fetch`` of the
       batch's features checked against the rows, and a finite loss on
       the fetched batch.

    Rank 0 prints the JAX function's line. Returns ``{'loss', 'dist_loss',
    'grads', 'halo', 'ring', 'line'}`` (``grads``: the train step's
    gradients, full size, as it applied them; ``halo``/``ring``: this
    rank's rows of the two aggregations; all on the host).
    """
    import torch.distributed as dist

    from pyg_lib_tpu_torch.parallel import (halo_exchange_aggregate,
                                            make_mesh, make_train_step,
                                            ring_halo_aggregate)
    from pyg_lib_tpu_torch.parallel.train import full_params
    from pyg_lib_tpu_torch.partition import (mesh_edge_partition,
                                             mesh_edge_partition_blocked)
    from pyg_lib_tpu_torch.sampler.dist_service import (
        DistNeighborSampler, collective_feature_fetch, partition_graph)
    from pyg_lib_tpu_torch.sampler.padding import pad_sample_output

    if dist.get_world_size() != n_devices:
        raise ValueError(f'need {n_devices} ranks, have '
                         f'{dist.get_world_size()}')
    device = _resolve_device(device)
    me = dist.get_rank()
    dp = max(n_devices // 2, 1)
    tp = n_devices // dp
    mesh = make_mesh((dp, tp), ('data', 'model'), device=device.type)

    # -- data-parallel + tensor-parallel training step --------------------
    batch = example_batch(num_graphs=2 * dp, device=device)
    model = SAGE(DIMS, generator=torch.Generator().manual_seed(0),
                 device=device)
    params = {'layers': [{k: v.detach() for k, v in layer.items()}
                         for layer in model.params()['layers']]}
    param_spec = {'layers': [{k: _tp_spec(v) for k, v in layer.items()}
                             for layer in params['layers']]}

    def loss_fn(params, batch):
        total, count = 0.0, 0.0
        for g in range(batch['x'].shape[0]):
            logits = sage_forward(params, batch['x'][g], batch['rowptr'][g],
                                  batch['row'][g])
            nll = torch.nn.functional.cross_entropy(
                logits, batch['label'][g].long(), reduction='none')
            mask = batch['node_mask'][g].to(nll.dtype)
            total = total + (nll * mask).sum()
            count = count + mask.sum()
        return total, count

    step = make_train_step(loss_fn,
                           functools.partial(torch.optim.Adam, lr=1e-3),
                           mesh, batch_spec=('data', ),
                           param_spec=param_spec)
    params, _, loss = step(params, None, batch)
    if not bool(torch.isfinite(loss)):
        raise AssertionError('training step produced non-finite loss')

    # -- edge-partitioned halo-exchange aggregation -------------------------
    rowptr, col = cycle_graph(8 * n_devices)
    part = mesh_edge_partition(rowptr, col, n_devices)
    mesh1d = make_mesh((n_devices, ), ('data', ), device=device.type)
    n, npd = part.num_nodes_padded, part.nodes_per_device
    x = np.random.default_rng(0).normal(size=(n, 16)).astype(np.float32)
    mine = slice(me * npd, (me + 1) * npd)
    x_mine = torch.from_numpy(x[mine]).to(device)
    agg = halo_exchange_aggregate(
        mesh1d, x_mine, torch.from_numpy(part.src_ids[me]).to(device),
        torch.from_numpy(part.rowptr[me]).to(device), axis='data')
    # Cycle graph: every node's aggregation = sum of its two neighbours.
    expected = (x[(np.arange(n) - 1) % n] + x[(np.arange(n) + 1) % n])[mine]
    np.testing.assert_allclose(agg.cpu().numpy(), expected, rtol=1e-4,
                               atol=1e-4)

    # -- ring halo aggregation -------------------------------------------
    bpart = mesh_edge_partition_blocked(rowptr, col, n_devices)
    ragg = ring_halo_aggregate(
        mesh1d, x_mine, torch.from_numpy(bpart.rowptr_blk[me]).to(device),
        torch.from_numpy(bpart.src_blk[me]).to(device), axis='data')
    np.testing.assert_allclose(ragg.cpu().numpy(), expected, rtol=1e-4,
                               atol=1e-4)

    # -- distributed sampling protocol + partition-book feature fetch -----
    n_total = 16 * n_devices  # divisible by n_devices for equal shards
    rng = np.random.default_rng(1)
    deg = rng.integers(1, 5, size=n_total)
    grp = np.zeros(n_total + 1, np.int64)
    grp[1:] = np.cumsum(deg)
    gcol = rng.integers(0, n_total, size=int(grp[-1])).astype(np.int64)
    dg = partition_graph(grp, gcol, n_devices)
    ds = DistNeighborSampler(dg, rng=5)
    drow, dcol, node_id, _ = ds.sample(
        rng.choice(n_total, size=8, replace=False), [3, 2])

    max_nodes, max_edges = 64, 128
    db = pad_sample_output((drow, dcol, node_id, None, [], []), max_nodes,
                           max_edges, num_seeds=8)
    feats = rng.normal(size=(n_total, 32)).astype(np.float32)
    pad_ids = np.zeros(max_nodes, np.int64)
    pad_ids[:len(node_id)] = node_id
    n_local = n_total // n_devices
    fetched = collective_feature_fetch(
        mesh1d, torch.from_numpy(feats[me * n_local:(me + 1) * n_local]).to(
            device), torch.from_numpy(pad_ids).to(device), axis='data')
    np.testing.assert_allclose(fetched.cpu().numpy()[:len(node_id)],
                               feats[node_id], rtol=1e-5, atol=1e-5)

    dist_batch = {
        'x': fetched[None],
        'rowptr': torch.from_numpy(db.rowptr[None]).to(device),
        'row': torch.from_numpy(db.row[None]).to(device),
        'node_mask': torch.from_numpy(db.node_mask[None]).to(device),
        'label': torch.from_numpy(rng.integers(
            0, 7, size=(1, max_nodes)).astype(np.int32)).to(device),
    }
    with torch.no_grad():
        total, count = loss_fn(full_params(mesh, params), dist_batch)
        dist_loss = total / count.clamp(min=1.0)
    if not bool(torch.isfinite(dist_loss)):
        raise AssertionError('dist-protocol batch produced bad loss')

    line = (f'dryrun_multichip({n_devices}): train step loss='
            f'{float(loss):.4f}, all-gather + ring halo aggregation '
            f'verified on {n} nodes, dist protocol (sample->merge->relabel->'
            f'collective fetch->step) loss={float(dist_loss):.4f}')
    if me == 0:
        print(line, flush=True)
    return {'loss': float(loss), 'dist_loss': float(dist_loss),
            'grads': [g.cpu().numpy() for g in step.grads],
            'halo': agg.cpu().numpy(), 'ring': ragg.cpu().numpy(),
            'line': line}


def _dryrun_rank(rank: int, world_size: int, device) -> Dict:
    return dryrun_multichip(world_size, device=device)


def run_dryrun_multichip(n_devices: int, backend: str = 'gloo',
                         device=None) -> List[Dict]:
    """Start ``n_devices`` ranks on ``backend`` (``parallel.spawn``) and
    run :func:`dryrun_multichip` in each; returns the ranks' results."""
    from pyg_lib_tpu_torch.parallel import spawn

    device = None if device is None else str(torch.device(device))
    return spawn(_dryrun_rank, n_devices, backend, device)
