"""Mini-batch loaders: the host sampling pipeline that feeds the card
(port of ``pyg_lib_tpu/loader.py``: ``NeighborLoader`` and
``HeteroNeighborLoader``).

* A thread pool samples (the C++ engine releases the GIL during its call,
  so the workers overlap), pads, and gathers each batch's feature rows on
  the host, straight into page-locked (pinned) memory when the batches go
  to the card;
* a window of ``lookahead`` batches in flight keeps the pool ahead of the
  consumer;
* finished batches are copied to the card with ``non_blocking=True`` on a
  side stream, one batch ahead of the one the consumer holds, so the copy
  of batch ``i + 1`` overlaps the step on batch ``i``. The consumer's
  stream waits on the copy's event before it reads the batch, and each
  tensor is marked as used on that stream, so its memory is not handed to
  the next copy while the step still reads it. A pinned buffer is not
  reused until its copy has finished: PyTorch's pinned-memory allocator
  records the copy's event on the buffer and hands it out again only after
  it.

Batch ``i`` of epoch ``e`` samples with the stream ``rng + e * nb + i``
(``nb`` batches an epoch) and the epoch's seed order is a permutation from
``rng + 7919 * e``, as in the JAX package, so the same ``rng`` gives the
JAX loader's batches bit for bit.

``DistNeighborLoader`` feeds the same pipeline from a partitioned graph:
each batch runs the distributed protocol (``sampler.dist_service``), and
the same ``rng`` gives the JAX ``DistNeighborLoader``'s batches bit for
bit.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from pyg_lib_tpu_torch import profiling, sampler
from pyg_lib_tpu_torch.sampler._cpp import EngineSample
from pyg_lib_tpu_torch.sampler.padding import (BudgetExceeded, bucket_ladder,
                                               budget_for,
                                               pad_hetero_sample_output,
                                               pad_sample_output)
from pyg_lib_tpu_torch.utils import _resolve_device

__all__ = ['DistNeighborLoader', 'HeteroNeighborLoader', 'NeighborLoader']


def _count_padding(pad, row: np.ndarray, nodes: int, edges: int,
                   node_slots: int, edge_slots: int, **attrs) -> None:
    """The ``sampler.pad`` span's counters of a padded batch: its real
    nodes and edges against its slots and, when the span records, the
    most edges (pad edges included) that read one source row of ``row``
    (counted after the span, outside its time)."""
    pad.attrs.update(nodes=int(nodes), node_slots=int(node_slots),
                     edges=int(edges), edge_slots=int(edge_slots), **attrs)
    if pad.recording:
        pad.attrs['max_row_reads'] = int(np.bincount(row).max())


def _phase_ms(sample, pad, gather) -> Dict[str, float]:
    """A batch's timing dict entries, from its three spans."""
    return {'sample_ms': sample.seconds * 1e3, 'pad_ms': pad.seconds * 1e3,
            'gather_ms': gather.seconds * 1e3}


class _Pipeline:
    """The iteration, the copies to the card and the checkpoint state the
    two loaders share. A subclass sets ``seeds``, ``batch_size``,
    ``num_workers``, ``lookahead``, ``rng``, ``device`` and ``drop_last``
    (through :meth:`_setup`) and gives ``_make_batch(seed_ids, stream)``,
    which returns ``(host batch, timing)``."""

    def _setup(self, seeds, batch_size, num_workers, lookahead, rng, device,
               drop_last):
        self.seeds = np.asarray(seeds, np.int64)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.lookahead = max(lookahead, 1)
        self.rng = rng
        self.device = _resolve_device(device)
        self.drop_last = drop_last
        self._pin = self.device.type == 'cuda'
        self._epoch = 0
        self._in_epoch = None
        # The current epoch's batches in order: sample_ms, pad_ms and
        # gather_ms (the worker's spans sampler.sample, sampler.pad and
        # loader.gather), num_nodes, num_edges, bucket, and on the card
        # 'h2d', the copy's pair of CUDA events.
        self.timings: List[Dict] = []

    def __len__(self) -> int:
        s = len(self.seeds)
        return s // self.batch_size if self.drop_last else -(
            -s // self.batch_size)

    def _host(self, a) -> torch.Tensor:
        """``a`` as a host tensor, pinned when batches go to the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self._pin else t

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self._pin)

    def state_dict(self) -> Dict:
        """The loader's position, at epoch granularity: after
        :meth:`load_state_dict` the next ``__iter__`` replays the seed
        order and sample streams the saved run would have used. Saved in
        the middle of an epoch, it replays that epoch from its start."""
        epoch = self._in_epoch if self._in_epoch is not None else \
            self._epoch
        return {'epoch': int(epoch), 'rng': int(self.rng)}

    def load_state_dict(self, state: Dict) -> None:
        if int(state.get('rng', self.rng)) != int(self.rng):
            raise ValueError(
                f"loader state has rng={state.get('rng')}, this loader "
                f'was built with rng={self.rng}; resume with the same '
                'base seed for reproducible streams')
        self._epoch = int(state['epoch'])
        self._in_epoch = None

    def _put(self, host: Dict, timing: Dict, side) -> Dict:
        """Start the copies of ``host``'s tensors to the card on ``side``
        (the CPU: the host tensors as they are)."""
        if side is None:
            return host
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            dev = {k: v.to(self.device, non_blocking=True)
                   if isinstance(v, torch.Tensor) else v
                   for k, v in host.items()}
            done.record(side)
        timing['h2d'] = (start, done)
        return dev

    def _hand_over(self, dev: Dict, timing: Dict) -> Dict:
        """Make the consumer's stream wait for ``dev``'s copies, and mark
        its tensors as used there."""
        if self.device.type == 'cuda':
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(timing['h2d'][1])
            for v in dev.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(stream)
        return dev

    def _job(self, seed_ids: np.ndarray, stream: int, traced: bool):
        """``_make_batch`` in a worker, whose spans record if the consumer
        saw a profiler session when it submitted the batch (a worker
        thread cannot see one)."""
        with profiling.recording(traced):
            return self._make_batch(seed_ids, stream)

    def __iter__(self) -> Iterator[Dict]:
        epoch = self._epoch
        self._epoch += 1
        self._in_epoch = epoch
        self.timings = []
        order = np.random.default_rng(self.rng + 7919 * epoch).permutation(
            len(self.seeds))
        nb = len(self)
        batches = [
            self.seeds[order[i * self.batch_size:(i + 1) * self.batch_size]]
            for i in range(nb)
        ]
        side = (torch.cuda.Stream(self.device) if self.device.type == 'cuda'
                else None)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = []
            submitted = 0

            def submit_next():
                nonlocal submitted
                if submitted < nb:
                    stream = self.rng + epoch * nb + submitted
                    futures.append((stream, pool.submit(
                        self._job, batches[submitted], stream,
                        torch.autograd._profiler_enabled())))
                    submitted += 1

            for _ in range(self.lookahead + 1):
                submit_next()
            staged = None  # (batch on the card, its timing), one ahead
            while futures or staged is not None:
                nxt = None
                if futures:
                    stream, fut = futures.pop(0)
                    with profiling.span('loader.starve', batch=stream):
                        host, timing = fut.result()
                    submit_next()
                    self.timings.append(timing)
                    nxt = (self._put(host, timing, side), timing)
                if staged is not None:
                    yield self._hand_over(*staged)
                staged = nxt
        self._in_epoch = None  # the epoch was consumed to its end


class NeighborLoader(_Pipeline):
    """Iterable over fixed-shape mini-batches on ``device``.

    Args:
        rowptr, col: the graph's CSR (host numpy).
        x: ``[N, F]`` host features, gathered per batch.
        y: ``[N]`` host labels (or ``None``), gathered per batch.
        seeds: ``[S]`` seed node ids, one epoch.
        batch_size: seeds a batch.
        num_neighbors: fanouts a hop (all >= 0, for a static budget).
        max_nodes / max_edges: an explicit first bucket; the worst case
            follows as the overflow bucket, so no edge is ever dropped.
            Without them the first bucket comes from 4 probe batches
            sampled here (their largest counts times ``probe_margin``).
        buckets: an explicit ascending ``[(max_nodes, max_edges), ...]``
            in place of the ladder (its last rung must hold every batch).
        num_workers: sampling threads.
        lookahead: batches in flight ahead of the consumer.
        rng: the base seed of the batches' streams.
        device: where the batches go (default: the CUDA card).
        drop_last: drop the last, smaller batch (default True).
        sample_kwargs: passed to ``sampler.neighbor_sample`` (``impl``
            among them).

    ``bucket_counts`` counts the batches padded into each bucket. Each
    batch is a dict: ``x [max_nodes, F]``, ``rowptr [max_nodes + 1]``,
    ``row``/``col [max_edges]`` (int32), ``node_mask``, ``num_seeds`` (an
    int; the seeds are the first nodes), ``batch`` (disjoint sampling)
    and ``y``.
    """

    def __init__(self, rowptr, col, x, y, seeds, batch_size: int,
                 num_neighbors: List[int],
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None,
                 buckets: Optional[List] = None,
                 probe_margin: float = 1.25, num_workers: int = 2,
                 lookahead: int = 2, rng: int = 0, device=None,
                 drop_last: bool = True, **sample_kwargs):
        self._setup(seeds, batch_size, num_workers, lookahead, rng, device,
                    drop_last)
        self.rowptr = np.ascontiguousarray(rowptr, np.int64)
        self.col = np.ascontiguousarray(col, np.int64)
        self.x = torch.from_numpy(np.asarray(x))
        self.y = None if y is None else torch.from_numpy(np.asarray(y))
        self.num_neighbors = list(num_neighbors)
        self.sample_kwargs = sample_kwargs
        if buckets is not None:
            self.buckets = [tuple(b) for b in buckets]
        else:
            worst = budget_for(batch_size, self.num_neighbors, slack=1.0)
            if max_nodes is not None or max_edges is not None:
                self.buckets = bucket_ladder(max_nodes or worst[0],
                                             max_edges or worst[1], *worst)
            else:
                self.buckets = bucket_ladder(
                    *self._probe_budget(probe_margin), *worst)
        self.bucket_counts = [0] * len(self.buckets)
        self._counts_lock = threading.Lock()
        self.max_nodes, self.max_edges = self.buckets[-1]

    def _probe_budget(self, margin: float):
        """The largest node and edge counts of 4 unpadded probe batches,
        times ``margin``."""
        rng = np.random.default_rng(0x9E3779B9)
        mn, me = 1, 1
        for _ in range(4):
            ids = rng.choice(len(self.seeds),
                             size=min(self.batch_size, len(self.seeds)),
                             replace=False)
            out = sampler.neighbor_sample(
                self.rowptr, self.col, self.seeds[ids], self.num_neighbors,
                rng=int(rng.integers(2**63)), **self.sample_kwargs)
            mn = max(mn, len(out[2]))
            me = max(me, len(out[0]))
        return int(mn * margin), int(me * margin)

    def _pad_to_bucket(self, out, num_seeds: int, disjoint: bool):
        """Pad into the smallest bucket that holds the batch; returns it
        and the bucket's index. ``out`` is ``_sample``'s: an
        ``EngineSample`` writes itself, a tuple goes through
        ``pad_sample_output``."""
        for bi, (bn, be) in enumerate(self.buckets):
            try:
                if isinstance(out, EngineSample):
                    b = out.pad(bn, be, num_seeds)
                else:
                    b = pad_sample_output(out, bn, be, num_seeds=num_seeds,
                                          disjoint=disjoint)
            except BudgetExceeded:
                continue
            with self._counts_lock:
                self.bucket_counts[bi] += 1
            return b, bi
        raise BudgetExceeded(
            f'sample exceeds even the worst-case bucket {self.buckets[-1]}')

    def _sample(self, seed_ids: np.ndarray, stream: int):
        """The batch's sample, as ``sampler.sample_for_padding`` returns
        it: kept in the engine where its edges come in destination order
        (``csc=True``), else ``sampler.neighbor_sample``'s tuple."""
        return sampler.sample_for_padding(self.rowptr, self.col, seed_ids,
                                          self.num_neighbors, rng=stream,
                                          **self.sample_kwargs)

    def _make_batch(self, seed_ids: np.ndarray, stream: int):
        with profiling.span('sampler.sample', batch=stream) as sample:
            out = self._sample(seed_ids, stream)
        with profiling.span('sampler.pad', batch=stream) as pad:
            b, bi = self._pad_to_bucket(
                out, len(seed_ids), self.sample_kwargs.get('disjoint', False))
        sample.attrs.update(path='padded' if isinstance(out, EngineSample)
                            else 'tuple', edges=b.num_edges)
        _count_padding(pad, b.row, b.num_nodes, b.num_edges, *self.buckets[bi],
                       bucket=bi)
        with profiling.span('loader.gather', batch=stream) as gather:
            nodes = torch.from_numpy(b.node_id)
            x = self._empty((nodes.shape[0], ) + tuple(self.x.shape[1:]),
                            self.x.dtype)
            torch.index_select(self.x, 0, nodes, out=x)
            batch = {
                'x': x,
                'rowptr': self._host(b.rowptr),
                'row': self._host(b.row),
                'col': self._host(b.col),
                'node_mask': self._host(b.node_mask),
                'num_seeds': len(seed_ids),
            }
            if b.batch is not None:
                batch['batch'] = self._host(b.batch)
            if self.y is not None:
                y = self._empty((nodes.shape[0], ) + tuple(self.y.shape[1:]),
                                self.y.dtype)
                batch['y'] = torch.index_select(self.y, 0, nodes, out=y)
        return batch, {**_phase_ms(sample, pad, gather),
                       'num_nodes': b.num_nodes, 'num_edges': b.num_edges,
                       'bucket': bi}


class HeteroNeighborLoader(_Pipeline):
    """Hetero mini-batches in the flattened R-GCN layout, through the same
    pipeline as :class:`NeighborLoader`.

    Args:
        rowptr_dict / col_dict: per-edge-type CSRs (host numpy).
        x_dict: node type -> ``[N_t, F]`` host features (one ``F``).
        y_dict: node type -> labels, or ``None``.
        seed_type / seeds: the seeds' node type and ids, one epoch.
        num_neighbors_dict: fanouts by edge type.
        node_budgets / max_edges: static padding budgets.

    Each batch: ``x [num_flat_nodes, F]`` (types at their offsets; pad
    rows repeat node 0 of their type), ``row``/``col``, ``rel_ptr``,
    ``edge_mask``, ``node_mask``, ``num_seeds``, and with labels of the
    seed type ``y`` and ``seed_offset``.
    """

    def __init__(self, rowptr_dict, col_dict, x_dict, y_dict, seed_type,
                 seeds, batch_size: int, num_neighbors_dict,
                 node_budgets: Dict[str, int], max_edges: int,
                 num_workers: int = 2, lookahead: int = 2, rng: int = 0,
                 device=None, drop_last: bool = True, **sample_kwargs):
        self._setup(seeds, batch_size, num_workers, lookahead, rng, device,
                    drop_last)
        self.rowptr_dict = {k: np.ascontiguousarray(v, np.int64)
                            for k, v in rowptr_dict.items()}
        self.col_dict = {k: np.ascontiguousarray(v, np.int64)
                         for k, v in col_dict.items()}
        self.x_dict = {t: torch.from_numpy(np.asarray(v))
                       for t, v in x_dict.items()}
        self.y_dict = (None if y_dict is None else
                       {t: np.asarray(v) for t, v in y_dict.items()})
        self.seed_type = seed_type
        self.num_neighbors_dict = {k: list(v)
                                   for k, v in num_neighbors_dict.items()}
        self.node_budgets = dict(node_budgets)
        self.max_edges = max_edges
        self.sample_kwargs = sample_kwargs

    def _make_batch(self, seed_ids: np.ndarray, stream: int):
        with profiling.span('sampler.sample', batch=stream) as sample:
            out = sampler.hetero_neighbor_sample(
                self.rowptr_dict, self.col_dict, {self.seed_type: seed_ids},
                self.num_neighbors_dict, rng=stream, **self.sample_kwargs)
        with profiling.span('sampler.pad', batch=stream) as pad:
            b = pad_hetero_sample_output(
                out, self.node_budgets, self.max_edges,
                csc=self.sample_kwargs.get('csc', False),
                disjoint=self.sample_kwargs.get('disjoint', False))
        num_nodes = int(sum(b.node_mask[t].sum() for t in b.type_offset))
        _count_padding(pad, b.row, num_nodes, b.num_edges, b.num_flat_nodes,
                       self.max_edges)
        with profiling.span('loader.gather', batch=stream) as gather:
            first = next(iter(self.x_dict.values()))
            x = self._empty((b.num_flat_nodes, first.shape[1]), first.dtype)
            for t, off in b.type_offset.items():
                bt = self.node_budgets[t]
                torch.index_select(self.x_dict[t], 0,
                                   torch.from_numpy(b.node_id[t]),
                                   out=x[off:off + bt])
            batch = {
                'x': x,
                'row': self._host(b.row),
                'col': self._host(b.col),
                'rel_ptr': self._host(b.rel_ptr),
                'edge_mask': self._host(b.edge_mask),
                'node_mask': self._host(np.concatenate(
                    [b.node_mask[t] for t in b.type_offset])),
                'num_seeds': len(seed_ids),
            }
            if b.batch and all(v is not None for v in b.batch.values()):
                batch['batch'] = self._host(np.concatenate(
                    [b.batch[t] for t in b.type_offset]))
            if self.y_dict is not None and self.seed_type in self.y_dict:
                batch['y'] = self._host(self.y_dict[self.seed_type][
                    b.node_id[self.seed_type]])
                batch['seed_offset'] = b.type_offset[self.seed_type]
        return batch, {**_phase_ms(sample, pad, gather),
                       'num_nodes': num_nodes, 'num_edges': b.num_edges}


class DistNeighborLoader(NeighborLoader):
    """:class:`NeighborLoader` over a partitioned graph: every batch runs
    the distributed protocol (sample -> merge -> relabel through
    :class:`~pyg_lib_tpu_torch.sampler.dist_service.DistNeighborSampler`)
    in place of the local sampler, with the same padded batches, the same
    pipeline and the same ``timings`` (``sample_ms`` is the protocol's).

    Batch ``i`` of epoch ``e`` is sampled by a coordinator seeded with its
    stream id, so batches do not depend on the threads' order, and the
    same ``rng`` gives the JAX package's batches bit for bit. Without
    ``max_nodes``, ``max_edges`` or ``buckets`` the batches take the
    worst-case single bucket (the probe of :class:`NeighborLoader` would
    sample a local graph, which there is not).

    Args:
        graph: a :class:`~pyg_lib_tpu_torch.sampler.dist_service.DistGraph`
            (``partition_graph``).
        x, y, seeds, batch_size, num_neighbors: as :class:`NeighborLoader`.
        replace, impl: the protocol's sampling options.
        **kw: the other :class:`NeighborLoader` arguments (``device``,
            ``num_workers``, ``rng``, budgets, ...).
    """

    def __init__(self, graph, x, y, seeds, batch_size: int,
                 num_neighbors: List[int], replace: bool = False,
                 impl: str = 'auto', **kw):
        from pyg_lib_tpu_torch.sampler.dist_service import DistGraph

        if not isinstance(graph, DistGraph):
            raise TypeError('DistNeighborLoader needs a DistGraph '
                            '(see sampler.dist_service.partition_graph)')
        if ('max_nodes' not in kw and 'max_edges' not in kw
                and 'buckets' not in kw):
            kw['max_nodes'], kw['max_edges'] = budget_for(
                batch_size, list(num_neighbors), slack=1.0)
        super().__init__(np.zeros(1, np.int64), np.zeros(0, np.int64), x,
                         y, seeds, batch_size, num_neighbors, **kw)
        self._graph = graph
        self._replace = replace
        self._impl = impl

    def _sample(self, seed_ids: np.ndarray, stream: int):
        from pyg_lib_tpu_torch.sampler.dist_service import DistNeighborSampler

        ds = DistNeighborSampler(self._graph, rng=stream,
                                 replace=self._replace, impl=self._impl)
        row, col, node_id, nph = ds.sample(seed_ids, self.num_neighbors)
        return row, col, node_id, None, nph, []
