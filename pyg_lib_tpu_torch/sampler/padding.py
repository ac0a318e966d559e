"""Padding and bucketing: ragged sampler output to fixed-shape batches.

Port of ``pyg_lib_tpu/sampler/padding.py`` (numpy, logic unchanged). On
the card a fixed shape lets a step reuse its allocations and plans; the
contracts are the JAX package's:

* Budgets are static upper bounds; exceeding one raises
  :class:`BudgetExceeded` so the caller can re-bucket (edges are never
  silently dropped).
* The padded CSR's ``rowptr[-1]`` equals the true edge count, so
  ``segment_*_csr`` (kernel K3 on the card) drops trailing pad positions;
  COO pad slots carry ``index == max_nodes``, out of range of a
  ``[max_nodes]`` target.
* Node padding repeats node 0 with ``node_mask`` False; masked rows must
  be excluded from losses by the caller.
"""

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    'BudgetExceeded',
    'PaddedBatch',
    'PaddedHeteroBatch',
    'budget_for',
    'bucket_ladder',
    'pad_sample_output',
    'pad_hetero_sample_output',
    'to_padded_csr',
]


class BudgetExceeded(ValueError):
    """Raised when a sample exceeds its static padding budget; the caller
    should retry with the next bucket size (never drop edges)."""


def budget_for(num_seeds: int, fanouts: List[int],
               slack: float = 1.0) -> Tuple[int, int]:
    """Worst-case (max_nodes, max_edges) for ``num_seeds`` seeds and the
    given per-hop fanouts (entries must be >= 0)."""
    if any(f < 0 for f in fanouts):
        raise ValueError('budget_for needs non-negative fanouts')
    nodes, frontier, edges = num_seeds, num_seeds, 0
    for f in fanouts:
        frontier *= f
        nodes += frontier
        edges += frontier
    return (int(math.ceil(nodes * slack)), int(math.ceil(edges * slack)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_ladder(base_nodes: int, base_edges: int, worst_nodes: int,
                  worst_edges: int) -> List[Tuple[int, int]]:
    """Ascending ``(max_nodes, max_edges)`` buckets: the base (sized from
    measured batch statistics), power-of-two steps up, and ALWAYS the
    worst case last — so overflow recovery is lossless no matter how
    adversarial a batch is (re-bucket, never drop edges). A well-chosen
    base keeps realistic runs inside the first bucket."""
    base_nodes = min(_round_up(max(base_nodes, 8), 8), worst_nodes)
    base_edges = min(_round_up(max(base_edges, 8), 8), worst_edges)
    ladder = [(base_nodes, base_edges)]
    n, e = base_nodes, base_edges
    while n < worst_nodes or e < worst_edges:
        n = min(n * 2, worst_nodes)
        e = min(e * 2, worst_edges)
        ladder.append((n, e))
    return ladder


@dataclass
class PaddedBatch:
    """Fixed-shape mini-batch.

    ``row``/``col`` are local ids into ``node_id``; pad edge slots have
    ``row == col == max_nodes`` (one past the last PADDED slot — always
    out of range; test realness with ``edge_mask``, or compare against
    ``max_nodes``, NOT the true ``num_nodes``).  ``rowptr`` is
    the padded-CSR pointer over ``col``-sorted edges (shape
    ``[max_nodes+1]``, ``rowptr[-1] == num_edges``) for
    ``segment_*_csr`` aggregation of incoming edges per destination node.
    """
    node_id: np.ndarray  # [max_nodes] int, padded with 0
    batch: Optional[np.ndarray]  # [max_nodes] int (disjoint) or None
    row: np.ndarray  # [max_edges] int (src local id, CSR-sorted by dst)
    col: np.ndarray  # [max_edges] int (dst local id, sorted)
    edge_id: Optional[np.ndarray]  # [max_edges] int or None
    rowptr: np.ndarray  # [max_nodes+1] int
    node_mask: np.ndarray  # [max_nodes] bool
    edge_mask: np.ndarray  # [max_edges] bool
    num_nodes: int
    num_edges: int
    num_sampled_nodes_per_hop: List[int]
    num_sampled_edges_per_hop: List[int]
    num_seeds: int


def to_padded_csr(row: np.ndarray, col: np.ndarray, num_nodes: int,
                  max_nodes: int, max_edges: int,
                  edge_id: Optional[np.ndarray] = None):
    """Sorts edges by ``col`` (destination) and emits a padded CSR over
    destinations: ``rowptr [max_nodes+1]``, permuted ``row``/``edge_id``.

    Pad slots (positions >= len(col)) get src/dst ``max_nodes`` so any
    direct COO use also drops them.
    """
    e = len(col)
    if e > max_edges:
        raise BudgetExceeded(f'{e} edges > budget {max_edges}')
    if num_nodes > max_nodes:
        raise BudgetExceeded(f'{num_nodes} nodes > budget {max_nodes}')
    perm = np.argsort(col, kind='stable')
    sorted_col = col[perm]
    counts = np.bincount(sorted_col, minlength=max_nodes)
    rowptr = np.zeros(max_nodes + 1, np.int32)
    rowptr[1:] = np.cumsum(counts)
    out_row = np.full(max_edges, max_nodes, np.int32)
    out_col = np.full(max_edges, max_nodes, np.int32)
    out_row[:e] = row[perm]
    out_col[:e] = sorted_col
    out_eid = None
    if edge_id is not None:
        out_eid = np.full(max_edges, -1, np.int64)
        out_eid[:e] = edge_id[perm]
    return rowptr, out_row, out_col, out_eid


@dataclass
class PaddedHeteroBatch:
    """Fixed-shape heterogeneous mini-batch in the flattened R-GCN layout.

    Node types are packed into one flat local id space: type ``t`` occupies
    locals ``[type_offset[t], type_offset[t] + type_budget[t])`` (actual
    nodes first, then padding).  Edges are concatenated by edge type
    (relation); ``rel_ptr [R+1]`` bounds each relation's block — exactly
    what :func:`pyg_lib_tpu_torch.models.rgcn_forward` and
    :func:`pyg_lib_tpu_torch.ops.segment_matmul` consume.  Pad edges carry
    ``row == col == num_flat_nodes``.
    """
    node_id: dict  # type -> [budget_t] global ids (padded with 0)
    node_mask: dict  # type -> [budget_t] bool
    batch: dict  # type -> [budget_t] int32 or None
    type_offset: dict  # type -> int
    edge_types: list  # ordered relations
    row: np.ndarray  # [max_edges] flat src local ids (relation-sorted)
    col: np.ndarray  # [max_edges] flat dst local ids
    edge_id: Optional[np.ndarray]
    rel_ptr: np.ndarray  # [R+1]
    edge_mask: np.ndarray
    num_flat_nodes: int
    num_edges: int


def pad_hetero_sample_output(sample_out, node_budgets, max_edges: int,
                             csc: bool = False,
                             disjoint: bool = False) -> PaddedHeteroBatch:
    """Pads the output of
    :func:`pyg_lib_tpu_torch.sampler.hetero_neighbor_sample`
    into the flattened relation-blocked layout for R-GCN-style models.

    Args:
        sample_out: the 6-tuple from ``hetero_neighbor_sample``.
        node_budgets: dict node type -> static budget.
        max_edges: static total edge budget (all relations combined).
    """
    row_d, col_d, node_d, eid_d, _, _ = sample_out
    edge_types = list(row_d.keys())
    src_of = (lambda k: k[0]) if not csc else (lambda k: k[2])
    dst_of = (lambda k: k[2]) if not csc else (lambda k: k[0])

    type_offset, off = {}, 0
    node_id, node_mask, batch = {}, {}, {}
    for t, budget in node_budgets.items():
        ids = node_d.get(t)
        if ids is None:
            ids = np.zeros((0, 2) if disjoint else (0, ), np.int64)
        n = len(ids)
        if n > budget:
            raise BudgetExceeded(f'{n} {t!r} nodes > budget {budget}')
        nid = np.zeros(budget, np.int64)
        bt = None
        if disjoint:
            nid[:n] = ids[:, 1]
            bt = np.full(budget, -1, np.int32)
            bt[:n] = ids[:, 0]
        else:
            nid[:n] = ids
        mask = np.zeros(budget, bool)
        mask[:n] = True
        node_id[t], node_mask[t], batch[t] = nid, mask, bt
        type_offset[t] = off
        off += budget
    num_flat = off

    rows, cols, eids = [], [], []
    rel_ptr = [0]
    for k in edge_types:
        src, dst = src_of(k), dst_of(k)
        if src not in type_offset or dst not in type_offset:
            raise ValueError(f'missing node budget for edge type {k}')
        # row_d is already (row, col) in caller orientation; flat-offset
        # it. The csc swap in src_of/dst_of and the conditional here
        # cancel exactly: rows always offset by the tuple's first type,
        # cols by its third (the impl swaps its OUTPUT orientation, not
        # the edge-type key; see _hetero_impl.py).
        r = np.asarray(row_d[k]) + type_offset[k[0]]
        c = np.asarray(col_d[k]) + type_offset[k[2]]
        rows.append(r)
        cols.append(c)
        if eid_d is not None:
            eids.append(np.asarray(eid_d[k]))
        rel_ptr.append(rel_ptr[-1] + len(r))
    e = rel_ptr[-1]
    if e > max_edges:
        raise BudgetExceeded(f'{e} edges > budget {max_edges}')
    row = np.full(max_edges, num_flat, np.int32)
    col = np.full(max_edges, num_flat, np.int32)
    row[:e] = np.concatenate(rows) if rows else []
    col[:e] = np.concatenate(cols) if cols else []
    eid = None
    if eid_d is not None:
        eid = np.full(max_edges, -1, np.int64)
        if eids:
            eid[:e] = np.concatenate(eids)
    edge_mask = np.zeros(max_edges, bool)
    edge_mask[:e] = True
    # Final rel_ptr entry covers the pad block so segment_matmul sees a
    # ptr[-1] == real edge count (pad rows produce zero output rows).
    return PaddedHeteroBatch(
        node_id=node_id, node_mask=node_mask, batch=batch,
        type_offset=type_offset, edge_types=edge_types, row=row, col=col,
        edge_id=eid, rel_ptr=np.asarray(rel_ptr, np.int32),
        edge_mask=edge_mask, num_flat_nodes=num_flat, num_edges=e)


def pad_sample_output(sample_out, max_nodes: int, max_edges: int,
                      num_seeds: int,
                      disjoint: bool = False) -> PaddedBatch:
    """Pads the output tuple of
    :func:`pyg_lib_tpu_torch.sampler.neighbor_sample` to static shapes."""
    row, col, node_id, edge_id, nnph, neph = sample_out
    if disjoint:
        batch = node_id[:, 0].astype(np.int32)
        nodes = node_id[:, 1]
    else:
        batch = None
        nodes = node_id
    n, e = len(nodes), len(row)
    if n > max_nodes:
        raise BudgetExceeded(f'{n} nodes > budget {max_nodes}')
    if e > max_edges:
        raise BudgetExceeded(f'{e} edges > budget {max_edges}')

    node_id_p = np.zeros(max_nodes, dtype=np.int64)
    node_id_p[:n] = nodes
    node_mask = np.zeros(max_nodes, bool)
    node_mask[:n] = True
    batch_p = None
    if batch is not None:
        batch_p = np.full(max_nodes, -1, np.int32)
        batch_p[:n] = batch

    rowptr, row_p, col_p, eid_p = to_padded_csr(
        np.asarray(row), np.asarray(col), n, max_nodes, max_edges, edge_id)
    edge_mask = np.zeros(max_edges, bool)
    edge_mask[:e] = True

    return PaddedBatch(
        node_id=node_id_p, batch=batch_p, row=row_p, col=col_p,
        edge_id=eid_p, rowptr=rowptr, node_mask=node_mask,
        edge_mask=edge_mask, num_nodes=n, num_edges=e,
        num_sampled_nodes_per_hop=list(nnph),
        num_sampled_edges_per_hop=list(neph), num_seeds=num_seeds)
