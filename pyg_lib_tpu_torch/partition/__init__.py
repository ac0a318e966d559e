"""Graph partitioning (port of ``pyg_lib_tpu.partition``).

:func:`metis` (balanced multi-source BFS growth and greedy boundary
refinement, the JAX package's stand-in for METIS), :func:`edge_cut`,
:func:`cluster_reorder` (relabel nodes so each part is contiguous, which
``ops.build_spmm_graph(reorder=...)`` uses for locality of the gathers)
and the mesh partitions :func:`mesh_edge_partition` and
:func:`mesh_edge_partition_blocked`. Numpy on the host, logic unchanged;
growth, refinement and the edge cut go through the C++ engine
(``sampler._cpp``) unless ``metis`` is given ``impl='numpy'``, so the same
seed gives the JAX package's parts bit for bit.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np

from pyg_lib_tpu_torch.sampler import _cpp

__all__ = [
    'metis',
    'edge_cut', 'cluster_reorder', 'mesh_edge_partition', 'EdgePartition',
    'mesh_edge_partition_blocked', 'BlockedEdgePartition',
]


def cluster_reorder(rowptr, col, part, block_rows=None,
                    with_edge_perm=True, col_dtype=None):
    """Relabel nodes so each partition's ids are contiguous; permute CSR.

    On clustered graphs a partition-contiguous labeling concentrates each
    row tile's gather indices in one small region of the feature table,
    the classic use of the reference's ``pyg_lib.partition.metis`` for
    locality-optimised node orderings.

    Stable within partitions (relative order of same-partition nodes is
    preserved). Returns ``(new_rowptr, new_col, node_perm, edge_perm)``
    where ``node_perm[new_id] = old_id`` — so ``new_x = x[node_perm]``
    — and ``edge_perm`` maps new edge slots to old edge ids (for
    carrying edge weights/attributes along). Outputs in the new id
    space map back via ``out_old = out_new[rank]`` with
    ``rank = np.argsort(node_perm)``.

    Scale controls (papers100M-class audit, bench/bench_scale_audit.py):
    ``block_rows`` processes the permutation in row blocks, bounding the
    O(E) int64 temporaries (~24 bytes/edge otherwise — 24 GB at 1B
    edges) to ~24 bytes x block edges; ``with_edge_perm=False`` skips
    materialising ``edge_perm`` (returned as None); ``col_dtype``
    narrows the output column array (int32 halves it whenever
    ``num_nodes < 2**31``).
    """
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col)
    part = np.ascontiguousarray(part, np.int64)
    n = rowptr.shape[0] - 1
    if part.shape[0] != n:
        raise ValueError(f'part has {part.shape[0]} entries for {n} nodes')
    node_perm = np.argsort(part, kind='stable')  # new -> old
    rank_dtype = np.int32 if (col_dtype == np.int32 or
                              (col_dtype is None and n < 2**31 and
                               col.dtype == np.int32)) else np.int64
    rank = np.empty(n, rank_dtype)
    rank[node_perm] = np.arange(n, dtype=rank_dtype)
    deg = np.diff(rowptr)
    new_deg = deg[node_perm]
    new_rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(new_deg, out=new_rowptr[1:])
    e = int(new_rowptr[-1])
    new_col = np.empty(e, col_dtype or col.dtype)
    edge_perm = np.empty(e, np.int64) if with_edge_perm else None
    nb = n if not block_rows else int(block_rows)
    for lo in range(0, max(n, 1), nb):
        hi = min(lo + nb, n)
        nd = new_deg[lo:hi]
        # Old edge id of each new edge slot in this block: new row i
        # copies the old row node_perm[i]'s slice in order.
        base = np.repeat(rowptr[node_perm[lo:hi]], nd)
        o0, o1 = int(new_rowptr[lo]), int(new_rowptr[hi])
        within = (np.arange(o1 - o0, dtype=np.int64) -
                  np.repeat(new_rowptr[lo:hi] - o0, nd))
        ep = base + within
        new_col[o0:o1] = rank[col[ep]]
        if with_edge_perm:
            edge_perm[o0:o1] = ep
    return new_rowptr, new_col, node_perm, edge_perm


def edge_cut(rowptr, col, part, edge_weight=None) -> float:
    """Total weight of edges crossing partitions (each direction counted
    once as stored) — the quantity ``metis`` minimises."""
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    part = np.ascontiguousarray(part, np.int64)
    ew = None if edge_weight is None else np.ascontiguousarray(
        edge_weight, np.float64)
    return float(_cpp.edge_cut_cpp(rowptr, col, part, ew))


def _neighbors_of(rowptr, col, frontier):
    """All CSR slots of ``frontier`` rows, fully vectorised (no per-node
    Python loop — the pre-round-3 deque BFS spent minutes at 10M nodes)."""
    deg = rowptr[frontier + 1] - rowptr[frontier]
    total = int(deg.sum())
    if total == 0:
        return col[:0]
    cs = np.cumsum(deg)
    idx = np.arange(total) + np.repeat(
        rowptr[frontier] - np.concatenate(([0], cs[:-1])), deg)
    return col[idx]


def _grow(rowptr, col, nw, k, rng, nodes=None, targets=None):
    """Balanced multi-source BFS region growing over ``nodes`` (or all).

    Level-synchronous: each round every still-hungry part claims its
    whole unassigned frontier (a prefix of it when the weight target
    would overflow), so each round is O(frontier edges) numpy work and
    the total is O(E) — scale-shaped for 10M+ node graphs, unlike a
    node-at-a-time Python queue.

    ``targets`` optionally gives per-part weight targets (default equal
    shares) — recursive bisection needs PROPORTIONAL targets when the
    two sides must host unequal partition counts (odd k)."""
    n = len(rowptr) - 1
    sub = np.arange(n) if nodes is None else np.asarray(nodes)
    in_sub = np.zeros(n, bool)
    in_sub[sub] = True
    if targets is None:
        targets = np.full(k, nw[sub].sum() / k)
    part = np.full(n, -1, np.int64)
    load = np.zeros(k)
    seeds = rng.choice(sub, size=min(k, len(sub)), replace=False)
    frontiers = []
    for p, s in enumerate(seeds):
        part[s] = p
        load[p] = nw[s]
        frontiers.append(np.array([s], np.int64))
    for p in range(len(seeds), k):
        frontiers.append(np.zeros(0, np.int64))

    active = True
    while active:
        active = False
        for p in range(k):
            if load[p] >= targets[p] or len(frontiers[p]) == 0:
                frontiers[p] = frontiers[p][:0]
                continue
            nbrs = _neighbors_of(rowptr, col, frontiers[p])
            nbrs = nbrs[in_sub[nbrs] & (part[nbrs] < 0)]
            if len(nbrs) == 0:
                frontiers[p] = frontiers[p][:0]
                continue
            nbrs = np.unique(nbrs)  # claim each node once
            # Prefix-take up to the remaining weight target.
            w_cum = np.cumsum(nw[nbrs])
            take = int(np.searchsorted(w_cum, targets[p] - load[p]) + 1)
            nbrs = nbrs[:take]
            part[nbrs] = p
            load[p] += float(nw[nbrs].sum())
            frontiers[p] = nbrs
            active = True

    left = sub[part[sub] < 0]
    if len(left):
        # Fill deficits in one vectorised pass: split the leftover run
        # into contiguous chunks proportional to each part's remaining
        # weight headroom (argmin-per-node was O(n) Python at scale).
        deficit = np.maximum(targets - load, 0.0)
        if deficit.sum() <= 0:
            deficit = np.ones(k)
        w_cum = np.cumsum(nw[left])
        bounds = np.cumsum(deficit) / deficit.sum() * w_cum[-1]
        assign = np.searchsorted(bounds, w_cum, side='left')
        assign = np.minimum(assign, k - 1)
        part[left] = assign
        load += np.bincount(assign, weights=nw[left], minlength=k)
    return part[sub], load


def _refine(rowptr, col, nw, ew, part, k, passes=2, balance=1.05):
    """Greedy boundary refinement: move a node to the partition holding
    most of its (weighted) incident edges when balance permits — a
    single-sweep Kernighan–Lin flavour that also gives ``edge_weight``
    its METIS meaning (weighted cut minimisation).

    Boundary-only and sparse: per pass this touches O(edges incident to
    boundary nodes) memory, never an ``[n, k]`` gain matrix (which at
    papers100M scale, 100M x 16 f64, would be 12.8 GB — the round-2
    implementation could not run at the size the partitioner exists
    for).  Interior nodes (every neighbor in their own part) can only
    lose from moving, so skipping them is exact, not approximate."""
    n = len(rowptr) - 1
    row = np.repeat(np.arange(n), np.diff(rowptr))
    load = np.bincount(part, weights=nw, minlength=k)
    cap = nw.sum() / k * balance
    for _ in range(passes):
        cross = part[row] != part[col]
        if not cross.any():
            break
        is_b = np.zeros(n, bool)
        is_b[row[cross]] = True
        sel = np.nonzero(is_b[row])[0]  # ALL edges of boundary nodes
        r, cp, w = row[sel], part[col[sel]], ew[sel]
        # Group incident weight by (node, neighbor part). CSR rows are
        # contiguous so `r` is sorted; a stable key sort keeps it so.
        key = r * k + cp
        order = np.argsort(key, kind='stable')
        key = key[order]
        uniq, start = np.unique(key, return_index=True)
        sums = np.add.reduceat(w[order], start)
        node_of, part_of = uniq // k, uniq % k
        # Per node: strongest partition and the weight in the current
        # one (groups of `node_of` are contiguous).
        nstart = np.unique(node_of, return_index=True)[1]
        best_in_group = np.maximum.reduceat(sums, nstart)
        cand_nodes = node_of[nstart]
        own = np.zeros(len(cand_nodes))
        own_mask = part_of == part[node_of]
        own_pos = np.searchsorted(cand_nodes, node_of[own_mask])
        own[own_pos] = sums[own_mask]
        # Recover WHICH partition attains the max: the FIRST hit per
        # group (lowest part id — the old argmax tie-break).
        grp = np.searchsorted(nstart, np.arange(len(sums)), side='right') - 1
        hit = sums == best_in_group[grp]
        first_hit = np.full(len(cand_nodes), len(sums), np.int64)
        np.minimum.at(first_hit, grp[hit], np.nonzero(hit)[0])
        best_part = part_of[first_hit]

        movers = np.nonzero(best_in_group > own)[0]
        moved = 0
        # The move loop stays sequential (each move changes loads), but
        # runs over boundary candidates only.
        for j in movers:
            v = int(cand_nodes[j])
            p_old, p_new = int(part[v]), int(best_part[j])
            if p_new == p_old or load[p_new] + nw[v] > cap:
                continue
            part[v] = p_new
            load[p_old] -= nw[v]
            load[p_new] += nw[v]
            moved += 1
        if not moved:
            break
    return part


def _grow_any(rowptr, col, nw, k, rng, nodes=None, targets=None,
              use_cpp=False):
    """Dispatch growth to the C++ fast path (zero O(E) temporaries) or
    the numpy specification. Same contract as :func:`_grow`; the random
    seeds are drawn HERE from ``rng`` so both paths consume the stream
    identically."""
    if not use_cpp:
        return _grow(rowptr, col, nw, k, rng, nodes, targets)
    n = len(rowptr) - 1
    sub = None if nodes is None else np.ascontiguousarray(nodes, np.int64)
    pool = np.arange(n) if sub is None else sub
    if targets is None:
        targets = np.full(k, nw[pool].sum() / k)
    seeds = np.ascontiguousarray(
        rng.choice(pool, size=min(k, len(pool)), replace=False), np.int64)
    part = np.full(n, -1, np.int64)
    load = np.zeros(k, np.float64)
    _cpp.part_grow_cpp(rowptr, col, np.ascontiguousarray(nw, np.float64),
                       k, np.ascontiguousarray(targets, np.float64), sub,
                       seeds, part, load)
    return part[pool], load


def metis(rowptr, col, num_partitions: int, node_weight=None,
          edge_weight=None, recursive: bool = False,
          seed: int = 0, impl: str = 'auto') -> np.ndarray:
    """Partitions a graph into ``num_partitions`` parts, minimising
    (weighted) edge cut.  API parity: reference ``pyg_lib.partition.metis``
    (``pyg_lib/partition/__init__.py:7-39``).

    Implementation: balanced multi-source BFS region growing + greedy
    boundary refinement — not METIS itself, as in the JAX package.
    ``recursive=True`` selects recursive bisection like METIS's
    ``PartGraphRecursive`` (repeated 2-way growth), ``False`` direct
    k-way; :func:`edge_cut` reports the cut.

    ``impl``: 'cpp' and its alias 'auto' run the C++ engine (no O(E)
    temporaries; a failed build raises, where the JAX package's 'auto'
    runs numpy), 'numpy' the specification. The two make identical seed
    draws but may diverge in BFS claim order; both satisfy the same
    balance and quality contracts.
    """
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    n = len(rowptr) - 1
    nw = (np.ones(n) if node_weight is None else np.ascontiguousarray(
        node_weight, np.float64))
    # ew stays None for unit weights: the native kernels treat a null
    # pointer as weight 1.0, and an O(E) float64 ones array is 8 GB at
    # the papers100M scale the cpp path exists for (scale audit).
    ew = (None if edge_weight is None else
          np.ascontiguousarray(edge_weight, np.float64))
    k = num_partitions
    if k <= 1:
        return np.zeros(n, np.int64)
    rng = np.random.default_rng(seed)

    if impl not in ('auto', 'cpp', 'numpy'):
        raise ValueError(f"impl must be 'auto', 'cpp' or 'numpy', got "
                         f'{impl!r}')
    use_cpp = impl != 'numpy'

    if recursive and k > 2:
        # Recursive bisection: split k into halves with proportional
        # weight targets, recurse on each side's induced node set.
        part = np.zeros(n, np.int64)

        def bisect(nodes, k_lo, k_hi, offset):
            if k_hi - k_lo == 1:
                part[nodes] = offset
                return
            mid = (k_lo + k_hi) // 2
            # Proportional weight targets: odd k puts more partitions
            # (hence more weight) on one side; a 50/50 bisection would
            # leave that side's partitions ~2x overloaded.
            w = nw[nodes].sum()
            frac = (mid - k_lo) / (k_hi - k_lo)
            sub_part, _ = _grow_any(rowptr, col, nw, 2, rng, nodes,
                                    targets=np.array([frac, 1.0 - frac]) * w,
                                    use_cpp=use_cpp)
            left = nodes[sub_part == 0]
            right = nodes[sub_part == 1]
            bisect(left, k_lo, mid, offset)
            bisect(right, mid, k_hi, offset + (mid - k_lo))

        bisect(np.arange(n), 0, k, 0)
    else:
        part, _ = _grow_any(rowptr, col, nw, k, rng, use_cpp=use_cpp)
    if use_cpp:
        part = np.ascontiguousarray(part, np.int64)
        _cpp.part_refine_cpp(rowptr, col, nw, ew, part, k, 2, 1.05)
        return part
    if ew is None:
        ew = np.ones(len(col))
    return _refine(rowptr, col, nw, ew, part, k)


class EdgePartition(NamedTuple):
    """Per-device edge partition for a halo-exchange aggregation
    (``parallel.halo_exchange_aggregate``: rank ``i`` takes row ``i`` of
    ``rowptr`` and ``src_ids``).

    ``num_nodes_padded`` is ``D * nodes_per_device``; node ``v`` lives on
    device ``v // nodes_per_device``.
    """
    rowptr: np.ndarray  # [D, nodes_per_device + 1] local CSR over dst
    src_ids: np.ndarray  # [D, E_max] global source ids (padded)
    edge_mask: np.ndarray  # [D, E_max] bool
    num_nodes_padded: int
    nodes_per_device: int


def mesh_edge_partition(rowptr, col, num_devices: int) -> EdgePartition:
    """Range-partitions destinations across ``num_devices`` and splits the
    CSR so each device owns the incoming edges of its node range — the
    layout consumed by a halo all-to-all.

    Input ``(rowptr, col)`` is interpreted as the *destination-major* CSR
    (``rowptr`` over destinations, ``col`` = global source ids) — i.e. the
    transpose/CSC of an outgoing-edge graph, which is the natural layout
    for incoming-edge aggregation.
    """
    rowptr = np.asarray(rowptr)
    col = np.asarray(col)
    n = len(rowptr) - 1
    d = num_devices
    npd = -(-n // d)  # nodes per device (ceil)
    n_pad = npd * d

    e_counts = []
    for i in range(d):
        lo = min(i * npd, n)
        hi = min((i + 1) * npd, n)
        e_counts.append(int(rowptr[hi] - rowptr[lo]))
    e_max = max(max(e_counts), 1)
    # Round up for clean tiling.
    e_max = ((e_max + 127) // 128) * 128

    out_rowptr = np.zeros((d, npd + 1), np.int32)
    out_src = np.zeros((d, e_max), np.int32)
    mask = np.zeros((d, e_max), bool)
    for i in range(d):
        lo = min(i * npd, n)
        hi = min((i + 1) * npd, n)
        base = int(rowptr[lo])
        cnt = int(rowptr[hi]) - base
        local_ptr = rowptr[lo:hi + 1] - base
        out_rowptr[i, :len(local_ptr)] = local_ptr
        out_rowptr[i, len(local_ptr):] = cnt
        out_src[i, :cnt] = col[base:base + cnt]
        # pad slots: point at node 0; they sit past rowptr[-1] so segment
        # ops drop them.
        mask[i, :cnt] = True
    return EdgePartition(out_rowptr, out_src, mask, n_pad, npd)


class BlockedEdgePartition(NamedTuple):
    """Per-(device, source-block) sub-CSRs for the ring halo exchange
    (``parallel.ring_halo_aggregate``: rank ``i`` takes row ``i`` of
    ``rowptr_blk`` and ``src_blk``).

    Device ``i`` owns destinations ``[i*npd, (i+1)*npd)``; its edges are
    split by source block ``b = src // npd`` into ``D`` sub-CSRs so that
    ring step ``s`` (holding source block ``(i+s) % D``) touches exactly
    the edges whose sources that block provides — every edge is processed
    once across the ring.
    """
    rowptr_blk: np.ndarray  # [D, D, npd+1] int32; [i, b] = sub-CSR of (i, b)
    src_blk: np.ndarray  # [D, D, E_blk_max] int32 block-LOCAL source ids
    num_nodes_padded: int
    nodes_per_device: int


def mesh_edge_partition_blocked(rowptr, col,
                                num_devices: int) -> BlockedEdgePartition:
    """Range-partitions destinations AND groups each device's edges by
    source block — the all-static-shape layout for overlap-friendly ring
    aggregation.  Same CSC input convention as :func:`mesh_edge_partition`.
    """
    rowptr = np.asarray(rowptr, np.int64)
    col = np.asarray(col, np.int64)
    n = len(rowptr) - 1
    d = num_devices
    npd = -(-n // d)
    n_pad = npd * d

    # Per (device, block): build sub-CSR.
    sub_ptrs = np.zeros((d, d, npd + 1), np.int64)
    sub_srcs: list = [[None] * d for _ in range(d)]
    for i in range(d):
        lo = min(i * npd, n)
        hi = min((i + 1) * npd, n)
        base = int(rowptr[lo])
        cnt = int(rowptr[hi]) - base
        local_ptr = (rowptr[lo:hi + 1] - base).astype(np.int64)
        srcs = col[base:base + cnt]
        blocks = np.minimum(srcs // npd, d - 1)
        dst_of_edge = np.repeat(
            np.arange(hi - lo),
            np.diff(local_ptr)) if cnt else np.zeros(0, np.int64)
        for b in range(d):
            sel = blocks == b
            e_sel = np.nonzero(sel)[0]
            # counts per local dst for this block
            cnts = np.bincount(dst_of_edge[e_sel], minlength=npd) \
                if cnt else np.zeros(npd, np.int64)
            sub_ptrs[i, b, 1:] = np.cumsum(cnts)
            sub_srcs[i][b] = (srcs[e_sel] - b * npd).astype(np.int32)

    e_blk_max = max(
        max((len(sub_srcs[i][b]) for i in range(d) for b in range(d)),
            default=0), 1)
    e_blk_max = ((e_blk_max + 127) // 128) * 128
    src_blk = np.zeros((d, d, e_blk_max), np.int32)
    for i in range(d):
        for b in range(d):
            s = sub_srcs[i][b]
            src_blk[i, b, :len(s)] = s
    return BlockedEdgePartition(sub_ptrs.astype(np.int32), src_blk, n_pad,
                                npd)
