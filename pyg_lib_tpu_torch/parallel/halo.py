"""Edge-partitioned aggregation with halo feature exchange (port of
``pyg_lib_tpu/parallel/halo.py``).

Partition layout (``partition.mesh_edge_partition`` and
``mesh_edge_partition_blocked``): rank ``i`` of the mesh axis owns node
rows ``[i * npd, (i + 1) * npd)`` of the features and the edges whose
destination falls in them, as a CSR over its local destinations with
global source ids, padded to a common edge count. Pad slots lie past the
CSR's last pointer, so the segment sum (kernel K3 on the card) never
reads them.

The JAX functions take the global arrays sharded over the axis and run
one program per device inside ``shard_map``; these take one rank's shard
and run in every rank of the axis's process group. Each differentiates
as its JAX counterpart does: the all-gather's gradient is a
reduce-scatter back to the owners, and the ring's gradient runs the ring
the other way. The collectives go through ``parallel._collectives``
(pinned host memory for CUDA tensors on a gloo group).
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pyg_lib_tpu_torch.ops.segment_csr import gather_csr_impl, segment_sum_csr
from pyg_lib_tpu_torch.parallel import _collectives as C

__all__ = ['halo_exchange_aggregate', 'ring_halo_aggregate']


class _AllGather(torch.autograd.Function):
    """All-gather of the rows; its gradient sums every rank's cotangent of
    the gathered matrix and hands each owner its rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return C.reduce_scatter(g, ctx.group), None


def halo_exchange_aggregate(mesh: DeviceMesh, x: torch.Tensor,
                            src_ids: torch.Tensor, rowptr: torch.Tensor,
                            axis: str = 'data') -> torch.Tensor:
    """Per-destination sums of source features across an edge-partitioned
    graph, in one rank of ``mesh``'s ``axis``.

    Args:
        mesh: a mesh (``parallel.make_mesh``) with the axis ``axis``.
        x: ``[N / D, F]`` this rank's node rows.
        src_ids: ``[E_max]`` global source ids of this rank's edges (row
            ``i`` of ``mesh_edge_partition``'s ``src_ids`` for rank ``i``;
            pad slots past ``rowptr[-1]``).
        rowptr: ``[N / D + 1]`` this rank's local CSR pointers.

    Returns:
        ``[N / D, F]`` this rank's rows of the sums. All ranks of the axis
        call it together: the source rows arrive by one all-gather (the
        full halo), then the rank gathers its edges' messages and sums
        them with ``segment_sum_csr`` (K3 on the card).
    """
    group = mesh.get_group(axis)
    xg = _AllGather.apply(x, group)  # [N, F]
    msgs = xg.index_select(0, src_ids.clamp(max=xg.shape[0] - 1))
    return segment_sum_csr(msgs, rowptr)


def _consume(blk, rowptr_blk, src_blk, owner):
    """Sums of the messages of the edges fed by source block ``owner``."""
    src = src_blk[owner].clamp(max=blk.shape[0] - 1)
    return segment_sum_csr(blk.index_select(0, src), rowptr_blk[owner])


def _block_grad(g, rowptr_blk, src_blk, owner):
    """The gradient of :func:`_consume` with respect to its block, for the
    cotangent ``g`` of its sums."""
    ptr, src = rowptr_blk[owner], src_blk[owner]
    gm = gather_csr_impl(g, ptr, src.shape[0])  # zeros at pad slots
    return torch.zeros_like(g).index_add_(
        0, src.clamp(max=g.shape[0] - 1).long(), gm)


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, rowptr_blk, src_blk, group):
        d, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.save_for_backward(rowptr_blk, src_blk)
        ctx.group = group
        blk = x.contiguous()
        # After s shifts the rank holds block (me + s) % D. The next
        # block's transfer is posted before the current one is consumed,
        # so the copy overlaps the gather and K3.
        shift = C.ring_shift(blk, (me - 1) % d, (me + 1) % d, group) \
            if d > 1 else None
        acc = _consume(blk, rowptr_blk, src_blk, me)
        for s in range(1, d):
            blk = shift.wait()
            if s < d - 1:
                shift = C.ring_shift(blk, (me - 1) % d, (me + 1) % d, group)
            acc = acc + _consume(blk, rowptr_blk, src_blk, (me + s) % d)
        return acc

    @staticmethod
    def backward(ctx, g):
        rowptr_blk, src_blk = ctx.saved_tensors
        group = ctx.group
        d, me = dist.get_world_size(group), dist.get_rank(group)
        g = g.contiguous()
        # The cotangent of the block held at step s goes back to the rank
        # it came from (me + 1), where it joins that rank's step s - 1.
        carry = _block_grad(g, rowptr_blk, src_blk, (me + d - 1) % d)
        for s in range(d - 1, 0, -1):
            shift = C.ring_shift(carry, (me + 1) % d, (me - 1) % d, group)
            local = _block_grad(g, rowptr_blk, src_blk, (me + s - 1) % d)
            carry = local + shift.wait()
        return carry, None, None, None


def ring_halo_aggregate(mesh: DeviceMesh, x: torch.Tensor,
                        part_rowptr_blk: torch.Tensor,
                        part_src_blk: torch.Tensor,
                        axis: str = 'data') -> torch.Tensor:
    """Ring-overlapped edge-partitioned aggregation, in one rank of
    ``mesh``'s ``axis`` (size D): source blocks travel round the ring
    while each rank sums the sub-CSR of the edges fed by the block it
    holds. A rank holds one remote block at a time, where
    :func:`halo_exchange_aggregate` holds the whole feature matrix.

    Args:
        mesh: a mesh with the axis ``axis``.
        x: ``[npd, F]`` this rank's node rows (``N = D * npd``).
        part_rowptr_blk: ``[D, npd + 1]`` this rank's sub-CSR pointers, one
            per source block (row ``i`` of
            ``partition.mesh_edge_partition_blocked``'s ``rowptr_blk``).
        part_src_blk: ``[D, E_blk_max]`` block-local source ids.

    Returns:
        ``[npd, F]`` this rank's rows of the sums. In step ``s`` the rank
        sends its block to rank ``(me - 1) % D`` and receives block
        ``(me + s) % D`` from rank ``(me + 1) % D``, as JAX's ``ppermute``
        with ``perm = [(j, (j - 1) % D)]``.
    """
    return _Ring.apply(x, part_rowptr_blk, part_src_blk,
                       mesh.get_group(axis))
