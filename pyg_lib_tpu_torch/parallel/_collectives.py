"""The collectives of the distribution layer, on the backend that the
caller's process group was made with.

NCCL takes CUDA tensors as they are. Gloo reduces host memory, so a CUDA
tensor on a gloo group is copied into page-locked (pinned) host memory,
the collective runs there, and the result is copied back to the card. The
choice follows the group's backend (``dist.get_backend(group)``), the one
the caller named when it made the group; nothing here catches a failed
collective to try another way. The compute stays on the card either way:
only the bytes a collective moves pass through the host.

``stats`` keeps each kind's host-clock ms and calls while ``timing`` is
on (``set_timing(True)``): ``all_gather``, ``reduce_scatter``, ``ring``
(a ring step's send and receive, from posting them to their end),
``all_reduce``, and ``staging``, the copies between the card
and pinned memory, which are counted there and not in the collective's
own ms. Timing synchronises the card around each collective, so it is
off unless a caller asks for it.
"""

import time
from contextlib import contextmanager
from typing import Dict, List

import torch
import torch.distributed as dist

__all__ = ['all_gather', 'all_reduce_', 'reduce_scatter', 'reset_stats',
           'ring_shift', 'set_timing', 'staged', 'stats']

KINDS = ('all_gather', 'reduce_scatter', 'ring', 'all_reduce', 'staging')
stats: Dict[str, List[float]] = {k: [0.0, 0] for k in KINDS}
_timing = False


def set_timing(on: bool) -> None:
    global _timing
    _timing = bool(on)


def reset_stats() -> None:
    for k in KINDS:
        stats[k] = [0.0, 0]


def staged(x: torch.Tensor, group=None) -> bool:
    """Whether a collective of ``x`` on ``group`` goes through pinned host
    memory: a CUDA tensor on a group whose backend is not NCCL."""
    return x.is_cuda and dist.get_backend(group) != 'nccl'


def _sync(x: torch.Tensor) -> None:
    if _timing and x.is_cuda:
        torch.cuda.synchronize(x.device)


@contextmanager
def _timed(kind: str, x: torch.Tensor):
    if not _timing:
        yield
        return
    _sync(x)
    t0 = time.perf_counter()
    yield
    _sync(x)
    stats[kind][0] += (time.perf_counter() - t0) * 1e3
    stats[kind][1] += 1


def _to_host(x: torch.Tensor) -> torch.Tensor:
    with _timed('staging', x):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
    return host


def _to_card(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    with _timed('staging', like):
        return host.to(like.device, non_blocking=True)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``[D * n, ...]``: every rank's ``x`` (``[n, ...]``) in rank order."""
    x = x.contiguous()
    d = dist.get_world_size(group)
    if staged(x, group):
        host = _to_host(x)
        out = torch.empty((d * x.shape[0], ) + tuple(x.shape[1:]),
                          dtype=x.dtype, pin_memory=True)
        with _timed('all_gather', host):
            dist.all_gather_into_tensor(out, host, group=group)
        return _to_card(out, x)
    out = x.new_empty((d * x.shape[0], ) + tuple(x.shape[1:]))
    with _timed('all_gather', x):
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's ``[n / D, ...]`` block of the sum of every rank's ``x``
    (``[n, ...]``, ``n`` a multiple of the group's size)."""
    x = x.contiguous()
    d = dist.get_world_size(group)
    if x.shape[0] % d:
        raise ValueError(f'reduce_scatter: {x.shape[0]} rows do not split '
                         f'over {d} ranks')
    shape = (x.shape[0] // d, ) + tuple(x.shape[1:])
    if staged(x, group):
        host = _to_host(x)
        out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
        with _timed('reduce_scatter', host):
            dist.reduce_scatter_tensor(out, host, group=group)
        return _to_card(out, x)
    out = x.new_empty(shape)
    with _timed('reduce_scatter', x):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce_(x: torch.Tensor, group=None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over ``group`` in place; returns ``x``."""
    if staged(x, group):
        host = _to_host(x)
        with _timed('all_reduce', host):
            dist.all_reduce(host, op=op, group=group)
        with _timed('staging', x):
            x.copy_(host, non_blocking=True)
        return x
    with _timed('all_reduce', x):
        dist.all_reduce(x, op=op, group=group)
    return x


class _Shift:
    """A ring step in flight: :meth:`wait` returns the received block on
    the sender's device."""

    def __init__(self, works, recv, like, t0):
        self._works, self._recv, self._like, self._t0 = works, recv, like, t0

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        if self._t0 is not None:
            _sync(self._like)
            stats['ring'][0] += (time.perf_counter() - self._t0) * 1e3
            stats['ring'][1] += 1
        recv = self._recv
        if recv.device != self._like.device:
            recv = _to_card(recv, self._like)
        return recv


def ring_shift(x: torch.Tensor, to: int, frm: int, group=None) -> _Shift:
    """Post ``x``'s send to group rank ``to`` and the receive of a block
    of ``x``'s shape from group rank ``frm``; returns at once, and the
    returned step's ``wait()`` gives the received block. Work between the
    two overlaps the transfer (with staging, the host's part of it)."""
    x = x.contiguous()
    if staged(x, group):
        send = _to_host(x)
        recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    else:
        send, recv = x, torch.empty_like(x)
    t0 = None
    if _timing:
        _sync(x)
        t0 = time.perf_counter()
    peer = lambda r: dist.get_global_rank(group, r) if group is not None \
        else r
    ops = [dist.P2POp(dist.isend, send, peer(to), group),
           dist.P2POp(dist.irecv, recv, peer(frm), group)]
    return _Shift(dist.batch_isend_irecv(ops), recv, x, t0)
