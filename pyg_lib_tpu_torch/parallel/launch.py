"""Rank plumbing: start ``world_size`` processes in one process group.

The JAX package has one controller that drives every device; PyTorch
runs one process a rank. :func:`spawn` starts the ranks with
``torch.multiprocessing`` (start method ``spawn``), joins them through a
``file://`` rendezvous in a fresh temporary directory (so concurrent runs,
such as parallel test workers, never collide on a port), calls
``fn(rank, world_size, *args)`` in each with the default group
initialised, and returns each rank's (picklable) result in rank order.

A rank that raises makes :func:`spawn` terminate the other ranks and
raise with that rank's traceback; a rank that ends without a result (a
crash, a kill) is reported with its exit code. Nothing is left waiting
in a collective.
"""

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ['RankError', 'spawn']


class RankError(RuntimeError):
    """A rank of :func:`spawn` failed; the message holds its traceback."""


def _rank_main(rank, world_size, backend, init_method, fn, args, results):
    """A rank's body: its result, or the time and traceback of its
    failure, goes to ``results`` before the group is torn down (the other
    ranks' collectives fail once it is)."""
    try:
        # Ranks share the host's cores (and a test run's workers do too).
        torch.set_num_threads(1)
        if torch.cuda.is_available():
            # Rank r takes card r mod the cards there are: on a one-card
            # machine every rank shares card 0.
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        try:
            out = fn(rank, world_size, *args)
        except Exception:  # reported to the parent, which raises
            results.put((rank, False, (time.time(), traceback.format_exc())))
            return
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, (time.time(), traceback.format_exc())))


def _first_failure(results, rank, value, world_size) -> RankError:
    """The error of the rank that failed first: one rank's failure makes
    the others' collectives fail too, so the reports that arrive within a
    second are compared by the time each rank failed."""
    failed = {rank: value}
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline:
        try:
            r, ok, v = results.get(timeout=max(deadline - time.monotonic(),
                                               0.01))
        except queue.Empty:
            break
        if not ok:
            failed[r] = v
    first = min(failed, key=lambda r: failed[r][0])
    return RankError(f'rank {first} of {world_size} failed:\n'
                     f'{failed[first][1]}')


def spawn(fn: Callable, world_size: int, backend: str = 'gloo', *args,
          timeout: float = 3600.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` new processes
    joined in a ``backend`` process group; return their results in rank
    order.

    ``fn`` must be importable by name (a module-level function). Each rank
    runs with ``torch.set_num_threads(1)``. Raises
    :class:`RankError` with the traceback of the first rank that fails, or
    when ``timeout`` seconds pass first.
    """
    if world_size < 1:
        raise ValueError(f'world_size must be >= 1, got {world_size}')
    ctx = mp.get_context('spawn')
    tmp = tempfile.mkdtemp(prefix='pygt_rdv_')
    init_method = 'file://' + os.path.join(tmp, 'rendezvous')
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, init_method, fn, args,
                               results), daemon=True)
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        out, waited = {}, 0.0
        while len(out) < world_size:
            # A rank that had exited before this wait began has written
            # all it will write: if the wait finds nothing, it sent no
            # result (it crashed, was killed, or its result did not pickle).
            exited = [r for r, p in enumerate(procs)
                      if r not in out and p.exitcode is not None]
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                if exited:
                    raise RankError(
                        f'rank {exited[0]} of {world_size} exited with code '
                        f'{procs[exited[0]].exitcode} and no result')
                if waited > timeout:
                    raise RankError(f'the ranks did not finish within '
                                    f'{timeout:.0f} s')
                continue
            if not ok:
                raise _first_failure(results, rank, value, world_size)
            out[rank] = value
        for p in procs:
            p.join()
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
