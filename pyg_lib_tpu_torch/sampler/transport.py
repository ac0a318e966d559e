"""Process-isolated transport for the distributed sampling service (port
of ``pyg_lib_tpu/sampler/transport.py``; the same wire protocol and the
same authkey rule).

The reference ships only the dist protocol kernels; the transport between
partitions lives in PyG's ``torch_geometric.distributed`` on top of
TensorPipe RPC. Here each graph partition is served by its own OS process
behind a ``multiprocessing.connection`` socket (AF_UNIX locally,
``(host, port)`` TCP across hosts: the same wire protocol either way), and
the coordinator scatters one-hop sample requests to all partitions and
gathers the replies.

Processes, not threads: the sampler's hot loop is C++ with the GIL
released, but a partition's isolation (its own memory, page cache and
lifetime) is the deployment shape, one service a host. The protocol stays
the pure-function triple (``dist_neighbor_sample`` ->
``merge_sampler_outputs`` -> ``relabel_neighborhood``), so in-process and
transported runs give the same bits (the seeds are computed by the
coordinator).

Wire format: pickled numpy tuples: ``('sample', seeds, fanout, rng,
replace, impl)`` / ``('hetero_sample', edge_type, seeds, fanout, rng,
replace, impl)`` / ``('stop',)``.
"""

import os
import secrets
import shutil
import tempfile
import uuid
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client, Listener
from typing import Dict, List, Optional, Sequence

__all__ = ['SamplingService', 'serve_partition']


def _worker_main(address, ready, payload, authkey):
    """Partition server process: owns one partition's CSR slices and
    answers one-hop sample requests until ``('stop',)``."""
    from pyg_lib_tpu_torch.sampler.dist import dist_neighbor_sample

    rowptr = payload.get('rowptr')
    col = payload.get('col')
    hetero = payload.get('hetero', {})  # edge_type -> (rowptr, col)

    with Listener(address, authkey=authkey) as listener:
        ready.send('ready')
        ready.close()
        while True:  # serve sequential coordinator connections
            try:
                conn = listener.accept()
            except (AuthenticationError, OSError, EOFError):
                # Failed handshakes (port scans, wrong key) and aborted
                # connects must not kill the server.
                continue
            with conn:
                while True:
                    try:
                        msg = conn.recv()
                    except (EOFError, OSError):
                        break  # coordinator went away; await the next one
                    op = msg[0]
                    if op == 'stop':
                        conn.send(('ok', ))
                        return
                    try:
                        if op == 'sample':
                            _, seeds, fanout, rng, replace, impl = msg
                            res = dist_neighbor_sample(rowptr, col, seeds,
                                                       fanout,
                                                       replace=replace,
                                                       rng=rng, impl=impl)
                        elif op == 'hetero_sample':
                            _, k, seeds, fanout, rng, replace, impl = msg
                            rp, cl = hetero[k]
                            res = dist_neighbor_sample(rp, cl, seeds,
                                                       fanout,
                                                       replace=replace,
                                                       rng=rng, impl=impl)
                        else:
                            raise ValueError(f'unknown op {op!r}')
                        conn.send(('ok', res))
                    except Exception as e:  # report, keep serving
                        conn.send(('error', f'{type(e).__name__}: {e}'))


def serve_partition(address, payload, authkey: bytes = None):
    """Run a partition server in THIS process (blocking): the entry
    point a deployment launches on each sampling host, with ``address`` a
    ``(host, port)`` TCP tuple and ``payload`` loaded from the
    partitioned graph store.

    ``authkey`` is REQUIRED: ``multiprocessing.connection`` transports
    pickles, and unpickling attacker bytes is arbitrary code execution —
    the HMAC challenge keyed on this shared secret is the only thing
    keeping unauthenticated peers off the port. Deployments must
    generate one secret (e.g. ``secrets.token_bytes(32)``) and pass the
    same value to every ``serve_partition`` and
    ``SamplingService.connect``.
    """
    from multiprocessing import Pipe

    if not authkey:
        raise ValueError(
            'serve_partition requires an explicit authkey (shared '
            'secret); the connection unpickles peer data, so it must '
            'never accept unauthenticated peers')
    a, b = Pipe()
    _worker_main(address, b, payload, authkey)
    a.close()


class SamplingService:
    """Coordinator-side handle to per-partition sampler servers.

    ``SamplingService.spawn(graph)`` forks one server process per
    partition of a :class:`~pyg_lib_tpu_torch.sampler.dist_service.DistGraph`
    or ``HeteroDistGraph`` over AF_UNIX sockets;
    ``SamplingService.connect(addresses)`` attaches to already-running
    servers (e.g. ``serve_partition`` on other hosts) over TCP. Requests
    to distinct partitions are pipelined: :meth:`scatter` sends all
    requests before collecting any reply.
    """

    def __init__(self, conns: Sequence, procs: Sequence = (),
                 tmpdir: Optional[str] = None):
        self._conns = list(conns)
        self._procs = list(procs)
        self._tmpdir = tmpdir

    # -- construction --------------------------------------------------

    @classmethod
    def spawn(cls, graph) -> 'SamplingService':
        """Start one local server process per partition of ``graph``."""
        import multiprocessing as mp

        ctx = mp.get_context('spawn')
        payloads = _payloads_for(graph)
        tmp = tempfile.mkdtemp(prefix='pygt_svc_')
        # Fresh secret per service: the key only ever travels through
        # the spawn pickle to our own children, never a constant in
        # public source.
        authkey = secrets.token_bytes(32)
        procs, conns = [], []
        pending = []
        for p, payload in enumerate(payloads):
            address = os.path.join(tmp, f'part{p}_{uuid.uuid4().hex}.sock')
            a, b = ctx.Pipe()
            proc = ctx.Process(target=_worker_main,
                               args=(address, b, payload, authkey),
                               daemon=True)
            proc.start()
            b.close()
            pending.append((a, address))
            procs.append(proc)
        for a, address in pending:
            if a.recv() != 'ready':  # pragma: no cover
                raise RuntimeError('partition server failed to start')
            a.close()
            conns.append(Client(address, authkey=authkey))
        return cls(conns, procs, tmpdir=tmp)

    @classmethod
    def connect(cls, addresses: Sequence,
                authkey: bytes = None) -> 'SamplingService':
        """Attach to running servers; ``addresses[p]`` serves partition
        ``p`` (TCP ``(host, port)`` tuples across hosts).
        ``authkey`` must be the shared secret the servers were started
        with (see :func:`serve_partition`)."""
        if not authkey:
            raise ValueError('SamplingService.connect requires the '
                             'authkey the servers were started with')
        return cls([Client(a, authkey=authkey) for a in addresses])

    # -- calls ---------------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return len(self._conns)

    def scatter(self, requests: Dict[int, tuple]) -> Dict[int, tuple]:
        """Send ``{partition: request}`` to every named partition, then
        collect replies (all sends complete before the first recv, so
        partitions sample concurrently)."""
        for p, req in requests.items():
            self._conns[p].send(req)
        out, errors = {}, []
        # Drain EVERY reply before raising: leaving replies queued would
        # desynchronise the per-connection FIFO, silently pairing later
        # requests with stale results.
        for p in requests:
            status, *rest = self._conns[p].recv()
            if status != 'ok':
                errors.append(
                    f'partition {p} failed: {rest[0] if rest else ""}')
            else:
                out[p] = rest[0] if rest else None
        if errors:
            raise RuntimeError('; '.join(errors))
        return out

    def disconnect(self):
        """Drop the connections WITHOUT stopping the servers (coordinator
        restart / handover: servers loop back to accept the next
        coordinator). Only meaningful for ``connect``-ed services —
        spawned local servers would leak, so they are stopped."""
        if self._procs:
            self.close()
            return
        for c in self._conns:
            c.close()
        self._conns = []

    def close(self):
        for c in self._conns:
            try:
                c.send(('stop', ))
                c.recv()
            except (OSError, EOFError):
                pass
            c.close()
        for pr in self._procs:
            pr.join(timeout=10)
            if pr.is_alive():  # pragma: no cover
                pr.terminate()
        self._conns, self._procs = [], []
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _payloads_for(graph) -> List[dict]:
    """Per-partition server payloads from a Dist(Hetero)Graph."""
    if hasattr(graph, 'rowptr_parts') and isinstance(
            graph.rowptr_parts, tuple):
        return [{
            'rowptr': graph.rowptr_parts[p],
            'col': graph.col_parts[p],
        } for p in range(graph.book.num_partitions)]
    # hetero: rowptr_parts is a dict keyed by (edge_type, p)
    num_parts = next(iter(graph.books.values())).num_partitions
    payloads = []
    for p in range(num_parts):
        het = {}
        for k in graph.edge_types:
            het[k] = (graph.rowptr_parts[(k, p)], graph.col_parts[(k, p)])
        payloads.append({'hetero': het})
    return payloads
