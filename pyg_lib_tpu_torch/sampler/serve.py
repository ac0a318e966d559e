"""Partition-server CLI, the entry point of each sampling host (port of
``pyg_lib_tpu/sampler/serve.py``).

The reference ecosystem deploys distributed sampling through PyG's
``torch_geometric.distributed`` (TensorPipe RPC workers managed by
torchrun); this framework's per-host unit is one OS process serving one
graph partition over authenticated TCP (``sampler.transport``, same wire
protocol as the local AF_UNIX service). Run on every sampling host:

    python -m pyg_lib_tpu_torch.sampler.serve \
        --partition part3.npz --host 0.0.0.0 --port 19309 \
        --authkey-file cluster.key

and attach coordinators with::

    SamplingService.connect([(h, 19309) for h in hosts], authkey=key)

Partition files are ``datasets.save_csr``-style npz archives holding
``rowptr``/``col`` (homogeneous) or ``rowptr__src__rel__dst`` /
``col__src__rel__dst`` pairs (hetero); build them with
``partition.metis`` + ``sampler.dist_service.DistGraph`` tooling.
"""

import argparse
import sys

import numpy as np

__all__ = ['load_partition_payload', 'main']


def load_partition_payload(path: str) -> dict:
    """Read a partition npz into a ``serve_partition`` payload."""
    with np.load(path, allow_pickle=False) as z:
        keys = set(z.files)
        if 'rowptr' in keys and 'col' in keys:
            return {'rowptr': z['rowptr'], 'col': z['col']}
        hetero = {}
        for k in keys:
            if not k.startswith('rowptr__'):
                continue
            et = tuple(k[len('rowptr__'):].split('__'))
            if len(et) != 3:
                raise ValueError(f'bad hetero key {k!r}: want '
                                 'rowptr__src__rel__dst')
            colk = 'col__' + '__'.join(et)
            if colk not in keys:
                raise ValueError(f'{k!r} has no matching {colk!r}')
            hetero[et] = (z[k], z[colk])
        if not hetero:
            raise ValueError(
                f'{path}: no rowptr/col or rowptr__*/col__* arrays')
        return {'hetero': hetero}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='pyg_lib_tpu_torch.sampler.serve',
        description='Serve one graph partition to remote coordinators.')
    ap.add_argument('--partition', required=True,
                    help='npz with rowptr/col (or hetero rowptr__s__r__d)')
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--port', type=int, required=True)
    ap.add_argument('--authkey-file', required=True,
                    help='file holding the cluster shared secret (bytes); '
                    'the wire protocol unpickles peer data, so serving '
                    'without authentication is remote code execution')
    args = ap.parse_args(argv)

    with open(args.authkey_file, 'rb') as f:
        authkey = f.read().strip()
    if len(authkey) < 16:
        ap.error('authkey must be at least 16 bytes of secret material')

    payload = load_partition_payload(args.partition)
    from pyg_lib_tpu_torch.sampler.transport import serve_partition

    print(f'serving {args.partition} on {args.host}:{args.port}',
          flush=True)
    serve_partition((args.host, args.port), payload, authkey=authkey)
    return 0


if __name__ == '__main__':
    sys.exit(main())
