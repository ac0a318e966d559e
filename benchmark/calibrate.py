"""The readings that the limits of a cell's comparison are set from: the
program on many seeds, the control and the faults on the same seeds. The
benchmark's own runs never run this.

    python benchmark/calibrate.py --workload <cell> --seeds 11 12 ... [--out file.jsonl]

For each seed, in one process: the cell's set-up, its first three steps
through the program, the program's state freed and the plain reference in
f64, by the harness's own :func:`~benchmark.harness.checked_run`, as a run
makes them (the comparison a run makes: the program's readings); then, in
the program's place

* ``control``: the reference in f32 with every matrix product in TF32,
  the nearest precision below the configuration's f32 with TF32 off;
* ``half``: the loss over half of the batch (the training nodes or the
  seeds), the mean taken over the rest;
* ``altered``: the first 128 rows of every aggregation doubled, an answer
  altered where it is produced (a kernel's wrong tile);
* ``stale``: a step that leaves the parameters unchanged;
* ``unweighted`` (weighted traffic only): the first batch's seeds sampled
  again by the program's sampler without the weights, for
  ``weight_lift``.

Each is compared with the f64 reference as a run compares the program.
One JSON line a seed goes to standard output (and to ``--out``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FAULTS = ('half', 'altered', 'stale')


def unweighted_lift(inputs: dict, cfg: dict) -> float:
    """``weight_lift`` of the first batch's seeds sampled again by the
    program's sampler with no weights."""
    import torch

    from benchmark.reference import sage_minibatch
    from pyg_lib_tpu_torch import sampler

    b0 = inputs['batches'][0]
    graph, disjoint = inputs['graph'], inputs['disjoint']
    seeds = b0['node_id'][:b0['num_seeds']]
    row, col, node_id, eid, nph, _ = sampler.neighbor_sample(
        graph['rowptr'], graph['col'], seeds, cfg['num_neighbors'],
        csc=True, disjoint=disjoint, rng=12345)
    trees = node_id[:, 0] if disjoint else None
    gid = node_id[:, 1] if disjoint else node_id
    b = {'node_id': gid, 'row': row, 'col': col, 'edge_id': eid,
         'batch': trees, 'num_nodes': len(gid), 'num_edges': len(row),
         'num_seeds': len(seeds), 'nodes_per_hop': nph,
         'x': torch.from_numpy(graph['x'][gid]),
         'y': torch.from_numpy(graph['y'][gid])}
    return sage_minibatch.batch_checks(b, graph, cfg, set(),
                                       disjoint)['weight_lift']


def calibrate(name: str, seed: int, device) -> dict:
    from benchmark import compare, harness

    clock = harness.Clock()
    run = harness.checked_run(name, seed, device, clock)
    inputs, ref, ref_mod, cfg = (run['inputs'], run['ref'], run['ref_mod'],
                                 run['cfg'])
    prog = run['prog']
    out = {'workload': name, 'seed': seed,
           'setup_s': clock.s['cell_s'] + clock.s['first_steps_s'],
           'program': harness.readings_of(run), 'losses': prog['losses']}
    if 'plans' in run['record']:
        out['plans'] = run['record']['plans']
    t0 = time.perf_counter()
    out['program_look'] = compare.look_readings(prog, ref, cfg['lr'])
    k = run['output_leaves']
    control = ref_mod.run(inputs, cfg, tf32=True)
    out['control'] = compare.training_readings(control, ref, k)
    out['control_look'] = compare.look_readings(control, ref, cfg['lr'])
    for fault in FAULTS:
        got = ref_mod.run(inputs, cfg, fault=fault)
        out[fault] = compare.training_readings(got, ref, k)
        out[fault + '_look'] = compare.look_readings(got, ref, cfg['lr'])
    out['control_and_faults_s'] = time.perf_counter() - t0
    if run['wl'].get('edge_weight') is not None:
        out['unweighted'] = {'weight_lift': unweighted_lift(inputs, cfg)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    for seed in args.seeds:
        line = json.dumps(calibrate(args.workload, seed, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as fh:
                fh.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
