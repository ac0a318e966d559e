"""The port's checkpoints (``pyg_lib_tpu_torch.checkpoint``) on the CPU:
the counterparts of ``tests/test_checkpoint.py``'s round trip, latest-step
choice and resume equivalence; the JAX package's directory layout and
metadata; a crashed save skipped; restore errors on a wrong structure,
shape or dtype; and a run of ``sage_forward`` + Adam + ``NeighborLoader``
(and a ``DistNeighborLoader``'s position) resumed from a checkpoint, equal
bit for bit to the run that was not interrupted.
"""

import json
import os

import numpy as np
import pytest
import torch

from pyg_lib_tpu_torch.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from pyg_lib_tpu_torch.loader import DistNeighborLoader, NeighborLoader
from pyg_lib_tpu_torch.models import SAGE, init_sage, sage_forward
from pyg_lib_tpu_torch.sampler.dist_service import partition_graph


def gen(seed):
    return torch.Generator().manual_seed(seed)


def bits_equal(a, b):
    """Two nested states equal bit for bit (tensors by their bytes)."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(
                    a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bits_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(bits_equal, a, b))
    return a == b


def test_save_restore_roundtrip(tmp_path):
    params = init_sage([8, 16, 4], gen(0), 'cpu')
    d = save_checkpoint(str(tmp_path / 'ckpt'), params, step=3,
                        metadata={'loader_epoch': 2})
    assert d.endswith('step_000000003')
    like = init_sage([8, 16, 4], gen(1), 'cpu')  # other values
    restored, meta = restore_checkpoint(str(tmp_path / 'ckpt'), like)
    assert meta['step'] == 3 and meta['loader_epoch'] == 2
    assert bits_equal(restored, params)


def test_latest_step_selection(tmp_path):
    path = str(tmp_path / 'c')
    save_checkpoint(path, {'w': torch.arange(4.0)}, step=1)
    save_checkpoint(path, {'w': torch.arange(4.0) * 2}, step=10)
    assert latest_step(path) == 10
    restored, meta = restore_checkpoint(path, {'w': torch.zeros(4)})
    assert torch.equal(restored['w'], torch.arange(4.0) * 2)
    assert meta['step'] == 10
    restored, meta = restore_checkpoint(path, {'w': torch.zeros(4)}, step=1)
    assert torch.equal(restored['w'], torch.arange(4.0)) and meta['step'] == 1
    assert latest_step(str(tmp_path / 'none')) is None


def test_a_crashed_save_is_skipped(tmp_path):
    path = str(tmp_path / 'c')
    save_checkpoint(path, {'w': torch.ones(3)}, step=4)
    # A save of step 7 that died before its metadata: the state is there,
    # the commit marker is not.
    d = save_checkpoint(path, {'w': torch.full((3, ), 7.0)}, step=7)
    os.remove(os.path.join(d, 'metadata.json'))
    os.makedirs(os.path.join(path, 'step_000000009'))  # died earlier
    os.makedirs(os.path.join(path, 'step_notanumber'))
    assert latest_step(path) == 4
    restored, meta = restore_checkpoint(path, {'w': torch.zeros(3)})
    assert meta['step'] == 4 and torch.equal(restored['w'], torch.ones(3))
    # Saving a step again replaces it and marks it complete once more.
    save_checkpoint(path, {'w': torch.full((3, ), 7.0)}, step=7)
    assert latest_step(path) == 7
    assert sorted(os.listdir(os.path.join(path, 'step_000000007'))) == [
        'metadata.json', 'state.pt']


def test_layout_and_metadata_are_the_jax_packages(tmp_path):
    import jax

    from pyg_lib_tpu import checkpoint as jcheckpoint
    from pyg_lib_tpu import loader as jloader
    from pyg_lib_tpu import models as jmodels

    rowptr, col, x, y = data(0)
    kw = dict(batch_size=8, num_neighbors=[3], rng=4)
    ldr = NeighborLoader(rowptr, col, x, y, np.arange(32), device='cpu',
                         **kw)
    jldr = jloader.NeighborLoader(rowptr, col, x, y, np.arange(32), **kw)
    for a in (ldr, jldr):
        list(a)
    got = save_checkpoint(str(tmp_path / 'port'),
                          init_sage([5, 4], gen(0), 'cpu'), step=12,
                          metadata={'note': 'x'}, loader=ldr)
    ref = jcheckpoint.save_checkpoint(
        str(tmp_path / 'jax'), jmodels.init_sage(jax.random.key(0), [5, 4]),
        step=12, metadata={'note': 'x'}, loader=jldr)
    assert os.path.basename(got) == os.path.basename(ref)
    with open(os.path.join(got, 'metadata.json')) as f:
        meta = json.load(f)
    with open(os.path.join(ref, 'metadata.json')) as f:
        assert meta == json.load(f)
    assert meta['loader_state'] == {'epoch': 1, 'rng': 4}


LIKE = {'model': {'w': torch.zeros(2, 3), 'b': torch.zeros(3)},
        'opt': [torch.zeros(2, dtype=torch.int64), 0.5]}


@pytest.mark.parametrize('like,match', [
    ({'model': {'w': torch.zeros(2, 3)}, 'opt': LIKE['opt']}, 'keys'),
    ({**LIKE, 'opt': LIKE['opt'][:1]}, 'list of 2, expected list of 1'),
    ({**LIKE, 'model': {'w': torch.zeros(3, 2), 'b': torch.zeros(3)}},
     r'\(2, 3\), expected torch.float32 \(3, 2\)'),
    ({**LIKE, 'model': {'w': torch.zeros(2, 3, dtype=torch.float64),
                        'b': torch.zeros(3)}}, 'expected torch.float64'),
    ({**LIKE, 'opt': [torch.zeros(2, dtype=torch.int64), torch.zeros(())]},
     'float, not a tensor'),
    ({**LIKE, 'opt': [torch.zeros(2, dtype=torch.int64), [0.5]]},
     'expected list'),
    ({**LIKE, 'model': [torch.zeros(2, 3), torch.zeros(3)]}, 'expected list'),
])
def test_restore_raises_on_a_wrong_structure_shape_or_dtype(tmp_path, like,
                                                            match):
    save_checkpoint(str(tmp_path), LIKE)
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(str(tmp_path), like)
    state, meta = restore_checkpoint(str(tmp_path), LIKE)
    assert bits_equal(state, LIKE) and meta == {}


def test_training_resume_equivalence(tmp_path):
    """Save at step k, keep training; restore and retrain from k: the
    parameters come out equal bit for bit (the optimizer's state too)."""
    rng = np.random.default_rng(0)
    n, f = 32, 8
    deg = rng.integers(1, 4, size=n)
    rowptr = torch.zeros(n + 1, dtype=torch.int64)
    rowptr[1:] = torch.from_numpy(np.cumsum(deg))
    row = torch.from_numpy(rng.integers(0, n, size=int(rowptr[-1])))
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, size=n))

    def fresh(seed):
        model = SAGE([f, 16, 4], gen(seed), 'cpu')
        return model, torch.optim.Adam(model.parameters(), lr=1e-2)

    def step(model, opt):
        opt.zero_grad()
        out = sage_forward(model.params(), x, rowptr, row)
        torch.nn.functional.cross_entropy(out, y).backward()
        opt.step()

    model, opt = fresh(0)
    for _ in range(3):
        step(model, opt)
    save_checkpoint(str(tmp_path / 'r'), {'model': model.state_dict(),
                                          'opt': opt.state_dict()}, step=3)
    for _ in range(2):
        step(model, opt)
    model2, opt2 = fresh(9)
    state, meta = restore_checkpoint(
        str(tmp_path / 'r'), {'model': model2.state_dict(),
                              'opt': opt2.state_dict()})
    assert meta['step'] == 3
    model2.load_state_dict(state['model'])
    opt2.load_state_dict(state['opt'])
    for _ in range(2):
        step(model2, opt2)
    assert bits_equal(model2.state_dict(), model.state_dict())
    assert bits_equal(opt2.state_dict(), opt.state_dict())


def data(seed, n=300, f=6):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, n)
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, n, int(rowptr[-1])).astype(np.int64)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return rowptr, col, x, rng.integers(0, 4, n)


@pytest.mark.parametrize('options', [
    dict(disjoint=True, edge_weight='uniform'),
    dict(disjoint=True, node_time='seeded', temporal_strategy='last'),
    dict()])
def test_a_loader_run_resumes_bit_for_bit(tmp_path, options):
    rowptr, col, x, y = data(1)
    rng = np.random.default_rng(2)
    if options.get('edge_weight') == 'uniform':
        options = dict(options, edge_weight=rng.uniform(0.05, 1.0, len(col)))
    if options.get('node_time') == 'seeded':
        options = dict(options, node_time=rng.integers(0, 100, len(x)))

    def fresh(seed):
        model = SAGE([6, 16, 4], gen(seed), 'cpu')
        ldr = NeighborLoader(rowptr, col, x, y, np.arange(0, 300, 3), 16,
                             [4, 3], device='cpu', rng=7, **options)
        return model, torch.optim.Adam(model.parameters(), lr=3e-3), ldr

    def steps(model, opt, ldr, k):
        it = iter(ldr)
        for _, batch in zip(range(k), it):
            opt.zero_grad()
            out = sage_forward(model.params(), batch['x'], batch['rowptr'],
                               batch['row'])
            n = batch['num_seeds']
            torch.nn.functional.cross_entropy(
                out[:n], batch['y'][:n]).backward()
            opt.step()
        return it

    def state(model, opt):
        return {'model': model.state_dict(), 'opt': opt.state_dict()}

    model, opt, ldr = fresh(0)
    for _ in range(2):  # two epochs, to their ends
        list(steps(model, opt, ldr, len(ldr)))
    save_checkpoint(str(tmp_path), state(model, opt), step=2 * len(ldr),
                    loader=ldr)
    steps(model, opt, ldr, 2).close()
    model2, opt2, ldr2 = fresh(5)
    restored, meta = restore_checkpoint(str(tmp_path), state(model2, opt2),
                                        loader=ldr2)
    assert meta['loader_state'] == {'epoch': 2, 'rng': 7}
    assert ldr2.state_dict() == {'epoch': 2, 'rng': 7}
    model2.load_state_dict(restored['model'])
    opt2.load_state_dict(restored['opt'])
    steps(model2, opt2, ldr2, 2).close()
    assert bits_equal(state(model2, opt2), state(model, opt))
    # Both stopped inside epoch 2: a save now would replay it from its
    # start, as the JAX package's loaders do.
    assert ldr2.state_dict() == ldr.state_dict() == {'epoch': 2, 'rng': 7}


def test_a_dist_loader_position_resumes(tmp_path):
    rowptr, col, x, y = data(3)

    def fresh():
        return DistNeighborLoader(partition_graph(rowptr, col, 3), x, y,
                                  np.arange(0, 300, 4), 16, [3, 2],
                                  device='cpu', rng=13)

    ldr = fresh()
    list(ldr)
    save_checkpoint(str(tmp_path), {'w': torch.ones(1)}, step=1, loader=ldr)
    epoch1 = list(ldr)
    again = fresh()
    restore_checkpoint(str(tmp_path), {'w': torch.zeros(1)}, loader=again)
    assert again.state_dict() == {'epoch': 1, 'rng': 13}
    for a, b in zip(list(again), epoch1):
        assert bits_equal(a, b)
