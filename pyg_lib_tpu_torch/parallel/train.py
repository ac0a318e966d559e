"""Data-parallel (optionally tensor-sharded) training steps (port of
``pyg_lib_tpu/parallel/train.py``).

Under ``jit`` the JAX step sees the global batch, and XLA inserts the
gradient all-reduce. Here every rank runs the step on its shard of the
batch, and the step all-reduces the gradient over the mesh's ``data``
axis itself, once a step, in one flat buffer. The levers are JAX's:

* **gradient accumulation** (``accum_steps``): a loop over microbatches
  with f32 gradient accumulators and one optimizer update, the mean-loss
  step over the whole batch at one microbatch's activation memory;
* **rematerialisation** (``remat=True``): ``torch.utils.checkpoint``
  around the loss;
* **donation** (``donate``): the update is in place anyway (the
  optimizer steps the caller's tensors), so the flag changes nothing;
  it is kept for the JAX signature;
* **tensor-sharded parameters** (``param_spec``): the leaves live as
  DTensors split over the ``model`` axis; the step gathers each to full
  size for the loss and steps the optimizer on this rank's shard.
"""

from typing import Callable, List, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from pyg_lib_tpu_torch.parallel import _collectives as C
from pyg_lib_tpu_torch.parallel.mesh import NamedSharding, named_sharding

__all__ = ['make_train_step']


def _axis_of(mesh: DeviceMesh, axis: str):
    """(group, size, this rank's index) of ``mesh``'s ``axis``."""
    i = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i)


def _piece(t: torch.Tensor, dim: int, n: int, r: int, what: str):
    if t.shape[dim] % n:
        raise ValueError(f'{what}: dimension {dim} of size {t.shape[dim]} '
                         f'does not split into {n} equal parts')
    return t.chunk(n, dim)[r]


def _shard_of(mesh: DeviceMesh, t: torch.Tensor, placements) -> torch.Tensor:
    """This rank's piece of ``t`` under ``placements``."""
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = _piece(t, p.dim, mesh.size(i), mesh.get_local_rank(i),
                       'param_spec')
    return t.contiguous()


def _unshard(mesh: DeviceMesh, t: torch.Tensor, placements) -> torch.Tensor:
    """The full tensor of this rank's shard ``t`` (all-gathers over each
    sharded mesh axis)."""
    for i, p in reversed(list(enumerate(placements))):
        if isinstance(p, Shard):
            t = C.all_gather(t.movedim(p.dim, 0),
                             mesh.get_group(i)).movedim(0, p.dim)
    return t


def _sharding(mesh, spec) -> Optional[NamedSharding]:
    if spec is None or isinstance(spec, NamedSharding):
        return spec
    return named_sharding(mesh, *spec)


def _leaf_specs(mesh, param_spec, params) -> List[Optional[NamedSharding]]:
    """One sharding (or ``None``) per leaf of ``params``: a single spec
    (a ``PartitionSpec``-like tuple or a ``NamedSharding``) applies to
    every leaf; a dict or list gives one per leaf."""
    n = len(pytree.tree_leaves(params))
    if param_spec is None:
        return [None] * n
    if isinstance(param_spec, (dict, list)):
        specs = pytree.tree_leaves(
            param_spec, is_leaf=lambda s: s is None or isinstance(
                s, (tuple, NamedSharding)))
        if len(specs) != n:
            raise ValueError(f'param_spec has {len(specs)} leaves, params '
                             f'{n}')
        return [_sharding(mesh, s) for s in specs]
    return [_sharding(mesh, param_spec)] * n


def make_train_step(loss_fn: Callable, optimizer: Callable, mesh: DeviceMesh,
                    batch_spec=None, *, param_spec=None,
                    accum_steps: int = 1, remat: bool = False,
                    donate: bool = False):
    """Builds ``step(params, opt_state, batch) -> (params, opt_state,
    loss)``, run by every rank of ``mesh``.

    ``params`` is a pytree (dicts and lists) of tensors. ``optimizer``
    builds a ``torch.optim`` optimizer from a list of tensors (e.g.
    ``functools.partial(torch.optim.Adam, lr=1e-3)``): pass
    ``opt_state=None`` to the first step and it builds one over the
    leaves (their shards, where sharded) and returns it as ``opt_state``.
    The update is in place; ``donate`` is accepted and changes nothing.

    ``loss_fn(params, batch)`` returns a scalar, or ``(sum, weight)``
    for a weighted mean. JAX's ``loss_fn`` sees the global batch, so a
    masked mean there is one mean over every rank's rows: return the
    masked sum and the mask's count, and the step divides by the count
    summed over the ``data`` axis (at least 1, as the JAX losses'
    ``maximum(mask.sum(), 1)``), which gives JAX's loss and gradient on
    the same global batch. A scalar is averaged over the ``data`` ranks
    (the same thing when every shard weighs the same).

    ``batch_spec`` (a ``PartitionSpec``-like tuple such as ``('data',)``
    or ``(None, 'data')``) says the batch passed in is the global one,
    split along dimension ``i`` over mesh axis ``batch_spec[i]``: the
    step takes this rank's part of every tensor leaf. Without it the
    batch passed in is this rank's own.

    With ``accum_steps > 1`` every tensor leaf of this rank's batch has a
    leading ``[accum_steps]`` microbatch axis; the step averages the
    microbatches' gradients and losses in f32 and updates once.

    ``param_spec`` shards the parameters over the mesh (a spec or a
    ``named_sharding`` for every leaf, or a dict/list of them, ``None``
    for a replicated leaf): the returned ``params`` hold DTensors, and
    leaves passed in as DTensors keep their placements.

    ``step.grads`` holds the gradients the last call applied (full size,
    after the all-reduce), in leaf order.
    """
    if accum_steps < 1:
        raise ValueError(f'accum_steps must be >= 1, got {accum_steps}')
    names = mesh.mesh_dim_names
    data = _axis_of(mesh, 'data') if 'data' in names else (None, 1, 0)
    data_group, data_size, _ = data
    lfn = loss_fn
    if remat:
        def lfn(params, batch):
            return checkpoint(loss_fn, params, batch, use_reentrant=False)

    def local_batch(batch):
        if batch_spec is None:
            return batch
        spec = tuple(batch_spec)

        def cut(t):
            if not isinstance(t, torch.Tensor):
                return t
            for dim, axis in enumerate(spec):
                if axis is not None:
                    _, n, r = _axis_of(mesh, axis)
                    t = _piece(t, dim, n, r, 'batch_spec')
            return t

        return pytree.tree_map(cut, batch)

    def scaled_loss(params, mb):
        """This rank's share of the global loss."""
        out = lfn(params, mb)
        if isinstance(out, tuple):
            total, weight = out
            w = torch.as_tensor(weight, dtype=torch.float32,
                                device=total.device).detach().clone()
            if data_group is not None:
                C.all_reduce_(w.reshape(1), data_group)
            return total / w.clamp(min=1.0)
        return out / data_size

    def step(params, opt_state, batch):
        leaves, spec = pytree.tree_flatten(params)
        shardings = _leaf_specs(mesh, param_spec, params)
        with torch.no_grad():
            for i, (leaf, sh) in enumerate(zip(leaves, shardings)):
                if sh is not None and not isinstance(leaf, DTensor):
                    leaves[i] = DTensor.from_local(
                        _shard_of(mesh, leaf.detach(), sh.placements), mesh,
                        sh.placements, run_check=False)
            shards = [leaf.to_local() if isinstance(leaf, DTensor) else leaf
                      for leaf in leaves]
            full = [_unshard(mesh, s, leaf.placements)
                    if isinstance(leaf, DTensor) else s
                    for s, leaf in zip(shards, leaves)]
        work = [f.detach().requires_grad_(True) for f in full]
        tree = pytree.tree_unflatten(work, spec)
        mine = local_batch(batch)
        if accum_steps == 1:
            loss = scaled_loss(tree, mine)
            grads = list(torch.autograd.grad(loss, work))
            loss = loss.detach().float()
        else:
            firsts = [t.shape[0] for t in pytree.tree_leaves(mine)
                      if isinstance(t, torch.Tensor)]
            if any(n != accum_steps for n in firsts):
                raise ValueError(f'accum_steps={accum_steps}, but the batch '
                                 f'leaves lead with {sorted(set(firsts))}')
            grads = [torch.zeros(w.shape, dtype=torch.float32,
                                 device=w.device) for w in work]
            loss = torch.zeros((), dtype=torch.float32,
                               device=work[0].device)
            for m in range(accum_steps):
                mb = pytree.tree_map(
                    lambda t: t[m] if isinstance(t, torch.Tensor) else t,
                    mine)
                lm = scaled_loss(tree, mb)
                for a, g in zip(grads, torch.autograd.grad(lm, work)):
                    a.add_(g.float())
                loss = loss + lm.detach().float()
            loss = loss / accum_steps
            grads = [(g / accum_steps).to(w.dtype)
                     for g, w in zip(grads, work)]
        with torch.no_grad():
            flat = torch.cat([g.reshape(-1).float() for g in grads] +
                             [loss.reshape(1)])
            if data_group is not None:
                C.all_reduce_(flat, data_group)
            parts = flat.split([g.numel() for g in grads] + [1])
            grads = [p.view(g.shape).to(g.dtype)
                     for p, g in zip(parts, grads)]
            loss = parts[-1].reshape(())
            if opt_state is None:
                opt_state = optimizer(shards)
            for s, g, leaf in zip(shards, grads, leaves):
                if isinstance(leaf, DTensor):
                    g = _shard_of(mesh, g, leaf.placements)
                s.grad = g
            opt_state.step()
            for s in shards:
                s.grad = None
        step.grads = grads
        return pytree.tree_unflatten(leaves, spec), opt_state, loss

    step.grads = None
    return step



def full_params(mesh: DeviceMesh, params):
    """``params`` with every DTensor leaf gathered to its full size (a
    plain tensor); the other leaves as they are."""
    with torch.no_grad():
        return pytree.tree_map(
            lambda leaf: _unshard(mesh, leaf.to_local(), leaf.placements)
            if isinstance(leaf, DTensor) else leaf, params)
