"""Checkpoints of parameters, optimizer state and loaders (port of
``pyg_lib_tpu/checkpoint.py``, with ``torch.save`` in place of orbax).

A checkpoint is a directory, ``path/step_XXXXXXXXX/`` when saved with a
step (else ``path`` itself), that holds

* ``state.pt``: the state, any nested dict, list or tuple of tensors and
  Python scalars (for example ``{'model': model.state_dict(), 'opt':
  opt.state_dict()}``), written by ``torch.save`` under a temporary name
  and moved into place with ``os.replace``;
* ``metadata.json``: the caller's metadata, the step and, under
  ``loader_state``, a loader's ``state_dict()``. It is written last, the
  same way, and marks the checkpoint complete: :func:`latest_step` skips a
  step directory without it (a save that crashed part way).

SpMM plans and sampler engines are not saved: they follow from the graph
and the seed, and are rebuilt faster than they would load.
"""

import json
import os
from typing import Any, Dict, Optional

import torch

__all__ = ['latest_step', 'restore_checkpoint', 'save_checkpoint']

_LOADER_KEY = 'loader_state'
_STATE = 'state.pt'
_META = 'metadata.json'


def _ckpt_dir(path: str, step: Optional[int]) -> str:
    return os.path.join(path, f'step_{step:09d}') if step is not None \
        else path


def _replace(dst: str, write) -> None:
    """``write(tmp)`` a file beside ``dst``, then move it onto ``dst``."""
    tmp = f'{dst}.tmp-{os.getpid()}'
    write(tmp)
    os.replace(tmp, dst)


def save_checkpoint(path: str, state, step: Optional[int] = None,
                    metadata: Optional[Dict[str, Any]] = None,
                    loader=None) -> str:
    """Saves ``state`` and the JSON ``metadata`` under
    ``path[/step_XXXXXXXXX]``; returns the checkpoint directory.

    ``loader``: a loader of :mod:`pyg_lib_tpu_torch.loader` (anything with
    ``state_dict()``) whose position goes into the metadata, so that
    :func:`restore_checkpoint` with ``loader=`` resumes its epochs and
    sample streams exactly. Saving a step again replaces it.
    """
    d = os.path.abspath(_ckpt_dir(path, step))
    os.makedirs(d, exist_ok=True)
    meta_path = os.path.join(d, _META)
    if os.path.exists(meta_path):
        os.remove(meta_path)  # incomplete until the new metadata is in
    _replace(os.path.join(d, _STATE), lambda f: torch.save(state, f))
    meta = dict(metadata or {})
    if loader is not None:
        meta[_LOADER_KEY] = loader.state_dict()
    if step is not None:
        meta['step'] = step

    def write_meta(f):
        with open(f, 'w') as fh:
            json.dump(meta, fh)

    _replace(meta_path, write_meta)
    return d


def _like(saved, like, where: str):
    """``saved`` checked against ``like``'s structure, shapes and dtypes,
    each tensor on the device of its counterpart in ``like``."""
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f'{where}: the checkpoint holds '
                             f'{type(saved).__name__}, not a tensor')
        if saved.shape != like.shape or saved.dtype != like.dtype:
            raise ValueError(
                f'{where}: the checkpoint holds {saved.dtype} '
                f'{tuple(saved.shape)}, expected {like.dtype} '
                f'{tuple(like.shape)}')
        return saved.to(like.device)
    if isinstance(like, dict):
        if not isinstance(saved, dict):
            raise ValueError(f'{where}: the checkpoint holds '
                             f'{type(saved).__name__}, not a dict')
        if not like:  # an optimizer's state before its first step
            return saved
        if set(saved) != set(like):
            raise ValueError(
                f'{where}: the checkpoint has keys {sorted(map(str, saved))}'
                f', expected {sorted(map(str, like))}')
        return type(saved)((k, _like(v, like[k], f'{where}[{k!r}]'))
                           for k, v in saved.items())
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(
                f'{where}: the checkpoint holds {type(saved).__name__} '
                f'of {len(saved) if isinstance(saved, (list, tuple)) else 1}'
                f', expected {type(like).__name__} of {len(like)}')
        return type(saved)(_like(v, w, f'{where}[{i}]')
                           for i, (v, w) in enumerate(zip(saved, like)))
    if isinstance(saved, (torch.Tensor, dict, list, tuple)):
        raise ValueError(f'{where}: the checkpoint holds '
                         f'{type(saved).__name__}, expected '
                         f'{type(like).__name__}')
    return saved  # a Python scalar: the saved value stands


def restore_checkpoint(path: str, like, step: Optional[int] = None,
                       loader=None):
    """Restores ``(state, metadata)``.

    ``like`` has the structure of the saved state (for example a fresh
    model's and optimizer's ``state_dict()``): each saved tensor must have
    its counterpart's shape and dtype and is put on its counterpart's
    device, and a different structure, shape or dtype raises
    ``ValueError``. An empty dict in ``like`` (an optimizer's ``state``
    before its first step) takes the saved entries as they are, each
    tensor on the device it was saved from (the CPU on a machine without
    a card); ``optimizer.load_state_dict`` then puts them beside their
    parameters. The file is read with ``weights_only=True``.

    ``step=None`` on a directory of steps picks the latest complete one.
    ``loader=``: applies the checkpoint's loader position with
    ``loader.load_state_dict`` (nothing if the checkpoint has none).
    """
    if step is None:
        step = latest_step(path)
    d = os.path.abspath(_ckpt_dir(path, step))
    saved = torch.load(os.path.join(d, _STATE),
                       map_location=None if torch.cuda.is_available()
                       else 'cpu', weights_only=True)
    state = _like(saved, like, 'state')
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(d, _META)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if loader is not None and _LOADER_KEY in meta:
        loader.load_state_dict(meta[_LOADER_KEY])
    return state, meta


def latest_step(path: str) -> Optional[int]:
    """The largest complete ``step_*`` checkpoint under ``path`` (None if
    the directory is flat or holds none complete).

    ``metadata.json`` is the commit marker: :func:`save_checkpoint`
    writes it after the state, so a step directory without it is a save
    that crashed or is still running, and resuming falls back to the
    previous complete step."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith('step_'):
            try:
                step = int(name[5:])
            except ValueError:
                continue
            if os.path.exists(os.path.join(path, name, _META)):
                steps.append(step)
    return max(steps) if steps else None
