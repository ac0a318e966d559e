"""What the A B B A timing tools (``time_dedup.py``, ``time_segment.py``,
``time_minmax_softmax.py``) share: reading a ``path[@NAME=VALUE,...]``
argument, building the sources with their register and spill report,
calling an earlier C interface without its wrapper, and setting a
wrapper's constants for one source's calls."""

import ctypes
import re
from pathlib import Path


def parse(arg, exports):
    """``path[@NAME=VALUE,...]`` -> (path, kernel id, parameter count of
    its C function, wrapper module, {module constant: value}).
    ``exports`` maps a C function's name after ``pygt_`` to its (kernel
    id, wrapper module)."""
    path, _, pairs = arg.partition('@')
    m = re.search(rf'int pygt_({"|".join(exports)})\(([^)]*)\)',
                  Path(path).read_text())
    if m is None:
        raise SystemExit(f'{path} exports none of '
                         f'{", ".join(k for k, _ in exports.values())}')
    kid, module = exports[m.group(1)]
    attrs = {}
    for pair in filter(None, pairs.split(',')):
        name, _, value = pair.partition('=')
        if not hasattr(module, name):
            raise SystemExit(f'{arg}: the {kid} wrapper has no {name}')
        attrs[name] = int(value)
    return path, kid, m.group(2).count(',') + 1, module, attrs


def build(paths):
    """Build the sources by ``_build.build_variants``, all in parallel, and
    print each build's registers and spills; ``{path: loaded library}``."""
    from pyg_lib_tpu_torch import _build

    built = _build.build_variants(paths)
    for path, so in built.items():
        log = so.with_suffix('.log').read_text()
        regs = re.findall(r'Used (\d+) registers', log)
        spills = re.findall(r'[1-9]\d* bytes spill stores', log)
        print(f'built {path}: registers {"/".join(regs)}, {len(spills)} '
              f'kernels with spill stores', flush=True)
    return {k: ctypes.CDLL(str(v)) for k, v in built.items()}


def direct(fn, argtypes, launch):
    """An earlier C interface, called without the wrapper:
    ``launch(fn, *args)`` returns ``(error, result)``."""
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        err, out = launch(fn, *args)
        if err:
            raise RuntimeError(f'launch failed: CUDA error {err}')
        return out

    return call


def set_constants(module, attrs):
    """Set ``module``'s constants to ``attrs``; return their old values."""
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    return saved
