"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``_build/<name>-<digest>.so``, where the digest covers the
source, the shared headers and the flags, so an edited source is built
anew and an unchanged one is reused. Several sources build in parallel,
one ``nvcc`` each. The library is loaded with ``ctypes``; the kernel
modules declare the argument types of the functions they call.

Nothing is built when this module is imported: the first call of a
kernel wrapper on a CUDA tensor builds what it needs (or
:func:`build` does it up front). A failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ['build', 'load', 'sources', 'BUILD_DIR']

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / 'csrc'
BUILD_DIR = _HERE / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources():
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc was not found on PATH or under '
                           '/usr/local/cuda/bin; the CUDA kernels cannot be '
                           'built')
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named sources (default: all) that are not built yet.

    Starts one ``nvcc`` per missing library, all at once, and waits for
    all of them. ``nvcc``'s output (with ``ptxas``'s register and shared
    memory report) goes to ``_build/<name>.log``. Returns the library
    path of every name.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-I', str(CSRC), '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f'{name}.log').write_text(out)
        if proc.returncode != 0:
            failed.append(f'{name}.cu:\n{out}')
            continue
        os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]
