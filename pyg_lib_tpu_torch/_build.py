"""Build the CUDA kernels under ``csrc/`` with ``nvcc``, and the host
sampling engine under ``csrc/host/`` with ``g++``, and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``_build/<name>-<digest>.so``, where the digest covers the
source, the shared headers and the flags, so an edited source is built
anew and an unchanged one is reused. Several sources build in parallel,
one ``nvcc`` each. The library is loaded with ``ctypes``; the kernel
modules declare the argument types of the functions they call.

The C++ engine of ``csrc/host/`` (the sampler, the hetero sampler,
subgraph, random walks and the partitioner) becomes one library,
``_build/host-<digest>.so``, built with the JAX package's Makefile flags;
its digest also covers what ``-march=native`` means on this machine, so
a library built for another CPU is not loaded. The engine's C-ABI
edge-case suite, ``csrc/host/test_abi.cpp``, is no part of it: it builds
into a program linked against the library (:func:`build_abi_test`).

Nothing is built when this module is imported: the first call of a
kernel wrapper on a CUDA tensor builds what it needs (or
:func:`build` does it up front), and the first call of the engine builds
it (:func:`load_host`). A failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ['build', 'build_abi_test', 'build_host', 'build_variants',
           'load', 'load_host', 'sources', 'BUILD_DIR']

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / 'csrc'
BUILD_DIR = _HERE / '_build'
HOST = CSRC / 'host'
ABI_TEST = HOST / 'test_abi.cpp'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# pyg_lib_tpu/csrc/Makefile's flags.
HOST_FLAGS = ('-O3', '-march=native', '-std=c++17', '-fPIC', '-fopenmp',
              '-shared')

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


def _gxx() -> str:
    path = shutil.which('g++')
    if path is None:
        raise RuntimeError('g++ was not found on PATH; the host sampling '
                           'engine cannot be built')
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def _run(jobs, compiler=None):
    """Start one compiler per job ``(source, library, log)``, all at once,
    and wait for all of them; each library is written under a temporary
    name and moved into place once built, and the compiler's output (with
    ``ptxas``'s register, shared memory and spill report for ``nvcc``)
    goes to the log. ``compiler(out)`` gives a job's command without its
    sources (default: ``nvcc`` with ``-I csrc``); a job's source may be a
    list of sources. Raises if any build failed."""
    if compiler is None:
        compiler = lambda out: [_nvcc(), *NVCC_FLAGS, '-I', str(CSRC), '-o',
                                out]
    procs = []
    for src, so, log in jobs:
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        srcs = src if isinstance(src, list) else [src]
        cmd = compiler(str(tmp)) + [str(p) for p in srcs]
        procs.append((src, so, log, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, log, tmp, proc in procs:
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            failed.append(f'{Path(proc.args[0]).name} failed for {src}:\n'
                          f'{out}')
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError('\n'.join(failed))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named sources (default: all) that are not built yet.

    Starts one ``nvcc`` per missing library, all at once, and waits for
    all of them. ``nvcc``'s output goes to ``_build/<name>.log``. Returns
    the library path of every name.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {n: _target(n) for n in names}
    _run([(CSRC / f'{n}.cu', so, BUILD_DIR / f'{n}.log')
          for n, so in targets.items() if not so.exists()])
    return targets


def build_variants(paths: Iterable[str]) -> Dict[str, Path]:
    """Build versions of a kernel source kept anywhere, to time them
    against each other. Each distinct source not built yet is built once,
    as :func:`build` builds (in parallel, ``-I csrc``), into
    ``_build/variant-<digest>.so`` with its log beside it as
    ``variant-<digest>.log``. The digest covers the headers beside the
    source as well as those of ``csrc``: a quoted ``#include`` finds a
    header in the source's own directory first, so two versions that
    differ only there are two libraries. Returns the library path of
    every path."""
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {}
    for path in dict.fromkeys(paths):
        h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
        h.update(Path(path).read_bytes())
        for p in (sorted(Path(path).parent.glob('*.cuh')) +
                  sorted(CSRC.glob('*.cuh'))):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        targets[path] = BUILD_DIR / f'variant-{h.hexdigest()[:16]}.so'
    # One build per library: copies with the same bytes share it.
    _run([(Path(path), so, so.with_suffix('.log'))
          for so, path in {so: p for p, so in targets.items()}.items()
          if not so.exists()])
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]


def _host_sources():
    """The engine's sources: ``csrc/host/*.cpp`` but the ABI suite."""
    return [p for p in sorted(HOST.glob('*.cpp')) if p != ABI_TEST]


def _host_target() -> Path:
    """``_build/host-<digest>.so``: the digest covers the flags, what
    ``-march=native`` resolves to here and every source of ``csrc/host``."""
    march = subprocess.run([_gxx(), '-march=native', '-Q', '--help=target'],
                           capture_output=True, text=True).stdout
    h = hashlib.sha256(' '.join(HOST_FLAGS).encode())
    h.update(march.encode())
    for p in _host_sources() + sorted(HOST.glob('*.h')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'host-{h.hexdigest()[:16]}.so'


def build_host() -> Path:
    """Build the host sampling engine (``csrc/host/*.cpp``) with ``g++``
    into one library, unless it is built already; ``g++``'s output goes to
    ``_build/host.log``. Raises if the build fails. Returns its path."""
    BUILD_DIR.mkdir(exist_ok=True)
    so = _host_target()
    if not so.exists():
        gxx = _gxx()
        _run([(_host_sources(), so, BUILD_DIR / 'host.log')],
             compiler=lambda out: [gxx, *HOST_FLAGS, '-o', out])
    return so


def build_abi_test() -> Path:
    """Build the engine's C-ABI edge-case suite (``csrc/host/test_abi.cpp``)
    into a program, ``_build/test_abi-<digest>``, linked against the
    engine (:func:`build_host`), unless it is built already; ``g++``'s
    output goes to ``_build/test_abi.log``. Raises if the build fails.
    Returns the program's path; it prints ``ABI TESTS PASSED`` and exits
    with 0 when every case holds."""
    lib = build_host()
    h = hashlib.sha256(lib.name.encode())
    h.update(ABI_TEST.read_bytes())
    exe = BUILD_DIR / f'test_abi-{h.hexdigest()[:16]}'
    if not exe.exists():
        gxx = _gxx()
        flags = [f for f in HOST_FLAGS if f != '-shared']
        _run([([ABI_TEST, lib], exe, BUILD_DIR / 'test_abi.log')],
             compiler=lambda out: [gxx, *flags, f'-Wl,-rpath,{BUILD_DIR}',
                                   '-o', out])
    return exe


def load_host() -> ctypes.CDLL:
    """The loaded host sampling engine, built first if needed."""
    with _lock:
        if 'host' not in _loaded:
            _loaded['host'] = ctypes.CDLL(str(build_host()))
        return _loaded['host']
