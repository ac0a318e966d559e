"""The C-ABI edge-case suite of the port's host engine
(``pyg_lib_tpu_torch/csrc/host/test_abi.cpp``, a copy of the JAX
package's ``csrc/test_abi.cpp``): built with ``g++`` against the port's
engine by ``_build.build_abi_test`` and run. The counterpart of
``tests/test_cpp_abi.py``, and skipped where that test skips.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

from pyg_lib_tpu_torch import _build


@pytest.mark.skipif(shutil.which('make') is None or
                    shutil.which('g++') is None,
                    reason='native toolchain unavailable')
def test_native_abi_suite():
    exe = _build.build_abi_test()
    assert exe.parent == _build.BUILD_DIR
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert 'ABI TESTS PASSED' in r.stdout


def test_the_suite_is_no_part_of_the_engine():
    sources = {p.name for p in _build._host_sources()}
    assert 'test_abi.cpp' not in sources
    assert {'sampler.cpp', 'hetero.cpp', 'graph_ops.cpp',
            'partition.cpp'} <= sources
    # Its header names its source; the rest is that source unchanged.
    head, body = _build.ABI_TEST.read_text().split('\n\n', 1)
    assert 'pyg_lib_tpu/csrc/test_abi.cpp' in head
    ref = Path(__file__).resolve().parents[1] / 'pyg_lib_tpu' / 'csrc'
    assert body == (ref / 'test_abi.cpp').read_text()
