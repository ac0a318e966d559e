"""The port's kernel build (``pyg_lib_tpu_torch/_build.py``) with a stand-in
compiler: a script that records its arguments and writes the ``-o``
file, so the job handling runs without ``nvcc``."""

import stat
import sys

import pytest

from pyg_lib_tpu_torch import _build

FAKE_NVCC = '''import pathlib, sys
args = sys.argv[1:]
if 'FAIL' in pathlib.Path(args[-1]).read_text():
    print('error: the stand-in refuses'); sys.exit(2)
out = pathlib.Path(args[args.index('-o') + 1])
out.write_text(' '.join(args))
print('ptxas info    : Used 32 registers')
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    exe = tmp_path / 'nvcc'
    exe.write_text(f'#!{sys.executable}\n{FAKE_NVCC}')
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, '_nvcc', lambda: str(exe))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'out')
    return tmp_path


def test_build_makes_each_library_once_with_its_log(fake_nvcc):
    got = _build.build(['segment_csr', 'segment_minmax'])
    for name, so in got.items():
        assert so.parent == fake_nvcc / 'out' and so.exists()
        assert f'{name}.cu' in so.read_text()
        assert 'registers' in (so.parent / f'{name}.log').read_text()
    stamp = {n: so.stat().st_mtime_ns for n, so in got.items()}
    assert _build.build(['segment_csr', 'segment_minmax']) == got
    assert {n: so.stat().st_mtime_ns for n, so in got.items()} == stamp
    assert not list((fake_nvcc / 'out').glob('*.tmp'))


def test_build_variants_key_on_the_source(fake_nvcc):
    a, b = fake_nvcc / 'a.cu', fake_nvcc / 'b.cu'
    a.write_text('// a kernel')
    b.write_text('// another kernel')
    got = _build.build_variants([str(a), str(b), str(a)])
    assert len(got) == 2 and got[str(a)] != got[str(b)]
    assert str(b) in got[str(b)].read_text()
    assert got[str(a)].with_suffix('.log').exists()
    b.write_text('// a kernel')  # the same bytes: the same library
    assert _build.build_variants([str(b)])[str(b)] == got[str(a)]


def test_build_variants_key_on_the_headers_beside_the_source(fake_nvcc):
    # Two versions that differ only in a header beside the source (which
    # nvcc's quoted #include finds before -I csrc) are two libraries.
    paths = []
    for name, body in (('a', '// one walker'), ('b', '// another walker'),
                       ('c', '// one walker')):
        (fake_nvcc / name).mkdir()
        (fake_nvcc / name / 'row_walk.cuh').write_text(body)
        (fake_nvcc / name / 'k.cu').write_text('#include "row_walk.cuh"')
        paths.append(str(fake_nvcc / name / 'k.cu'))
    got = _build.build_variants(paths)
    assert got[paths[0]] != got[paths[1]]
    assert got[paths[0]] == got[paths[2]]  # the same bytes throughout
    assert len({so for so in got.values() if so.exists()}) == 2
    (fake_nvcc / 'c' / 'row_walk.cuh').write_text('// edited')
    assert _build.build_variants(paths[2:])[paths[2]] not in got.values()


def test_build_raises_on_a_failed_compile(fake_nvcc):
    src = fake_nvcc / 'k.cu'
    src.write_text('// FAIL')
    with pytest.raises(RuntimeError, match='the stand-in refuses'):
        _build.build_variants([str(src)])
