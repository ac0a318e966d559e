"""K1's and K7's shared row walker (``csrc/row_walk.cuh``) on the CPU.

The walker's host half, the launcher's choice of branch
(``walk_dispatch``) and the grid (``walk_grid``), is plain C++: it is
compiled here with the host compiler against stand-in CUDA headers that
declare what the header names, and run on the addresses and widths the
kernels meet (aligned and one element into storage; F = 1, 3, 47, 48,
128, 256, 512, 600; f32, bf16 and int8). The same program builds each branch's
``RowWalk`` as a block's lanes would and checks that their features cover
each of the F columns exactly once.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / 'pyg_lib_tpu_torch' / 'csrc'
ELEM = {'f32': 4, 'bf16': 2, 'int8': 1}

# Declarations of what row_walk.cuh and common.cuh name from CUDA; the
# device code is parsed, and only RowWalk's constructor is run.
CUDA_RUNTIME_H = '''#pragma once
#include <algorithm>
#include <cstdint>
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
float __int_as_float(int);
float __uint_as_float(unsigned);
template <class T> T __ldg(const T*);
template <class T> T __shfl_sync(unsigned, T, int);
float4 make_float4(float, float, float, float);
float fmaf(float, float, float);
using std::min;
'''
CUDA_BF16_H = '''#pragma once
struct __nv_bfloat16 { unsigned short r; };
float __bfloat162float(__nv_bfloat16);
__nv_bfloat16 __float2bfloat16_rn(float);
'''
# argv: dtype (0 f32, 1 bf16, 2 int8), F, byte offsets of x, out and
# scale (-1: no scale). Prints "W NV grid.y covered blocks": covered is 1
# when the lanes of every block hold each feature of [0, F) exactly once,
# blocks the unweighted kernel's blocks an SM (its register cap).
MAIN_CPP = '''#include <cstdio>
#include <cstdlib>
#include <vector>
#include "row_walk.cuh"
template <typename T>
void show(const char* x, const char* out, const char* scale, int F) {
  pygt::walk_dispatch<T>(x, out, scale, F, [&](auto w, auto nv) {
    constexpr int W = decltype(w)::value, NV = decltype(nv)::value;
    const dim3 grid = pygt::walk_grid(7, F, W, NV);
    std::vector<int> seen(F, 0);
    bool inside = true;
    for (unsigned y = 0; y < grid.y; ++y)
      for (int lane = 0; lane < 32; ++lane) {
        // The kernels' first feature of a lane, as they compute it.
        const pygt::RowWalk<T, W, NV, true, false> walk(
            F, y * (32 * W * NV) + lane * W, lane);
        for (int v = 0; v < NV; ++v)
          for (int k = 0; k < W && walk.ok[v]; ++k) {
            const int f = walk.fl + v * 32 * W + k;
            if (f < F) seen[f] += 1; else inside = false;
          }
      }
    bool once = inside;
    for (int c : seen) once = once && c == 1;
    std::printf("%d %d %u %d %d\\n", W, NV, grid.y, once ? 1 : 0,
                pygt::walk_blocks<T, W, NV, false>());
  });
}
int main(int argc, char** argv) {
  alignas(16) static char buf[64];
  const int F = std::atoi(argv[2]), sc = std::atoi(argv[5]);
  const char* x = buf + std::atoi(argv[3]);
  const char* out = buf + std::atoi(argv[4]);
  const char* scale = sc < 0 ? nullptr : buf + sc;
  switch (std::atoi(argv[1])) {
    case 0: show<float>(x, out, scale, F); break;
    case 1: show<__nv_bfloat16>(x, out, scale, F); break;
    default: show<int8_t>(x, out, scale, F);
  }
}
'''


@pytest.fixture(scope='module')
def gate(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('walk')
    (tmp / 'cuda_runtime.h').write_text(CUDA_RUNTIME_H)
    (tmp / 'cuda_bf16.h').write_text(CUDA_BF16_H)
    (tmp / 'main.cpp').write_text(MAIN_CPP)
    cxx = shutil.which('g++') or shutil.which('c++')
    assert cxx, 'a host C++ compiler is needed to build the walker host code'
    exe = tmp / 'gate'
    subprocess.run([cxx, '-std=c++17', '-D__device__=',
                    '-D__forceinline__=inline', '-D__global__=',
                    '-I', str(tmp), '-I', str(CSRC), str(tmp / 'main.cpp'),
                    '-o', str(exe)], check=True, capture_output=True)
    return exe


def _pick_vpl(f, cap=4):
    v = 1
    while v < cap and 32 * v < f:
        v *= 2
    return v


@pytest.mark.parametrize('dtype', list(ELEM))
@pytest.mark.parametrize('f', [1, 3, 47, 48, 128, 256, 512, 600])
@pytest.mark.parametrize('where', ['aligned', 'x one element in',
                                   'out one float in', 'scale one float in',
                                   'no scale'])
def test_walker_takes_the_vector_branch_only_on_aligned_full_slices(
        gate, dtype, f, where):
    elem = ELEM[dtype]
    offs = {'aligned': (0, 0, 0), 'x one element in': (elem, 0, 0),
            'out one float in': (0, 4, 0), 'scale one float in': (0, 0, 4),
            'no scale': (0, 0, -1)}[where]
    out = subprocess.run([str(gate), str(list(ELEM).index(dtype)), str(f),
                          *map(str, offs)], check=True, capture_output=True,
                         text=True).stdout.split()
    w, nv, grid_y, covered, blocks = map(int, out)
    vector = (where in ('aligned', 'no scale') and f * elem % 16 == 0
              and f * elem >= 512)
    if vector:
        assert (w, nv) == (16 // elem, 1)
        # Registers: 48 for f32 (5 blocks of 256 threads), 64 otherwise.
        assert blocks == (5 if elem == 4 else 4)
    else:
        assert (w, nv) == (1, _pick_vpl(f))
        assert blocks == (8 if nv <= 2 else 4)  # 32 or 64 registers
    assert grid_y == -(-f // (32 * w * nv))
    assert covered == 1


def test_k1_and_k7_walk_rows_with_the_shared_walker():
    # Neither kernel keeps a slot loop of its own: both reach x only
    # through RowWalk, so the two cannot drift apart.
    for name in ('spmm_chunked.cu', 'spmm_range_fused.cu'):
        src = '\n'.join(line for line in (CSRC / name).read_text()
                        .splitlines() if not line.lstrip().startswith('//'))
        assert '#include "row_walk.cuh"' in src
        assert 'walk.run(' in src and 'walk.write(' in src
        assert '__shfl_sync' not in src and '__ldg' not in src
