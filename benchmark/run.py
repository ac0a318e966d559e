"""Run one benchmark cell and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It imports the port, never JAX or the
JAX package, and keeps the program's build caches inside the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The checkout's root, not this folder, goes first on the path: the
# benchmark's modules import as ``benchmark.*``.
sys.path[0] = str(ROOT)
# The port builds its kernels under its own _build/ in the checkout; a
# kernel cache that a later version of it may use goes there too, at a
# fixed path, so that only a checkout's first run compiles.
for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                 ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
    os.environ.setdefault(var, str(ROOT / '.bench_cache' / sub))

from benchmark import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(sys.argv[1:], T_START))
