"""Profiling and roofline helpers (port of ``pyg_lib_tpu/profiling.py``).

* :func:`device_roofline`: the card's published peaks (the H100's HBM3
  rate, its f32 rate outside the tensor cores and its tensor cores' dense
  bf16 rate), labelled with the card's name and power limit as
  ``nvidia-smi`` gives them; ``None`` on the CPU or on another card, where
  the JAX package puts a made-up CPU figure;
* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace;
* :func:`measure`: times a callable and gives its rates and, on the card,
  their shares of the peaks.
"""

import contextlib
import os
import os.path as osp
import subprocess
import time
from typing import NamedTuple, Optional

import torch

__all__ = ['Roofline', 'device_roofline', 'measure', 'trace']

# NVIDIA's data sheet, H100 SXM at its full 700 W power limit: HBM3, f32
# outside the tensor cores, and the tensor cores' dense bf16 rate (the
# sheet's 1,979 TFLOP/s assumes 2:4 sparsity).
H100_HBM_GBPS = 3350.0
H100_F32_TFLOPS = 67.0
H100_TENSOR_BF16_TFLOPS = 989.0


class Roofline(NamedTuple):
    """A card's published peaks, and the card they are for."""
    device: str  # nvidia-smi's "name, power.limit"
    hbm_gbps: float
    f32_tflops: float
    tensor_bf16_tflops: float  # the JAX package's mxu_bf16_tflops

    def balance_flop_per_byte(self) -> float:
        """The arithmetic intensity at the knee of the tensor cores' bf16
        roofline (the JAX package's MXU knee): work below it is bound by
        HBM."""
        return self.tensor_bf16_tflops * 1e12 / (self.hbm_gbps * 1e9)


def device_roofline() -> Optional[Roofline]:
    """The H100's peaks, labelled with ``nvidia-smi``'s name and power
    limit of card 0 (a card set below 700 W runs slower under load than
    they say); ``None`` without a card or on another card."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    if 'H100' not in name:
        return None
    try:
        name = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader', '--id=0'], capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        pass  # the name from torch, without its power limit
    return Roofline(name, H100_HBM_GBPS, H100_F32_TFLOPS,
                    H100_TENSOR_BF16_TFLOPS)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` context over the CPU and, when there is a card,
    CUDA activity; on exit it writes a Chrome trace
    (``trace-<pid>-<ns>.json``, for ``chrome://tracing`` or Perfetto)
    under ``log_dir``, which defaults to ``<home>/traces``. Yields
    ``log_dir``."""
    if log_dir is None:
        from pyg_lib_tpu_torch.home import get_home_dir
        log_dir = osp.join(get_home_dir(), 'traces')
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(osp.join(
        log_dir, f'trace-{os.getpid()}-{time.time_ns()}.json'))


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def measure(fn, *args, iters: int = 8, bytes_accessed: int = 0,
            flops: int = 0, warmup: int = 1):
    """Times ``fn(*args)`` over ``iters`` calls after ``warmup`` calls.

    When an argument is a CUDA tensor the calls are timed with CUDA events
    on the current stream; otherwise with the host clock. Returns a dict
    with ``seconds`` (a call) and, when given, ``gbps`` (``bytes_accessed``
    a call) and ``tflops`` (``flops`` a call). On the card, where
    :func:`device_roofline` gives a roofline, it adds their shares of the
    peaks: ``hbm_fraction`` and ``tensor_core_fraction`` (of the tensor
    cores' dense bf16 peak: the JAX package's ``mxu_fraction``), and
    ``roofline_of``, the card they are for.
    """
    card = _on_card(args)
    for _ in range(warmup):
        fn(*args)
    if card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    res = {'seconds': dt}
    if bytes_accessed:
        res['gbps'] = bytes_accessed / dt / 1e9
    if flops:
        res['tflops'] = flops / dt / 1e12
    roof = device_roofline() if card else None
    if roof is not None:
        if bytes_accessed:
            res['hbm_fraction'] = res['gbps'] / roof.hbm_gbps
        if flops:
            res['tensor_core_fraction'] = (res['tflops'] /
                                           roof.tensor_bf16_tflops)
        res['roofline_of'] = roof.device
    return res
