"""Profiling and roofline helpers (port of ``pyg_lib_tpu/profiling.py``).

* :func:`device_roofline`: the card's published peaks (the H100's HBM3
  rate, its f32 rate outside the tensor cores and its tensor cores' dense
  bf16 rate), labelled with the card's name and power limit as
  ``nvidia-smi`` gives them; ``None`` on the CPU or on another card, where
  the JAX package puts a made-up CPU figure;
* :func:`span`: the program's one span-and-counter recorder. A span times
  its block always; while a ``torch.profiler`` session is on it also
  records ``(name, start_ns, end_ns, thread, parent, attrs)`` into a
  bounded buffer (:func:`spans`) on the trace's clock, and on a thread
  that launches device work opens a ``record_function`` range of its name;
* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace,
  with the spans of threads the profiler does not see on rows of their
  own;
* :func:`measure`: times a callable and gives its rates and, on the card,
  their shares of the peaks.
"""

import collections
import contextlib
import json
import os
import os.path as osp
import subprocess
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

__all__ = ['Roofline', 'Span', 'clear_spans', 'device_roofline', 'measure',
           'recording', 'setup_span', 'span', 'spans', 'trace']

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


class Span(NamedTuple):
    """One recorded span. ``start_ns`` and ``end_ns`` are Unix nanoseconds,
    the axis of ``torch.profiler``'s exported trace (an event's ``ts`` in
    us plus the trace's ``baseTimeNanoseconds`` / 1000); ``thread`` is the
    native thread id, the trace's ``tid``; ``parent`` the name of the span
    open around it on the same thread, or ``None``."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


# The recorder's buffer: the newest SPAN_CAPACITY spans of the process.
SPAN_CAPACITY = 1 << 16
_SPANS: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_SPANS_LOCK = threading.Lock()
_local = threading.local()  # .record: recording(); .stack: open spans


class span:
    """``with span(name, **attrs) as s:`` times the block with one pair of
    clock reads (``s.seconds``) and, while recording, keeps it as a
    :class:`Span` whose ``attrs`` is ``s.attrs``: attributes set on it
    after the block, before the span is read, are kept too.

    It records while a ``torch.profiler`` session is on as this thread
    sees it, and then also opens ``record_function(name)``, so that the
    range sits in the profiler's trace beside the kernels; on a thread the
    session does not reach (a worker), it records inside
    :func:`recording`, with no range. ``s.recording`` says whether it
    records. With neither, a span costs the session check and the two
    clock reads."""

    __slots__ = ('name', 'attrs', 'recording', '_range', '_t0', '_t1',
                 '_unix0', '_parent')
    always = False

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> 'span':
        traced = _profiler_enabled()
        self.recording = (traced or self.always
                          or getattr(_local, 'record', False))
        self._range = None
        if not self.recording:
            self._t0 = time.perf_counter_ns()
            return self
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        # The trace's axis; the duration comes from the monotonic pair.
        self._unix0 = time.time_ns()
        if traced:  # the range opens and closes inside the span
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self._t1 = time.perf_counter_ns()
        if self.recording:
            _local.stack.pop()
            rec = Span(self.name, self._unix0,
                       self._unix0 + self._t1 - self._t0,
                       threading.get_native_id(), self._parent, self.attrs)
            with _SPANS_LOCK:
                _SPANS.append(rec)
        return False

    @property
    def seconds(self) -> float:
        return (self._t1 - self._t0) / 1e9


class setup_span(span):
    """A :class:`span` of one-off set-up work (a plan's build, its gates):
    recorded with no session too, since it runs once and is read long
    after."""
    __slots__ = ()
    always = True


@contextlib.contextmanager
def recording(on: bool):
    """Spans of this thread record inside the block if ``on``: a worker
    thread, which no profiler session reaches, records the job of a
    consumer that saw one."""
    before = getattr(_local, 'record', False)
    _local.record = on
    try:
        yield
    finally:
        _local.record = before


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most :data:`SPAN_CAPACITY`)."""
    with _SPANS_LOCK:
        return list(_SPANS)


def clear_spans() -> None:
    """Empty the buffer of :func:`spans`."""
    with _SPANS_LOCK:
        _SPANS.clear()


def _add_unseen_spans(path: str, start_ns: int, end_ns: int) -> None:
    """Write into the Chrome trace at ``path`` the spans recorded between
    ``start_ns`` and ``end_ns`` on threads that have no event there (the
    loader's workers), each such thread on a row of its own."""
    with open(path) as fh:
        tr = json.load(fh)
    events = tr['traceEvents']
    seen = {ev.get('tid') for ev in events if ev.get('ph') == 'X'}
    base = tr.get('baseTimeNanoseconds', 0)
    pid = os.getpid()
    rows = set()
    for sp in spans():
        if sp.thread in seen or not start_ns <= sp.start_ns <= end_ns:
            continue
        if sp.thread not in rows:
            rows.add(sp.thread)
            events.append({'ph': 'M', 'name': 'thread_name', 'pid': pid,
                           'tid': sp.thread,
                           'args': {'name': f'spans of thread {sp.thread}'}})
        events.append({'ph': 'X', 'cat': 'program_span', 'name': sp.name,
                       'pid': pid, 'tid': sp.thread,
                       'ts': (sp.start_ns - base) / 1e3,
                       'dur': (sp.end_ns - sp.start_ns) / 1e3,
                       'args': sp.attrs})
    with open(path, 'w') as fh:
        json.dump(tr, fh, default=str)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` context over the CPU and, when there is a card,
    CUDA activity; on exit it writes a Chrome trace
    (``trace-<pid>-<ns>.json``, for ``chrome://tracing`` or Perfetto)
    under ``log_dir``, which defaults to ``<home>/traces``, with the
    :func:`span` records of the threads the profiler does not see (the
    loader's workers) on rows of their own. Yields ``log_dir``."""
    if log_dir is None:
        from pyg_lib_tpu_torch.home import get_home_dir
        log_dir = osp.join(get_home_dir(), 'traces')
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    start_ns = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    end_ns = time.time_ns()
    path = osp.join(log_dir, f'trace-{os.getpid()}-{end_ns}.json')
    prof.export_chrome_trace(path)
    _add_unseen_spans(path, start_ns, end_ns)


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
