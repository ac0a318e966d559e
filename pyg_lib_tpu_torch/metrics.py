"""Training-loop metrics: per-phase counters and roofline gauges (port of
``pyg_lib_tpu/metrics.py``).

* per-phase wall-time attribution: host sampling, padding, host-to-device
  copies and the step (a sampled-GNN loop whose host side starves the
  card shows here first);
* throughput gauges: edges/s, GB/s and FLOP/s, and their shares of the
  card's peaks (``profiling.device_roofline``: the H100's published HBM3
  rate and f32 rate outside the tensor cores, labelled with the card's
  name and power limit as ``nvidia-smi`` gives them; no figure on the CPU
  or on another card, where the shares are left out);
* a machine-readable sink: JSON lines, one per report window.

Use::

    metrics = Metrics(edges_per_step=E, bytes_per_step=B, every=20)
    for it in range(steps):
        with metrics.phase('sample'):
            batch = make_batch(...)
        with metrics.phase('step'):
            loss = step(*batch)
        metrics.step(loss=loss)           # emits one JSON line every 20
    print(metrics.summary())

Losses passed to ``step`` stay on the card until the window closes, when
the last one is read (which waits for the card): between reports the host
never blocks on it. ``phase('step')`` therefore measures the launch of an
asynchronous step; the window's ``steps_per_s`` (which spans the read) is
the rate with the card's time in it, and the ``other`` bucket takes the
wait.
"""

import contextlib
import json
import time
from typing import Callable, Optional, Union

from pyg_lib_tpu_torch import profiling
from pyg_lib_tpu_torch.profiling import Roofline, device_roofline

__all__ = ['Metrics', 'Roofline', 'device_roofline']


class Metrics:
    """Windowed training metrics with phase counters and roofline gauges.

    Args:
        sink: where JSON lines go — a path (appended), a callable taking
            the record dict, or ``None`` for stdout.
        every: emit one record per this many ``step()`` calls.
        edges_per_step: graph edges processed per step (→ ``edges_per_s``).
        bytes_per_step: HBM bytes a step moves (→ ``gbps``/``hbm_fraction``).
        flops_per_step: FLOPs per step (→ ``tflops``/``f32_fraction``).
    """

    def __init__(self, sink: Union[str, Callable, None] = None,
                 every: int = 20, *, edges_per_step: int = 0,
                 bytes_per_step: int = 0, flops_per_step: int = 0):
        if every < 1:
            raise ValueError(f'every must be >= 1, got {every}')
        self._sink = sink
        self.every = every
        self.edges_per_step = edges_per_step
        self.bytes_per_step = bytes_per_step
        self.flops_per_step = flops_per_step
        self._roof = False  # not looked up yet (None: no figure)
        self.steps = 0
        self._win_t0 = time.perf_counter()
        self._win_phases: dict = {}
        self._win_loss = []  # lazy device scalars, synced at window edge
        self._records = []
        self._t_start = self._win_t0
        self._totals: dict = {}

    # ------------------------------------------------------------ phases
    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute the enclosed host wall time to ``name``: a
        ``phase.<name>`` span of :mod:`~pyg_lib_tpu_torch.profiling`, so
        under ``profiling.trace()`` the phase is a range of the trace."""
        s = profiling.span(f'phase.{name}')
        try:
            with s:
                yield
        finally:
            dt = s.seconds
            self._win_phases[name] = self._win_phases.get(name, 0.0) + dt
            self._totals[name] = self._totals.get(name, 0.0) + dt

    # ------------------------------------------------------------- steps
    def step(self, loss=None, **gauges):
        """Count one training step; emit a record at window edges.

        ``loss`` may be a tensor on the card; it is read only when the
        window closes. Extra keyword gauges (floats) are
        averaged over the window.
        """
        self.steps += 1
        if loss is not None:
            self._win_loss.append(loss)
        for k, v in gauges.items():
            key = f'gauge:{k}'
            self._win_phases[key] = self._win_phases.get(key, 0.0) + float(v)
        if self.steps % self.every == 0:
            self._emit()

    def _roofline(self) -> Optional[Roofline]:
        if self._roof is False:
            self._roof = device_roofline()
        return self._roof

    def _emit(self):
        if self._win_loss:
            # One wait per window, on the last loss: the steps run in
            # order on the card, so its value covers the whole window.
            float(self._win_loss[-1])
        now = time.perf_counter()
        dt = max(now - self._win_t0, 1e-9)
        n = self.every
        rec = {'step': self.steps, 'steps_per_s': round(n / dt, 3)}
        if self._win_loss:
            rec['loss'] = round(
                sum(float(v) for v in self._win_loss) / len(self._win_loss),
                6)
        phases = {k: v for k, v in self._win_phases.items()
                  if not k.startswith('gauge:')}
        if phases:
            accounted = sum(phases.values())
            rec['phases_ms'] = {k: round(v / n * 1e3, 3)
                                for k, v in sorted(phases.items())}
            # Device wait + anything not under a phase() context.
            rec['phases_ms']['other'] = round(
                max(dt - accounted, 0.0) / n * 1e3, 3)
        for k, v in self._win_phases.items():
            if k.startswith('gauge:'):
                rec[k[6:]] = round(v / n, 6)
        step_s = dt / n
        if self.edges_per_step:
            rec['edges_per_s'] = round(self.edges_per_step / step_s, 1)
        roof = self._roofline() if (self.bytes_per_step or
                                    self.flops_per_step) else None
        if self.bytes_per_step:
            rec['gbps'] = round(self.bytes_per_step / step_s / 1e9, 2)
            if roof is not None:
                rec['hbm_fraction'] = round(rec['gbps'] / roof.hbm_gbps, 6)
        if self.flops_per_step:
            rec['tflops'] = round(self.flops_per_step / step_s / 1e12, 3)
            if roof is not None:
                rec['f32_fraction'] = round(rec['tflops'] / roof.f32_tflops,
                                            6)
        if roof is not None:
            rec['roofline_of'] = roof.device
        self._records.append(rec)
        self._write(rec)
        self._win_t0 = time.perf_counter()
        self._win_phases = {}
        self._win_loss = []

    def _write(self, rec):
        line = json.dumps(rec)
        if callable(self._sink):
            self._sink(rec)
        elif isinstance(self._sink, str):
            with open(self._sink, 'a') as f:
                f.write(line + '\n')
        else:
            print(line, flush=True)

    # ----------------------------------------------------------- summary
    @property
    def records(self):
        return list(self._records)

    def summary(self) -> dict:
        """Run-level totals: steps/s overall and per-phase time shares."""
        total = max(time.perf_counter() - self._t_start, 1e-9)
        out = {'steps': self.steps,
               'steps_per_s': round(self.steps / total, 3),
               'wall_s': round(total, 3)}
        if self._totals:
            out['phase_share'] = {k: round(v / total, 4)
                                  for k, v in sorted(self._totals.items())}
        if self.edges_per_step and self.steps:
            out['edges_per_s'] = round(
                self.edges_per_step * self.steps / total, 1)
        return out
