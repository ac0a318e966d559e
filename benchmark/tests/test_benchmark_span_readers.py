"""The readers of the program's spans (``pyg_lib_tpu_torch.profiling``):
each over synthetic spans with a known answer, and ``None`` where the
buffer holds none of its spans or the program has no recorder."""

import pytest

from benchmark import harness
from pyg_lib_tpu_torch import profiling


def sp(name, ms, **attrs):
    return profiling.Span(name, 1_000_000, 1_000_000 + int(ms * 1e6), 7,
                          None, attrs)


SPANS = [
    sp('sampler.sample', 30.0, batch=0),
    sp('sampler.pad', 4.0, batch=0, edges=600, edge_slots=1000,
       max_row_reads=400),
    sp('sampler.pad', 6.0, batch=1, edges=900, edge_slots=1000,
       max_row_reads=100),
    sp('sampler.pad', 5.0, batch=2, edges=500, edge_slots=1000),
    sp('loader.gather', 10.0, batch=0),
    sp('loader.gather', 20.0, batch=1),
    sp('loader.starve', 0.5, batch=0),
    sp('loader.starve', 1.5, batch=1),
    sp('loader.starve', 4.0, batch=2),
    sp('ops.spmm', 0.1, plan='SpmmPlan'),
    sp('ops.spmm.backward', 0.3, plan='SpmmPlan'),
    sp('model.aggregate', 9.0, layer=0),
    sp('plan.gate', 100.0, side='fwd', gain=1.0),
    sp('plan.gate', 150.0, side='bwd', gain=1.1),
    sp('plan.build', 600.0),
]

CASES = {
    # 100 * (400 + 100 + 500) / 3000
    'sampler.pad_edge_share': 100.0 / 3,
    'sampler.max_row_reads': 250.0,
    'sampler.pad_ms': 5.0,
    'loader.gather_ms': 15.0,
    'loader.starve_ms': 2.0,
    'spmm.host_ms': 0.2,
    'plan.gate_s': 0.25,
}


@pytest.mark.parametrize('metric', sorted(CASES))
def test_a_span_reader(metric, monkeypatch):
    read = harness.reader(metric)
    monkeypatch.setattr(profiling, 'spans', lambda: list(SPANS))
    assert read({}) == pytest.approx(CASES[metric], rel=1e-9)
    # none of its spans: nothing to read
    monkeypatch.setattr(profiling, 'spans', lambda: [
        s for s in SPANS if s.name in ('sampler.sample', 'model.aggregate')])
    assert read({}) is None
    # a program without the recorder
    monkeypatch.delattr(profiling, 'spans')
    assert read({}) is None

