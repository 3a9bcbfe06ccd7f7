"""The readers of the program's spans (``perfbench/metrics/_spans.py`` and
the metrics that use it) on a hand-made record: each reads its median, and
None where the record holds no such span or the program has no recorder."""
from __future__ import annotations

import sys

import pytest

from perfbench.run import _metric_reader
from perfbench.tests.helpers import ROOT  # noqa: F401  (puts src on the path)


def _span(i, name, parent=None, host=None, stream=None, attrs=None,
          counts=None, req=None):
    return {"id": i, "name": name, "t0_ns": 0, "t1_ns": 0, "host_ms": host,
            "stream_ms": stream, "parent": parent, "req": req,
            "attrs": attrs or {}, "counts": counts or {}}


RECORD = [
    _span(0, "pool.iteration", stream=400.0),
    _span(1, "pool.refill", 0, stream=9.0, attrs={"attached": 1}),
    _span(2, "pool.step", 0, stream=380.0),
    _span(3, "train.grad", 2, stream=150.0),
    _span(4, "train.update", 2, stream=60.0),
    _span(5, "pool.select", 2, stream=20.0),
    _span(6, "pool.refill", stream=0.1, attrs={"attached": 0}),
    _span(7, "train.grad", stream=170.0),
    _span(8, "train.update", stream=70.0),
    _span(9, "pool.select", stream=22.0),
    _span(10, "pool.refill", stream=13.0, attrs={"attached": 2}),
    _span(11, "train.grad", stream=160.0),
    _span(12, "serve.decode_step", host=80.0, counts={"cast_bytes": 100}),
    _span(13, "model.block", 12, counts={"cast_bytes": 2_000_000}),
    _span(14, "model.block", 12, counts={"cast_bytes": 3_000_000}),
    _span(15, "serve.read", 12, host=40.0),
    _span(16, "serve.decode_step", host=90.0),
    _span(17, "model.block", 16, counts={"cast_bytes": 4_000_000}),
    _span(18, "op.flash_attention", 17, counts={"cast_bytes": 1_000_000}),
    _span(19, "serve.read", 16, host=50.0),
    _span(20, "serve.decode_step", host=70.0),
    _span(21, "model.block", 20, counts={"cast_bytes": 7_000_000}),
    _span(22, "serve.read", 20, host=2.0),
    _span(23, "serve.attach", stream=1.5, req=4),
    _span(24, "serve.attach", stream=2.5, req=5),
    _span(25, "serve.prefill", host=60.0, counts={"cast_bytes": 9}, req=5),
]

READINGS = {"grad_ms.train": 160.0, "update_ms.train": 65.0,
            "lane_select_ms.train": 21.0, "refill_ms.train": 11.0,
            "decode_wait_ms.serve": 40.0, "attach_ms.serve": 2.0,
            "decode_cast_mb.serve": 5.0001}


@pytest.fixture
def recorded(monkeypatch):
    from repro_torch.core import spans

    def set_record(rec):
        monkeypatch.setattr(spans, "record", lambda: list(rec))
    return set_record


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_its_median(recorded, name):
    recorded(RECORD)
    assert _metric_reader(name)({}) == pytest.approx(READINGS[name],
                                                     rel=1e-12)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_none_without_its_span(recorded, name):
    recorded([])
    assert _metric_reader(name)({}) is None
    # spans without stream times (a CPU run) and no decode step: only the
    # host time of the token read is left to read
    recorded([dict(s, stream_ms=None) for s in RECORD
              if s["name"] != "serve.decode_step"])
    left = READINGS[name] if name == "decode_wait_ms.serve" else None
    assert _metric_reader(name)({}) == left


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_none_from_a_program_without_spans(monkeypatch, name):
    import repro_torch.core
    monkeypatch.delattr(repro_torch.core, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert _metric_reader(name)({}) is None
