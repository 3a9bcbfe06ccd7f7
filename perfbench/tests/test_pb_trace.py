"""The trace's reduction on hand-made events: the busy union, the top
device operations, idle gaps by host activity, and the device time of a
harness range through the launches' correlation ids."""
from __future__ import annotations

import pytest
import torch

from perfbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, thread=1,
                 annotation=False):
        self._a = (name, dev, start, dur, corr, thread, annotation)

    def name(self):
        return self._a[0]

    def device_type(self):
        return self._a[1]

    def start_ns(self):
        return self._a[2]

    def duration_ns(self):
        return self._a[3]

    def correlation_id(self):
        return self._a[4]

    def start_thread_id(self):
        return self._a[5]

    def is_user_annotation(self):
        return self._a[6]


def events():
    return [
        Ev("pb.op.flash_attention#0", CPU, 100, 300),
        Ev("cudaLaunchKernel", CPU, 150, 10, corr=7),
        Ev("cudaLaunchKernel", CPU, 250, 10, corr=8),
        Ev("cudaLaunchKernel", CPU, 600, 10, corr=9),
        Ev("aten::item", CPU, 500, 200),
        Ev("kernel_a", CUDA, 200, 100, corr=7),
        Ev("kernel_b", CUDA, 280, 70, corr=8),
        Ev("kernel_a", CUDA, 800, 100, corr=9),
        Ev("pb.op.flash_attention#0", CUDA, 200, 150, annotation=True),
    ]


def test_summary_on_hand_made_events():
    s = trace.summarize(events(), 0, 1000)
    # busy: [200, 350] and [800, 900]
    assert s["busy_s"] == 250e-9 and s["window_s"] == 1000e-9
    assert s["device_ops"][0][0] == "kernel_a"
    assert s["device_ops"][0][1] == pytest.approx(200e-9)
    assert s["device_ops"][1] == ["kernel_b", pytest.approx(70e-9)]
    idle = dict(s["idle_gaps"])
    # [0, 200): no host op at 0; [350, 800): aten::item covers 500.. but
    # at 350 the innermost covering event is the range (100..400)
    assert idle["no host op"] == pytest.approx(300e-9)
    assert idle["pb.op.flash_attention#0"] == pytest.approx(450e-9)
    assert s["ranges"]["pb.op.flash_attention"] == [(0, pytest.approx(170e-9))]


def test_range_roofline_reads_only_traced_calls():
    s = trace.summarize(events(), 0, 1000)
    calls = [(0, 0.0, 3.35e12 * 85e-9), (1, 1.0, 1.0)]
    assert abs(trace.range_roofline(s, calls, "flash_attention") - 50.0) < 1e-9
    assert trace.range_roofline(s, calls, "rmsnorm") is None
    assert trace.range_roofline(None, calls, "flash_attention") is None


def test_op_ranges_wrap_and_restore():
    import types
    mod = types.SimpleNamespace(f=lambda x: x + 1)
    calls: dict = {}
    with trace.op_ranges(mod, ["f"], {"f": lambda x: (2 * x, 3 * x)},
                         calls):
        assert mod.f(1) == 2 and mod.f(2) == 3
    assert calls["f"] == [(0, 2, 3), (1, 4, 6)]
    assert mod.f(1) == 2 and not hasattr(mod.f, "__wrapped__")
