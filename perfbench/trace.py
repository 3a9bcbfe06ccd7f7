"""The traced run's reading of the device: ``torch.profiler`` over part of
the window, reduced to the device's busy time, the operations that took
most of it, the idle gaps by what the host was doing, and the device time
of each range the harness opened around a call into the port.

Times come from the profiler's own events (``kineto_results``), on the
host's wall clock in ns: kernels, copies and sets are device events; the
host's ops, ranges and CUDA runtime calls are the others. A device event
belongs to a range when the runtime call that launched it (same
correlation id) started inside the range on the range's thread."""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

RANGE_PREFIX = "pb."
NAME_CHARS = 120


class Tracer:
    """A profiler made ready when the tracer is made (in set-up: the
    profiler's own start-up took seconds on the card), recording from
    ``start`` to ``stop`` only (one warm-up and one active cycle of its
    schedule)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.events = None
        self.prof = profile(activities=acts,
                            schedule=schedule(wait=0, warmup=1, active=1,
                                              repeat=1),
                            on_trace_ready=self._ready)
        self.prof.start()               # warm-up: the profiler's start-up
        self.t0 = self.t1 = None

    def _ready(self, prof):
        self.events = prof.profiler.kineto_results.events()

    def start(self):
        self.prof.step()                # recording from here
        self.t0 = time.time_ns()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.step()                # the active cycle ends: trace ready
        self.prof.stop()

    def summary(self) -> dict:
        return summarize(self.events or [], self.t0, self.t1)


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def _merged(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, t0: int, t1: int) -> dict:
    """busy_s, window_s, the top device operations and idle gaps
    ([name, seconds], at most 10 each), and for each range opened with
    ``op_range`` the device seconds of its calls in order."""
    dev, host = [], []
    for e in events:
        name = e.name()
        if _is_device(e):
            if name.startswith(RANGE_PREFIX) or e.is_user_annotation():
                continue
            dev.append(e)
        elif not name.startswith("ProfilerStep"):   # the schedule's range
            host.append(e)
    spans = []
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        s, d = e.start_ns(), e.duration_ns()
        by_name[e.name()[:NAME_CHARS]] += d / 1e9
        spans.append((max(s, t0), min(s + d, t1)))
    busy = _merged([(s, e) for s, e in spans if e > s])
    busy_ns = sum(e - s for s, e in busy)

    # idle gaps within the window, by the innermost host event at their start
    host.sort(key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in host]
    gaps, edge = [], t0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    idle: Dict[str, float] = defaultdict(float)
    for gs, ge in gaps:
        name = "no host op"
        i = bisect.bisect_right(starts, gs) - 1
        for j in range(i, max(i - 2000, -1), -1):
            h = host[j]
            if h.start_ns() + h.duration_ns() >= gs:
                name = h.name()[:NAME_CHARS]
                break
        idle[name] += (ge - gs) / 1e9

    # device time of each harness range: kernels whose launch lies in it
    launches = defaultdict(list)          # thread -> [(start, correlation)]
    for h in host:
        if h.name().startswith(("cuda", "cu")) and h.correlation_id():
            launches[h.start_thread_id()].append((h.start_ns(),
                                                  h.correlation_id()))
    dev_by_corr: Dict[int, float] = defaultdict(float)
    for e in dev:
        dev_by_corr[e.correlation_id()] += e.duration_ns() / 1e9
    ranges: Dict[str, List[tuple]] = defaultdict(list)
    for h in host:
        name = h.name()
        if not name.startswith(RANGE_PREFIX) or "#" not in name:
            continue
        tag, _, idx = name.partition("#")
        s, e = h.start_ns(), h.start_ns() + h.duration_ns()
        if s < t0 or e > t1:
            continue
        calls = launches.get(h.start_thread_id(), [])
        lo = bisect.bisect_left(calls, (s, -1))
        hi = bisect.bisect_right(calls, (e, 1 << 62))
        secs = sum(dev_by_corr.get(c, 0.0) for _, c in calls[lo:hi])
        ranges[tag].append((int(idx), secs))
    top = lambda d: [[k, v] for k, v in sorted(d.items(),         # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_ns / 1e9, "window_s": (t1 - t0) / 1e9,
            "device_ops": top(by_name), "idle_gaps": top(idle),
            "ranges": {k: sorted(v) for k, v in ranges.items()},
            "n_device_events": len(dev)}


@contextlib.contextmanager
def op_ranges(module, names: List[str], work: Dict[str, Callable],
              calls: Dict[str, List[tuple]]):
    """Within the block, each ``module.<name>`` runs inside a profiler
    range ``pb.op.<name>#<i>`` and appends (i, flops, bytes) from
    ``work[name](*args, **kwargs)`` to ``calls[name]``."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def traced(*args, **kwargs):
            i = len(calls[name])
            calls[name].append((i, *work[name](*args, **kwargs)))
            tag = f"{RANGE_PREFIX}op.{name}#{i}"
            with torch.profiler.record_function(tag):
                return fn(*args, **kwargs)
        return traced

    for n in names:
        calls.setdefault(n, [])
        setattr(module, n, wrap(n, saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def range_roofline(summary: Optional[dict], calls: List[tuple],
                   tag: str) -> Optional[float]:
    """Σ least time / Σ device time, in %, over the calls of ``tag`` that
    the trace holds with device time; None when there are none."""
    from perfbench.counts import bound_s
    if not summary:
        return None
    dev = dict(summary["ranges"].get(f"{RANGE_PREFIX}op.{tag}", []))
    bound = spent = 0.0
    for i, flops, nbytes in calls:
        if dev.get(i, 0.0) > 0:
            bound += bound_s(flops, nbytes)
            spent += dev[i]
    return 100.0 * bound / spent if spent > 0 else None
