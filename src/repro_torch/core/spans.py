"""The port's program spans: where a traced run spends its time, by phase.

A span is opened with ``with span(name, **attrs):`` at a phase boundary of
the program (a lane-pool iteration, a train step's gradient, a decode step,
a public kernel op). While no profiler records, ``span`` returns one shared
no-op context and ``count`` returns at once: an untraced run pays one
attribute read a call. While a profiler records (``torch.profiler`` or
``torch.autograd.profiler``; in a scheduled profiler, its active cycles
only), a span

  * opens a profiler range ``repro_torch.<name>``, so the trace shows the
    phase and names the host work inside it;
  * takes ``time.time_ns()`` at both ends, the clock of the profiler's
    events, so a span lines up with the trace;
  * records a CUDA event pair on the current stream where CUDA is in use,
    for the stream time between its ends;
  * notes its parent, the innermost span open on its thread, and the
    request it serves (``req=<id>`` among the attrs).

``count(name, n)`` adds ``n`` to the innermost open span's counter ``name``
(``cast_bytes``: the bytes of a weight read by a cast to the compute dtype).

To use it, run the work under a profiler and read both afterwards: the
ranges in the profiler's trace, and ``record()``, the complete spans of the
latest recording session in the order they opened, each a dict of ``id``,
``name``, ``t0_ns``, ``t1_ns``, ``host_ms``, ``stream_ms`` (None without
CUDA), ``parent`` (an ``id`` or None), ``req``, ``attrs`` and ``counts``. A
span still open when recording stops is dropped. The first span recorded
after a stop starts a new record; the recorder sees the stop at the first
``span``, ``count`` or ``record`` call made while nothing records.

    with torch.profiler.profile(activities=[...]):
        server.run(requests)
    steps = [s for s in spans.record() if s["name"] == "serve.decode_step"]
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

PREFIX = "repro_torch."


class _Noop:
    """The context ``span`` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _Noop()


class _Recorder:
    """The live session (None while nothing records) and the latest one,
    each the list of its spans in the order they opened, and each
    thread's stack of open spans."""

    def __init__(self):
        self.live: Optional[list] = None
        self.last: Optional[list] = None
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def session(self) -> list:
        if self.live is None:
            self.live = self.last = []
        return self.live


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "attrs", "req", "session", "id", "parent", "t0_ns",
                 "t1_ns", "ev", "stream_ms", "counts", "done", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.req = attrs.pop("req", None)
        self.attrs = attrs
        self.counts: Dict[str, int] = {}
        self.ev = None
        self.stream_ms = None
        self.done = False

    def set(self, **attrs):
        """Attrs known only once the phase has run."""
        self.attrs.update(attrs)

    def __enter__(self):
        sess = _REC.session()
        stack = _REC.stack()
        top = stack[-1] if stack else None
        self.session = sess
        self.parent = top.id if top is not None and top.session is sess \
            else None
        self.id = len(sess)
        sess.append(self)
        self.t0_ns = time.time_ns()  # lint: disable=DET002(the profiler's event clock: a span lines up with the trace's ranges on it)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.ev[1].record()
        self._range.__exit__(*exc)
        self.t1_ns = time.time_ns()  # lint: disable=DET002(the profiler's event clock: a span lines up with the trace's ranges on it)
        _REC.stack().pop()
        if _profiler._is_profiler_enabled and _REC.live is self.session:
            self.done = True
        else:
            _REC.live = None            # recording stopped inside the span
        return False


def span(name: str, **attrs):
    """A context around one phase named ``name``; ``req=<id>`` ties it to
    a request, the other attrs describe it (``set`` adds more inside)."""
    if _profiler._is_profiler_enabled:
        return _Span(name, attrs)
    if _REC.live is not None:
        _REC.live = None
    return _NOOP


def count(name: str, n: int):
    """Add ``n`` to counter ``name`` of the innermost open span."""
    if not _profiler._is_profiler_enabled:
        if _REC.live is not None:
            _REC.live = None
        return
    stack = _REC.stack()
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n


def _plain(v):
    if isinstance(v, torch.Size):
        return list(v)
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    return v


def record() -> List[dict]:
    """The complete spans of the latest recording session, in the order
    they opened (see the module docstring). Stream times are resolved
    here, after one synchronize."""
    if not _profiler._is_profiler_enabled:
        _REC.live = None
    sess = _REC.last
    if sess is None:
        return []
    done = [s for s in sess if s.done]
    pending = [s for s in done if s.ev is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.stream_ms = s.ev[0].elapsed_time(s.ev[1])
            s.ev = None
    return [{"id": s.id, "name": s.name, "t0_ns": s.t0_ns, "t1_ns": s.t1_ns,
             "host_ms": (s.t1_ns - s.t0_ns) / 1e6, "stream_ms": s.stream_ms,
             "parent": s.parent, "req": s.req,
             "attrs": {k: _plain(v) for k, v in s.attrs.items()},
             "counts": dict(s.counts)} for s in done]
