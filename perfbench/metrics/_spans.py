"""The program's own spans (``repro_torch.core.spans``), shared by the
readers of span metrics. A program without the recorder, or a run that
recorded no such span, reads None."""
from __future__ import annotations

import statistics
from typing import Callable, List, Optional


def record() -> List[dict]:
    """The complete spans of the program's latest recording session (the
    traced window), or [] where the program has no recorder."""
    try:
        from repro_torch.core import spans
    except ImportError:
        return []
    return spans.record()


def median_ms(name: str, field: str,
              keep: Callable[[dict], bool] = lambda s: True
              ) -> Optional[float]:
    """The median of ``field`` (``host_ms`` or ``stream_ms``) over the
    spans called ``name`` that ``keep`` admits and that hold the field."""
    vals = [s[field] for s in record()
            if s["name"] == name and s[field] is not None and keep(s)]
    return statistics.median(vals) if vals else None


def counted_under(spans: List[dict], name: str, counter: str) -> List[int]:
    """For each span called ``name``, its ``counter`` summed with that of
    every span below it."""
    children: dict = {}
    for s in spans:
        children.setdefault(s["parent"], []).append(s)
    out = []
    for root in (s for s in spans if s["name"] == name):
        total, todo = 0, [root]
        while todo:
            s = todo.pop()
            total += s["counts"].get(counter, 0)
            todo.extend(children.get(s["id"], []))
        out.append(total)
    return out
