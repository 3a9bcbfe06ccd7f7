"""The 95th percentile of every gap between two consecutive tokens of a
request whose later token fell in the window, on the host clock, in ms.
The serve cells run above capacity (every request queued at the start),
so this tail is a per-layer reading beside the tokens per second."""


def read(ctx):
    s = ctx.get("serve")
    return s["gap_p95_ms"] if s else None
