"""1 - the union of device operations over the traced window, in %."""
from perfbench.metrics._idle import idle


def read(ctx):
    return idle(ctx) if ctx.get("serve") else None
