"""Median host time between two pool steps' completions in the window."""


def read(ctx):
    t = ctx.get("train")
    return t["step_ms_median"] if t else None
