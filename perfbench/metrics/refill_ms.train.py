"""Stream time of a ``pool.refill`` that attached a task (its state made
and written into a free lane), the median over the traced window's
refills, in ms."""
from perfbench.metrics._spans import median_ms


def read(ctx):
    return median_ms("pool.refill", "stream_ms",
                     lambda s: s["attrs"].get("attached", 0) >= 1)
