"""Stream time of ``serve.attach``, a joiner's cache written into its
lane of the pool, the median over the traced window's joiners, in ms."""
from perfbench.metrics._spans import median_ms


def read(ctx):
    return median_ms("serve.attach", "stream_ms")
