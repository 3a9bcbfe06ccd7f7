"""Host time of ``serve.read``, the decode step's read of its tokens: how
long the host waits there for the card, the median over the traced
window's decode steps, in ms."""
from perfbench.metrics._spans import median_ms


def read(ctx):
    return median_ms("serve.read", "host_ms")
