"""Stream time of ``pool.select``, the "where" mode's ``torch.where`` that
keeps inactive lanes' state, the median over the traced window's pool
steps, in ms."""
from perfbench.metrics._spans import median_ms


def read(ctx):
    return median_ms("pool.select", "stream_ms")
