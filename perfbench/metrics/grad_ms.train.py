"""Stream time of ``train.grad`` (the forward and backward of every lane
under the pool's vmap), the median over the traced window's pool steps,
in ms."""
from perfbench.metrics._spans import median_ms


def read(ctx):
    return median_ms("train.grad", "stream_ms")
