"""The FLOPs the window's lane steps need (forward and backward,
``counts.train_step_flops``) over the window, as a share of the bf16
peak, in %."""
from perfbench.common import PEAK_BF16_FLOPS


def read(ctx):
    t = ctx.get("train")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * t["flops"] / t["window_s"] / PEAK_BF16_FLOPS
