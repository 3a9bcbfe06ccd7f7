"""The FLOPs of the tokens prefilled and decoded in the window
(``counts.prefill_flops``, ``counts.decode_flops``) over the window, as
a share of the bf16 peak, in %."""
from perfbench.common import PEAK_BF16_FLOPS


def read(ctx):
    s = ctx.get("serve")
    if not s or s["window_s"] <= 0 or not s["flops"]:
        return None
    return 100.0 * s["flops"] / s["window_s"] / PEAK_BF16_FLOPS
