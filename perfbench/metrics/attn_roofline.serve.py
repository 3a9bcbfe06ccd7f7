"""Flash attention's least time (``counts.attention_work`` at the bf16
and memory peaks) over the device time of the kernels launched inside the
``ops.flash_attention`` calls of the traced window, in %."""
from perfbench.trace import range_roofline


def read(ctx):
    s = ctx.get("serve")
    if not s:
        return None
    return range_roofline(ctx.get("trace"),
                          s["op_calls"].get("flash_attention", []),
                          "flash_attention")
