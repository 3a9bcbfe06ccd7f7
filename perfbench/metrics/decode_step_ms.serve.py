"""ServeStats' host seconds in decode steps over the steps, in the
window."""


def read(ctx):
    s = ctx.get("serve")
    if not s or not s["global_steps"]:
        return None
    return 1e3 * s["decode_s"] / s["global_steps"]
