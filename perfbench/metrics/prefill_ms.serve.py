"""ServeStats' host seconds in prefills over the prefills, in the
window."""


def read(ctx):
    s = ctx.get("serve")
    if not s or not s["prefills"]:
        return None
    return 1e3 * s["prefill_s"] / s["prefills"]
