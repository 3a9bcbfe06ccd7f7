"""Lane steps over lane slots stepped in the window, in %."""


def read(ctx):
    t = ctx.get("train")
    if not t or not t["lane_slots"]:
        return None
    return 100.0 * t["lane_steps"] / t["lane_slots"]
