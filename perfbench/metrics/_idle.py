"""The device's idle share of the traced window, shared by the
``device_idle.*`` readers."""


def idle(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["n_device_events"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
