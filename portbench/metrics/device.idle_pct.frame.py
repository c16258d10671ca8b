"""device.idle_pct.frame: 100 x (1 - busy_s / window_s) of the traced window
of frames, the same two numbers the result line gives under device."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
