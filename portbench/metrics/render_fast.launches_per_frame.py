"""render_fast.launches_per_frame: device kernels in the traced window
over the frames in it."""

from portbench import trace


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["spans"]:
        return None
    return trace.kernel_count(t) / t["spans"]
