"""inverse.launches_per_step: device kernels in the traced window over the
fit steps in it."""

from portbench import trace


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["spans"]:
        return None
    return trace.kernel_count(t) / t["spans"]
