"""compose.device_ms_per_frame: device time of every kernel in the traced
window but the scene march, over the frames in it (composition, the
atlas, rays and masks, the sparse gather and scatter)."""

from portbench import trace


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["spans"]:
        return None
    return 1000.0 * trace.kernel_seconds(
        t, lambda n: not trace.is_march(n)) / t["spans"]
