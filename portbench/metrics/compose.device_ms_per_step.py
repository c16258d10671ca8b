"""compose.device_ms_per_step: device time of every kernel in the traced
window but the two march kernels, over the fit steps in it (composition
forward and backward, the atlas rebuild, the loss, the optimizer)."""

from portbench import trace


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["spans"]:
        return None
    return 1000.0 * trace.kernel_seconds(
        t, lambda n: not (trace.is_march(n) or trace.is_march_bwd(n))
    ) / t["spans"]
