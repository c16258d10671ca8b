"""compose.level_kernels_per_frame: launches of the composition kernel
(compose_levels_kernel, every level of a frame in one launch) in the traced
window over the frames in it; nothing where the program has no such
kernel."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["spans"]:
        return None
    from schwarzschild_tpu_torch import compose

    if not hasattr(compose, "compose_levels"):
        return None
    return sum(1 for name, _, _ in t["kernels"]
               if "compose_levels_kernel" in name) / t["spans"]
