"""march_scene_bwd_roofline: the adjoint kernel's least time at the
traced fit steps' inputs (work.bwd_bound_s) over its device time, in
percent."""

from portbench import roofline


def read(ctx):
    return roofline.bwd(ctx)
