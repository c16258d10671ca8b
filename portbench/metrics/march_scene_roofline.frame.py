"""march_scene_roofline.frame: the scene march's least time at the
traced frames' inputs (work.march_bound_s of the executed steps that the
benchmark's own march counts) over its device time, in percent."""

from portbench import roofline


def read(ctx):
    return roofline.march(ctx)
