"""march_scene_roofline.fit: the scene march's least time at the traced
fit steps' inputs over its device time, in percent."""

from portbench import roofline


def read(ctx):
    return roofline.march(ctx)
