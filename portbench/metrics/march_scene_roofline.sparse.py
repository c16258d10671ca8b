"""march_scene_roofline.sparse: march_scene_roofline.frame in the lane-
sparse cell, where it moves frame_ms.sparse."""

from portbench.run import reader

read = reader("march_scene_roofline.frame")
