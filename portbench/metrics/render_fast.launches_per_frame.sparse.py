"""render_fast.launches_per_frame.sparse: render_fast.launches_per_frame in
the lane-sparse cell, where it moves frame_ms.sparse."""

from portbench.run import reader

read = reader("render_fast.launches_per_frame")
