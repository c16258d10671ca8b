"""compose.device_ms_per_frame.sparse: compose.device_ms_per_frame in the
lane-sparse cell, where it moves frame_ms.sparse."""

from portbench.run import reader

read = reader("compose.device_ms_per_frame")
