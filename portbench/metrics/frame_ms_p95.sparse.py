"""frame_ms_p95.sparse: frame_ms_p95 of the lane-sparse cell (see
frame_ms.sparse)."""

from portbench.run import reader

read = reader("frame_ms_p95")
