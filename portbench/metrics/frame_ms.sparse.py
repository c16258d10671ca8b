"""frame_ms.sparse: frame_ms of the lane-sparse cell, a metric of its own
because its host-paced frames spread some five times wider than the
still's (PERF.md §2)."""

from portbench.run import reader

read = reader("frame_ms")
