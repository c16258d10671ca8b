"""device.idle_pct.sparse: device.idle_pct.frame in the lane-sparse cell,
where it moves frame_ms.sparse."""

from portbench.run import reader

read = reader("device.idle_pct.frame")
