"""compose.level_kernels_per_step: compose.level_kernels_per_frame over the
fit steps in the traced window (a step asks for gradients, so its
composition runs in torch and the reading is 0)."""

from portbench.run import reader

read = reader("compose.level_kernels_per_frame")
