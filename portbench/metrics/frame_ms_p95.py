"""frame_ms_p95: the 95th percentile of all the window's frame times
(host clock between consecutive synchronised frames; linear between
ranks)."""

import numpy as np


def read(ctx):
    return 1000.0 * float(np.percentile(ctx["window"].times, 95))
