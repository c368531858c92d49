"""The 95th percentile of the latency of every solve call in the window
(host clock around the call, which ends when the solution is ready),
in milliseconds."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile([c.seconds for c in run.calls], 95))
