"""95th percentile of the latencies of every request due in the window
(numpy's linear interpolation), over all requests at once."""

import math

import numpy as np


def read(run):
    lat = [s.latency_s for s in run.window.served
           if s.device >= 0 and math.isfinite(s.latency_s)]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
