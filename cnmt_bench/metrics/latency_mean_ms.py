"""Mean latency of every request due in the window: from its due time to
its submission, plus the engine's latency (queue, execution, link)."""

import math


def read(run):
    lat = [s.latency_s for s in run.window.served
           if s.device >= 0 and math.isfinite(s.latency_s)]
    return 1e3 * sum(lat) / len(lat) if lat else None
