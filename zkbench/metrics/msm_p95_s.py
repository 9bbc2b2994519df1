"""msm_p95_s: the 95th percentile (nearest rank) of every MSM request's time in
the window, its copy to the host included."""

import math


def read(run):
    lat = sorted(run.latencies)
    return lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
