"""The 95th percentile (nearest rank) of every request's time from the
``generate`` call to its images on the host, in ms."""

import math


def read(r):
    lat = sorted(r.latencies_s)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
