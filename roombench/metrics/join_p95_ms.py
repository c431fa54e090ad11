"""The 95th percentile (nearest rank) over every join of the window, each
timed from the start of the batch that carried it to the return of its
reply."""

import math


def read(rec, name):
    lat = sorted(rec["join_latency_s"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
