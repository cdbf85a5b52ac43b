"""The 95th percentile (nearest rank), over every request due in the window,
of the seconds from its due time to the last byte of its PDB answer; a
failed or refused request counts as infinitely late."""

import math


def read(record):
    lat = sorted(record.latencies)
    if not lat:
        return None
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return p95 if math.isfinite(p95) else None
