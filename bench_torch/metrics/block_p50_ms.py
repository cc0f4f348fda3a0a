"""Median over every stream-block of the window of the time from the tick
its block was due to that stream's sink call (open loop)."""

import numpy as np


def read(run):
    lat = run.get("latencies_ms")
    return None if lat is None or not lat.size else float(np.percentile(lat, 50))
