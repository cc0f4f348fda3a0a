"""99th percentile over the stream-blocks of the window (the traced ticks
left out) of the time from the tick its block was due to that stream's
sink call (open loop). It varies between processes by more than a bound
can hold (PERF.md), so it stands beside ``block_p50_ms`` unbounded."""

import numpy as np


def read(run):
    lat = run.get("latencies_ms")
    return None if lat is None or not lat.size else float(np.percentile(lat, 99))
