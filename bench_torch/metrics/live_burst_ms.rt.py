"""Median over the window's delivered blocks of the live engine of the wall
time of the ``live.burst`` span that wrote the block, over the burst's
blocks: front, suppressor, back, the metrics' unpack and the output writer
(program span; the halves' self times are in a traced run's breakdown)."""

import numpy as np


def read(run):
    burst = run.get("live", {}).get("burst_ms")
    return None if burst is None or not burst.size else float(np.median(burst))
