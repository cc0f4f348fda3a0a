"""99th percentile over the window's delivered blocks of the live engine
of the time from a block's input tick to the end of the ``live.burst``
span that wrote it into the output ring (``block_p50_ms``'s latencies):
the tail, where a capture on the DSP thread stalls it."""

import numpy as np


def read(run):
    lat = run.get("live", {}).get("latencies_ms")
    return None if lat is None or not lat.size else float(np.percentile(lat, 99))
