"""The whole step's share of the card's peak in the live engine: a block's
operations at one stream (``bench_torch/counts/live.py``: the front half,
the RNNoise frame, the back half and the Silero worker's windows a block;
f32 at 67 TFLOP/s, f64 at 34) over ``live_burst_ms.rt``, the median burst
wall time a block (program span)."""

import numpy as np


def read(run):
    live = run.get("live", {})
    burst = live.get("burst_ms")
    if run["device"] != "cuda" or burst is None or not burst.size:
        return None
    return 100.0 * run["counts"]["peak_s"] / (float(np.median(burst)) / 1e3)
