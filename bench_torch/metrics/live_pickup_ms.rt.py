"""Median over the window's delivered blocks of the live engine of the time
from a block's input tick to the start of the ``live.burst`` span that took
it: the DSP thread's polling of its input ring (program span)."""

import numpy as np


def read(run):
    pick = run.get("live", {}).get("pickup_ms")
    return None if pick is None or not pick.size else float(np.median(pick))
