"""Median wall time of one ``ServingEngine.step()`` call over the window,
timed by the benchmark around the call (engine host: gather, launch, wait,
delivery to the sinks)."""

import numpy as np


def read(run):
    steps = run.get("step_s")
    return None if steps is None or not steps.size else 1e3 * float(np.median(steps))
