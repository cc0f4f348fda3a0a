"""Host milliseconds of the ``replay.capture`` spans that start in the live
engine's window or its drain: the graphs captured on the DSP thread for the
topology the UI's de-esser toggle makes (the front and back halves' pair,
once; the toggle back finds them in the cache). Warm-up and capture, from
taking the capture lock (program span)."""


def read(run):
    return run.get("live", {}).get("capture_ms")
