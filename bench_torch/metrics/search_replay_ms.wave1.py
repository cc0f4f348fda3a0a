"""Device kernel time a 20 ms block of the compressor search's profiled
call: the union of its kernels' intervals (the fresh state, the capture's
warm-up block, the graph's replays, the output's transposes; host-device
copies and sets left out) over the take's blocks."""


def read(run):
    t = run.get("trace")
    if not t or not t.get("busy_s") or "kernel_ms_per_block" not in t:
        return None
    return t["kernel_ms_per_block"]
