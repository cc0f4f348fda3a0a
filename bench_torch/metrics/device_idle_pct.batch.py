"""Share of the profiled stretch of the window in which no kernel, copy or
set ran on the device."""


def read(run):
    t = run.get("trace")
    if run["mix"]["loop"] != "closed" or not t or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
