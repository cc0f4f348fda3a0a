"""Device busy time per block: the union of kernel, copy and set intervals
in the profiler's trace of a steady stretch of the window, over its blocks
(the engine's graph replay and the copies around it; open loop)."""


def read(run):
    t = run.get("trace")
    if run["mix"]["loop"] != "open" or not t or not t.get("busy_s"):
        return None
    return t["busy_ms_per_block"]
