"""Device milliseconds of the suppressor stage (RNNoise or DeepFilterNet3)
inside the engine's graph replay, between the events the graph records
around it (the program's ``replay.stage_ms.suppressor`` samples: the last
block of the call before the profiled one, the profiler off; closed loop)."""


def read(run):
    e = (run.get("trace") or {}).get("engine")
    if run["mix"]["loop"] != "closed" or not e or not e["unprofiled"]:
        return None
    return e["unprofiled"]["stage_ms"].get("suppressor")
