"""Device milliseconds of the chain's own stages inside the engine's graph
replay: the in-step VAD, the front half and the back half, between the
events the graph records around them (the program's ``replay.stage_ms``
samples: the last block of the call before the profiled one, the profiler
off; closed loop)."""

STAGES = ("vad", "front", "back")


def read(run):
    e = (run.get("trace") or {}).get("engine")
    if run["mix"]["loop"] != "closed" or not e or not e["unprofiled"]:
        return None
    stage_ms = e["unprofiled"]["stage_ms"]
    if not all(s in stage_ms for s in STAGES):
        return None
    return sum(stage_ms[s] for s in STAGES)
