"""Host milliseconds a block in ``ServingEngine._gather`` less the slot resets
and control writes under it (self time of the program's ``engine.gather``
span), over the call before the profiled call, with the program's spans on
and the profiler off (closed loop)."""


def read(run):
    e = (run.get("trace") or {}).get("engine")
    if run["mix"]["loop"] != "closed" or not e or not e["unprofiled"]:
        return None
    u = e["unprofiled"]
    return u["self_ns"].get("engine.gather", 0) / 1e6 / u["blocks"]
