"""Host milliseconds a tick that ``step()`` waits for the card's copy of its
block (the program's ``engine.wait`` span), over the 100 ticks before the
profiled ticks, with the program's spans on and the profiler off (open
loop)."""


def read(run):
    e = (run.get("trace") or {}).get("engine")
    if run["mix"]["loop"] != "open" or not e or not e["unprofiled"]:
        return None
    u = e["unprofiled"]
    return u["self_ns"].get("engine.wait", 0) / 1e6 / u["blocks"]
