"""Host milliseconds a tick in the sink calls of ``ServingEngine._deliver``
(self time of the program's ``engine.deliver`` span), over the 100 ticks
before the profiled ticks, with the program's spans on and the profiler off
(open loop)."""


def read(run):
    e = (run.get("trace") or {}).get("engine")
    if run["mix"]["loop"] != "open" or not e or not e["unprofiled"]:
        return None
    u = e["unprofiled"]
    return u["self_ns"].get("engine.deliver", 0) / 1e6 / u["blocks"]
