"""Share of the profiled call in which the device is idle while the
host works inside the engine, under an engine span other than
``engine.wait`` (the host waiting for the card) and ``engine.launch`` (whose
idle is mostly the profiler's own: a graph launch holds the host for
milliseconds under its CUDA tracing), the innermost open at each moment;
the stretch is counted without the idle under ``engine.launch`` (closed
loop)."""

LEFT_OUT = ("engine.wait", "engine.launch")


def read(run):
    e = (run.get("trace") or {}).get("engine")
    if run["mix"]["loop"] != "closed" or not e:
        return None
    idle = e["idle_ns"]
    host = sum(v for k, v in idle.items() if k.startswith("engine.") and k not in LEFT_OUT)
    return 100.0 * host / (e["window_ns"] - idle.get("engine.launch", 0))
