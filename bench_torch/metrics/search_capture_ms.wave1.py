"""Host milliseconds of the program's ``replay.capture`` spans in one call
of the compressor search, traced with the program's tracer on and the
profiler off (``runtime/tracing.py`` ``snapshot()``): the graph ``run_take``
captures afresh every call, its eager warm-up block included."""


def read(run):
    t = run.get("tracer")
    if not t or not t["captures"]:
        return None
    return t["capture_ms"]
