"""Host-device copy time a 20 ms block of the compressor search's profiled
call: the union of its host-to-device and device-to-host copies (the take
staged, the candidates' output audio and stats fetched) over the take's
blocks."""


def read(run):
    t = run.get("trace")
    if not t or not t.get("busy_s") or "copy_ms_per_block" not in t:
        return None
    return t["copy_ms_per_block"]
