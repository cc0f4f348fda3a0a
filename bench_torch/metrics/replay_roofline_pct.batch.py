"""The sum over the step's stages of their least time (bytes at 3.35 TB/s
or operations at the f32 / f64 peak, bench_torch/counts) over the device's
busy time per block."""


def read(run):
    t = run.get("trace")
    if run["mix"]["loop"] != "closed" or not t or not t.get("busy_s"):
        return None
    return 100.0 * 1e3 * run["counts"]["bound_s"] / t["busy_ms_per_block"]
