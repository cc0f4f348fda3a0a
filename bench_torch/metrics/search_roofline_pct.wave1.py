"""The sum over the offline chain's stages of their least time a 20 ms block
of the search's candidates (bytes at 3.35 TB/s or operations at the f32 /
f64 peak, ``bench_torch/counts`` ``chain_stages``) over the device kernel
time a block, ``search_replay_ms.wave1``."""


def read(run):
    t = run.get("trace")
    if not t or not t.get("busy_s") or not t.get("kernel_ms_per_block"):
        return None
    return 100.0 * 1e3 * run["counts"]["bound_s"] / t["kernel_ms_per_block"]
