"""The whole step's share of the card's peak: the operations of one block
of the fleet (bench_torch/counts: f32 at 67 TFLOP/s, f64 at 34) over the
window's wall time per block (a traced run leaves its profiled call out)."""


def read(run):
    if run["mix"]["loop"] != "closed" or not run["blocks"] or run["device"] != "cuda":
        return None
    return 100.0 * run["counts"]["peak_s"] / run["untraced_block_s"]
