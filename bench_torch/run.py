"""Run one cell of the port's benchmark once and print its result.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card: it builds
the serving engine of the cell's configuration (or the program the
configuration names, ``bench_torch/programs/``), warms it up, measures for
``--seconds`` seconds, checks the probe streams against the plain reference
and prints one JSON object as its last line of standard output. With no
card, or fewer than the cell asks for, it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "audioforge_tpu"}
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_torch" / sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch import harness

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), T_START)
    # the port and the benchmark run without the JAX package: a run that
    # loaded it (or JAX) prints no result
    loaded = sorted({m.split(".")[0] for m in sys.modules} & JAX_NAMES)
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
