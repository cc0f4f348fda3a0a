"""The control of the benchmark's check: the plain reference put in the
program's place and computed one precision below the configuration's.

The configurations state float32 with TF32 off (the port sets
``allow_tf32 = False``), so the control computes every matrix product and
convolution of the reference in TF32: each float32 input rounded to TF32's
10-bit mantissa (round to nearest, ties to even), the products summed in
float32, as the card does with TF32 on. It runs the probe streams of a
cell's traffic, on the seeds given, and compares them with the float32
reference by the numbers the benchmark compares:

    python3 bench_torch/control.py --workload <name> --seeds 1 2 3

prints, per seed, each number beside the configuration's limit, and last a
JSON line. A sound limit lies above the program's readings and below every
control reading (``bench_torch/readings.py`` takes both on the card).
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PRODUCTS = ("aten.mm.", "aten.addmm.", "aten.bmm.", "aten.baddbmm.", "aten.convolution.")


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32: 10 mantissa bits, nearest, ties to
    even; other dtypes as they are."""
    if t.dtype != torch.float32:
        return t
    bits = t.view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(t)
    return torch.where(finite, rounded.view(torch.float32), t)


class TF32(TorchDispatchMode):
    """Inside it, the float32 inputs of every matrix product and convolution
    are rounded to TF32 first."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(_PRODUCTS):
            args = tuple(to_tf32(a) if isinstance(a, torch.Tensor) else a for a in args)
        return func(*args, **(kwargs or {}))


def tf32_rows(config: dict, x: np.ndarray) -> np.ndarray:
    """The plain reference over ``x`` as :func:`harness.reference_rows`
    runs it, in TF32."""
    from .harness import reference_rows

    with TF32():
        return reference_rows(config, x)


def probe_numbers(config: dict, mix: dict, fleet: int, seed: int, sizes: dict | None = None):
    """The compared numbers of the TF32 control on one seed's probes: the
    reference in TF32 against the reference in float32."""
    from .harness import compare, one_ulp_up, reference_rows
    from .traffic.generator import Traffic

    check = dict(config["check"], **(sizes or {}))
    traffic = Traffic(mix, fleet, int(check["probes"]), seed)
    x = np.stack([traffic.probe_input(j, int(check["blocks"]))
                  for j in range(len(traffic.probe_at))])
    both = reference_rows(config, np.concatenate([x, one_ulp_up(x)]))
    return compare(tf32_rows(config, x), both[:len(x)], both[len(x):], traffic.probe_class)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the TF32 control of a cell's check")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    from . import harness

    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    config, mix, fleet = harness.cell_files(harness.find_cell(bench, args.workload))
    limits, rows = config["check"]["limits"], []
    with ProcessPoolExecutor(len(args.seeds), mp_context=get_context("spawn")) as pool:
        results = [pool.submit(probe_numbers, config, mix, fleet, s) for s in args.seeds]
        results = [r.result() for r in results]
    for seed, numbers in zip(args.seeds, results):
        caught = any(numbers[k] > v for k, v in limits.items())
        rows.append({"seed": seed, **numbers, "fails_check": caught})
        print(f"control {args.workload} seed {seed}: " + ", ".join(
            f"{k} {v}" + (f" (limit {limits[k]:g})" if k in limits else "")
            for k, v in numbers.items()) + f"; fails the check: {caught}", flush=True)
    print(json.dumps({"workload": args.workload, "control": "TF32", "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from bench_torch import control
    sys.exit(control.main())
