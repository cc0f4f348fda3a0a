"""The readings a cell's limits are set from, taken in one process on the
card: the program's compared numbers on many seeds, and the TF32 control's
on some of them.

    python3 bench_torch/readings.py --workloads <name> ... --seconds 6 ... \
        --seeds 11 12 ... --control 11 12 13 [--save readings.npz]

For each workload (with its own ``--seconds``, or one for all) each seed
runs the cell as a run does (its fleet, its loop, its probes) in a window
long enough for every probe to deliver its blocks; the probes are then
checked against the plain reference as a run checks them. The reference's
loops cost the same per block whatever the batch, so each workload's rows
of every seed, and the same one ULP up, go into one reference run, and the
control's TF32 rows into a second; all of them run side by side once the
card is done. Prints a line
per workload and seed and, last, a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# the caches at run.py's paths, so that the program's build is shared with it
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_torch" / sub)


def _per_block(a: np.ndarray) -> np.ndarray:
    """RMS a block of ``[P, k * 480]``: ``[P, k]``."""
    return np.sqrt(np.mean(a.reshape(a.shape[0], -1, 480) ** 2, axis=-1))


def _rows_of(job: tuple, data: dict, name: str, seed: int) -> np.ndarray:
    """``seed``'s rows of a reference job ``(seeds, rows)`` run over the
    probes of ``seeds`` in order."""
    seeds, rows = job
    counts = [data[name, s]["checked"] for s in seeds]
    at = sum(counts[:seeds.index(seed)])
    return rows[at:at + data[name, seed]["checked"]]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workloads", nargs="+", required=True)
    parser.add_argument("--seconds", type=float, nargs="+", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, nargs="*", default=[])
    parser.add_argument("--save", help="an .npz of each probe's RMS a block: the "
                        "reference's, and the distance from it of the program, of the "
                        "reference one ULP up and of the control")
    args = parser.parse_args(argv)
    import torch

    from bench_torch import control, harness

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    seconds = dict(zip(args.workloads, args.seconds * len(args.workloads)
                       if len(args.seconds) == 1 else args.seconds))
    data, rows = {}, []
    for name in args.workloads:
        cell = harness.find_cell(bench, name)
        for seed in args.seeds:
            r = harness.run_cell(bench, cell, seed, seconds[name], False, time.perf_counter(),
                                 reference=False)
            d = data[name, seed] = r["probes"]
            rows.append({"workload": name, "seed": seed, "failed": r["failed"],
                         "attempted": r["attempted"], "probes_checked": [d["checked"], d["of"]]})
            print(f"{name} seed {seed}: window done, failed {r['failed']}, probes "
                  f"{d['checked']} of {d['of']}", flush=True)
    jobs = {}
    with ProcessPoolExecutor(2 * len(args.workloads), mp_context=get_context("spawn")) as pool:
        for name in args.workloads:
            config = harness.cell_files(harness.find_cell(bench, name))[0]
            done = [s for s in args.seeds if data[name, s]["checked"]]
            for kind, seeds in (("program", done),
                                ("control", [s for s in done if s in args.control])):
                if seeds:
                    x = np.concatenate([data[name, s]["x"] for s in seeds])
                    job = (pool.submit(harness.reference_rows, config,
                                       np.concatenate([x, harness.one_ulp_up(x)]))
                           if kind == "program" else pool.submit(control.tf32_rows, config, x))
                    jobs[name, kind] = (seeds, job)
        out = {key: (seeds, f.result()) for key, (seeds, f) in jobs.items()}
    saved = {}
    for row in rows:
        name, seed = row["workload"], row["seed"]
        d = data[name, seed]
        if not d["checked"]:
            continue
        config = harness.cell_files(harness.find_cell(bench, name))[0]
        limits = config["check"]["limits"]
        seeds, both = out[name, "program"]
        half = len(both) // 2
        w = _rows_of((seeds, both[:half]), data, name, seed)
        moved = _rows_of((seeds, both[half:]), data, name, seed)
        row["program"] = harness.compare(d["got"], w, moved, d["classes"])
        row["correct"] = harness.verdict(
            {"probes_checked": (d["checked"], d["of"]), **row["program"]}, limits)[0]
        key = f"{name}_{seed}"
        saved.update({f"{key}_classes": d["classes"], f"{key}_ref": _per_block(w),
                      f"{key}_program": _per_block(d["got"] - w),
                      f"{key}_ulp": _per_block(moved - w)})
        if seed in out.get((name, "control"), ((),))[0]:
            ctl = _rows_of(out[name, "control"], data, name, seed)
            row["control"] = harness.compare(ctl, w, moved, d["classes"])
            saved[f"{key}_control"] = _per_block(ctl - w)
        print(f"{name} seed {seed}: program {row['program']}"
              + (f", control {row['control']}" if "control" in row else "")
              + f"; correct {row['correct']} under {limits}", flush=True)
    if args.save:
        np.savez(args.save, **saved)
    print(json.dumps({"runs": rows}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
