"""The knee sweep of an open-loop mix: fleets from 64 up in steps of 64,
each run for ``--seconds`` on the mix's ticks in one process, until two in a
row miss; the knee is the largest fleet that keeps ``block_p99_ms`` within
the limit with no growing backlog. The cell's fleet is four fifths of it,
rounded down to a multiple of 64.

    python3 bench_torch/sweep.py --config full_rnnoise_vad --mix paced --seed 5 --seconds 20

It writes ``traffic/fleets/<mix>.<config>.json`` (also into ``--out``, a
directory, when given) and prints the readings as rows of a Markdown table.
It needs a CUDA card, as a run does.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

LIMIT_MS = 10.0
FLEETS = range(64, 1025, 64)


def measure(config: dict, mix: dict, fleet: int, seed: int, seconds: float) -> dict:
    """One fleet's open-loop window: its latency percentiles, late ticks and
    whether the lateness grew from the window's first tenth to its last."""
    import torch

    from bench_torch import harness
    from bench_torch.traffic.generator import Traffic

    eng = harness.build_engine(config, fleet, "cuda")
    traffic = Traffic(mix, fleet, 1, seed)
    ceiling = float(harness.ref_live_params(config)["limiter_ceiling_linear"])
    run = harness._Run(eng, traffic, fleet, 0, ceiling * (1 + 1e-6), False)
    harness.warm_up(run, mix)
    w = harness.open_loop(run, mix, seconds)
    gc.unfreeze()
    lat = w["latencies_ms"].reshape(w["blocks"], fleet)
    first, last = lat[: len(lat) // 10, 0].mean(), lat[-len(lat) // 10:, 0].mean()
    row = {"fleet": fleet, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "late_ticks": w["late_ticks"],
           "ticks": w["blocks"], "failed": run.failed,
           "step_ms_p50": 1e3 * float(np.median(w["step_s"])),
           "growing": bool(last > first + mix["tick_ms"]) or run.failed > 0}
    del eng, run
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the knee sweep of an open-loop mix")
    parser.add_argument("--config", required=True)
    parser.add_argument("--mix", default="paced")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch

    from bench_torch import harness

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    config = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")
    mix = harness.load_json(harness.HERE / "traffic" / f"{args.mix}.json")
    rows, missed = [], 0
    for fleet in FLEETS:
        t = time.perf_counter()
        rows.append(measure(config, mix, fleet, args.seed, args.seconds))
        print(json.dumps(rows[-1]), f"({time.perf_counter() - t:.1f} s)", flush=True)
        missed = missed + 1 if rows[-1]["p99_ms"] > LIMIT_MS or rows[-1]["growing"] else 0
        if missed == 2:
            break
    within = [r["fleet"] for r in rows if r["p99_ms"] <= LIMIT_MS and not r["growing"]]
    knee = max(within) if within else None
    fleet = max(64, int(0.8 * knee) // 64 * 64) if knee else 64
    card = torch.cuda.get_device_name(0)
    record = {"fleet": fleet, "knee": knee, "limit_ms": LIMIT_MS, "seconds": args.seconds,
              "seed": args.seed, "card": card, "readings": rows}
    name = f"{args.mix}.{args.config}.json"
    for d in [harness.HERE / "traffic" / "fleets"] + ([args.out] if args.out else []):
        d.mkdir(parents=True, exist_ok=True)
        (d / name).write_text(json.dumps(record, indent=1) + "\n")
    print(f"| {args.config} fleet | p50 ms | p99 ms | late ticks | step() p50 ms | growing |")
    for r in rows:
        print(f"| {r['fleet']} | {r['p50_ms']:.3f} | {r['p99_ms']:.3f} | {r['late_ticks']} of "
              f"{r['ticks']} | {r['step_ms_p50']:.3f} | {r['growing']} |")
    print(f"knee {knee}, cell fleet {fleet} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
