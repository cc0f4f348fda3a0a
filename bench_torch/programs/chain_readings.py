"""The readings the compressor search's limits are set from, taken in one
process on the card: the program's compared numbers on many seeds, and on
some of them the planted faults' (``chain_faults``) and the controls'.

    python3 bench_torch/programs/chain_readings.py \\
        --workload voice_setup_search.wave1_10s --seeds 11 12 ... --control 11 12 13 --seconds 6

Each seed runs the cell as a run does (its takes, its candidates, its loop,
its probes) in a window of ``--seconds``, long enough for every probe's
call; each control seed also runs once with each fault planted. The probes
are then checked as a run checks them, against the plain reference on the
CPU, in worker processes.

The controls are the plain reference put in the program's place, computed
one precision below each that the configuration states: ``tf32``, every
float32 matrix product of the reference (the true-peak interpolators) with
its inputs rounded to TF32 (``bench_torch/control.py``); ``f32_biquad``,
the EQ's biquad cascade with float32 state and arithmetic instead of
float64, as DF2T steps a sample; and ``both``.

Prints a line per seed, fault and control, and last a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
CONTROLS = ("tf32", "f32_biquad", "both")
NUMBERS = ("class_err_ratio_max", "stat_err_ratio_max", "events_gap_max",
           "diagnostics_gap_max")


def cascade_f32(x, coeffs, z, fade_total, fade_remaining):
    """The reference's ``biquad_cascade`` of static sections (lane 0) with
    float32 state and arithmetic: a wavefront of DF2T steps, section ``s``
    filtering sample ``k - s`` at step ``k``."""
    n, T = x.shape
    S = coeffs.shape[1]
    if S == 0:
        return x, z.clone()
    b0, b1, b2, a1, a2 = coeffs[:, :, 0].to(torch.float32).unbind(-1)  # [N, S] each
    z1, z2 = z[:, :, 0, 0].to(torch.float32), z[:, :, 0, 1].to(torch.float32)
    sec = torch.arange(S)
    prev = torch.zeros((n, S), dtype=torch.float32)
    zero = torch.zeros((n, 1), dtype=torch.float32)
    y = torch.empty((n, T), dtype=torch.float32)
    for k in range(T + S - 1):
        inp = torch.cat([x[:, k:k + 1] if k < T else zero, prev[:, :-1]], dim=1)
        out = b0 * inp + z1
        live = (k - sec >= 0) & (k - sec < T)
        z1, z2 = (torch.where(live, b1 * inp - a1 * out + z2, z1),
                  torch.where(live, b2 * inp - a2 * out, z2))
        prev = out
        if k >= S - 1:
            y[:, k - S + 1] = out[:, S - 1]
    lane = torch.stack([z1, z2], -1).to(torch.float64)
    return y, torch.stack([lane, lane], dim=2)


@contextmanager
def lower(kind: str):
    """Inside it, the plain reference computes as control ``kind`` does."""
    from ..control import TF32
    from ..reference.ops import biquad

    sound = biquad.biquad_cascade
    if kind in ("f32_biquad", "both"):
        biquad.biquad_cascade = cascade_f32
    try:
        if kind in ("tf32", "both"):
            with TF32():
                yield
        else:
            yield
    finally:
        biquad.biquad_cascade = sound


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="readings of the compressor search's check")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=6.0)
    args = parser.parse_args(argv)
    from .. import harness
    from . import chain
    from .chain_faults import FAULTS, UNSEEN

    faults = {**FAULTS, **UNSEEN}
    t_all = time.perf_counter()
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    limits = config["check"]["limits"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    got = {}  # (seed, fault or None) -> probe data
    for seed in args.seeds:
        runs = [None] + (list(faults) if seed in args.control else [])
        for fault in runs:
            r = chain.run_cell(bench, cell, seed, args.seconds, False, time.perf_counter(),
                               device=device, engine_hook=faults.get(fault), reference=False)
            got[seed, fault] = r["probes"]
            print(f"ran seed {seed} {fault or 'sound'}: {r['probes']['checked']} probes, "
                  f"failed {r['failed']} of {r['attempted']}", flush=True)
    print(f"the card's part: {time.perf_counter() - t_all:.1f} s", flush=True)
    t_ref = time.perf_counter()
    jobs = []   # (seed, what) and its job
    for s in args.seeds:
        data = got[s, None]
        for take, cands in zip(data["takes"], data["candidates"]):
            jobs += [((s, "want"), (config, take, cands)),
                     ((s, "moved"), (config, harness.one_ulp_up(take), cands))]
            if s in args.control:
                jobs += [((s, k), (config, take, cands, k)) for k in CONTROLS]
    rows = chain.run_jobs([job for _, job in jobs], os.cpu_count() or 1)
    parts = {}
    for (key, _), r in zip(jobs, rows):
        parts.setdefault(key, []).append(r)
    joined = {key: (np.concatenate([y for y, _ in p]),
                    {k: np.concatenate([st[k] for _, st in p]) for k in p[0][1]})
              for key, p in parts.items()}
    print(f"the reference's part: {time.perf_counter() - t_ref:.1f} s", flush=True)
    out = []

    def line(seed, what, numbers):
        caught = any(not numbers[k] <= v for k, v in limits.items() if k in numbers)
        out.append({"seed": seed, "run": what, "fails_check": caught,
                    **{k: numbers[k] for k in (*NUMBERS, "class_err_ratio", "stat_err_ratio",
                                               "class_ulp_move", "probe_err_max")
                       if k in numbers}})
        print(f"{what} seed {seed}: " + ", ".join(
            f"{k} {numbers[k]:.6g} (limit {limits[k]:g})" for k in NUMBERS if k in numbers)
            + f"; by stat {({k: round(v, 3) for k, v in numbers['stat_err_ratio'].items()})}"
            f"; fails the check: {caught}", flush=True)

    for (seed, fault), data in got.items():
        if data["checked"] != data["of"]:
            print(f"seed {seed} {fault}: {data['checked']} of {data['of']} probes", flush=True)
            continue
        want, moved = joined[seed, "want"], joined[seed, "moved"]
        numbers = chain.compare_rows(chain.stacked(data), want, moved,
                                     np.asarray(data["classes"]))
        numbers["diagnostics_gap_max"] = chain.diagnostics_gap(config, data)
        line(seed, fault or "program", numbers)
    for s in args.control:
        classes = np.asarray(got[s, None]["classes"])
        for k in CONTROLS:
            numbers = chain.compare_rows(joined[s, k], joined[s, "want"], joined[s, "moved"],
                                         classes)
            line(s, f"control {k}", numbers)
    print(json.dumps({"workload": args.workload, "limits": limits, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "bench_torch" / sub)
    from bench_torch.programs import chain_readings
    sys.exit(chain_readings.main())
