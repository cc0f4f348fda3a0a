"""The readings the live engine's limits are set from: the program's
compared numbers on many seeds, and on some of them the planted faults'
(``live_faults``) and the controls'; or the spans' cost.

    python3 bench_torch/programs/live_readings.py \\
        --workload live_rnnoise.rt --seeds 11 12 ... --control 11 12 13 --seconds 30 \\
        [--faults eq_gain_off ...] [--faults-only] [--save DIR | --load DIR] [--workers N]
    python3 bench_torch/programs/live_readings.py --workload live_rnnoise.rt --span-cost 2000

Each seed runs the cell as a run does (its take, its control traffic, its
probes) in a window of ``--seconds``; each control seed also runs once with
each fault planted. The probes are then checked as a run checks them,
against the plain reference on the CPU, a worker process a render.
``--save DIR`` runs the cell only and writes each run's probes to ``DIR``
(one gzipped pickle a run); ``--load DIR`` renders and compares the probes
saved there, so that the reference's part runs on any host's CPU.

The controls are the plain reference put in the program's place, computed
one precision below each that the configuration states: ``tf32``, every
float32 matrix product and convolution of the reference with its inputs
rounded to TF32 (``bench_torch/control.py``); ``f32_biquad``, every biquad
cascade (the EQ, the high-passes, the meters' K-weighting) as the
reference's per-sample DF2T wavefront, crossfades and all, with float32
state and arithmetic in place of float64.

``--span-cost N``: N blocks through ``_process_block`` on the card, the
spans on and off in turns of a tenth: the median wall ms of a block each way.

Prints a line per seed, fault and control, and last a JSON line.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import pickle
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
CONTROLS = ("tf32", "f32_biquad")


def cascade_f32(x, coeffs, z, fade_total, fade_remaining):
    """The reference's crossfaded cascade (``biquad._cascade_wavefront``:
    at step k section s filters sample k - s) with float32 state and
    arithmetic; the state handed back as float64, its type in the chain."""
    n, T = x.shape
    S = coeffs.shape[1]
    if S == 0:
        return x, z.clone()
    f32 = torch.float32
    b0, b1, b2, a1, a2 = coeffs.to(f32).unbind(-1)  # [N, S, 2] each
    z1, z2 = z[..., 0].to(f32), z[..., 1].to(f32)  # [N, S, 2]
    t_idx = torch.arange(T, dtype=f32)
    total = fade_total.to(f32)[..., None]
    done = (fade_total - fade_remaining).to(f32)[..., None] + 1.0
    w = torch.where(total > 0, ((done + t_idx) / total.clamp_min(1.0)).clamp(0.0, 1.0), 1.0)
    fading = fade_remaining > 0
    sec = torch.arange(S)
    out_prev = torch.zeros((n, S), dtype=f32)
    y = torch.empty((n, T), dtype=f32)
    zero = torch.zeros((n, 1), dtype=f32)
    for k in range(T + S - 1):
        head = x[:, k:k + 1].to(f32) if k < T else zero
        inp = torch.cat([head, out_prev[:, :-1]], dim=1)[..., None]
        yl = b0 * inp + z1
        live = ((k - sec >= 0) & (k - sec < T))[:, None]
        z1, z2 = (torch.where(live, b1 * inp - a1 * yl + z2, z1),
                  torch.where(live, b2 * inp - a2 * yl, z2))
        wk = w.gather(2, (k - sec).clamp(0, T - 1).expand(n, S)[..., None])[..., 0]
        out_prev = torch.where(fading, (1.0 - wk) * yl[..., 0] + wk * yl[..., 1], yl[..., 0])
        if k >= S - 1:
            y[:, k - S + 1] = out_prev[:, S - 1]
    lane0 = torch.stack([z1[..., 0], z2[..., 0]], -1)
    lane1 = torch.where(fading[..., None], torch.stack([z1[..., 1], z2[..., 1]], -1), lane0)
    return y, torch.stack([lane0, lane1], dim=2).to(torch.float64)


@contextmanager
def lower(kind: str):
    """Inside it, the plain reference computes as control ``kind`` does."""
    from ..control import TF32
    from ..reference.ops import biquad

    sound = biquad.biquad_cascade
    if kind == "f32_biquad":
        biquad.biquad_cascade = cascade_f32
    try:
        if kind == "tf32":
            with TF32():
                yield
        else:
            yield
    finally:
        biquad.biquad_cascade = sound


def span_cost(config: dict, blocks: int, device: str = "cuda") -> dict:
    """``_process_block`` over ``blocks`` blocks of a capture with the
    configuration's controls and a fresh VAD snapshot (no threads), the
    spans on and off in turns of a tenth: the median wall ms a block each
    way, and each way's spans a block."""
    from audioforge_tpu_torch.models import suppressor as supp
    from audioforge_tpu_torch.runtime import processor, tracing

    from ..traffic.generator import mic_capture
    from .live import apply_controls

    p = processor.AudioProcessor(device=device)
    apply_controls(p, config["controls"])
    cfg, params, topo, par, _ = p._snapshot_control()
    state = p._fresh_state(cfg, None)
    engine = supp.engine_init(topo["noise_model"], par["suppressor_strength"], device=p.device)
    engine = p._warm(cfg, params, state, engine, topo)
    delay = np.zeros(engine["latency_samples"], np.float32)
    p._vad_state = {"probability": 0.7, "timestamp": time.perf_counter() + 3600.0,
                    "available": True}
    audio = mic_capture(4, 400, 17)[2].reshape(-1, 480)
    times = {True: [], False: []}
    turn = max(blocks // 10, 1)
    tracing.reset()
    for b in range(blocks):
        on = (b // turn) % 2 == 1
        (tracing.enable if on else tracing.disable)()
        t0 = time.perf_counter()
        with tracing.span("live.burst"):
            state, _, engine, delay = p._process_block(cfg, params, state,
                                                       audio[b % len(audio)][None], engine,
                                                       delay, topo)
        times[on].append(time.perf_counter() - t0)
    tracing.disable()
    spans = len(tracing.snapshot()["spans"])
    tracing.reset()
    return {"blocks": blocks, "block_ms_off": 1e3 * float(np.median(times[False])),
            "block_ms_on": 1e3 * float(np.median(times[True])),
            "spans_a_block_on": spans / max(len(times[True]), 1)}


def card_part(args, bench, cell, faults, blocks: int) -> dict:
    """The runs on the card: ``{(seed, fault or None): probe data}``, each
    also written to ``args.save`` when given."""
    from . import live

    device = "cuda" if torch.cuda.is_available() else "cpu"
    got = {}
    for seed in args.seeds:
        sound = [] if args.faults_only else [None]
        for fault in sound + (list(faults) if seed in args.control else []):
            r = live.run_cell(bench, cell, seed, args.seconds, False, time.perf_counter(),
                              device=device, engine_hook=faults.get(fault), reference=False)
            got[seed, fault] = r["probes"]
            lat = r["live"]["latencies_ms"]
            print(f"ran seed {seed} {fault or 'sound'}: {r['probes']['checked']} probes, "
                  f"failed {r['failed']} of {r['attempted']}, dropped "
                  f"{r['live']['dropped_blocks']}, captures {r['live']['captures']}, "
                  f"block p50 {float(np.median(lat)) if lat.size else None} ms", flush=True)
            if args.save:
                path = Path(args.save) / f"{seed}_{fault or 'sound'}.pkl.gz"
                path.parent.mkdir(parents=True, exist_ok=True)
                with gzip.open(path, "wb", compresslevel=6) as f:
                    pickle.dump({"seed": seed, "fault": fault, "blocks": blocks,
                                 "probes": r["probes"]}, f)
    return got


def load_part(directory: str) -> tuple:
    """The probes saved in ``directory`` and their stretches' blocks."""
    got, blocks = {}, set()
    for path in sorted(Path(directory).glob("*.pkl.gz")):
        with gzip.open(path, "rb") as f:
            saved = pickle.load(f)
        got[saved["seed"], saved["fault"]] = saved["probes"]
        blocks.add(saved["blocks"])
    if len(blocks) != 1:
        raise ValueError(f"{directory} holds runs of stretches of {sorted(blocks)} blocks")
    return got, blocks.pop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="readings of the live engine's check")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--faults", nargs="*", default=None,
                        help="the faults planted on the control seeds (default: all)")
    parser.add_argument("--faults-only", action="store_true",
                        help="run the control seeds with their faults only, not sound")
    parser.add_argument("--save", default=None, help="run the cell only; save its probes here")
    parser.add_argument("--load", default=None, help="check the probes saved here")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--span-cost", type=int, default=0)
    args = parser.parse_args(argv)
    from .. import harness
    from . import live
    from .live_faults import FAULTS, UNSEEN

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    if args.span_cost:
        print(json.dumps(span_cost(config, args.span_cost)), flush=True)
        return 0
    faults = {**FAULTS, **UNSEEN}
    if args.faults is not None:
        faults = {k: faults[k] for k in args.faults}
    limits = config["check"]["limits"]
    blocks = int(config["check"]["blocks"])
    t_all = time.perf_counter()
    if args.load:
        got, blocks = load_part(args.load)
    else:
        got = card_part(args, bench, cell, faults, blocks)
        print(f"the card's part: {time.perf_counter() - t_all:.1f} s", flush=True)
        if args.save:
            return 0
    control_seeds = set(args.control) or {s for s, f in got if f is not None}
    t_ref = time.perf_counter()
    jobs, keys = [], []
    for (seed, fault), data in sorted(got.items(), key=lambda kv: (kv[0][0], kv[0][1] or "")):
        if not data["checked"]:
            continue
        jobs.append((config, data["schedule"], live.with_ulp_up(data["probes"]), blocks))
        keys.append((seed, fault, None))
        if fault is None and seed in control_seeds:
            for k in CONTROLS:
                jobs.append((config, data["schedule"], data["probes"], blocks, k))
                keys.append((seed, None, k))
    rows = dict(zip(keys, live.run_jobs(jobs, min(len(jobs), os.cpu_count() or 1,
                                                  args.workers))))
    print(f"the reference's part: {time.perf_counter() - t_ref:.1f} s", flush=True)
    out = []
    shown = ("probe_err_ratio_median", "class_floor_ratio_max", "state_err_ratio_max",
             "class_err_ratio_max")

    def line(seed, what, numbers, classes):
        caught = any(not numbers[k] <= v for k, v in limits.items() if k in numbers)
        out.append({"seed": seed, "run": what, "fails_check": caught,
                    "classes": [int(c) for c in classes],
                    **{k: numbers[k] for k in shown + ("class_err_ratio", "class_ulp_move",
                                                       "state_err_ratio", "probe_err_max",
                                                       "probe_err_move", "state_probe_err_move")}})
        print(f"{what} seed {seed}: " + ", ".join(f"{k} {numbers[k]:.6g}" for k in shown)
              + f"; by class {[round(v, 3) for v in numbers['class_err_ratio']]}; by stage "
              f"{ {k: round(v, 3) for k, v in numbers['state_err_ratio'].items()} }; "
              f"fails the check: {caught}", flush=True)

    for (seed, fault, control), both in rows.items():
        if control is not None:
            continue
        data = got[seed, fault]
        n = data["checked"]
        if n != data["of"]:
            print(f"seed {seed} {fault}: {n} of {data['of']} probes", flush=True)
        line(seed, fault or "program",
             live.compare_all(data["got"], data["after"], data["classes"], both, n),
             data["classes"])
        for k in CONTROLS if fault is None and seed in control_seeds else ():
            y, after = rows[seed, None, k]
            line(seed, f"control {k}",
                 live.compare_all(list(y), after, data["classes"], both, n), data["classes"])
    print(json.dumps({"workload": args.workload, "limits": limits, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "bench_torch" / sub)
    from bench_torch.programs import live_readings
    sys.exit(live_readings.main())
