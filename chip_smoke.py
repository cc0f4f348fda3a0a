"""On-card smoke test of audioforge_tpu_torch (needs one CUDA GPU).

Run from the root of the repository: ``python3 chip_smoke.py``. Phases, each
of which stops the script with a non-zero exit when it fails:

0. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device is a failure (there is no CPU path);
1. build: compiles the CUDA kernels under audioforge_tpu_torch/csrc/;
2. kernels: each kernel against its plain PyTorch twin on the card, at the
   shapes the serving path gives it, with both times from CUDA events;
3. slice: the serving engine at fleet 1024 (RNNoise + default live chain)
   through 5 x step() and step_many(10): finite output within the limiter
   ceiling, and every on-path kernel launched its expected count per block;
4. card against CPU: the same 4-stream engine on the card and on the CPU
   (plain twins) for 10 blocks.

The line before the last is a JSON object with every kernel's launches on
the slice run, error against its twin and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BLOCK = 480
FLEET = 1024
FS = 48000.0
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def speech_like(n: int, n_blocks: int, seed: int) -> np.ndarray:
    """Voiced bursts with per-stream pitch, hiss, and one transient over
    full scale per stream, ``[n, n_blocks * 480]``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * BLOCK) / FS
    f0 = rng.uniform(100.0, 220.0, (n, 1))
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    voiced = sum(np.sin(2 * np.pi * f0 * h * t + h * phase) / h for h in range(1, 6))
    env = (np.sin(2 * np.pi * rng.uniform(2.0, 5.0, (n, 1)) * t + phase) > -0.3)
    x = 0.3 * env * voiced * rng.uniform(0.3, 1.2, (n, 1))
    x += 0.01 * rng.standard_normal(x.shape)
    at = rng.integers(0, x.shape[1] - 64, n)
    for i in range(n):
        x[i, at[i]: at[i] + 48] = 1.6 * np.sign(x[i, at[i]: at[i] + 48] + 1e-3)
    return x.astype(np.float32)


def phase0_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke.py needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"
    print(card, flush=True)
    print(f"[0] torch {torch.__version__} CUDA {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card}); python "
          f"{sys.version.split()[0]}", flush=True)
    return card


def phase1_build():
    from audioforge_tpu_torch import kernels

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"[1] build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}", flush=True)
    log = lib_path.with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")


def phase2_kernels(card: str) -> dict:
    from audioforge_tpu_torch.ops import biquad, eq, envelope, scan
    from audioforge_tpu_torch.ops import compressor as comp

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(7)
    results = {}

    def report(name, err, tol, ms, plain_ms, shape):
        print(f"[2] {name} {shape}: max_abs_err {err:.3e} (tol {tol:g}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms ({card})", flush=True)
        check(np.isfinite(err) and err <= tol, f"{name} disagrees with its plain twin")
        prev = results.get(name)
        if prev is None or err > prev["max_abs_err"]:
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # env_scan at the tool's shapes: [480, 2048] time-major, 50 blocks
    R, B = 50, 2048
    xs = torch.tensor(rng.standard_normal((R, BLOCK, B)).astype(np.float32), device=dev)
    env0 = torch.zeros(B, device=dev)

    def env_run(fn):
        env, ys = env0, []
        for r in range(R):
            y, env = fn(xs[r], env)
            ys.append(y)
        return torch.stack(ys), env

    yk, ek = env_run(envelope.env_scan)
    yp, ep = env_run(envelope.env_scan_plain)
    err = max((yk - yp).abs().max().item(), (ek - ep).abs().max().item())
    ms = cuda_ms(lambda: env_run(envelope.env_scan), 3) / R
    plain_ms = cuda_ms(lambda: env_run(envelope.env_scan_plain), 1) / R
    report("env_scan", err, 1e-5, ms, plain_ms, f"[{BLOCK}, {B}] x {R} blocks")

    # max_affine_scan as the lookahead limiter drives it, [1024, 480]
    target = torch.tensor(rng.uniform(0.5, 1.0, (FLEET, BLOCK)).astype(np.float32),
                          device=dev)
    target = torch.where(target > 0.8, torch.ones_like(target), target)
    v = (1.0 - target).contiguous()
    rho = torch.full((FLEET,), float(np.exp(-1.0 / (0.05 * FS))), device=dev)
    c = ((1.0 - rho)[:, None] * v).contiguous()
    u0 = torch.rand(FLEET, device=dev)
    err = (scan.max_affine_scan(v, rho, c, u0)
           - scan.max_affine_scan_plain(v, rho, c, u0)).abs().max().item()
    ms = cuda_ms(lambda: scan.max_affine_scan(v, rho, c, u0), 50)
    plain_ms = cuda_ms(lambda: scan.max_affine_scan_plain(v, rho, c, u0), 2)
    report("max_affine_scan", err, 1e-5, ms, plain_ms, f"[{FLEET}, {BLOCK}]")

    # biquad_cascade: the EQ with the bench gains and a crossfade in flight
    gains = [-2.5, 1.5, -1.0, 2.0, 3.0, 2.5, 1.5, -2.0, 1.0, -1.5]
    bands = [eq.EqBandConfig(b.filter_type, b.frequency_hz, g, 4.33, 12, True)
             for b, g in zip(eq.default_bands(), gains)]
    st = eq.eq_init(bands, FS, n=FLEET, device=dev)
    x = torch.tensor(speech_like(FLEET, 2, 8), device=dev)
    st, _ = eq.eq_process(st, x[:, :BLOCK].contiguous())
    st = eq.eq_set_band(st, 4, eq.EqBandConfig(1, 1500.0, -6.0, 2.0), FS)
    xb = x[:, BLOCK:].contiguous()
    args = (xb, st["coeffs"].contiguous(), st["z"].contiguous(),
            st["fade_total"].contiguous(), st["fade_remaining"].contiguous())
    yk, zk = biquad.biquad_cascade(*args)
    yp, zp = biquad.biquad_cascade_plain(*args)
    err = max((yk - yp).abs().max().item(), (zk - zp).abs().max().item())
    ms = cuda_ms(lambda: biquad.biquad_cascade(*args), 50)
    plain_ms = cuda_ms(lambda: biquad.biquad_cascade_plain(*args), 1)
    report("biquad_cascade", err, 1e-6, ms, plain_ms,
           f"[{FLEET}, {BLOCK}] x {st['z'].shape[1]} sections, crossfade in flight")

    # compressor_scan, both flag sets of the serving chain's options
    xc = torch.tensor(speech_like(FLEET, 1, 9), device=dev)
    for flags in ({"sidechain_highpass_enabled": True},
                  {"sidechain_highpass_enabled": True, "adaptive_release": True,
                   "auto_makeup_enabled": True}):
        cfg = comp.CompressorConfig(**flags)
        p = {k: torch.full((FLEET,), float(np.float32(val)), device=dev)
             for k, val in comp.compressor_params(cfg, threshold_db=-30.0).items()}
        s0 = comp.compressor_init(cfg, n=FLEET, device=dev)
        scan_state = {k: s0[k] for k in comp.SCAN_STATE_KEYS}
        makeup = torch.full((FLEET,), 1.2, device=dev)
        sk, yk = comp.compressor_scan(cfg, p, makeup, scan_state, xc)
        sp, yp = comp.compressor_scan_plain(cfg, p, makeup, scan_state, xc)
        err = (yk - yp).abs().max().item()
        check(max((sk[k] - sp[k]).abs().max().item() for k in ("current_gr_db",))
              <= 1e-3, "compressor_scan state disagrees with its plain twin")
        ms = cuda_ms(lambda: comp.compressor_scan(cfg, p, makeup, scan_state, xc), 50)
        plain_ms = cuda_ms(
            lambda: comp.compressor_scan_plain(cfg, p, makeup, scan_state, xc), 1)
        report("compressor_scan", err, 1e-5, ms, plain_ms,
               f"[{FLEET}, {BLOCK}] {sorted(flags)}")
    return results


def _engine(capacity: int, device: str, audio: np.ndarray):
    from audioforge_tpu_torch.runtime.serving import ServingConfig, ServingEngine

    eng = ServingEngine(ServingConfig(capacity=capacity), device=device)
    outs = [[] for _ in range(capacity)]
    for i in range(capacity):
        slot = eng.attach(sink=lambda blk, i=i: outs[i].append(blk))
        eng.push(slot, audio[i])
    return eng, outs


def phase3_slice(card: str) -> dict:
    from audioforge_tpu_torch import kernels
    from audioforge_tpu_torch.runtime import live_chain as lc

    n_blocks = 15
    audio = speech_like(FLEET, n_blocks, 11)
    t0 = time.perf_counter()
    eng, outs = _engine(FLEET, DEVICE, audio)
    print(f"[3] engine at fleet {FLEET} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(5):
        eng.step()
    t_step = (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    eng.step_many(10)
    t_many = (time.perf_counter() - t0) / 10
    counts = dict(kernels.launch_counts)
    print(f"[3] launches over {n_blocks} blocks: {counts}", flush=True)

    y = np.stack([np.concatenate(o) for o in outs])
    check(y.shape == (FLEET, n_blocks * BLOCK), f"output shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite output")
    ceiling = 10.0 ** (lc.effective_limiter_ceiling_db(-1.0, True) / 20.0)
    peak = float(np.abs(y).max())
    check(peak <= ceiling + 1e-6, f"output peak {peak} above the ceiling {ceiling}")
    per_block = {"biquad_cascade": 5, "max_affine_scan": 2, "compressor_scan": 1}
    for name, k in per_block.items():
        check(counts[name] == k * n_blocks,
              f"{name}: {counts[name]} launches, expected {k} per block")
    print(f"[3] output finite, peak {peak:.4f} <= ceiling {ceiling:.4f}; "
          f"gr limiter max {float(eng._last_metrics['limiter_gain_reduction_db'].max()):.2f} dB",
          flush=True)
    print(f"[3] seconds per block (info, {card}): step() {t_step:.4f}, "
          f"step_many(10) {t_many:.4f}; audio-sec/sec at fleet {FLEET}: "
          f"{FLEET * BLOCK / FS / t_step:.1f} (step), "
          f"{FLEET * BLOCK / FS / t_many:.1f} (step_many)", flush=True)
    layer_split(eng, card)
    return counts


def layer_split(eng, card: str) -> None:
    """Seconds of one more step() by layer, with a device synchronise
    around each timed stage (information only)."""
    from audioforge_tpu_torch.ops import gate as gate_ops
    from audioforge_tpu_torch.runtime import live_chain as lc
    from audioforge_tpu_torch.runtime import serving as sv

    stages = [(lc, "front_block"), (gate_ops, "gate_process"),
              (sv, "_supp_step"), (lc, "back_block")]
    seconds = {}
    originals = {(mod, name): getattr(mod, name) for mod, name in stages}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    for (mod, name), fn in originals.items():
        setattr(mod, name, timed(name, fn))
    try:
        eng.push(0, np.zeros(BLOCK, np.float32))
        t0 = time.perf_counter()
        eng.step()
        total = time.perf_counter() - t0
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    print(f"[3] one step() by layer (info, {card}): total {total:.4f} s; front "
          f"{seconds['front_block']:.4f} (gate loop {seconds['gate_process']:.4f}), "
          f"rnnoise {seconds['_supp_step']:.4f}, back {seconds['back_block']:.4f}",
          flush=True)


def phase4_card_vs_cpu() -> None:
    n, n_blocks = 4, 10
    audio = speech_like(n, n_blocks, 12)
    ys, periods = {}, {}
    for device in (DEVICE, "cpu"):
        eng, outs = _engine(n, device, audio)
        eng.step_many(n_blocks)
        ys[device] = np.stack([np.concatenate(o) for o in outs])
        periods[device] = eng._state["supp"]["model"]["last_period"].cpu().numpy()
    rms = float(np.sqrt(np.mean((ys[DEVICE].astype(np.float64) - ys["cpu"]) ** 2)))
    print(f"[4] card vs CPU over {n_blocks} blocks x {n} streams: RMS diff "
          f"{rms:.3e} (tol 1e-3), max {np.abs(ys[DEVICE] - ys['cpu']).max():.3e}; "
          f"last_period card {periods[DEVICE].tolist()} cpu "
          f"{periods['cpu'].tolist()}", flush=True)
    check(rms <= 1e-3, "card and CPU outputs differ")
    check(bool((periods[DEVICE] == periods["cpu"]).all()), "pitch periods differ")


def main() -> int:
    card = phase0_device()
    phase1_build()
    measured = phase2_kernels(card)
    counts = phase3_slice(card)
    phase4_card_vs_cpu()
    sources = {
        "env_scan": ("audioforge_tpu_torch/csrc/env_scan.cu",
                     "tools/evaluate_scan_kernel_strategy.py:72"),
        "max_affine_scan": ("audioforge_tpu_torch/csrc/max_affine_scan.cu",
                            "audioforge_tpu/ops/scan.py:305"),
        "biquad_cascade": ("audioforge_tpu_torch/csrc/biquad_cascade.cu",
                           "audioforge_tpu/ops/biquad.py:346"),
        "compressor_scan": ("audioforge_tpu_torch/csrc/compressor_scan.cu",
                            "audioforge_tpu/ops/compressor.py:277"),
    }
    table = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
              "launches": counts[name], **measured[name]}
             for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
