"""On-card smoke test of audioforge_tpu_torch (needs one CUDA GPU).

Run from the root of the repository: ``python3 chip_smoke.py``. Phases, in
the order they run ([8]-[10] after [4], [11]-[14] last), each of which stops the script with
a non-zero exit when it fails, and each followed by its wall-clock time:

0. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; no CUDA device is a failure (there is no CPU path);
1. build: compiles the CUDA kernels under audioforge_tpu_torch/csrc/ and
   prints ptxas's registers and spills; a spill in any kernel fails;
2. kernels: each kernel against its plain PyTorch twin on the card, at the
   shapes the serving path gives it, with its time on the card (a CUDA
   graph of the wrapper call, replayed), the eager call's and the plain
   twin's times (CUDA events) and the least time the card could take (bytes
   over 3.35 TB/s or operations over the f32/f64 peak, whichever is
   larger); biquad_cascade at 1, 2, 10 and 17 sections (crossfades in
   flight and idle), with its time per block weighted by the launches of
   each section count, and checked at 1 and 10 sections on blocks long
   enough that the kernel runs them in several shared-memory chunks, as are
   compressor_scan (also without the sidechain high-pass), gate_scan
   (every mode), cleanup_scan, max_affine_scan and limiter_gain_scan on
   blocks of 960 samples; cleanup_scan gentle and strong with the notches'
   crossfades in flight and strong with none, the rumble trigger firing on
   the quarter of the streams that carry a low thump; limiter_gain_scan on
   lookahead-limiter- and true-peak-limiter-shaped inputs; the four kernels
   of the model stages (vad_front, vad_lstm_head, dfn_features,
   dfn_spec_synth, the last also with the post filter on; vad_front,
   vad_lstm_head and dfn_features also at 1023 streams and at one), with the time of
   ``torch._VF.lstm_cell`` beside vad_lstm_head; then, as information, the time per call of both limiter stages and of the three
   block-level torch stages that have no kernel yet (limiter window max,
   true-peak polyphase FIR, hum oscillator bank), the first two with their
   bound and the time of the one PyTorch call that computes each, and the
   bound of the hum oscillator bank, the block reductions and the RNNoise
   frame at fleet 1024 beside their time on the card;
3. default path: the serving engine at fleet 1024 (RNNoise + default live
   chain), whose first step captures its CUDA graph (capture time, nodes,
   kernel launches per replay), then 5 x step() and step_many(10) with the
   launch counts read over those 15 blocks: finite output within the limiter
   ceiling, and every on-path kernel launched its expected count per block;
   then, as information, a layer split (the eager step on copies of the
   engine's buffers), 600 step() calls (p50, p99, max), step_many spans,
   600 step_pipelined() calls, the replay alone on the card, the graph's
   state copy-back and the peak device memory;
4. full live chain: the engine at fleet 1024 with strong cleanup and the
   de-esser for 60 blocks (two hum windows complete): launches per block,
   finite output within the ceiling, hum detected on the hum streams, de-esser
   reduction on the sibilant streams; then the same information as [3];
5. card against CPU: the same 4-stream engines on the card (graph replays)
   and on the CPU (plain twins), default path for 10 blocks, adaptive
   release for 10, full chain for 27 blocks (a hum window completes) and the
   three model paths for 10 (the VAD probability and the DeepFilterNet3
   norms compared too);
6. profile (information): a ``torch.profiler`` reading of 3 graph replays
   (step() calls) on each of the five paths at fleet 1024: CUDA kernels per
   step, the card's busy share and the kernels that take the most time;
7. graph against eager: the full chain at fleet 1024 for 60 blocks with an
   attach, a slot reset, a control write, suppressor writes and staged EQ
   programs mid-run, through the engine's graph replays and through
   ``_serving_step`` called eagerly on the card on the same inputs: every
   block's output and the final state ``torch.equal``; and a second engine
   through step_pipelined() + flush_pipeline() delivers the same blocks as
   step() (but a block in flight when its stream detaches), a third through
   step_many over the spans between the events (chunks of ``CHUNK_BLOCKS``
   blocks) the same blocks, each call's as views of one array, and the same
   state, and a fourth through step_pipelined, step, step_many(9),
   step_pipelined and flush_pipeline the same blocks in the order taken;
   then the DeepFilterNet3-LL path at fleet 1024 for 20 blocks with a
   slot reset, graph against eager, ``torch.equal`` (held to 1e-5, naming
   the blocks and leaves, where not equal);
8. VAD-on path: bench.py's VAD cell (strong cleanup, de-esser, VAD-assisted
   gate, RNNoise) with the in-step Silero VAD at fleet 1024, 16 blocks:
   capture, launches per block, output finite within the ceiling, the
   probability in [0, 1] and available from the 4th block on, the gate's
   VAD branch open on the voiced streams the posterior calls voice and shut
   on the quiet class; then [3]'s information over 200 timed calls;
9. DeepFilterNet3-LL path and 10. the standard DeepFilterNet3 path, each
   with the default chain at fleet 1024, 16 blocks: as [8], and the
   noise-only class at suppressor strength 1 at least 10 dB below the same
   class at strength 0.
11. offline chain: bench.py's downstream chain (de-esser, the ten-band
   Auto-EQ curve, adaptive compressor with auto makeup and sidechain HP,
   both limiters) at batch 2048 (16 x 128) over 200 blocks through
   ``chain_run(return_audio=False)``, one graph replay a block: launches per
   block, finite stats, the output true peak within 0.1 dB of the ceiling
   (ROADMAP F7), de-esser reduction on the sibilant streams, graph replays
   ``torch.equal`` to the eager chain over 10 blocks, a 4-stream 20-block
   run within 1e-5 RMS of the CPU's; seconds per call, audio-s/s, the replay
   alone per block, capture and peak memory;
12. simulators: every ``api.py`` simulator (the chain at 48 and 44.1 kHz,
   the batch of 68 candidates, ``simulate_eq_v2``, the auto-makeup control,
   the gate/suppressor study in both orders), ``analyze_vad_probabilities``
   at 16 and 48 kHz and ``resample`` on the card against ``device="cpu"``
   on 0.3-1 s takes, then each on a 10 s take on the card (seconds per
   call);
13. live engine: the single-stream ``AudioProcessor`` with no suppressor,
   RNNoise, DeepFilterNet3-LL and DeepFilterNet3 (``AUDIOFORGE_ENABLE_
   DEEPFILTER=1`` for the phase): (a) ``_process_block`` over 300 blocks with
   a VAD snapshot, output finite within the ceiling, the first 8 within 1e-3
   RMS of ``device="cpu"``, launches per block as expected, the graphs
   captured at the first block and none after, the DeepFilterNet3 backend
   available and not failed, the host time per block (also split by stage
   over 100 more blocks) and each graph's replay alone on the card; (b) the threads and the VAD worker free-running 5 s on
   a virtual source and sink (no engine error, no capture after the start;
   per-block DSP time, replays per block); (c) 10 s in real time (drops,
   underruns, p99: information) with a topology change half way (its
   captures, stall and memory); then the VAD worker's window graph alone
   (its replay on the card, host ms per window: information) and (d) the
   seeded control storm of ``runtime/stress_harness.py`` (120 blocks,
   bounded output);
14. sharded preset fleet: the voice preset's serving topology at fleet 1024
   with the builtin presets of that topology round-robin over the streams,
   60 blocks of mic_capture audio, unsharded and over fleet meshes of 2 and
   4 shards on the one card: audio within 1e-4 RMS / 1e-3 max of the
   unsharded run, launches a block exactly the shard count times the
   unsharded engine's, each shard's replay alone and all of them (CUDA
   events), step() p50/p99 over 200 calls, step_many(50) per block, peak
   memory; 8 streams over 2 shards on the card against 2 on the CPU (1e-3
   RMS); the 68-candidate sweep with a 2-shard mesh against none (1e-5);
   ``dryrun_multichip(2)`` on the card; ``python -m audioforge_tpu_torch run
   --preset`` as a subprocess (exit 0) and ``capture_preset`` after
   ``apply_preset`` equal to the preset. Several cards are not run: the
   machine has one.

Phase [2] also holds the kernels at the offline path's own shapes (one
stream of 882 samples at 44.1 kHz, the live EQ's 4800-sample blocks through
16 slots, 68 candidates with their own compressor parameters, bench.py's
2048 x 480, the gate and ``vad_lstm_head`` for one stream).

The line before the last is a JSON object with every kernel's launches (on
the full-chain run; the model stages' kernels on their own paths' runs,
the DeepFilterNet3 kernels summed over [9] and [10]; plus each kernel's
launches in [13](a), the VAD worker's in [13](b) and the fleets' in [14]), error against its twin (the worst over its
configurations), times and bound (of its first configuration); the last
line is ``{"ok": true, "device": {...}}``. compare_kernels.py times the
kernels of two checkouts on phase [2]'s inputs (:func:`timed_calls`).
"""

from __future__ import annotations

import collections
import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.counts import PEAKS, bound
from bench_torch.traffic.generator import _voice_on, mic_capture

BLOCK = 480
FLEET = 1024
FS = 48000.0
DEVICE = "cuda"
FULL_BLOCKS = 60            # hum windows (250 ms) complete at blocks 25 and 50
ENV_BLOCKS = 50             # env_scan blocks per run (the tool's 50 blocks)
GATE_BLOCKS = 30            # gate_scan blocks per mode
ENV_CHECK_BLOCKS = 3        # env_scan blocks per further shape checked
# env_scan's serial floor: cycles a step on the env chain of its loop. The
# SASS of env_scan.cu's serial loop (`compare_kernels.py --sass
# env_scan_kernel`) has two instructions on it a step, two FFMAs side by side
# and then FMNMX; a chain of this step alone, in registers, takes 13.8 cycles
# a step on the H100 (PERF.md, env_scan's finding), about 7 a dependent
# instruction.
ENV_CHAIN_CYCLES = 14
ENV_CLOCK_S = 0.5           # seconds of env_scan replays while the SM clock is sampled
# kernels whose lane state must fit in registers (phase [1] fails on a spill)
NO_SPILL_KERNELS = ("env_scan_kernel", "biquad_cascade_kernel", "deesser_scan_kernel",
                    "compressor_scan_kernel", "gate_scan_kernel", "cleanup_scan_kernel",
                    "max_affine_scan_kernel", "limiter_gain_scan_kernel",
                    "vad_front_kernel", "vad_lstm_head_kernel", "dfn_features_kernel",
                    "dfn_spec_synth_kernel")
CHUNKED_BLOCK = 2 * BLOCK   # every tiled kernel but biquad_cascade runs it as two chunks
TIMED_CALLS = 600           # step() and step_pipelined() calls timed per path: six beyond the p99
TIMED_SPAN = 50             # blocks of audio queued at a time while timing; step_many's span
MODEL_TIMED_CALLS = 200     # step() and step_pipelined() calls timed on the model paths [8]-[10]
MODEL_BLOCKS = 16           # blocks a model path runs before its timing (VAD warm after 4)
REPLAY_MS = {}              # a path's tag -> its graph's replay alone on the card, ms


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


def kernel_times(fn, reps: int = 20):
    """``(device_ms, call_ms)`` per call of ``fn``: its time on the card,
    from CUDA events around the replay of a CUDA graph of ``reps`` calls (the
    kernel and the wrapper's own few tensor ops, without the host's cost of
    launching them), and the eager call's time from CUDA events (``reps``
    calls back to back, so it includes that cost where the kernel is
    shorter)."""
    call_ms = cuda_ms(fn, reps)
    # a warm-up on a side stream first, as the capture's stream needs its own
    # library state (cuBLAS workspace) before it is captured
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3) / reps, call_ms


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


def voiced_blocks(n_blocks: int, seed: int) -> np.ndarray:
    """Whether the voice of ``mic_capture(1, n_blocks, seed)`` sounds through
    each whole block (its phase is that function's first draw)."""
    phase = np.random.default_rng(seed).uniform(0, 2 * np.pi, (1, 1))
    t = np.arange(n_blocks * BLOCK) / FS
    return _voice_on(t, phase)[0].reshape(n_blocks, BLOCK).all(axis=1)


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
    entry, spills = "", []
    for line in log.read_text().splitlines() if log.is_file() else ():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")
        if ("spill stores" in line and any(k in entry for k in NO_SPILL_KERNELS)
                and "0 bytes spill stores, 0 bytes spill loads" not in line):
            spills.append(f"{entry}: {line.strip()}")
    check(not spills, f"ptxas reports spills: {spills}")


class Results:
    """Per-kernel numbers for the JSON line; a kernel checked in several
    configurations keeps its worst error over all of them and the times and
    bound of the first one reported (the main path's headline shape)."""

    def __init__(self, card: str):
        self.card = card
        self.rows = {}

    def report(self, name, err, tol, times, plain_ms, shape, bytes_moved,
               f32_ops=0.0, f64_ops=0.0, library_ms=None) -> float:
        """Print and check one configuration (``times`` from
        :func:`kernel_times`); returns its bound in ms."""
        ms, call_ms = times
        bound_ms, bound_by = bound(bytes_moved, f32_ops, f64_ops)
        print(f"[2] {name} {shape}: max_abs_err {err:.3e} (tol {tol:g}); kernel "
              f"{ms:.4f} ms on the card (call {call_ms:.4f} ms), plain {plain_ms:.3f} "
              f"ms, bound {bound_ms:.5f} ms ({bound_by}) ({self.card})", flush=True)
        check(np.isfinite(err) and err <= tol, f"{name} disagrees with its plain twin")
        row = self.rows.setdefault(name, {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        return bound_ms


def _max_err(a: dict, b: dict) -> float:
    """Largest difference over matching tensors of two (nested) dicts."""
    worst = 0.0
    for k, v in a.items():
        if isinstance(v, dict):
            worst = max(worst, _max_err(v, b[k]))
        else:
            worst = max(worst, (v.double() - b[k].double()).abs().max().item())
    return worst


def _state_err(a: dict, b: dict) -> float:
    """Largest difference over matching ``[N]`` state tensors, each relative
    to the larger of 1 and the reference's magnitude (a release time of
    hundreds of ms carries an f32 rounding of 1e-5 per step)."""
    return max(((a[k] - v).abs() / v.abs().clamp_min(1.0)).max().item() for k, v in b.items())


def _idle_odd_streams(st: dict) -> dict:
    """A unit state whose crossfades stay in flight on the even streams and
    are idle (identical lanes, no fade) on the odd ones."""
    st = {k: v.clone() for k, v in st.items()}
    odd = torch.arange(st["z"].shape[0], device=st["z"].device) % 2 == 1
    st["coeffs"][odd, :, 1] = st["coeffs"][odd, :, 0]
    st["z"][odd, :, 1] = st["z"][odd, :, 0]
    st["fade_total"][odd] = 0
    st["fade_remaining"][odd] = 0
    return st


def biquad_inputs():
    """``(x, shapes)``: a block of ``[FLEET, BLOCK]`` and ``(name, sections,
    unit state)`` for every section count the serving path launches
    biquad_cascade with (1: RNNoise's input high-pass and cleanup's owned
    high-pass; 2: the two K-weighting meters and the DC blocker + 80 Hz
    pair; 10: the EQ, idle and with a band edit's crossfade) and 17, which
    the wrapper splits into two launches. The crossfades of 1.5 ms start at
    the block's first sample, so they end mid-block, on the even streams and
    are idle on the odd ones."""
    from audioforge_tpu_torch.ops import biquad, eq, loudness, routing

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(8)
    x = torch.tensor(speech_like(FLEET, 2, 8), device=dev)
    x0, xb = x[:, :BLOCK].contiguous(), x[:, BLOCK:].contiguous()
    fade = biquad.crossfade_samples(FS)

    gains = [-2.5, 1.5, -1.0, 2.0, 3.0, 2.5, 1.5, -2.0, 1.0, -1.5]
    bands = [eq.EqBandConfig(b.filter_type, b.frequency_hz, g, 4.33, 12, True)
             for b, g in zip(eq.default_bands(), gains)]
    eq_idle, _ = eq.eq_process(eq.eq_init(bands, FS, n=FLEET, device=dev), x0)
    eq_st = eq.eq_set_band(eq_idle, 4, eq.EqBandConfig(1, 1500.0, -6.0, 2.0), FS)

    freqs = np.geomspace(60.0, 14000.0, 17)
    design = lambda g: biquad.design(biquad.PEAKING, freqs, g, 2.0, FS)
    long_st, _ = biquad.unit_process(
        biquad.unit_init(design(rng.uniform(-3, 3, 17)), FLEET, dev), x0)
    long_st = biquad.unit_schedule(long_st, design(rng.uniform(-3, 3, 17)), fade)

    def fixed(coeffs):
        st = biquad.unit_init(np.asarray(coeffs, np.float32), FLEET, dev)
        st["z"] = torch.tensor(1e-3 * rng.standard_normal(st["z"].shape), device=dev)
        st["z"][:, :, 1] = st["z"][:, :, 0]
        return st

    return xb, (
        ("eq", 10, _idle_odd_streams(eq_st)),
        ("eq idle", 10, eq_idle),
        ("hp", 1, fixed([routing._hp_coeffs(routing.PREFILTER_HZ, FS)])),
        ("k-weighting", 2, fixed(loudness.k_weighting_coefficients(FS))),
        ("split", 17, _idle_odd_streams(long_st)),
    )


def _cascade_args(x, st):
    return (x, *(st[k].contiguous() for k in ("coeffs", "z", "fade_total", "fade_remaining")))


def biquad_chunk_inputs():
    """``(sections, T, args)`` at 1 and 10 sections on blocks of 960 and 2100
    samples: the kernel's 64 KB tile holds 484 samples of 32 streams (P <= 2
    lanes) or 2020 of 8 streams (P = 16), so both run in two chunks. The
    even streams have crossfades of the longest length a unit schedules,
    with their remaining counts spread over it, so that they end in either
    chunk or after the block; the odd streams are idle."""
    from audioforge_tpu_torch.ops import biquad

    _, shapes = biquad_inputs()
    st = next(st for name, _, st in shapes if name == "split")
    x = torch.tensor(speech_like(FLEET, 5, 18), device=DEVICE)
    rng = np.random.default_rng(19)
    out = []
    for sections, T in ((1, 960), (10, 2100)):
        cut = {k: v[:, :sections].contiguous() for k, v in st.items()}
        even = cut["fade_remaining"] > 0
        total = biquad.MAX_COEFF_CROSSFADE_SAMPLES
        left = torch.tensor(rng.integers(1, total + 1, even.shape), dtype=torch.int32,
                            device=DEVICE)
        cut["fade_total"] = torch.where(even, total, 0).to(torch.int32)
        cut["fade_remaining"] = torch.where(even, left, 0).to(torch.int32)
        out.append((sections, T, _cascade_args(x[:, :T].contiguous(), cut)))
    return out


def phase2_biquad(res: Results) -> None:
    """biquad_cascade on :func:`biquad_inputs`, and its time per block
    weighted by the launches of each section count; then checked on
    :func:`biquad_chunk_inputs`."""
    from audioforge_tpu_torch.ops import biquad

    xb, shapes = biquad_inputs()
    n_elem = FLEET * BLOCK
    device, bounds = {}, {}
    for name, sections, st in shapes:
        args = _cascade_args(xb, st)
        yk, zk = biquad.biquad_cascade(*args)
        yp, zp = biquad.biquad_cascade_plain(*args)
        err = max((yk - yp).abs().max().item(), (zk - zp).abs().max().item())
        times = kernel_times(lambda: biquad.biquad_cascade(*args))
        plain_ms = cuda_ms(lambda: biquad.biquad_cascade_plain(*args), 1)
        fading = int((st["fade_remaining"] > 0).sum().item())
        ending = int(((st["fade_remaining"] > 0)
                      & (st["fade_remaining"] < BLOCK)).any(dim=1).sum().item())
        # per section and sample 9 f64 ops on lane 0; a fading section adds
        # lane 1 and the blend (9 + 6)
        f64_ops = BLOCK * (9 * FLEET * sections + 15 * fading)
        flight = (f", crossfade ending mid-block on {ending} streams, idle on "
                  f"{FLEET - ending}" if fading else ", idle")
        bounds[name] = res.report(
            "biquad_cascade", err, 1e-6, times, plain_ms,
            f"[{FLEET}, {BLOCK}] x {sections} sections{flight}",
            8 * n_elem + FLEET * sections * (40 + 64 + 8), f64_ops=f64_ops)
        device[name] = times[0]
    # launches per block: the EQ (10 sections), RNNoise's high-pass and on the
    # full chain cleanup's owned high-pass (1), both meters' K-weighting and
    # on the default path the DC blocker + 80 Hz pair (2)
    for eq_name, state in (("eq idle", "idle"), ("eq", "crossfading")):
        full = device[eq_name] + 2 * device["hp"] + 2 * device["k-weighting"]
        bound_full = bounds[eq_name] + 2 * bounds["hp"] + 2 * bounds["k-weighting"]
        default = device[eq_name] + device["hp"] + 3 * device["k-weighting"]
        print(f"[2] biquad_cascade per block with the EQ {state}: full chain (10 + 2 x 1 "
              f"+ 2 x 2 sections) {full:.4f} ms, bound {bound_full:.5f} ms; default "
              f"path (10 + 1 + 3 x 2) {default:.4f} ms ({res.card})", flush=True)
    row = res.rows["biquad_cascade"]
    for sections, T, args in biquad_chunk_inputs():
        yk, zk = biquad.biquad_cascade(*args)
        yp, zp = biquad.biquad_cascade_plain(*args)
        err = max((yk - yp).abs().max().item(), (zk - zp).abs().max().item())
        ends = args[4][args[4] > 0]
        print(f"[2] biquad_cascade [{FLEET}, {T}] x {sections} sections in chunks: "
              f"max_abs_err {err:.3e} (tol 1e-6); crossfades end within the block on "
              f"{int((ends < T).sum())} of {ends.numel()} fading sections", flush=True)
        check(np.isfinite(err) and err <= 1e-6,
              f"biquad_cascade disagrees with its plain twin over {T}-sample blocks")
        row["max_abs_err"] = max(row["max_abs_err"], err)


def env_inputs():
    """``(xs, env0)``: env_scan at the tool's shapes, 50 blocks of
    ``[480, 2048]`` time-major."""
    rng = np.random.default_rng(7)
    xs = torch.tensor(rng.standard_normal((ENV_BLOCKS, BLOCK, 2048)).astype(np.float32),
                      device=DEVICE)
    return xs, torch.zeros(2048, device=DEVICE)


def env_run(fn, xs, env0):
    """``fn`` (env_scan or its twin) over the blocks of ``xs``."""
    env, ys = env0, []
    for r in range(xs.shape[0]):
        y, env = fn(xs[r], env)
        ys.append(y)
    return torch.stack(ys), env


def env_chain(fn, xs, env0):
    """``fn`` over the blocks of ``xs``, the envelope carried; the last
    block's ``(y, env)``. Each block reads its own input and writes its own
    output, so a block's input comes from device memory, not the L2, as over
    the tool's 50 blocks."""
    env = env0
    for r in range(xs.shape[0]):
        y, env = fn(xs[r], env)
    return y, env


def max_affine_inputs(T: int = BLOCK):
    """``(v, rho, c, u0)`` as the lookahead limiter gives them, [1024, T]."""
    rng = np.random.default_rng(10)
    target = torch.tensor(rng.uniform(0.5, 1.0, (FLEET, T)).astype(np.float32),
                          device=DEVICE)
    target = torch.where(target > 0.8, torch.ones_like(target), target)
    v = (1.0 - target).contiguous()
    rho = torch.full((FLEET,), float(np.exp(-1.0 / (0.05 * FS))), device=DEVICE)
    c = ((1.0 - rho)[:, None] * v).contiguous()
    return v, rho, c, torch.rand(FLEET, device=DEVICE)


def limiter_stage_inputs(kind: str):
    """``(process, args)``: ``limiter_process`` or ``tp_limiter_process``
    (``kind`` "limiter" or "true-peak") at fleet 1024 with the serving
    defaults, its state warmed over one block of speech with transients over
    the ceiling, and the arguments for the next block."""
    from audioforge_tpu_torch.ops import limiter, true_peak, util

    x = torch.tensor(1.5 * speech_like(FLEET, 2, 25), device=DEVICE)
    x0, xb = x[:, :BLOCK].contiguous(), x[:, BLOCK:].contiguous()
    if kind == "limiter":
        cfg = limiter.LimiterConfig()
        params = {k: torch.full((FLEET,), float(np.float32(v)), device=DEVICE)
                  for k, v in limiter.limiter_params(cfg).items()}
        st, _, _ = limiter.limiter_process(
            cfg, limiter.limiter_init(cfg, n=FLEET, device=DEVICE), x0, params)
        return limiter.limiter_process, (cfg, st, xb, params)
    cfg = true_peak.TruePeakLimiterConfig()
    ceiling = torch.full((FLEET,), float(np.float32(util.db_to_linear(cfg.ceiling_db))),
                         device=DEVICE)
    st, _, _ = true_peak.tp_limiter_process(
        cfg, true_peak.tp_limiter_init(n=FLEET, device=DEVICE), x0, ceiling)
    return true_peak.tp_limiter_process, (cfg, st, xb, ceiling)


def _call_args(mod, name: str, drive):
    """The arguments ``mod.name`` was last called with while ``drive()`` ran."""
    captured = {}
    run = getattr(mod, name)

    def spy(*args):
        captured["args"] = args
        return run(*args)

    setattr(mod, name, spy)
    try:
        drive()
    finally:
        setattr(mod, name, run)
    return captured["args"]


def limiter_gain_inputs(kind: str, T: int = BLOCK):
    """The arguments ``limiter_process`` ("limiter") or ``tp_limiter_process``
    ("true-peak") gives ``limiter_gain_scan`` on :func:`limiter_stage_inputs`,
    the block repeated to ``T`` samples."""
    from audioforge_tpu_torch.ops import limiter, true_peak

    process, args = limiter_stage_inputs(kind)
    args = (*args[:2], args[2].repeat(1, T // BLOCK), *args[3:])
    return _call_args(limiter if kind == "limiter" else true_peak, "limiter_gain_scan",
                      lambda: process(*args))


def compressor_inputs():
    """``(label, (cfg, params, makeup, scan_state, x))`` for the flag sets of
    the serving chain's options and for the compressor without its sidechain
    high-pass."""
    from audioforge_tpu_torch.ops import compressor as comp

    xc = torch.tensor(speech_like(FLEET, 1, 9), device=DEVICE)
    out = []
    for flags in ({"sidechain_highpass_enabled": True},
                  {"sidechain_highpass_enabled": True, "adaptive_release": True,
                   "auto_makeup_enabled": True},
                  {}):
        cfg = comp.CompressorConfig(**flags)
        p = {k: torch.full((FLEET,), float(np.float32(val)), device=DEVICE)
             for k, val in comp.compressor_params(cfg, threshold_db=-30.0).items()}
        s0 = comp.compressor_init(cfg, n=FLEET, device=DEVICE)
        scan_state = {k: s0[k] for k in comp.SCAN_STATE_KEYS}
        makeup = torch.full((FLEET,), 1.2, device=DEVICE)
        out.append((str(sorted(flags)), (cfg, p, makeup, scan_state, xc)))
    return out


def sm_clock_during(fn, seconds: float) -> float:
    """The median SM clock in MHz (nvidia-smi, sampled every 20 ms) while
    ``fn`` runs back to back for ``seconds``; 0 when unreadable."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    mhz = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    return float(np.median(mhz)) if mhz else 0.0


def env_shapes(xs):
    """``(label, blocks [R, T, B])`` of env_scan's further checks: B = 2047
    (rows not 16-byte aligned, a last strip of 15 columns) and 1, and T = 960
    (two of the tool's blocks as one)."""
    x3 = xs[:ENV_CHECK_BLOCKS]
    yield "[480, 2047]", x3[:, :, :2047].contiguous()
    yield "[480, 1]", x3[:, :, :1].contiguous()
    yield "[960, 2048]", xs[:2 * ENV_CHECK_BLOCKS].reshape(ENV_CHECK_BLOCKS, 2 * BLOCK, -1)


def phase2_pr1_kernels(res: Results) -> None:
    phase2_env(res)
    phase2_max_affine(res)
    phase2_limiters(res)
    phase2_biquad(res)
    phase2_compressor(res)


def phase2_env(res: Results) -> None:
    """env_scan over the tool's 50 blocks of [480, 2048] with the envelope
    carried, then over a few blocks of each of :func:`env_shapes`; its time
    per block over the 50 blocks and over them as 25 blocks of [960, 2048],
    and its serial floor beside its bytes bound."""
    from audioforge_tpu_torch.ops import envelope

    xs, env0 = env_inputs()
    B = xs.shape[2]
    yk, ek = env_run(envelope.env_scan, xs, env0)
    yp, ep = env_run(envelope.env_scan_plain, xs, env0)
    err = max((yk - yp).abs().max().item(), (ek - ep).abs().max().item())
    times = tuple(t / ENV_BLOCKS for t in
                  kernel_times(lambda: env_chain(envelope.env_scan, xs, env0), 3))
    # per element: abs, compare/select, 4 for the one-pole, max, log
    res.report("env_scan", err, 1e-5, times,
               cuda_ms(lambda: envelope.env_scan_plain(xs[0], env0), 1),
               f"[{BLOCK}, {B}] x {ENV_BLOCKS} blocks", 8 * BLOCK * B, f32_ops=8 * BLOCK * B)
    for label, xb in env_shapes(xs):
        e0 = env0[:xb.shape[2]].contiguous()
        yk, ek = env_run(envelope.env_scan, xb, e0)
        yp, ep = env_run(envelope.env_scan_plain, xb, e0)
        err = max((yk - yp).abs().max().item(), (ek - ep).abs().max().item())
        print(f"[2] env_scan {label} x {xb.shape[0]} blocks: max_abs_err {err:.3e} (tol 1e-5)",
              flush=True)
        check(np.isfinite(err) and err <= 1e-5, f"env_scan {label} disagrees with its twin")
        res.rows["env_scan"]["max_abs_err"] = max(res.rows["env_scan"]["max_abs_err"], err)
    long_blocks = xs.reshape(ENV_BLOCKS // 2, 2 * BLOCK, B)
    ms_480 = res.rows["env_scan"]["ms"]
    ms_960 = kernel_times(lambda: env_chain(envelope.env_scan, long_blocks, env0),
                          3)[0] / long_blocks.shape[0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        env_chain(envelope.env_scan, xs, env0)
    clock = sm_clock_during(graph.replay, ENV_CLOCK_S)
    floor_ms = ENV_CHAIN_CYCLES * BLOCK / (1e3 * clock) if clock else float("nan")
    step_ns = 1e6 * (ms_960 - ms_480) / BLOCK
    print(f"[2] env_scan serial floor {floor_ms:.5f} ms a [{BLOCK}, {B}] block "
          f"({ENV_CHAIN_CYCLES} chain cycles a step x {BLOCK} at the {clock:g} MHz the SM "
          f"ran env_scan at) beside its bytes bound {1e3 * 8 * BLOCK * B / PEAKS["hbm_bytes_per_s"]:.5f}"
          f" ms; kernel [{2 * BLOCK}, {B}] {ms_960:.4f} ms a block, so {step_ns:.2f} ns "
          f"({step_ns * clock / 1e3:.1f} cycles) a further step ({res.card})", flush=True)


def phase2_max_affine(res: Results) -> None:
    """max_affine_scan on :func:`max_affine_inputs`, also over a block that
    runs as two shared-memory chunks."""
    from audioforge_tpu_torch.ops import scan

    n_elem = FLEET * BLOCK
    args = max_affine_inputs()
    err = (scan.max_affine_scan(*args) - scan.max_affine_scan_plain(*args)).abs().max().item()
    times = kernel_times(lambda: scan.max_affine_scan(*args))
    plain_ms = cuda_ms(lambda: scan.max_affine_scan_plain(*args), 2)
    long_args = max_affine_inputs(CHUNKED_BLOCK)
    err2 = (scan.max_affine_scan(*long_args)
            - scan.max_affine_scan_plain(*long_args)).abs().max().item()
    print(f"[2] max_affine_scan [{FLEET}, {CHUNKED_BLOCK}] in chunks: max_abs_err {err2:.3e} "
          "(tol 1e-5)", flush=True)
    check(np.isfinite(err2) and err2 <= 1e-5,
          f"max_affine_scan disagrees with its plain twin over {CHUNKED_BLOCK}-sample blocks")
    res.report("max_affine_scan", max(err, err2), 1e-5, times, plain_ms, f"[{FLEET}, {BLOCK}]",
               12 * n_elem, f32_ops=3 * n_elem)


def _limiter_gain_err(args):
    """limiter_gain_scan against its plain twin on ``args``: the largest
    difference over y, the last and the least gain, and the streams whose
    limited-events flags differ."""
    from audioforge_tpu_torch.ops import scan

    yk, lastk, mink, evk = scan.limiter_gain_scan(*args)
    yp, lastp, minp, evp = scan.limiter_gain_scan_plain(*args)
    err = max((yk - yp).abs().max().item(), (lastk - lastp).abs().max().item(),
              (mink - minp).abs().max().item())
    return err, int((evk != evp).sum().item()), minp, evp


def phase2_limiters(res: Results) -> None:
    """limiter_gain_scan on :func:`limiter_gain_inputs`, as the lookahead
    limiter and as the true-peak limiter call it, also over a block that runs
    as two shared-memory chunks; then the card's time of both limiter stages
    (window max or polyphase FIR, the kernel, the state's bookkeeping)."""
    from audioforge_tpu_torch.ops import scan

    n_elem = FLEET * BLOCK
    for kind in ("limiter", "true-peak"):
        args = limiter_gain_inputs(kind)
        err, flags, min_gain, events = _limiter_gain_err(args)
        err2, flags2, _, _ = _limiter_gain_err(limiter_gain_inputs(kind, CHUNKED_BLOCK))
        limited = int((min_gain < 1.0).sum().item())
        print(f"[2] limiter_gain_scan {kind}: gain below 1 on {limited} of {FLEET} streams "
              f"(least {min_gain.min().item():.3f}), limited events on "
              f"{int(events.sum().item())}; events flags differ from the twin on {flags} "
              f"streams; [{FLEET}, {CHUNKED_BLOCK}] in chunks: max_abs_err {err2:.3e} (tol "
              f"1e-5), flags differ on {flags2}", flush=True)
        check(limited >= FLEET // 2, f"limiter_gain_scan ({kind}): the inputs hardly limit")
        check(flags == 0 and flags2 == 0 and np.isfinite(err2) and err2 <= 1e-5,
              f"limiter_gain_scan ({kind}) disagrees with its plain twin")
        times = kernel_times(lambda: scan.limiter_gain_scan(*args))
        plain_ms = cuda_ms(lambda: scan.limiter_gain_scan_plain(*args), 2)
        # per sample ~16 f32 operations (a division, compares, clips, the
        # recurrence's multiply, add and max); 8 bytes in, 4 out
        res.report("limiter_gain_scan", max(err, err2), 1e-5, times, plain_ms,
                   f"[{FLEET}, {BLOCK}] {kind}", 12 * n_elem + FLEET * 4 * 6,
                   f32_ops=16 * n_elem)
    for kind in ("limiter", "true-peak"):
        process, args = limiter_stage_inputs(kind)
        device_ms, eager_ms = kernel_times(lambda: process(*args))
        print(f"[2] stage (info, {res.card}): {process.__name__} [{FLEET}, {BLOCK}]: "
              f"{device_ms:.4f} ms on the card, eager {eager_ms:.4f} ms per call", flush=True)


def phase2_compressor(res: Results) -> None:
    """compressor_scan on :func:`compressor_inputs`, and from the kernel's
    state over a block that runs as two shared-memory chunks."""
    from audioforge_tpu_torch.ops import compressor as comp

    n_elem = FLEET * BLOCK
    x_long = torch.tensor(speech_like(FLEET, CHUNKED_BLOCK // BLOCK, 19), device=DEVICE)
    for label, args in compressor_inputs():
        sk, yk = comp.compressor_scan(*args)
        sp, yp = comp.compressor_scan_plain(*args)
        err = (yk - yp).abs().max().item()
        serr = _state_err(sk, sp)
        check((sk["current_gr_db"] - sp["current_gr_db"]).abs().max().item() <= 1e-3
              and serr <= 1e-3,
              f"compressor_scan state disagrees with its plain twin ({serr:.3e})")
        # from the kernel's state, a block that runs as two shared-memory chunks
        long_args = (*args[:3], sk, x_long)
        sk2, yk2 = comp.compressor_scan(*long_args)
        sp2, yp2 = comp.compressor_scan_plain(*long_args)
        err2, serr2 = (yk2 - yp2).abs().max().item(), _state_err(sk2, sp2)
        gr_err2 = (sk2["current_gr_db"] - sp2["current_gr_db"]).abs().max().item()
        print(f"[2] compressor_scan [{FLEET}, {CHUNKED_BLOCK}] {label} in chunks: max_abs_err "
              f"{err2:.3e} (tol 1e-5), state {serr2:.3e} (tol 1e-3); gain reduction up to "
              f"{sk2['current_gr_db'].max().item():.1f} dB", flush=True)
        check(np.isfinite(err2) and err2 <= 1e-5 and serr2 <= 1e-3 and gr_err2 <= 1e-3,
              f"compressor_scan disagrees with its plain twin over {CHUNKED_BLOCK}-sample blocks")
        err = max(err, err2)
        times = kernel_times(lambda: comp.compressor_scan(*args))
        plain_ms = cuda_ms(lambda: comp.compressor_scan_plain(*args), 1)
        # ~70 f32 operations per sample (log10f, powf and sqrtf counted once)
        res.report("compressor_scan", err, 1e-5, times, plain_ms,
                   f"[{FLEET}, {BLOCK}] {label}",
                   8 * n_elem + FLEET * 4 * 2 * (8 + 12), f32_ops=70 * n_elem)


def gate_inputs():
    """``(name, cfg, params, state, blocks)`` for every gate mode: 30 blocks
    ``(x, vad inputs)`` of 5-10 Hz bursts whose VAD inputs (probability near
    0 or near 1) change per block, so hold, chatter and (VAD modes)
    auto-relax engage."""
    from audioforge_tpu_torch.ops import gate

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(13)
    t = np.arange(GATE_BLOCKS * BLOCK) / FS
    env = np.sin(2 * np.pi * rng.uniform(5.0, 10.0, (FLEET, 1)) * t
                 + rng.uniform(0, 6, (FLEET, 1))) > 0.2
    x = torch.tensor((0.2 * env * np.sin(2 * np.pi * 180.0 * t)
                      + 0.002 * rng.standard_normal((FLEET, t.size))).astype(np.float32),
                     device=dev)
    out = []
    for mode, name in ((gate.THRESHOLD_ONLY, "threshold-only"),
                       (gate.VAD_ASSISTED, "VAD-assisted"), (gate.VAD_ONLY, "VAD-only")):
        cfg = gate.GateConfig(mode=mode)
        p = {k: torch.full((FLEET,), float(np.float32(v)), device=dev)
             for k, v in gate.gate_params(cfg, attack_ms=5.0, release_ms=60.0).items()}
        p["threshold_db"] = torch.tensor(rng.uniform(-45, -25, FLEET).astype(np.float32),
                                         device=dev)
        blocks = []
        for b in range(GATE_BLOCKS):
            prob = np.where(rng.random(FLEET) > 0.5, rng.uniform(0.7, 1.0, FLEET),
                            rng.uniform(0.0, 0.3, FLEET))
            vad = (torch.tensor(prob.astype(np.float32), device=dev),
                   torch.tensor(rng.random(FLEET) > 0.2, device=dev),
                   torch.tensor(rng.random(FLEET) > 0.5, device=dev),
                   torch.full((FLEET,), 0.48, device=dev))
            blocks.append((x[:, b * BLOCK:(b + 1) * BLOCK].contiguous(), vad))
        out.append((name, cfg, p, gate.gate_init(n=FLEET, device=dev), blocks))
    return out


def phase2_gate(res: Results) -> None:
    """gate_scan in every mode over :func:`gate_inputs`, each block against
    the plain twin from the kernel's state; timed on the last block."""
    from audioforge_tpu_torch.ops import gate

    n_elem = FLEET * BLOCK
    for name, cfg, p, st, blocks in gate_inputs():
        err, diverged = 0.0, 0
        for xb, vad in blocks:
            args = (cfg, st, xb, *vad, p)
            sk, yk, _ = gate.gate_process(*args)
            sp, yp, _ = gate.gate_process_plain(*args)
            # a stream diverges where a threshold test flipped on a 1-ulp
            # difference of log10f/powf: its integer state or its audio
            # departs from the plain twin's
            stream_err = (yk - yp).abs().amax(dim=1)
            apart = stream_err > 1e-4
            for k in gate.INT_KEYS:
                apart |= sk[k] != sp[k]
            diverged += int(apart.sum().item())
            err = max(err, float(torch.where(apart, 0.0, stream_err).max().item()))
            st = sk
        chatter = int((st["chatter_event_count"] > 0).sum().item())
        relax = int((st["auto_relax_remaining"] > 0).sum().item())
        print(f"[2] gate_scan {name}: {diverged} of {FLEET * GATE_BLOCKS} stream-blocks "
              f"diverged from the plain twin (tol 0.1 %); chatter fired on {chatter} "
              f"streams, {relax} in auto-relax, "
              f"{int((st['hold_remaining'] > 0).sum())} holding", flush=True)
        check(diverged <= FLEET * GATE_BLOCKS // 1000,
              f"gate_scan ({name}): {diverged} stream-blocks differ from the plain twin")
        check(chatter > 0 and (relax > 0 or cfg.mode == gate.THRESHOLD_ONLY),
              f"gate_scan ({name}): chatter or auto-relax never engaged")
        times = kernel_times(lambda: gate.gate_process(*args))
        plain_ms = cuda_ms(lambda: gate.gate_process_plain(*args), 1)
        # ~35 f32 operations per sample threshold-only, ~80 with VAD fusion
        ops = (35 if cfg.mode == gate.THRESHOLD_ONLY else 80) * n_elem
        res.report("gate_scan", err, 1e-4, times, plain_ms, f"[{FLEET}, {BLOCK}] {name}",
                   8 * n_elem + FLEET * 4 * 2 * 18, f32_ops=ops)
        # from the final state, two blocks as one that runs as two
        # shared-memory chunks
        x_long = torch.cat([blocks[0][0], blocks[1][0]], dim=1).contiguous()
        long_args = (cfg, st, x_long, *vad, p)
        sk, yk, _ = gate.gate_process(*long_args)
        sp, yp, _ = gate.gate_process_plain(*long_args)
        stream_err = (yk - yp).abs().amax(dim=1)
        apart = stream_err > 1e-4
        for k in gate.INT_KEYS:
            apart |= sk[k] != sp[k]
        print(f"[2] gate_scan [{FLEET}, {CHUNKED_BLOCK}] {name} in chunks: "
              f"{int(apart.sum())} of {FLEET} streams diverged from the plain twin (tol "
              f"0.1 %), max_abs_err of the others "
              f"{float(torch.where(apart, 0.0, stream_err).max()):.3e}", flush=True)
        check(int(apart.sum()) <= FLEET // 1000,
              f"gate_scan ({name}) disagrees with its plain twin over {CHUNKED_BLOCK}-sample "
              "blocks")


def deesser_inputs(auto: bool):
    """``(config, state, x)``: the de-esser at threshold -40 dB (auto or
    manual gain computer) with its envelopes warmed over two blocks of
    :func:`mic_capture`, so the reduction is engaged, and the third block."""
    from audioforge_tpu_torch.ops import deesser

    dev = torch.device(DEVICE)
    x = torch.tensor(mic_capture(FLEET, 3, 14), device=dev)
    cfg = deesser.DeEsserConfig(enabled=True, auto_enabled=auto, threshold_db=-40.0)
    st = deesser.deesser_init(cfg, n=FLEET, device=dev)
    for b in range(2):
        st, _ = deesser.deesser_scan(cfg, st, x[:, b * BLOCK:(b + 1) * BLOCK].contiguous())
    return cfg, st, x[:, 2 * BLOCK:].contiguous()


def phase2_deesser(res: Results) -> None:
    from audioforge_tpu_torch.ops import deesser

    n_elem = FLEET * BLOCK
    for auto in (True, False):
        cfg, st, xb = deesser_inputs(auto)
        sk, yk = deesser.deesser_scan(cfg, st, xb)
        sp, yp = deesser.deesser_scan_plain(cfg, st, xb)
        err = (yk - yp).abs().max().item()
        serr = _max_err(sk, sp)
        check(serr <= 1e-3, f"deesser_scan state disagrees with its plain twin ({serr:.3e})")
        engaged = int((sk["current_reduction_db"] > 0.1).sum().item())
        check(engaged >= FLEET // 8, f"deesser_scan: reduction on only {engaged} streams")
        times = kernel_times(lambda: deesser.deesser_scan(cfg, st, xb))
        plain_ms = cuda_ms(lambda: deesser.deesser_scan_plain(cfg, st, xb), 1)
        name = "auto" if auto else "manual"
        print(f"[2] deesser_scan {name}: reduction > 0.1 dB on {engaged} streams, "
              f"max {sk['current_reduction_db'].max().item():.2f} dB", flush=True)
        # ~270 f32 operations per sample: 9 biquads, envelopes, 4 log10f,
        # 3 sqrtf, 3 powf, the gain computer per band
        res.report("deesser_scan", err, 1e-4, times, plain_ms,
                   f"[{FLEET}, {BLOCK}] {name}", 8 * n_elem + FLEET * 4 * 2 * 33,
                   f32_ops=270 * n_elem)


def cleanup_inputs(mode: int, fading: bool = True, T: int = BLOCK):
    """The arguments routing_process gives cleanup_scan in ``mode`` for a
    block of ``T`` samples: a state whose window ends 200 samples into the
    block, both notches retuned (to 50.4 and 100.8 Hz) with their crossfades
    in flight (``fading``) or idle; the streams of class 3 (every fourth)
    carry no hum hold and a 45 Hz thump from the block's start, so the rumble
    trigger fires on them once the window has ended."""
    from audioforge_tpu_torch.ops import routing

    dev = torch.device(DEVICE)
    audio = mic_capture(FLEET, 1 + T // BLOCK, 15)
    t = np.arange(T)
    audio[3::4, BLOCK:] += (0.7 * np.sin(2 * np.pi * 45.0 * t / FS)
                            * np.minimum(1.0, t / 100.0)).astype(np.float32)
    x = torch.tensor(audio, device=dev)
    cfg = routing.RoutingConfig(cleanup_mode=mode)
    st = routing.routing_init(cfg, n=FLEET, device=dev)
    # after the first block the window ends 200 samples into the second
    st["window_pos"] = torch.full((FLEET,), cfg.window_samples - 200 - BLOCK,
                                  dtype=torch.int32, device=dev)
    st, _, _ = routing.routing_process(cfg, st, x[:, :BLOCK].contiguous())
    # the tracked line: away from the notches' 55 Hz, so they retune, or on it
    line = torch.full((FLEET,), 50.4 if fading else 55.0, device=dev)
    if fading:
        for key, mult in (("hum_notch", 1.0), ("harmonic_notch", 2.0)):
            st[key] = routing._smooth_notch_retune(st[key], line * mult, FS,
                                                   cfg.notch_fade_samples)
    thump = torch.arange(FLEET, device=dev) % 4 == 3
    st.update(hum_line_hz=line,
              hum_hold=torch.where(thump, 0, 20000).to(torch.int32),
              rumble_hold=(torch.arange(FLEET, device=dev) % 3 * 700).to(torch.int32),
              hum_strength=torch.full_like(line, 0.5),
              harmonic_strength=torch.full_like(line, 0.3))
    return _call_args(routing, "cleanup_scan",
                      lambda: routing.routing_process(cfg, st, x[:, BLOCK:].contiguous()))


def cleanup_configs():
    """``(label, mode, fading)`` of the cleanup_scan configurations."""
    from audioforge_tpu_torch.ops import routing

    return (("gentle", routing.CLEANUP_GENTLE, True), ("strong", routing.CLEANUP_STRONG, True),
            ("strong idle", routing.CLEANUP_STRONG, False))


def _cleanup_err(args, name: str):
    """cleanup_scan against its plain twin on ``args``: the largest
    difference of y and of the state; the rumble hold must be equal. Also
    returns the streams whose rumble trigger fired in the block."""
    from audioforge_tpu_torch.ops import routing

    ok, yk = routing.cleanup_scan(*args)
    op, yp = routing.cleanup_scan_plain(*args)
    check(torch.equal(ok["rumble_hold"], op["rumble_hold"]),
          f"cleanup_scan {name}: rumble hold differs from the plain twin's")
    # a hold that stands within a block of its set value was set in the block
    hold_set, T = routing._scan_consts(args[0])[3], args[3].shape[-1]
    fired = int((op["rumble_hold"] > hold_set - T).sum().item())
    return (yk - yp).abs().max().item(), _max_err(ok, op), fired


def phase2_cleanup(res: Results) -> None:
    """cleanup_scan on :func:`cleanup_inputs` for every configuration of
    :func:`cleanup_configs`, also over a block that runs as two shared-memory
    chunks."""
    from audioforge_tpu_torch.ops import routing

    n_elem = FLEET * BLOCK
    for name, mode, fade in cleanup_configs():
        args = cleanup_inputs(mode, fade)
        check(bool((args[2]["boundary"] == 200).all()), "the window does not end mid-block")
        fading = sum(int((args[1][k]["fade_remaining"] > 0).sum().item())
                     for k in ("hum_notch", "harmonic_notch"))
        check(fading == (2 * FLEET if fade else 0), f"cleanup_scan {name}: {fading} notch "
              "crossfades in flight")
        err, serr, fired = _cleanup_err(args, name)
        check(serr <= 1e-5, f"cleanup_scan state disagrees with its plain twin ({serr:.3e})")
        err2, serr2, fired2 = _cleanup_err(cleanup_inputs(mode, fade, CHUNKED_BLOCK), name)
        print(f"[2] cleanup_scan {name}: the rumble trigger fired on {fired} of {FLEET} "
              f"streams, rumble hold equal to the twin's on all; [{FLEET}, {CHUNKED_BLOCK}] in "
              f"chunks: max_abs_err {err2:.3e}, state {serr2:.3e} (tol 1e-5), fired on {fired2}",
              flush=True)
        check(fired == FLEET // 4 and fired2 == FLEET // 4,
              f"cleanup_scan {name}: the rumble trigger fired on {fired} and {fired2} streams, "
              f"expected the {FLEET // 4} with a thump")
        check(np.isfinite(err2) and err2 <= 1e-5 and serr2 <= 1e-5,
              f"cleanup_scan {name} disagrees with its plain twin over {CHUNKED_BLOCK}-sample "
              "blocks")
        times = kernel_times(lambda: routing.cleanup_scan(*args))
        plain_ms = cuda_ms(lambda: routing.cleanup_scan_plain(*args), 1)
        # f32: ~20 rumble operations per sample; f64: DC blocker (3), two
        # notches' lane 0 and mix (12 each), lane 1 and blend while fading (12)
        f64_ops = BLOCK * (27 * FLEET + 12 * fading)
        flight = "crossfades in flight" if fade else "no crossfade in flight"
        res.report("cleanup_scan", max(err, err2), 1e-5, times, plain_ms,
                   f"[{FLEET}, {BLOCK}] {name}, window ends at t=200, {flight}",
                   8 * n_elem + FLEET * (4 * (8 + 20 + 10) + 8 * 8 * 2),
                   f32_ops=20 * n_elem, f64_ops=f64_ops)


def phase2_torch_stages(card: str) -> None:
    """Information: the time per call, at the serving shapes, of the three
    block-level stages that are vectorised torch with no kernel of their own
    yet, with their calls per block: eager (CUDA events around back-to-back
    calls, the host's launch cost included) and on the card alone (a CUDA
    graph of the calls, replayed); for the window max and the true-peak FIR
    also their bound and the card's time of the one PyTorch call that
    computes each (a yardstick; the port does not call it)."""
    from audioforge_tpu_torch.ops import limiter, routing, scan, true_peak

    rng = np.random.default_rng(23)
    W = limiter.LimiterConfig().lookahead_samples
    ext = torch.tensor(rng.standard_normal((FLEET, W + BLOCK)).astype(np.float32),
                       device=DEVICE).abs()
    tp_ext = torch.tensor(rng.standard_normal((FLEET, true_peak._H + BLOCK)).astype(np.float32),
                          device=DEVICE)
    xb = torch.tensor(mic_capture(FLEET, 1, 24), device=DEVICE)
    st = routing.routing_init(routing.RoutingConfig(cleanup_mode=routing.CLEANUP_STRONG),
                              n=FLEET, device=torch.device(DEVICE))
    omegas = routing._bank_omegas(FS, xb.device)
    boundary = torch.full((FLEET,), 200, dtype=torch.int32, device=DEVICE)
    stages = (
        (f"limiter window max, ops/scan.py sliding_window_max [{FLEET}, {W} + {BLOCK}] "
         f"window {W + 1}", "1 per block",
         lambda: scan.sliding_window_max(ext, W + 1)[:, W:]),
        (f"true-peak 4x32 polyphase FIR, ops/true_peak.py _interp_peaks [{FLEET}, "
         f"{true_peak._H} + {BLOCK}]", "3 per block (input detector, limiter in and out)",
         lambda: true_peak._interp_peaks(tp_ext, BLOCK)),
        (f"hum oscillator bank, ops/routing.py _hum_bank [{FLEET}, {BLOCK}] x 26 bins",
         "1 per full-chain block, 0 on the default path",
         lambda: routing._hum_bank(st["bin_phase"], omegas, boundary, xb)),
    )
    for name, calls, fn in stages:
        device_ms, eager_ms = kernel_times(fn)
        print(f"[2] torch stage (info, {card}): {name}: eager {eager_ms:.4f} ms per call, "
              f"{device_ms:.4f} ms on the card; {calls}", flush=True)
    # the one PyTorch call that computes each of the first two, and their
    # bounds: each input read once, the output written once; the window max
    # as three comparisons per sample (van Herk / Gil-Werman), the FIR as 4 x
    # 32 multiply-adds and the |.| maximum over the four phases and the sample
    n_out = FLEET * BLOCK
    taps = torch.tensor(true_peak._FIR_OLDEST_FIRST.T.copy(), device=DEVICE)[:, None]
    library = (
        ("limiter window max", "F.max_pool1d",
         lambda: F.max_pool1d(ext[:, None], W + 1, stride=1)[:, 0],
         lambda: scan.sliding_window_max(ext, W + 1)[:, W:],
         bound(4 * FLEET * (W + BLOCK) + 4 * n_out, f32_ops=3 * n_out)),
        ("true-peak 4x32 polyphase FIR", "F.conv1d (the FIR product alone)",
         lambda: F.conv1d(tp_ext[:, None], taps),
         lambda: torch.matmul(tp_ext.unfold(-1, true_peak.TAPS_PER_PHASE, 1),
                              true_peak._fir(tp_ext.device)).transpose(1, 2),
         bound(4 * FLEET * (true_peak._H + BLOCK) + 4 * n_out,
               f32_ops=n_out * (2 * 4 * true_peak.TAPS_PER_PHASE + 9))),
    )
    for name, call, lib_fn, ours, (bound_ms, bound_by) in library:
        err = (lib_fn() - ours()).abs().max().item()
        lib_ms, _ = kernel_times(lib_fn)
        print(f"[2] torch stage (info, {card}): {name}: {call} {lib_ms:.4f} ms on the card "
              f"(max_abs_err against the stage's own arithmetic {err:.2e}); bound "
              f"{bound_ms:.5f} ms ({bound_by})", flush=True)
    phase2_stage_bounds(card, xb, st, omegas, boundary)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def phase2_stage_bounds(card: str, xb, st, omegas, boundary) -> None:
    """Information: the bound of the three torch stages that have no kernel
    yet, at fleet 1024, beside their time on the card (a CUDA graph of 20
    calls, replayed) and their calls per block. The hum oscillator bank:
    its input and output once, and ten f32 operations per stream, bin and
    sample (the two multiply-adds of the I and Q sums, and the oscillator's
    advance as a complex rotation in place of a sine and a cosine). The
    block reductions (input sanitize and meters, output sanitize and
    meters, four calls a block): each call reads its block once and the
    sanitizers write it once; three operations a sample each. The RNNoise
    frame: its weights, its state in and out, the frame in and out, and the
    multiply-adds of its GEMMs and convolutions as
    ``torch.utils.flop_counter`` counts them (the elementwise work
    left out, so the bound stays a least time). No single PyTorch call
    computes any of the three."""
    from torch.utils.flop_counter import FlopCounterMode

    from audioforge_tpu_torch.models import rnnoise
    from audioforge_tpu_torch.ops import routing

    n, T = xb.shape
    ceiling = torch.full((n,), 0.8, device=DEVICE)
    acc = torch.zeros(n, device=DEVICE)
    coeff = torch.tensor(float(np.exp(-1.0 / (0.3 * FS))), device=DEVICE)
    weights = rnnoise.load_weights(rnnoise.discover_model_path(), DEVICE)
    state = rnnoise.rnnoise_state_init(n=n, device=DEVICE)
    pcm = torch.clamp(rnnoise.soft_clip(xb) * rnnoise.PCM_SCALE, -rnnoise.PCM_MODEL_LIMIT,
                      rnnoise.PCM_MODEL_LIMIT)

    def reductions():
        y, _, _ = routing.sanitize_and_clamp_input(xb)
        routing.meter_block_stats(y, acc, coeff)
        z, _, _ = routing.sanitize_and_clamp_output(y, ceiling)
        routing.meter_block_stats(z, acc, coeff)

    with FlopCounterMode(display=False) as counter:
        new_state, y, aux = rnnoise.rnnoise_frame(weights, state, pcm)
    rnnoise_flops = counter.get_total_flops()
    sample_bytes = 4 * n * T
    stages = (
        ("hum oscillator bank", "1 per full-chain block, 0 on the default and preset paths",
         lambda: routing._hum_bank(st["bin_phase"], omegas, boundary, xb),
         bound(sample_bytes + 4 * st["bin_phase"].numel() + 4 * n + 4 * n * (4 * 26 + 2),
               f32_ops=10.0 * n * 26 * T)),
        ("block reductions", "4 per block on every path (2 sanitizers, 2 meters)",
         reductions,
         bound(6 * sample_bytes + 4 * n * 16, f32_ops=4 * 3.0 * n * T)),
        ("RNNoise frame", "1 per block on the RNNoise paths",
         lambda: rnnoise.rnnoise_frame(weights, state, pcm),
         bound(_tree_bytes(weights) + _tree_bytes(state) + _tree_bytes(new_state)
               + 2 * sample_bytes + _tree_bytes(aux), f32_ops=rnnoise_flops)),
    )
    for name, calls, fn, (bound_ms, bound_by) in stages:
        device_ms, eager_ms = kernel_times(fn)
        print(f"[2] torch stage bound (info, {card}): {name} [{n}, {T}]: {device_ms:.4f} ms "
              f"on the card, eager {eager_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}); "
              f"{calls}; library call none", flush=True)


def voice_and_noise(n: int, n_blocks: int, seed: int) -> np.ndarray:
    """Four stream classes (i % 4) over noise at -34 dBFS, ``[n, n_blocks *
    480]``: 0 and 1 voiced bursts (harmonics 3-6 of a per-stream pitch of
    180-240 Hz, which the Silero archive calls voice, at two levels), on and
    off at 2.5-3 Hz; 2 and 3 the noise alone."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * BLOCK) / FS
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    f0 = rng.uniform(180.0, 240.0, (n, 1))
    cls = np.arange(n)[:, None] % 4
    voiced = sum(np.sin(2 * np.pi * f0 * h * t + h * phase) for h in range(3, 7))
    on = np.sin(2 * np.pi * rng.uniform(2.5, 3.0, (n, 1)) * t + phase) > -0.2
    x = np.where(cls == 0, 0.15, np.where(cls == 1, 0.06, 0.0)) * voiced * on
    x = x + 0.02 * rng.standard_normal((n, t.size))
    return x.astype(np.float32)


def vad_path_audio(n: int, n_blocks: int, seed: int) -> np.ndarray:
    """:func:`voice_and_noise` with class 3 at -50 dBFS, where the Silero
    archive's posterior stays near 0."""
    x = voice_and_noise(n, n_blocks, seed)
    x[3::4] *= 0.15
    return x


def model_kernel_inputs():
    """Phase [2]'s inputs of the four model kernels at fleet 1024, the shapes
    the serving step gives them, from two blocks of :func:`voice_and_noise`:
    ``(vad_front args, vad_lstm_head args, dfn_features args,
    dfn_spec_synth args)``; the Silero and DeepFilterNet3-LL archives."""
    from audioforge_tpu_torch.models import dfn3, silero

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(41)
    x = torch.tensor(voice_and_noise(FLEET, 2, 41), device=dev)
    x0, x1 = x[:, :BLOCK].contiguous(), x[:, BLOCK:].contiguous()
    zero = torch.zeros(FLEET, 30, device=dev)
    hist, window, _ = silero.vad_front_plain(x0, zero, torch.zeros(FLEET, 576, device=dev),
                                             1.0)
    front = (x1, hist.contiguous(), window, torch.tensor(1.0, device=dev))
    sw = {k: v.to(dev) for k, v in silero.default_params().items()}
    lstm = torch.tensor(rng.normal(0, 0.3, (FLEET, 2, 128)).astype(np.float32), device=dev)
    gates = silero.vad_gates(sw, silero.vad_front_plain(*front)[2], lstm[:, 0])
    head = (sw, gates, lstm, torch.tensor(rng.uniform(0, 1, FLEET).astype(np.float32),
                                          device=dev),
            torch.tensor(np.arange(FLEET) % 7, dtype=torch.int32, device=dev),
            torch.tensor(0.5, device=dev))
    c = dfn3._consts(dev)
    spec = torch.view_as_real(torch.fft.rfft(torch.cat([x0, x1], 1) * c["window"])).contiguous()
    st = dfn3.dfn_state_init(n=FLEET, device=dev)
    features = (spec, st["erb_norm"], st["unit_norm"])
    f32 = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    synth = (spec, f32(rng.uniform(0, 1, (FLEET, 32))),
             f32(rng.normal(0, 0.3, (FLEET, 5, 96, 2))),
             f32(rng.normal(0, 1, (FLEET, 5, 96, 2))), torch.tensor(30.0, device=dev),
             torch.tensor(0.0, device=dev))
    return front, head, features, synth


def _rows(args, m: int) -> tuple:
    """The first ``m`` streams of a kernel's arguments (0-d controls as
    they are)."""
    return tuple(a[:m] if a.dim() else a for a in args)


def head_rows(head, m: int) -> tuple:
    """The first ``m`` streams of vad_lstm_head's arguments (the weights as
    they are)."""
    return (head[0], *_rows(head[1:], m))


def _tuple_err(a, b) -> float:
    return max((u.double() - v.double()).abs().max().item() for u, v in zip(a, b))


def phase2_models(res: Results) -> None:
    """The four kernels of the model stages against their plain twins at the
    serving shapes (fleet 1024; vad_front, vad_lstm_head and dfn_features
    also at 1023 and one stream): vad_front, vad_lstm_head (and beside it
    ``torch._VF.lstm_cell``, the one PyTorch call of an LSTM cell, GEMMs
    included), dfn_features and dfn_spec_synth (also with the post filter
    on)."""
    from audioforge_tpu_torch.models import dfn3, silero

    front, head, features, synth = model_kernel_inputs()
    n = FLEET
    # fleet 1024 (the headline), 1023 (a last block that is not whole) and one
    # stream; every slice is a row prefix, so contiguous and aligned
    for m in (n, n - 1, 1):
        args = _rows(front, m)
        err = _tuple_err(silero.vad_front(*args), silero.vad_front_plain(*args))
        # bytes: the block, history and the kept 416 samples of the window
        # read; history, window and frames written; 160 x 31 multiply-adds and
        # 1,024 pre-gain products per stream
        res.report("vad_front", err, 1e-5, kernel_times(lambda: silero.vad_front(*args)),
                   cuda_ms(lambda: silero.vad_front_plain(*args), 20),
                   f"[{m}, {BLOCK}] -> frames [{4 * m}, 256]",
                   4 * m * (BLOCK + 30 + 416 + 30 + 576 + 1024),
                   f32_ops=m * (2 * 160 * 31 + 1024))

    sw, lstm = head[0], head[2]
    x_t = torch.relu(head[1][:, :128])  # an input of the encoder's width
    lib = lambda: torch._VF.lstm_cell(x_t, (lstm[:, 0], lstm[:, 1]), sw["lstm_wi"],
                                      sw["lstm_wh"], sw["lstm_bi"], sw["lstm_bh"])
    library_ms, _ = kernel_times(lib)
    for m in (n, n - 1, 1):
        args = head_rows(head, m)
        out_k, out_p = silero.vad_lstm_head(*args), silero.vad_lstm_head_plain(*args)
        flags = int((out_k[2] != out_p[2]).sum() + (out_k[4] != out_p[4]).sum())
        err = _tuple_err([out_k[i] for i in (0, 1, 3)], [out_p[i] for i in (0, 1, 3)])
        print(f"[2] vad_lstm_head [{m}]: blocks seen and available differ from the twin on "
              f"{flags} streams; available on {int(out_k[4].sum())} of {m}", flush=True)
        check(flags == 0, f"vad_lstm_head [{m}]: counts or flags differ from the plain twin")
        # bytes: gate pre-activations and c0 read, h1 and c1 written, the [N]
        # rows; per unit 3 sigmoids and 2 tanh (~20 operations each) and ~12
        # more, the head's multiply-add
        res.report("vad_lstm_head", err, 1e-5,
                   kernel_times(lambda: silero.vad_lstm_head(*args)),
                   cuda_ms(lambda: silero.vad_lstm_head_plain(*args), 20), f"[{m}, 512]",
                   4 * m * (512 + 128 + 256 + 6), f32_ops=m * 128 * 114,
                   library_ms=library_ms)
    print(f"[2] vad_lstm_head: library torch._VF.lstm_cell (its two GEMMs included, no "
          f"head, EMA or calibration) {library_ms:.4f} ms on the card ({res.card})", flush=True)

    for m in (n, n - 1, 1):
        args = _rows(features, m)
        err = _tuple_err(dfn3.dfn_features(*args), dfn3.dfn_features_plain(*args))
        # bytes: the spectrum and both norms read, features and norms written;
        # per bin the power (3), per band a log10 (~20), per low bin a sqrt
        # and an rsqrt (~10) and the EMAs
        res.report("dfn_features", err, 1e-3, kernel_times(lambda: dfn3.dfn_features(*args)),
                   cuda_ms(lambda: dfn3.dfn_features_plain(*args), 20),
                   f"[{m}, 481, 2] -> [{m}, 32] + [{m}, 2, 96]",
                   4 * m * (962 + 32 + 96 + 32 + 192 + 32 + 96),
                   f32_ops=m * (3 * 481 + 32 * 26 + 96 * 16))

    for beta in (0.0, 0.02):
        args = (*synth[:5], torch.tensor(beta, device=DEVICE))
        err = _tuple_err([dfn3.dfn_spec_synth(*args)], [dfn3.dfn_spec_synth_plain(*args)])
        # bytes: the target spectrum, gains, taps and history read, the
        # spectrum written; per bin ~8 operations, 40 more on a low bin
        # (the five complex taps), the post filter's sin per band
        res.report("dfn_spec_synth", err, 1e-4,
                   kernel_times(lambda: dfn3.dfn_spec_synth(*args)),
                   cuda_ms(lambda: dfn3.dfn_spec_synth_plain(*args), 20),
                   f"[{n}, 481, 2], post filter beta {beta:g}",
                   4 * n * (962 + 32 + 960 + 960 + 962),
                   f32_ops=n * (8 * 481 + 40 * 96 + 30 * 32))


def timed_calls():
    """``(label, call, reps, blocks)`` for every kernel configuration phase
    [2] times, on phase [2]'s inputs: ``call`` runs the wrapper on ``blocks``
    blocks; a time is :func:`kernel_times` of ``call`` over ``reps``
    calls, over ``blocks``. compare_kernels.py times these per checkout."""
    from audioforge_tpu_torch.ops import (biquad, compressor, deesser, envelope, gate,
                                          routing, scan)

    xs, env0 = env_inputs()
    yield "env_scan", lambda: env_chain(envelope.env_scan, xs, env0), 3, ENV_BLOCKS
    long_blocks = xs.reshape(ENV_BLOCKS // 2, 2 * BLOCK, -1)
    yield ("env_scan [960, 2048]", lambda: env_chain(envelope.env_scan, long_blocks, env0), 3,
           ENV_BLOCKS // 2)
    args = max_affine_inputs()
    yield "max_affine_scan", lambda: scan.max_affine_scan(*args), 20, 1
    for kind in ("limiter", "true-peak"):
        # the whole stage, which every checkout has; the kernel's limiter
        # form where the checkout has it
        process, args = limiter_stage_inputs(kind)
        yield (f"{process.__name__} (stage)",
               lambda process=process, args=args: process(*args), 20, 1)
        if hasattr(scan, "limiter_gain_scan"):
            args = limiter_gain_inputs(kind)
            yield (f"limiter_gain_scan {kind}",
                   lambda args=args: scan.limiter_gain_scan(*args), 20, 1)
    xb, shapes = biquad_inputs()
    for name, sections, st in shapes:
        bq = _cascade_args(xb, st)
        yield (f"biquad_cascade {name} ({sections} sections)",
               lambda bq=bq: biquad.biquad_cascade(*bq), 20, 1)
    for label, args in compressor_inputs():
        yield (f"compressor_scan {label}",
               lambda args=args: compressor.compressor_scan(*args), 20, 1)
    for name, cfg, p, st, blocks in gate_inputs():
        for xg, vad in blocks[:-1]:  # the kernel's state before the last block
            st, _, _ = gate.gate_process(cfg, st, xg, *vad, p)
        args = (cfg, st, blocks[-1][0], *blocks[-1][1], p)
        yield f"gate_scan {name}", lambda args=args: gate.gate_process(*args), 20, 1
    for auto in (True, False):
        args = deesser_inputs(auto)
        yield (f"deesser_scan {'auto' if auto else 'manual'}",
               lambda args=args: deesser.deesser_scan(*args), 20, 1)
    for name, mode, fade in cleanup_configs():
        args = cleanup_inputs(mode, fade)
        yield f"cleanup_scan {name}", lambda args=args: routing.cleanup_scan(*args), 20, 1
    try:
        from audioforge_tpu_torch.models import dfn3, silero
    except ImportError:  # a checkout from before the model stages
        return
    front, head, features, synth = model_kernel_inputs()
    yield "vad_front", lambda: silero.vad_front(*front), 20, 1
    yield "vad_lstm_head", lambda: silero.vad_lstm_head(*head), 20, 1
    one = head_rows(head, 1)  # the live engine's VAD window
    yield "vad_lstm_head one stream", lambda: silero.vad_lstm_head(*one), 20, 1
    yield "dfn_features", lambda: dfn3.dfn_features(*features), 20, 1
    one = _rows(features, 1)  # the live engine's DeepFilterNet3 frame
    yield "dfn_features one stream", lambda: dfn3.dfn_features(*one), 20, 1
    yield "dfn_spec_synth", lambda: dfn3.dfn_spec_synth(*synth), 20, 1


def _engine(capacity: int, device: str, audio: np.ndarray, chain=None, **config):
    """An engine of ``capacity`` streams (``config``: ServingConfig's other
    fields) with ``audio [capacity, samples]`` queued, one sink list each."""
    from audioforge_tpu_torch.runtime import live_chain as lc
    from audioforge_tpu_torch.runtime.serving import ServingConfig, ServingEngine

    cfg = ServingConfig(capacity=capacity, chain=chain or lc.LiveChainConfig(), **config)
    eng = ServingEngine(cfg, device=device)
    outs = [[] for _ in range(capacity)]
    for i in range(capacity):
        slot = eng.attach(sink=lambda blk, i=i: outs[i].append(blk))
        eng.push(slot, audio[i])
    return eng, outs


def full_chain():
    from audioforge_tpu_torch.runtime import live_chain as lc

    return lc.LiveChainConfig(cleanup_mode="strong", deesser_enabled=True)


def _check_output(outs, n_blocks: int, capacity: int) -> float:
    from audioforge_tpu_torch.runtime import live_chain as lc

    y = np.stack([np.concatenate(o) for o in outs])
    check(y.shape == (capacity, n_blocks * BLOCK), f"output shape {y.shape}")
    check(bool(np.isfinite(y).all()), "non-finite output")
    ceiling = 10.0 ** (lc.effective_limiter_ceiling_db(-1.0, True) / 20.0)
    peak = float(np.abs(y).max())
    check(peak <= ceiling + 1e-6, f"output peak {peak} above the ceiling {ceiling}")
    return peak


def _check_per_block(counts: dict, per_block: dict, n_blocks: int, path: str) -> None:
    for name, k in per_block.items():
        check(counts[name] == k * n_blocks,
              f"{path}: {name} {counts[name]} launches, expected {k} per block")


def graph_nodes(graph) -> dict:
    """Node counts by type of a captured CUDA graph (the engine keeps its
    graph), read through libcuda (`cuGraphGetNodes`)."""
    lib = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(lib.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    kinds, kind = collections.Counter(), ctypes.c_int()
    names = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType
    for node in nodes:
        check(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kinds[names.get(kind.value, "other")] += 1
    return {"nodes": count.value, **kinds}


def print_capture(eng, card: str, tag: str) -> None:
    print(f"{tag} step graph (info, {card}): captured in {eng.capture_seconds:.3f} s at the "
          f"first step, {graph_nodes(eng._shards[0]._graph)}; kernel launches per replay "
          f"{eng._shards[0]._graph_launches}", flush=True)


def feed(eng, audio: np.ndarray) -> None:
    """Queue ``audio [N, samples]`` on every slot."""
    for i in range(eng.capacity):
        eng.push(i, audio[i])


# the children of engine.step whose self time time_paths prints
ENGINE_SPANS = ("engine.gather", "engine.reset", "engine.stage_vad", "engine.capture",
                "engine.launch", "engine.wait", "engine.unpack", "engine.deliver")


def time_paths(eng, outs, audio: np.ndarray, card: str, tag: str,
               n_timed: int = TIMED_CALLS) -> None:
    """Information, on the engine's graph replays: ``n_timed`` step() calls
    (p50, p99 and max from ``latency_histogram``), step_many spans of
    TIMED_SPAN blocks, ``n_timed`` step_pipelined() calls, the replay alone
    on the card (CUDA events around back-to-back replays), the state
    copy-back's share of it and the peak device memory since the engine was
    built; then step()'s host time by the engine's spans. ``audio``
    (TIMED_SPAN blocks) is queued again every TIMED_SPAN blocks, outside the
    timed calls."""
    from audioforge_tpu_torch.runtime import serving as sv
    from audioforge_tpu_torch.runtime import tracing

    def run(call, n_calls: int, blocks: int) -> dict:
        eng._step_times.clear()
        for i in range(n_calls):
            if i * blocks % TIMED_SPAN == 0:
                for o in outs:
                    o.clear()
                feed(eng, audio)
            call()
        eng.flush_pipeline()
        torch.cuda.synchronize()
        return eng.latency_histogram()

    rate = lambda ms: FLEET * BLOCK / FS / (ms / 1e3)
    for name, call, n_calls, blocks in (
            ("step()", eng.step, n_timed, 1),
            (f"step_many({TIMED_SPAN}) per block", lambda: eng.step_many(TIMED_SPAN),
             4, TIMED_SPAN),
            ("step_pipelined()", eng.step_pipelined, n_timed, 1)):
        chunks0 = _chunk_tally()
        h = run(call, n_calls, blocks)
        chunks, hidden = np.subtract(_chunk_tally(), chunks0)
        overlap = f"; chunks hidden {hidden} of {chunks}" if chunks else ""
        print(f"{tag} {name} x {h['samples']} blocks (info, {card}): p50 {h['p50_ms']:.3f} ms, "
              f"p99 {h['p99_ms']:.3f} ms, max {h['max_ms']:.3f} ms; audio-sec/sec at fleet "
              f"{FLEET} (p50) {rate(h['p50_ms']):.1f}{overlap}", flush=True)
    # where step()'s host time goes: the self time of each of the engine's own
    # spans over TIMED_CALLS / 5 more calls ("wait" is the wait for the card's
    # copy of the block; "launch" holds the copies' launches and the
    # metrics' copies; "the rest" is engine.step's own)
    calls = max(1, n_timed // 5)
    tracing.reset()
    tracing.enable()
    try:
        run(eng.step, calls, 1)
    finally:
        tracing.disable()
    split = tracing.self_ns(tracing.snapshot()["spans"])
    tracing.reset()
    total_ms = float(np.mean(eng._step_times)) * 1e3
    parts = ", ".join(f"{name[7:]} {split.get(name, 0) / calls / 1e6:.3f}"
                      for name in ENGINE_SPANS)
    print(f"{tag} step() host split, mean ms of {calls} calls by engine span (info, {card}): "
          f"total {total_ms:.3f}: {parts}, the rest "
          f"{split.get('engine.step', 0) / calls / 1e6:.3f}", flush=True)
    replay_ms = cuda_ms(eng._shards[0]._graph.replay, 50)
    REPLAY_MS[tag] = replay_ms
    # the copy-back alone: a graph of _copy_into on the pairs one eager step
    # gives, on copies of the state
    state = sv._clone_tree(eng._shards[0]._state)
    new_state, _, _ = eager_step(eng, state)
    pairs = len(sv._leaf_pairs(state, new_state, []))
    copy_ms, _ = kernel_times(lambda: sv._copy_into(state, new_state))
    # the same step eagerly, back to back on a copy of the state (the
    # per-block work of the step before it was captured, without staging
    # and sinks)
    eager_ms = cuda_ms(lambda: eager_step(eng, state), 10)
    print(f"{tag} replay alone on the card (info, {card}): {replay_ms:.3f} ms per block, "
          f"{rate(replay_ms):.1f} audio-sec/sec; the state copy-back ({pairs} leaves) "
          f"{copy_ms:.4f} ms of it; the eager step {eager_ms:.3f} ms per block; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB", flush=True)


def phase3_default(card: str) -> dict:
    from audioforge_tpu_torch import kernels

    n_blocks = 15
    audio = speech_like(FLEET, TIMED_SPAN, 11)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, outs = _engine(FLEET, DEVICE, audio)
    eng.step()  # captures the step's graph
    torch.cuda.synchronize()
    print(f"[3] engine at fleet {FLEET} built and its first step run in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print_capture(eng, card, "[3]")
    kernels.reset_launch_counts()
    for _ in range(5):
        eng.step()
    eng.step_many(10)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    print(f"[3] default path, launches over {n_blocks} blocks: {counts}", flush=True)
    peak = _check_output(outs, n_blocks + 1, FLEET)
    _check_per_block(counts, {"biquad_cascade": 5, "limiter_gain_scan": 2,
                              "compressor_scan": 1, "gate_scan": 1}, n_blocks,
                     "default path")
    print(f"[3] output finite, peak {peak:.4f} within the ceiling", flush=True)
    layer_split(eng, card, "[3]")
    time_paths(eng, outs, audio, card, "[3]")
    return counts


def phase4_full_chain(card: str) -> dict:
    from audioforge_tpu_torch import kernels

    audio = mic_capture(FLEET, FULL_BLOCKS, 16)
    torch.cuda.reset_peak_memory_stats()
    eng, outs = _engine(FLEET, DEVICE, audio, full_chain())
    kernels.reset_launch_counts()
    for _ in range(FULL_BLOCKS // 2 - 5):
        eng.step_many(2)  # the first call captures the step's graph
    for _ in range(10):
        m = eng.step()
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    print(f"[4] full chain (strong cleanup + de-esser), launches over {FULL_BLOCKS} "
          f"blocks: {counts}", flush=True)
    print_capture(eng, card, "[4]")
    _check_per_block(counts, {"biquad_cascade": 5, "limiter_gain_scan": 2,
                              "compressor_scan": 1, "gate_scan": 1,
                              "deesser_scan": 1, "cleanup_scan": 1}, FULL_BLOCKS,
                     "full chain")
    peak = _check_output(outs, FULL_BLOCKS, FLEET)
    cls = np.arange(FLEET) % 4
    hum = m["routing_hum_detected"].cpu().numpy()
    red = m["deesser_gain_reduction_db"].cpu().numpy()
    windows = eng._shards[0]._state["chain"]["routing"]["windows_observed"].cpu().numpy()
    print(f"[4] hum detected on {hum[cls == 0].mean():.3f} of the 50.4 Hz streams, "
          f"{hum[cls == 1].mean():.3f} of the 59.7 Hz streams, {hum[cls >= 2].mean():.3f} "
          f"of the others; de-esser reduction > 0 on {(red[cls == 2] > 0).mean():.3f} of "
          f"the sibilant streams (mean {red[cls == 2].mean():.2f} dB); windows "
          f"observed {int(windows.min())}", flush=True)
    check(bool(hum[cls == 0].all() and hum[cls == 1].all()),
          "hum not detected on every hum stream")
    check(bool((red[cls == 2] > 0).all()), "no de-esser reduction on a sibilant stream")
    print(f"[4] output finite, peak {peak:.4f} within the ceiling", flush=True)
    layer_split(eng, card, "[4]")
    time_paths(eng, outs, audio[:, :TIMED_SPAN * BLOCK], card, "[4]")
    return counts


def vad_chain():
    """bench.py's VAD cell's chain as the reference really runs it (strong
    cleanup, ROADMAP F1; the de-esser on, F3) with the VAD-assisted gate."""
    from audioforge_tpu_torch.ops import gate
    from audioforge_tpu_torch.runtime import live_chain as lc

    return lc.LiveChainConfig(cleanup_mode="strong", deesser_enabled=True,
                              gate_mode=gate.VAD_ASSISTED)


# per path: (ServingConfig fields, the chain, kernel launches per block)
_CHAIN_LAUNCHES = {"biquad_cascade": 5, "limiter_gain_scan": 2, "compressor_scan": 1,
                   "gate_scan": 1}
MODEL_PATHS = {
    "VAD-on": (dict(vad_enabled=True), vad_chain,
               {**_CHAIN_LAUNCHES, "deesser_scan": 1, "cleanup_scan": 1, "vad_front": 1,
                "vad_lstm_head": 1}),
    # without RNNoise, its input high-pass is not launched
    "DFN3-LL": (dict(suppressor_model="deepfilter-ll"), None,
                {**_CHAIN_LAUNCHES, "biquad_cascade": 4, "dfn_features": 1,
                 "dfn_spec_synth": 1}),
    "DFN3 standard": (dict(suppressor_model="deepfilter"), None,
                      {**_CHAIN_LAUNCHES, "biquad_cascade": 4, "dfn_features": 1,
                       "dfn_spec_synth": 1}),
}


def phase_model_path(card: str, name: str, tag: str) -> dict:
    """One model path at fleet 1024 (:data:`MODEL_PATHS`): the first step
    captures the graph, then MODEL_BLOCKS - 1 step() calls with the launch
    counts read over them: every kernel of the path launched its count per
    block, output finite within the ceiling; the VAD path: the probability
    in [0, 1], available from the 4th block on and never before, and the
    VAD-assisted gate's fused score at 1 on the voiced streams whose
    posterior is above 0.5 (the VAD branch open) and below it on the quiet
    class; a DeepFilterNet3 path: the noise-only class at suppressor
    strength 1 at least 10 dB below the same class at strength 0. Then
    MODEL_TIMED_CALLS timed calls as in [3]."""
    from audioforge_tpu_torch import kernels

    config, chain, per_block = MODEL_PATHS[name]
    t0 = time.perf_counter()
    vad = config.get("vad_enabled", False)
    audio = (vad_path_audio if vad else voice_and_noise)(FLEET, TIMED_SPAN, 50 + len(name))
    torch.cuda.reset_peak_memory_stats()
    eng, outs = _engine(FLEET, DEVICE, audio, chain() if chain else None, **config)
    cls = np.arange(FLEET) % 4
    if not vad:
        for slot in np.flatnonzero(cls == 3):
            eng.set_stream_suppressor(int(slot), strength=0.0)
    metrics = [eng.step()]  # captures the step's graph
    print_capture(eng, card, tag)
    kernels.reset_launch_counts()
    for _ in range(MODEL_BLOCKS - 1):
        metrics.append(eng.step())
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    print(f"{tag} {name} path at fleet {FLEET}, launches over {MODEL_BLOCKS - 1} blocks after "
          f"the capture: {counts}", flush=True)
    _check_per_block(counts, per_block, MODEL_BLOCKS - 1, f"{name} path")
    peak = _check_output(outs, MODEL_BLOCKS, FLEET)
    if vad:
        for b, m in enumerate(metrics):
            prob, avail = m["vad_probability"].cpu().numpy(), m["vad_available"].cpu().numpy()
            check(bool(np.isfinite(prob).all() and prob.min() >= 0.0 and prob.max() <= 1.0),
                  f"VAD probability outside [0, 1] at block {b}")
            check(bool(avail.all()) if b >= 3 else not avail.any(),
                  f"VAD available {int(avail.sum())} of {FLEET} at block {b}")
        m = metrics[-1]
        prob, fused = m["vad_probability"].cpu().numpy(), m["gate_fused_score"].cpu().numpy()
        voiced = (cls <= 1) & (prob > 0.5)
        print(f"{tag} VAD probability on the last block: mean {prob[cls == 0].mean():.3f} / "
              f"{prob[cls == 1].mean():.3f} / {prob[cls == 2].mean():.3f} / "
              f"{prob[cls == 3].mean():.3f} by class; the gate's fused score on the "
              f"{int(voiced.sum())} voiced streams above 0.5 min {fused[voiced].min():.3f}, "
              f"on the quiet class max {fused[cls == 3].max():.3f}", flush=True)
        check(voiced.sum() >= FLEET // 8 and fused[voiced].min() >= 0.99,
              "the VAD-assisted gate did not open on the voiced streams")
        check(prob[cls == 3].max() < 0.5 and fused[cls == 3].max() < 0.99,
              "the VAD opened the gate on the quiet class")
    else:
        y = np.stack([np.concatenate(o) for o in outs])[:, -8 * BLOCK:]
        rms = np.sqrt(np.mean(y.astype(np.float64) ** 2, axis=1))
        atten = 20.0 * np.log10(rms[cls == 3].mean() / rms[cls == 2].mean())
        print(f"{tag} the noise-only class at strength 1 is {atten:.2f} dB below the same "
              f"class at strength 0 over the last 8 blocks (output RMS "
              f"{rms[cls == 2].mean():.5f} against {rms[cls == 3].mean():.5f})", flush=True)
        check(atten >= 10.0, f"{name}: the suppressor does not attenuate noise")
    print(f"{tag} output finite, peak {peak:.4f} within the ceiling; {MODEL_BLOCKS} blocks in "
          f"{time.perf_counter() - t0:.1f} s with the engine's set-up", flush=True)
    time_paths(eng, outs, audio, card, tag, MODEL_TIMED_CALLS)
    if name == "DFN3-LL":
        for n in (FLEET, 1):
            dfn_frame_rows(card, tag, n)
    return counts


# kernel names of cuDNN's engines: its own namespace, its implicit-GEMM
# convolutions and its generic convolution kernels
CUDNN_MARKS = ("cudnn", "fprop", "convolve")
DFN_FRAME_REPLAYS = 50   # replays timed (CUDA events) and profiled (kernel census)
DFN_OP_ROWS = 25         # rows of the per-op table


def dfn_frame_rows(card: str, tag: str, n: int) -> None:
    """Information: one DFN3-LL frame (``dfn3.dfn_frame`` with the trained
    archive) of ``n`` streams after three frames of :func:`voice_and_noise`,
    captured as a graph: its replay on the card (CUDA events), its output's
    and gains' error against the same frame on the CPU, the kernels of one
    replay with those of cuDNN (:data:`CUDNN_MARKS`) counted apart, and the
    per-op table of the same frame run eagerly (``torch.profiler`` with
    ``record_shapes``: each aten op that launched kernels, its input shapes,
    its kernels' ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audioforge_tpu_torch import kernels
    from audioforge_tpu_torch.models import dfn3
    from audioforge_tpu_torch.runtime import replay

    cpu = dfn3.default_params(True)
    params = {k: v.to(DEVICE) for k, v in cpu.items()}
    x = torch.from_numpy(voice_and_noise(n, 4, 61 + n).reshape(n, 4, BLOCK))
    st = dfn3.dfn_state_init(n=n, device="cpu")
    for f in range(3):
        st, _, _ = dfn3.dfn_frame(cpu, st, x[:, f])
    _, y_cpu, aux_cpu = dfn3.dfn_frame(cpu, st, x[:, 3])
    x_dev = x[:, 3].to(DEVICE)
    controls = [kernels.scalar(v, DEVICE) for v in (dfn3.DEFAULT_ATTEN_LIM_DB,
                                                    dfn3.DEFAULT_POST_FILTER_BETA)]

    def frame(state):
        _, y, aux = dfn3.dfn_frame(params, state, x_dev, *controls)
        return y, aux["erb_gains"]

    state = {k: v.to(DEVICE) for k, v in st.items()}
    graph, (y, gains), launches, _ = replay.capture_graph(DEVICE, frame, state)
    graph.replay()
    torch.cuda.synchronize()
    y_err = (y.cpu().double() - y_cpu.double()).abs().max().item()
    g_err = (gains.cpu().double() - aux_cpu["erb_gains"].double()).abs().max().item()
    ms = cuda_ms(graph.replay, DFN_FRAME_REPLAYS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(DFN_FRAME_REPLAYS):
            graph.replay()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per_replay = sum(e.count for e in rows) / DFN_FRAME_REPLAYS
    cudnn = [e for e in rows if any(m in e.key.lower() for m in CUDNN_MARKS)]
    cudnn_n = sum(e.count for e in cudnn) / DFN_FRAME_REPLAYS
    cudnn_ms = sum(e.self_device_time_total for e in cudnn) / DFN_FRAME_REPLAYS / 1e3
    print(f"{tag} one DFN3-LL frame at {n} stream(s) as a graph (info, {card}): "
          f"{ms:.4f} ms a replay (CUDA events); error against the CPU frame: output max "
          f"{y_err:.3e}, ERB gains max {g_err:.3e}; {per_replay:.0f} kernels a replay, "
          f"{cudnn_n:.0f} of them cuDNN's ({cudnn_ms:.4f} ms); hand kernels {launches}",
          flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / DFN_FRAME_REPLAYS / 1e3:8.4f} ms "
              f"{e.count / DFN_FRAME_REPLAYS:4.0f}x  {e.key[:90]}")
    frame(state)  # warm for the eager profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        frame(state)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in ops) / 1e3
    print(f"{tag} the same frame run eagerly, by aten op and input shapes (info, {card}): "
          f"{total:.4f} ms of kernels over {len(ops)} rows; the {DFN_OP_ROWS} longest:",
          flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:DFN_OP_ROWS]:
        shapes = ", ".join(str(list(s)) for s in e.input_shapes if s)
        print(f"    {e.self_device_time_total / 1e3:8.4f} ms {e.count:3d}x  {e.key[:32]:32s} "
              f"{shapes[:110]}")


def layer_split(eng, card: str, tag: str) -> None:
    """Seconds of one step by layer, with a device synchronise around each
    timed stage (information only). A graph replay does not see Python
    wrappers, so this runs ``_serving_step`` eagerly on copies of the
    engine's buffers."""
    from audioforge_tpu_torch.ops import deesser, gate, routing
    from audioforge_tpu_torch.runtime import live_chain as lc
    from audioforge_tpu_torch.runtime import serving as sv

    stages = [(lc, "front_block"), (routing, "routing_process"),
              (gate, "gate_process"), (sv, "_supp_step"), (lc, "back_block"),
              (deesser, "deesser_process")]
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

    state = sv._clone_tree(eng._shards[0]._state)
    for (mod, name), fn in originals.items():
        setattr(mod, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_step(eng, state)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    g = lambda k: seconds.get(k, 0.0)
    print(f"{tag} one eager _serving_step by layer, on copies of the engine's buffers "
          f"(info, {card}): total {total:.4f} s; front "
          f"{g('front_block'):.4f} (routing {g('routing_process'):.4f}, gate "
          f"{g('gate_process'):.4f}), rnnoise {g('_supp_step'):.4f}, back "
          f"{g('back_block'):.4f} (de-esser {g('deesser_process'):.4f})", flush=True)
    card_split(eng, card, tag)


def card_split(eng, card: str, tag: str) -> None:
    """The card's time per block of the stages ROADMAP queue 2 items 2-5
    would put into kernels, from a ``torch.profiler`` reading of one eager
    ``_serving_step`` on copies of the engine's buffers with each stage under
    a ``record_function`` range (the device time of the kernels launched in
    it; information only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from audioforge_tpu_torch.models import rnnoise, vad_gate
    from audioforge_tpu_torch.ops import compressor, limiter, loudness, routing, true_peak
    from audioforge_tpu_torch.runtime import serving as sv

    stages = [(rnnoise, "rnnoise_frame", "K9 RNNoise frame"),
              (true_peak, "_interp_peaks", "K6/K7 true-peak FIR"),
              (limiter, "sliding_window_max", "K6/K7 limiter window max"),
              (routing, "_hum_analysis", "K13b hum analysis"),
              (routing, "meter_block_stats", "K12 block meters"),
              (loudness, "meter_process", "K12 K-weighted loudness"),
              (vad_gate, "vad_gate_process", "K12 VAD auto-gate"),
              (compressor, "finalize_block", "K12 compressor finalize"),
              (routing, "sanitize_and_clamp_input", "K12 sanitize and clamp"),
              (routing, "sanitize_and_clamp_output", "K12 sanitize and clamp")]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in stages]

    def ranged(label, fn):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    state = sv._clone_tree(eng._shards[0]._state)
    for (mod, name, label), (_, _, fn) in zip(stages, originals):
        setattr(mod, name, ranged(label, fn))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eager_step(eng, state)
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    # a range's device time is its kernels' (the GPU-side span of the same
    # name, which covers the idle time between them, is left out); a range
    # nested in another counts in both
    events, labels = prof.events(), {label for _, _, label in stages}
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    by_label = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in labels:
            by_label[e.name] += e.device_time_total / 1e3
    parts = ", ".join(f"{k} {v:.3f}" for k, v in by_label.most_common())
    print(f"{tag} card time of one eager step by stage, ms of kernels (info, {card}): "
          f"all kernels {total:.3f}; {parts}", flush=True)


def phase5_card_vs_cpu() -> None:
    """The same 4-stream engines on the card and on the CPU: output RMS
    difference 1e-3; RNNoise's pitch periods, the hum line and the rumble
    flags equal; on the VAD path the last block's probability within 1e-3 and
    ``available`` equal; on the DeepFilterNet3 paths the ERB norms within
    1e-3."""
    from audioforge_tpu_torch.runtime import live_chain as lc

    n = 4
    for name, chain, n_blocks, audio, config in (
            ("default path", None, 10, speech_like(n, 10, 12), {}),
            ("adaptive release", lc.LiveChainConfig(adaptive_release=True), 10,
             speech_like(n, 10, 13), {}),
            ("full chain", full_chain(), 27, mic_capture(n, 27, 17), {}),
            ("VAD-on", vad_chain(), 10, vad_path_audio(n, 10, 18),
             MODEL_PATHS["VAD-on"][0]),
            ("DFN3-LL", None, 10, voice_and_noise(n, 10, 19), MODEL_PATHS["DFN3-LL"][0]),
            ("DFN3 standard", None, 10, voice_and_noise(n, 10, 20),
             MODEL_PATHS["DFN3 standard"][0])):
        ys, periods, hum, vad, norms = {}, {}, {}, {}, {}
        t0 = time.perf_counter()
        for device in (DEVICE, "cpu"):
            eng, outs = _engine(n, device, audio, chain, **config)
            m = eng.step_many(n_blocks)
            vad[device] = (m["vad_probability"].cpu().numpy(),
                           m["vad_available"].cpu().numpy())
            ys[device] = np.stack([np.concatenate(o) for o in outs])
            model = eng._shards[0]._state["supp"]["model"]
            periods[device] = (model["last_period"].cpu().numpy() if "last_period" in model
                               else np.zeros(0))
            norms[device] = (model["erb_norm"].cpu().numpy() if "erb_norm" in model
                             else np.zeros(0))
            hum[device] = (m["routing_hum_line_hz"].cpu().numpy(),
                           m["routing_rumble_detected"].cpu().numpy())
        diff = ys[DEVICE].astype(np.float64) - ys["cpu"]
        rms = float(np.sqrt(np.mean(diff ** 2)))
        vad_err = float(np.abs(vad[DEVICE][0] - vad["cpu"][0]).max())
        vad_same = bool((vad[DEVICE][1] == vad["cpu"][1]).all())
        norm_err = float(np.abs(norms[DEVICE] - norms["cpu"]).max(initial=0.0))
        print(f"[5] card vs CPU, {name}, {n_blocks} blocks x {n} streams: RMS diff "
              f"{rms:.3e} (tol 1e-3), max {np.abs(diff).max():.3e}; last_period card "
              f"{periods[DEVICE].tolist()} cpu {periods['cpu'].tolist()}; hum line card "
              f"{hum[DEVICE][0].tolist()} cpu {hum['cpu'][0].tolist()}; VAD probability "
              f"max diff {vad_err:.3e} (tol 1e-3), available equal {vad_same}; ERB norm "
              f"max diff {norm_err:.3e} (tol 1e-3); {time.perf_counter() - t0:.1f} s",
              flush=True)
        check(rms <= 1e-3, f"card and CPU outputs differ ({name})")
        check(bool((periods[DEVICE] == periods["cpu"]).all()), "pitch periods differ")
        check(bool(np.allclose(hum[DEVICE][0], hum["cpu"][0], atol=1e-3)
                   and (hum[DEVICE][1] == hum["cpu"][1]).all()),
              f"hum line or rumble flags differ ({name})")
        check(vad_err <= 1e-3 and vad_same, f"VAD outputs differ ({name})")
        check(norm_err <= 1e-3, f"DeepFilterNet3 norms differ ({name})")


SOURCES = {
    "env_scan": ("audioforge_tpu_torch/csrc/env_scan.cu",
                 "tools/evaluate_scan_kernel_strategy.py:72"),
    "max_affine_scan": ("audioforge_tpu_torch/csrc/max_affine_scan.cu",
                        "audioforge_tpu/ops/scan.py:305"),
    "limiter_gain_scan": ("audioforge_tpu_torch/csrc/max_affine_scan.cu",
                          "audioforge_tpu/ops/limiter.py:131"),
    "biquad_cascade": ("audioforge_tpu_torch/csrc/biquad_cascade.cu",
                       "audioforge_tpu/ops/biquad.py:346"),
    "compressor_scan": ("audioforge_tpu_torch/csrc/compressor_scan.cu",
                        "audioforge_tpu/ops/compressor.py:277"),
    "gate_scan": ("audioforge_tpu_torch/csrc/gate_scan.cu",
                  "audioforge_tpu/ops/gate.py:233"),
    "deesser_scan": ("audioforge_tpu_torch/csrc/deesser_scan.cu",
                     "audioforge_tpu/ops/deesser.py:199"),
    "cleanup_scan": ("audioforge_tpu_torch/csrc/cleanup_scan.cu",
                     "audioforge_tpu/ops/routing.py:476"),
    "vad_front": ("audioforge_tpu_torch/csrc/vad_front.cu",
                  "audioforge_tpu/ops/resample.py:315"),
    "vad_lstm_head": ("audioforge_tpu_torch/csrc/silero_lstm.cu",
                      "audioforge_tpu/models/silero.py:265"),
    "dfn_features": ("audioforge_tpu_torch/csrc/dfn_features.cu",
                     "audioforge_tpu/models/dfn3.py:621"),
    "dfn_spec_synth": ("audioforge_tpu_torch/csrc/dfn_synth.cu",
                       "audioforge_tpu/models/dfn3.py:770"),
}

def phase6_profile(card: str) -> None:
    """CUDA kernels per ``step()`` (one graph replay each) and the card's busy
    share over 3 steps at fleet 1024, default path, full chain and the three
    model paths, from a ``torch.profiler`` trace (device rows only); beside
    it the replay alone on the card from CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    models = [(name, chain() if chain else None, config,
               (vad_path_audio if config.get("vad_enabled") else voice_and_noise)(
                   FLEET, 6, 23 + i))
              for i, (name, (config, chain, _)) in enumerate(MODEL_PATHS.items())]
    for name, chain, config, audio in (
            ("default path", None, {}, speech_like(FLEET, 6, 21)),
            ("full chain", full_chain(), {}, mic_capture(FLEET, 6, 22)), *models):
        eng, _ = _engine(FLEET, DEVICE, audio, chain, **config)
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        launches = sum(e.count for e in rows) / 3
        busy_s = sum(e.self_device_time_total for e in rows) / 1e6
        print(f"[6] {name} ({card}): {launches:.0f} CUDA kernels per step() (graph "
              f"replay); kernel time {busy_s / 3 * 1e3:.2f} ms of {wall / 3 * 1e3:.2f} ms "
              f"per profiled step, busy share {busy_s / wall:.3f}; the replay alone "
              f"{cuda_ms(eng._shards[0]._graph.replay, 20):.3f} ms on the card (CUDA events)",
              flush=True)
        for e in rows[:12]:
            print(f"    {e.self_device_time_total / 3e3:8.3f} ms/step {e.count // 3:6d}x  "
                  f"{e.key[:90]}")
        own = [e for e in rows if any(f"{name}_kernel" in e.key for name in SOURCES)]
        print(f"[6] {name}: the hand-written kernels alone (without their wrappers' tensor "
              f"ops), {sum(e.self_device_time_total for e in own) / 3e3:.3f} ms per step:")
        for e in own:
            print(f"    {e.self_device_time_total / 3e3:8.4f} ms/step {e.count // 3:6d}x  "
                  f"{e.key[:60]}")


def eager_step(eng, state, mask=None):
    """An unsharded engine's step run eagerly on ``state``, with its one
    shard's static inputs: ``(state, y, metrics)``."""
    from audioforge_tpu_torch.runtime import serving as sv
    sh = eng._shards[0]
    return sv._serving_step(eng.config, sh._params_dev, state, sh._fresh, sh._x, sh._active,
                            mask, sh._vad_prob, sh._vad_avail)


def _chunk_tally() -> tuple:
    """The tracer's counts of step_many's chunks so far, and of those still
    running on the card when the host came to wait for them."""
    from audioforge_tpu_torch.runtime import tracing

    c = tracing.snapshot()["counters"]
    return c.get("engine.span_chunks", 0), c.get("engine.span_chunks_hidden", 0)


def _tree_diff(a: dict, b: dict, path: str = "") -> list:
    """Paths of the leaves of two trees of one layout that are not equal."""
    out = []
    for k, v in a.items():
        if isinstance(v, dict):
            out += _tree_diff(v, b[k], f"{path}.{k}")
        elif not torch.equal(v, b[k]):
            out.append(f"{path}.{k}")
    return out


def phase7_graph_vs_eager(card: str) -> None:
    """The full chain at fleet 1024 over FULL_BLOCKS blocks, with events
    before blocks 10-40: eight streams attach, a stream is detached and
    attached again (a slot reset), a control write, two suppressor writes, an
    EQ program staged on a running stream and one on a stream reset in the
    same step (it lands a step later). Engine A steps with step(); beside it
    ``_serving_step`` runs eagerly on the card on A's static inputs, the
    reset passed as its mask and the staged EQ rows written into its state:
    every block's output and the final state must be ``torch.equal``.
    Engine B runs the same schedule through step_pipelined() and
    flush_pipeline(): the same blocks, one call later, and the same final
    state, but for the block in flight when a stream detaches (block 19 of
    slot 5, block 39 of slot 13), which reaches neither that stream nor the
    one attached in its slot. Engine C runs it through step_many over the
    spans between the events: every stream's blocks and the final state
    equal step()'s, each call's blocks views of one ``[span, N, BLOCK]``
    array, one ``engine.span_chunks`` a chunk. Engine D runs, without the
    events, step_pipelined, step, step_many(9), step_pipelined and
    flush_pipeline, so that step() and step_many take host buffers while
    the first pipelined block is in flight: every stream's 12 blocks, in
    the order the engine took them, equal step()'s."""
    from audioforge_tpu_torch.ops import eq
    from audioforge_tpu_torch.runtime import serving as sv

    late = 8
    audio = mic_capture(FLEET, FULL_BLOCKS, 31)
    boost = [eq.EqBandConfig(b.filter_type, b.frequency_hz, 6.0 if i == 6 else 0.0, 1.0)
             for i, b in enumerate(eq.default_bands())]

    def build():
        eng = sv.ServingEngine(sv.ServingConfig(capacity=FLEET, chain=full_chain()),
                               device=DEVICE)
        outs = [[] for _ in range(FLEET)]
        for i in range(FLEET - late):
            attach(eng, outs, 0)
        return eng, outs

    def attach(eng, outs, b):
        """Attach the first free slot with its audio from block ``b``."""
        slot = next(i for i, s in enumerate(eng._slots) if not s.active)
        check(eng.attach(sink=outs[slot].append) == slot, "attach took another slot")
        eng.push(slot, audio[slot, b * BLOCK:])
        return slot

    def events(eng, outs, b):
        if b == 10:
            for _ in range(late):
                attach(eng, outs, b)
        elif b == 20:
            eng.detach(5)
            check(attach(eng, outs, b) == 5, "slot 5 was not reused")
        elif b == 25:
            eng.set_stream_params(3, compressor_threshold_db=-45.0, limiter_ceiling_db=-6.0)
        elif b == 30:
            eng.set_stream_suppressor(7, strength=0.4)
            eng.set_stream_suppressor(9, enabled=False)
        elif b == 35:
            eng.set_stream_eq(11, boost)
        elif b == 40:
            eng.detach(13)
            check(attach(eng, outs, b) == 13, "slot 13 was not reused")
            eng.set_stream_eq(13, boost)

    eng, outs = build()
    ref = sv._clone_tree(eng._shards[0]._state)
    apart = []
    t0 = time.perf_counter()
    for b in range(FULL_BLOCKS):
        events(eng, outs, b)
        reset = eng._reset_pending.copy()
        staged = {s: tree for s, tree in eng._pending_eq.items() if not reset[s]}
        eng.step()
        for slot, tree in staged.items():
            ref["chain"]["eq"] = {k: v.clone() for k, v in ref["chain"]["eq"].items()}
            for k, row in tree.items():
                ref["chain"]["eq"][k][slot] = row[0].to(DEVICE)
        mask = torch.from_numpy(reset).to(DEVICE) if reset.any() else None
        ref, y_ref, _ = eager_step(eng, ref, mask)
        y = eng._shards[0]._graph_out[0]
        if not torch.equal(y, y_ref):
            apart.append((b, (y - y_ref).abs().max().item()))
    torch.cuda.synchronize()
    state_apart = _tree_diff(ref, eng._shards[0]._state)
    eq_rows = eng._shards[0]._state["chain"]["eq"]["coeffs"]
    print(f"[7] graph against eager, full chain at fleet {FLEET}, {FULL_BLOCKS} blocks with "
          f"attach, reset, control, suppressor and EQ writes ({time.perf_counter() - t0:.1f} "
          f"s, {card}): blocks whose y differs {apart}; state leaves that differ "
          f"{state_apart}", flush=True)
    check(not apart and not state_apart, "the graph replay and the eager step differ")
    check(not eng._pending_eq and not torch.equal(eq_rows[11], eq_rows[12])
          and torch.equal(eq_rows[11], eq_rows[13]), "the staged EQ programs did not land")

    pipe, pipe_outs = build()
    for b in range(FULL_BLOCKS):
        events(pipe, pipe_outs, b)
        pipe.step_pipelined()
    pipe.flush_pipeline()
    lost = {5: 19, 13: 39}  # in flight when the slot's stream detached
    want = [o[:lost[i]] + o[lost[i] + 1:] if i in lost else o for i, o in enumerate(outs)]
    same = all(len(pipe_outs[i]) == len(want[i]) and np.array_equal(
        np.concatenate(pipe_outs[i]), np.concatenate(want[i])) for i in range(FLEET))
    state_apart = _tree_diff(pipe._shards[0]._state, eng._shards[0]._state)
    print(f"[7] step_pipelined + flush_pipeline against step(): {FLEET} streams "
          f"{'equal' if same else 'DIFFER'} over {FULL_BLOCKS} blocks, the blocks in flight "
          f"at a detach dropped; state leaves that differ {state_apart}", flush=True)
    check(same and not state_apart, "step_pipelined delivers other blocks than step()")

    # the call forms mixed: step() and step_many take host buffers while the
    # first pipelined block is in flight. Taken 0, 1, 2-10, 11; delivered 1,
    # 2-10, 0, 11
    mixed, mixed_outs = build()
    mixed.step_pipelined()
    mixed.step()
    mixed.step_many(9)
    mixed.step_pipelined()
    mixed.flush_pipeline()
    order = [10, *range(10), 11]
    same = all(len(mixed_outs[i]) == 12 and all(
        np.array_equal(mixed_outs[i][j], outs[i][b]) for b, j in enumerate(order))
        for i in range(FLEET - late))
    print(f"[7] step_pipelined, step, step_many(9), step_pipelined, flush_pipeline against "
          f"step(): {FLEET - late} streams {'equal' if same else 'DIFFER'} over 12 blocks "
          f"in the order taken", flush=True)
    check(same, "the mixed call forms deliver other blocks than step()")

    # step_many over the spans between the events: chunks of CHUNK_BLOCKS
    # blocks, filled and delivered while the card runs the next. The EQ
    # program staged on slot 13 as it is reset lands a call later, which is
    # block 41 only if a call ends there
    many, many_outs = build()
    bounds = (0, 10, 20, 25, 30, 35, 40, 41, FULL_BLOCKS)
    chunks0 = _chunk_tally()
    one_array = True
    for a, b in zip(bounds, bounds[1:]):
        events(many, many_outs, a)
        many.step_many(b - a)
        bases = {id(o[-1].base) for o in many_outs if o}
        one_array &= len(bases) == 1 and many_outs[0][-1].base.shape == (b - a, FLEET, BLOCK)
    chunks, hidden = np.subtract(_chunk_tally(), chunks0)
    want = sum(-(-(b - a) // sv.CHUNK_BLOCKS) for a, b in zip(bounds, bounds[1:]))
    same = all(np.array_equal(np.concatenate(many_outs[i]), np.concatenate(outs[i]))
               for i in range(FLEET))
    state_apart = _tree_diff(many._shards[0]._state, eng._shards[0]._state)
    print(f"[7] step_many over {len(bounds) - 1} spans against step(): {FLEET} streams "
          f"{'equal' if same else 'DIFFER'} over {FULL_BLOCKS} blocks; state leaves that "
          f"differ {state_apart}; one array a call {one_array}; chunks {chunks} (want "
          f"{want}), hidden {hidden}", flush=True)
    check(same and not state_apart and one_array and chunks == want and hidden <= chunks,
          "step_many delivers other blocks than step()")


DFN_EAGER_BLOCKS = 20


def phase7_dfn_graph_vs_eager(card: str) -> None:
    """The DeepFilterNet3-LL path at fleet 1024 over DFN_EAGER_BLOCKS blocks,
    a stream detached and attached again (a slot reset) before block 8: the
    engine's graph replays against ``_serving_step`` called eagerly on the
    card on the same inputs, every block's output and the final state
    ``torch.equal``. Where they are not equal, the blocks and state leaves
    that differ are named and held to 1e-5 (the graph and the eager step call
    the same kernels and library products on the same shapes; only a library
    call that picked another algorithm under capture could make them
    differ)."""
    from audioforge_tpu_torch.runtime import serving as sv

    t0 = time.perf_counter()
    audio = voice_and_noise(FLEET, DFN_EAGER_BLOCKS, 34)
    eng, outs = _engine(FLEET, DEVICE, audio, **MODEL_PATHS["DFN3-LL"][0])
    ref = sv._clone_tree(eng._shards[0]._state)
    apart, worst = [], 0.0
    for b in range(DFN_EAGER_BLOCKS):
        if b == 8:
            eng.detach(5)
            check(eng.attach(sink=outs[5].append) == 5, "slot 5 was not reused")
            eng.push(5, audio[5, b * BLOCK:])
        reset = eng._reset_pending.copy()
        eng.step()
        mask = torch.from_numpy(reset).to(DEVICE) if reset.any() else None
        ref, y_ref, _ = eager_step(eng, ref, mask)
        y = eng._shards[0]._graph_out[0]
        if not torch.equal(y, y_ref):
            apart.append(b)
            worst = max(worst, (y - y_ref).abs().max().item())
    torch.cuda.synchronize()
    leaves = _tree_diff(ref, eng._shards[0]._state)
    flat = lambda t, path: t if not path else flat(t[path[0]], path[1:])
    for leaf in leaves:
        path = leaf.strip(".").split(".")
        a, b = flat(ref, path), flat(eng._shards[0]._state, path)
        worst = max(worst, (a.double() - b.double()).abs().max().item())
    print(f"[7] graph against eager, DFN3-LL at fleet {FLEET}, {DFN_EAGER_BLOCKS} blocks with a "
          f"slot reset ({time.perf_counter() - t0:.1f} s, {card}): blocks whose y differs "
          f"{apart}; state leaves that differ {leaves}; max difference {worst:.3e}",
          flush=True)
    check(worst <= 1e-5, "the DFN3 graph replay and the eager step differ beyond 1e-5")


# ---------------------------------------------------------------------------
# The offline chain and its simulators: [2] (new shapes), [11], [12]
# ---------------------------------------------------------------------------

OFFLINE_SHAPE = (16, 128)    # bench.py's downstream batch: 2048 streams
OFFLINE_BLOCKS = 200         # 2 s a stream per call, as bench.py runs it
OFFLINE_GAINS = [-2.5, 1.5, -1.0, 2.0, 3.0, 2.5, 1.5, -2.0, 1.0, -1.5]
OFFLINE_EAGER_BLOCKS = 10    # graph replays held torch.equal to the eager chain
OFFLINE_CPU = (4, 20)        # streams and blocks held against the CPU
OFFLINE_TIMED_REPLAYS = 50
SIM_SECONDS = 10.0           # the simulators' take on the card
SIM_CANDIDATES = 68          # Auto Voice Setup's compressor search
# per block on the offline chain: the EQ and the compressor's K-weighting, the
# two limiters
OFFLINE_LAUNCHES = {"biquad_cascade": 2, "deesser_scan": 1, "compressor_scan": 1,
                    "limiter_gain_scan": 2}


def offline_chain_config(fs: float = FS):
    """bench.py's downstream chain (``bench.py:84-126``): de-esser, the
    ten-band Auto-EQ curve at Q 4.33, the compressor with adaptive release,
    auto makeup and sidechain high-pass at -24 dB / 3:1, both limiters.
    Returns ``(config, compressor params, bands)``."""
    from audioforge_tpu_torch.ops import compressor as comp
    from audioforge_tpu_torch.ops import deesser as des
    from audioforge_tpu_torch.ops import eq
    from audioforge_tpu_torch.runtime import chain

    cfg = chain.ChainConfig(
        sample_rate=fs, deesser_enabled=True, eq_enabled=True, compressor_enabled=True,
        limiter_enabled=True, deesser=des.DeEsserConfig(sample_rate=fs, enabled=True),
        compressor=comp.CompressorConfig(sample_rate=fs, enabled=True, adaptive_release=True,
                                         auto_makeup_enabled=True,
                                         sidechain_highpass_enabled=True, block_samples=BLOCK))
    params = comp.compressor_params(cfg.compressor, threshold_db=-24.0, ratio=3.0)
    bands = [eq.EqBandConfig(b.filter_type, b.frequency_hz, g, 4.33, b.slope_db_per_octave,
                             True) for b, g in zip(eq.default_bands(), OFFLINE_GAINS)]
    return cfg, params, bands


def offline_audio(n: int, n_blocks: int, seed: int) -> torch.Tensor:
    """bench.py's downstream input (a 220 Hz tone at 0.25 gated 0.35 s in
    0.6 s, noise at 0.01), every fourth stream sibilant instead (a 0.25
    6.8 kHz tone over the tone at 0.05), and per stream one 10 ms stretch
    6.4 times louder (the tone's peaks at 1.6, over full scale);
    ``[n, n_blocks, 480]`` made on the card. (A full-scale burst of random
    sign, as :func:`speech_like` has, drives the reference's true-peak
    limiter, which clamps the samples of its gained output, 0.12 dB over its
    ceiling between samples: the JAX chain does the same on such input.)"""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    t = torch.arange(n_blocks * BLOCK, device=DEVICE, dtype=torch.float64) / FS
    tone = torch.sin(2 * np.pi * 220.0 * t) * ((t % 0.6) < 0.35)
    sib = (0.05 * tone + 0.25 * torch.sin(2 * np.pi * 6800.0 * t)).to(torch.float32)
    x = (0.25 * tone).to(torch.float32) + 0.01 * torch.randn((n, t.numel()), generator=g,
                                                             device=DEVICE)
    x = torch.where((torch.arange(n, device=DEVICE) % 4 == 2)[:, None], sib, x)
    at = torch.randint(0, t.numel() - BLOCK, (n,), generator=g, device=DEVICE)
    idx = at[:, None] + torch.arange(BLOCK, device=DEVICE)
    x.scatter_(1, idx, 6.4 * x.gather(1, idx))
    return x.reshape(n, n_blocks, BLOCK)


def sim_take(fs: float, seconds: float, seed: int) -> np.ndarray:
    """One take for the simulators: voiced bursts (160 Hz, 0.3 s in 0.5 s)
    over a low noise floor, with sibilance in the bursts' second half and one
    transient over the limiter's ceiling."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    on = (t % 0.5) < 0.3
    voiced = sum(np.sin(2 * np.pi * 160.0 * h * t + h) / h for h in range(1, 6))
    sib = 0.15 * np.sin(2 * np.pi * 6800.0 * t) * on * ((t % 0.5) > 0.15)
    x = np.where(on, 0.3, 0.01) * voiced + sib + 0.003 * rng.standard_normal(t.size)
    x[int(0.12 * fs):int(0.12 * fs) + 40] *= 3.0
    return x.astype(np.float32)


def phase2_offline(res: Results) -> None:
    """The hand kernels at the shapes the offline path gives them that the
    serving path does not: one stream in a block of eight (the single-take
    simulators), 882-sample rows at 44.1 kHz (not 16-byte aligned), the live
    EQ's 4800-sample blocks through a 16-slot layout, 68 candidates with
    their own compressor parameters, bench.py's batch of 2048; each against
    its plain twin, with its time on the card."""
    from audioforge_tpu_torch.models import silero
    from audioforge_tpu_torch.ops import biquad, compressor as comp, deesser, eq, gate
    from audioforge_tpu_torch.ops import limiter, scan

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(77)

    def timed(name, call, plain, err, tol, shape, bytes_moved, **ops):
        times = kernel_times(call)
        plain_ms = cuda_ms(plain, 1)
        res.report(name, err, tol, times, plain_ms, shape, bytes_moved, **ops)

    # de-esser: one stream of 882 samples at 44.1 kHz and of 960 at 48 kHz,
    # warmed over two blocks of a sibilant capture
    for fs, T in ((44100.0, 882), (FS, 960)):
        cfg = deesser.DeEsserConfig(sample_rate=fs, enabled=True, threshold_db=-40.0)
        x = torch.tensor(mic_capture(4, 3 * T // BLOCK + 1, 14)[2:3, :3 * T], device=dev)
        st = deesser.deesser_init(cfg, n=1, device=dev)
        for b in range(2):
            st, _ = deesser.deesser_scan(cfg, st, x[:, b * T:(b + 1) * T].contiguous())
        xb = x[:, 2 * T:].contiguous()
        sk, yk = deesser.deesser_scan(cfg, st, xb)
        sp, yp = deesser.deesser_scan_plain(cfg, st, xb)
        serr = _max_err(sk, sp)
        print(f"[2] deesser_scan [1, {T}] at {fs:g} Hz: reduction "
              f"{sk['current_reduction_db'].item():.2f} dB, state against the twin "
              f"{serr:.3e} (tol 1e-3)", flush=True)
        check(serr <= 1e-3 and sk["current_reduction_db"].item() > 0.5,
              f"deesser_scan [1, {T}]: state disagrees or no reduction")
        timed("deesser_scan", lambda: deesser.deesser_scan(cfg, st, xb),
              lambda: deesser.deesser_scan_plain(cfg, st, xb),
              (yk - yp).abs().max().item(), 1e-4,
              f"[1, {T}] at {fs:g} Hz", 8 * T + 2 * 4 * 33, f32_ops=270 * T)

    # compressor: one stream of 882 at 44.1 kHz; 68 candidates of 960 with
    # their own threshold, ratio, attack and release; bench.py's 2048 x 480
    cfg48, _, _ = offline_chain_config()
    for n, T, fs in ((1, 882, 44100.0), (SIM_CANDIDATES, 960, FS), (2048, BLOCK, FS)):
        cfg = comp.CompressorConfig(sample_rate=fs, adaptive_release=True,
                                    auto_makeup_enabled=True, sidechain_highpass_enabled=True,
                                    block_samples=T)
        p = {k: torch.full((n,), float(np.float32(v)), device=dev)
             for k, v in comp.compressor_params(cfg, threshold_db=-24.0, ratio=3.0).items()}
        if n == SIM_CANDIDATES:
            p["threshold_db"] = torch.tensor(rng.uniform(-40, -10, n).astype(np.float32),
                                             device=dev)
            p["ratio"] = torch.tensor(rng.uniform(1.5, 8, n).astype(np.float32), device=dev)
            p["attack_coeff"] = torch.tensor(np.exp(-1000.0 / (rng.uniform(1, 30, n) * fs))
                                             .astype(np.float32), device=dev)
            p["base_release_ms"] = torch.tensor(rng.uniform(40, 400, n).astype(np.float32),
                                                device=dev)
        s0 = comp.compressor_init(cfg, n=n, device=dev)
        scan_state = {k: s0[k] for k in comp.SCAN_STATE_KEYS}
        x = torch.tensor(speech_like(n, -(-T // BLOCK), 90 + n)[:, :T].copy(), device=dev)
        args = (cfg, p, torch.full((n,), 1.1, device=dev), scan_state, x)
        sk, yk = comp.compressor_scan(*args)
        sp, yp = comp.compressor_scan_plain(*args)
        err = (yk - yp).abs().max().item()
        serr = _state_err(sk, sp)
        check(serr <= 1e-3, f"compressor_scan [{n}, {T}] state disagrees ({serr:.3e})")
        timed("compressor_scan", lambda: comp.compressor_scan(*args),
              lambda: comp.compressor_scan_plain(*args), err, 1e-5,
              f"[{n}, {T}] at {fs:g} Hz" + (", per-stream parameters"
                                            if n == SIM_CANDIDATES else ""),
              8 * n * T + n * 4 * 2 * (8 + 12), f32_ops=70 * n * T)

    # limiter_gain_scan: the lookahead limiter's call on one stream of 882
    lcfg = limiter.LimiterConfig(ceiling_db=-6.0, sample_rate=44100.0)
    lp = {k: torch.full((1,), float(np.float32(v)), device=dev)
          for k, v in limiter.limiter_params(lcfg).items()}
    x = torch.tensor(speech_like(1, 2, 93)[:, :882].copy(), device=dev)
    args = _call_args(limiter, "limiter_gain_scan", lambda: limiter.limiter_process(
        lcfg, limiter.limiter_init(lcfg, n=1, device=dev), x, lp))
    err, flags, min_gain, _ = _limiter_gain_err(args)
    check(flags == 0 and min_gain.min().item() < 1.0,
          "limiter_gain_scan [1, 882]: events differ or no limiting")
    timed("limiter_gain_scan", lambda: scan.limiter_gain_scan(*args),
          lambda: scan.limiter_gain_scan_plain(*args), err, 1e-5, "[1, 882] lookahead",
          12 * 882 + 4 * 6, f32_ops=16 * 882)

    # biquad_cascade: the live EQ's 16-slot layout (two pass filters) over one
    # 4800-sample block with a band's crossfade in flight; the static offline
    # EQ at [1, 882] and at bench.py's [2048, 480]
    v2 = [eq.EqBandConfig(t, f, g, q, sl, True) for t, f, g, q, sl in (
        (0, 80.0, -2.0, 1.0, 12), (1, 160.0, 1.0, 1.41, 12), (1, 320.0, 1.5, 1.0, 12),
        (4, 60.0, 0.0, 0.707, 48), (1, 1280.0, 2.0, 1.41, 12), (1, 2500.0, -1.0, 1.41, 12),
        (1, 5000.0, -1.5, 2.0, 12), (3, 8000.0, 0.0, 4.0, 12), (5, 18000.0, 0.0, 0.707, 48),
        (2, 16000.0, 1.0, 0.7, 12))]
    st = eq.eq_init(v2, FS, n=1, device=dev)
    st = eq.eq_set_band(st, 4, eq.EqBandConfig(1, 1500.0, -6.0, 2.0), FS,
                        layout=eq.eq_layout(v2))
    x = torch.tensor(speech_like(1, 10, 94), device=dev)
    bq = _cascade_args(x, st)
    yk, zk = biquad.biquad_cascade(*bq)
    yp, zp = biquad.biquad_cascade_plain(*bq)
    S = bq[1].shape[1]
    timed("biquad_cascade", lambda: biquad.biquad_cascade(*bq),
          lambda: biquad.biquad_cascade_plain(*bq), max((yk - yp).abs().max().item(),
                                                        (zk - zp).abs().max().item()),
          1e-6, f"[1, 4800] x {S} sections (live EQ, one crossfading)",
          8 * 4800 + S * (40 + 64 + 8), f64_ops=4800 * (9 * S + 15))
    cfg, _, bands = offline_chain_config()
    for n, T, fs in ((1, 882, 44100.0), (2048, BLOCK, FS)):
        full = eq.bands_to_sections(bands, fs)
        c = torch.tensor(np.concatenate(eq.compact_cascade(full)).astype(np.float32),
                         device=dev)
        z = torch.tensor(1e-3 * rng.standard_normal((n, c.shape[0], 2)), device=dev)
        x = torch.tensor(speech_like(n, -(-T // BLOCK), 95)[:, :T].copy(), device=dev)
        yk, zk = biquad.apply_fixed(c, z, x)
        lanes = biquad._dual_lane(c, n)
        idle = torch.zeros((n, c.shape[0]), dtype=torch.int32, device=dev)
        yp, zp = biquad.biquad_cascade_plain(x, lanes, torch.stack([z, z], 2), idle, idle)
        err = max((yk - yp).abs().max().item(), (zk - zp[:, :, 0]).abs().max().item())
        timed("biquad_cascade", lambda: biquad.apply_fixed(c, z, x),
              lambda: biquad.biquad_cascade_plain(x, lanes, torch.stack([z, z], 2), idle,
                                                  idle),
              err, 1e-6, f"[{n}, {T}] x {c.shape[0]} static sections (offline EQ)",
              8 * n * T + n * c.shape[0] * (40 + 64), f64_ops=9 * n * T * c.shape[0])

    # gate_scan: VAD-assisted, one stream in its block of eight
    name, gcfg, gp, gst, blocks = gate_inputs()[1]
    sl = slice(5, 6)
    one = lambda t: t[sl].contiguous()
    p1 = {k: one(v) for k, v in gp.items()}
    st1 = {k: one(v) for k, v in gst.items()}
    err = 0.0
    for xb, vad in blocks[:10]:
        args = (gcfg, st1, one(xb), *(one(v) for v in vad), p1)
        sk, yk, _ = gate.gate_process(*args)
        sp, yp, _ = gate.gate_process_plain(*args)
        for k in gate.INT_KEYS:
            check(bool((sk[k] == sp[k]).all()), f"gate_scan [1, 480] {k} differs from the twin")
        err = max(err, (yk - yp).abs().max().item())
        st1 = sk
    timed("gate_scan", lambda: gate.gate_process(*args), lambda: gate.gate_process_plain(*args),
          err, 1e-4, f"[1, {BLOCK}] {name}", 8 * BLOCK + 4 * 2 * 18, f32_ops=80 * BLOCK)

    # vad_lstm_head: one stream, the offline pass's warm-up-free form
    sw = {k: v.to(dev) for k, v in silero.default_params().items()}
    head = (sw, torch.tensor(rng.normal(0, 1, (1, 512)).astype(np.float32), device=dev),
            torch.tensor(rng.normal(0, 0.3, (1, 2, 128)).astype(np.float32), device=dev),
            torch.tensor([0.3], device=dev), torch.tensor([5], dtype=torch.int32, device=dev),
            torch.tensor(0.5, device=dev), 1)
    err = _tuple_err(silero.vad_lstm_head(*head), silero.vad_lstm_head_plain(*head))
    timed("vad_lstm_head", lambda: silero.vad_lstm_head(*head),
          lambda: silero.vad_lstm_head_plain(*head), err, 1e-5, "[1] (offline pass)",
          4 * (512 + 2 * 256 + 2 * 512 + 130 + 8), f32_ops=40 * 512)


def phase11_offline_chain(card: str) -> None:
    """bench.py's downstream chain at batch 2048 (16 x 128) over 200 blocks
    of 480 through ``chain_run(return_audio=False)``: one CUDA graph replay a
    block. Fails on a missing launch (per block: biquad_cascade 2,
    deesser_scan 1, compressor_scan 1, limiter_gain_scan 2), non-finite stats,
    an output true peak over the ceiling by more than the reference's 0.1 dB
    (ROADMAP F7), no de-esser reduction on the
    sibilant streams, graph replays not torch.equal to the eager chain on the
    card over 10 blocks, or a 4-stream 20-block run more than 1e-5 RMS from
    the CPU's; prints seconds per call, audio-s/s, the replay alone per block
    (CUDA events), the capture and the peak memory."""
    from audioforge_tpu_torch import kernels
    from audioforge_tpu_torch.ops import util
    from audioforge_tpu_torch.runtime import chain, replay

    cfg, params, bands = offline_chain_config()
    n = int(np.prod(OFFLINE_SHAPE))
    x = offline_audio(n, OFFLINE_BLOCKS, 11).reshape(*OFFLINE_SHAPE, OFFLINE_BLOCKS, BLOCK)
    print(f"[11] input {tuple(x.shape)} f32 on the card: {x.numel() * 4 / 1e6:.0f} MB",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for call in range(3):
        state = chain.chain_init(cfg, params, bands, batch_shape=OFFLINE_SHAPE, device=DEVICE)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        final, ys, stats = chain.chain_run(cfg, params, state, x, return_audio=False)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts = dict(kernels.launch_counts)
        if call == 0:
            print(f"[11] launches over {OFFLINE_BLOCKS} blocks: {counts}", flush=True)
            _check_per_block(counts, OFFLINE_LAUNCHES, OFFLINE_BLOCKS, "offline chain")
    check(ys is None, "chain_run(return_audio=False) kept audio")
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    audio_s = n * OFFLINE_BLOCKS * BLOCK / FS
    for k, v in stats.items():
        check(tuple(v.shape) == OFFLINE_SHAPE + (OFFLINE_BLOCKS,), f"stats {k} shape")
        check(bool(torch.isfinite(v.float()).all()), f"non-finite stats {k}")
    ceiling = float(np.float32(util.db_to_linear(cfg.limiter.ceiling_db)))
    otp = stats["output_true_peak"].max().item()
    red = stats["deesser_gain_reduction_db"].reshape(n, -1).amax(dim=1).cpu().numpy()
    cls = np.arange(n) % 4
    lim = int((stats["limiter_peak_gain_reduction_db"].reshape(n, -1).amax(dim=1) > 0.1).sum())
    print(f"[11] the lookahead limiter reduced by over 0.1 dB on {lim} of {n} streams; "
          f"output true peak {otp:.5f} (ceiling {ceiling:.5f}); limited events on "
          f"{int((stats['true_peak_limited_events'].sum(-1) > 0).sum())} of {n} streams; "
          f"de-esser reduction on the sibilant streams min {red[cls == 2].min():.2f} dB, "
          f"elsewhere max {red[cls != 2].max():.2f} dB; compressor GR up to "
          f"{stats['compressor_gain_reduction_db'].max().item():.2f} dB", flush=True)
    # the true-peak limiter clamps the samples of its gained output, so its
    # true peak may pass the ceiling between samples (ROADMAP F7); the
    # reference's own test allows 0.1 dB (tests/test_api.py:130)
    over_db = 20.0 * np.log10(max(otp, 1e-10) / ceiling)
    above = int((stats["output_true_peak"].reshape(n, -1).amax(dim=1) > ceiling).sum())
    print(f"[11] output true peak {over_db:+.4f} dB against the ceiling, above it on "
          f"{above} of {n} streams (tol +0.1 dB)", flush=True)
    check(over_db <= 0.1, f"output true peak {otp} over {ceiling} by {over_db:.3f} dB")
    check(lim > 0, "the limiters never engaged")
    check(red[cls == 2].min() > 0.5, "no de-esser reduction on the sibilant streams")
    print(f"[11] chain_run at batch {n} x {OFFLINE_BLOCKS} blocks: "
          f"{', '.join(f'{s:.3f}' for s in seconds)} s per call (capture included), "
          f"{audio_s / min(seconds):.0f} audio-s/s per GPU; peak memory {peak_mib:.0f} MiB "
          f"({card})", flush=True)

    # the replay alone: a take replayed block by block, CUDA events
    flat = chain.chain_init(cfg, params, bands, batch_shape=(n,), device=DEVICE)
    p = chain.comp_param_tensors(params, n, x.device)
    xs = x.reshape(n, OFFLINE_BLOCKS, BLOCK).transpose(0, 1)

    def step(st, block):
        st, _, s = chain.chain_block(cfg, p, st, block["x"])
        return st, s

    take = replay.TakeReplay(step, flat, {"x": xs}, OFFLINE_BLOCKS)
    take.capture()
    print(f"[11] capture {take.capture_seconds:.3f} s, graph launches per replay "
          f"{take.graph_launches}", flush=True)
    replay_ms = cuda_ms(take.replay, OFFLINE_TIMED_REPLAYS)
    print(f"[11] the replay alone: {replay_ms:.4f} ms per block of {n} streams, "
          f"{n * BLOCK / FS / (replay_ms / 1e3):.0f} audio-s/s ({card})", flush=True)

    # graph replays against the eager chain on the card, first 10 blocks
    head = x.reshape(n, OFFLINE_BLOCKS, BLOCK)[:, :OFFLINE_EAGER_BLOCKS].contiguous()
    st0 = chain.chain_init(cfg, params, bands, batch_shape=(n,), device=DEVICE)
    _, y_graph, s_graph = chain.chain_run(cfg, params, st0, head)
    st = chain.chain_init(cfg, params, bands, batch_shape=(n,), device=DEVICE)
    apart = []
    for b in range(OFFLINE_EAGER_BLOCKS):
        st, y, s = chain.chain_block(cfg, p, st, head[:, b].contiguous())
        if not torch.equal(y, y_graph[:, b]):
            apart.append(f"block {b} audio")
        apart += [f"block {b} {k}" for k, v in s.items() if not torch.equal(v, s_graph[k][:, b])]
    print(f"[11] graph replays against the eager chain on the card over "
          f"{OFFLINE_EAGER_BLOCKS} blocks: {'torch.equal' if not apart else apart[:8]}",
          flush=True)
    check(not apart, f"offline chain graph differs from the eager chain: {apart[:8]}")

    # a 4-stream, 20-block run on the card and on the CPU
    k, nb = OFFLINE_CPU
    small = x.reshape(n, OFFLINE_BLOCKS, BLOCK)[:k, :nb].contiguous()
    _, yc, sc = chain.chain_run(cfg, params, chain.chain_init(
        cfg, params, bands, batch_shape=(k,), device=DEVICE), small)
    t0 = time.perf_counter()
    _, yh, sh = chain.chain_run(cfg, params, chain.chain_init(
        cfg, params, bands, batch_shape=(k,), device="cpu"), small.cpu())
    rms = float(torch.sqrt(torch.mean((yc.cpu().double() - yh.double()) ** 2)))
    db_err = max((sc[s].cpu().float() - sh[s].float()).abs().max().item()
                 for s in sc if s.endswith("_db"))
    print(f"[11] card against CPU, {k} streams x {nb} blocks: audio RMS {rms:.3e} (tol "
          f"1e-5), dB stats max {db_err:.3e}; CPU run {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(rms <= 1e-5 and db_err <= 1e-2, "offline chain on the card differs from the CPU")


UNIT_DIAGNOSTICS = ("activity", "reliability", "gate_gain", "p",
                    "gate_noise_floor_reliability", "compressor_gain_reduction_active_ratio")


def _diag_err(card: dict, cpu: dict, name: str, quiet: bool = False) -> None:
    """Hold a simulator's card diagnostics against its CPU ones: audio RMS
    1e-4 / max 1e-3, dB values 1e-2, probabilities, activities and gains
    1e-3, counts and flags exact."""
    check(set(card) == set(cpu), f"{name}: diagnostics keys differ")
    worst = {"audio_rms": 0.0, "audio_max": 0.0, "value": 0.0}
    for k, ref in cpu.items():
        got = card[k]
        if k.endswith("runtime_ms"):
            continue
        if isinstance(ref, (bool, int)) and not isinstance(ref, float):
            check(got == ref, f"{name}: {k} {got} against {ref} on the CPU")
            continue
        a, b = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        if a.size == 0 and b.size == 0:
            continue
        d = np.abs(a - b)
        if k == "output_audio":
            worst["audio_rms"] = max(worst["audio_rms"], float(np.sqrt(np.mean(d ** 2))))
            worst["audio_max"] = max(worst["audio_max"], float(d.max()))
        else:
            tol = 1e-3 if k in UNIT_DIAGNOSTICS else 1e-2
            check(float(d.max()) <= tol, f"{name}: {k} off by {float(d.max()):.3e}")
            worst["value"] = max(worst["value"], float(d.max()))
    check(worst["audio_rms"] <= 1e-4 and worst["audio_max"] <= 1e-3,
          f"{name}: audio off by {worst}")
    if quiet:
        return
    audio = (f"audio RMS {worst['audio_rms']:.2e}, max {worst['audio_max']:.2e}, "
             if "output_audio" in cpu else "")
    print(f"[12] {name}: card against CPU {audio}values max {worst['value']:.2e}",
          flush=True)


def phase12_simulators(card: str) -> None:
    """The api simulators, analyze_vad_probabilities and resample on the card
    against the same calls with device="cpu" (the plain twins), on takes short
    enough for the CPU; then each on a 10 s take on the card (seconds per
    call, information)."""
    from audioforge_tpu_torch import api
    from audioforge_tpu_torch.models import silero
    from audioforge_tpu_torch.ops import resample

    legacy = [(80.0, -2.0, 1.0), (160.0, 0.0, 1.41), (320.0, 1.5, 1.0), (640.0, 0.0, 1.41),
              (1280.0, 2.0, 1.41), (2500.0, 0.0, 1.41), (5000.0, -1.5, 2.0),
              (8000.0, 0.0, 1.41), (12000.0, 0.0, 1.41), (16000.0, 1.0, 0.7)]
    v2 = [("high_pass", 40.0, 0.0, 0.707, 24, True), ("bell", 160.0, 1.0, 1.41, 12, True),
          ("bell", 320.0, 1.5, 1.0, 12, True), ("bell", 640.0, 0.0, 1.41, 12, True),
          ("bell", 1280.0, 2.0, 1.41, 12, True), ("bell", 2500.0, -1.0, 1.41, 12, True),
          ("bell", 5000.0, -1.5, 2.0, 12, True), ("notch", 8000.0, 0.0, 4.0, 12, True),
          ("low_pass", 18000.0, 0.0, 0.707, 48, True),
          ("high_shelf", 16000.0, 1.0, 0.7, 12, True)]
    rng = np.random.default_rng(12)
    cands = [{"threshold_db": float(t), "ratio": float(r), "attack_ms": float(a),
              "release_ms": float(rel)} for t, r, a, rel in zip(
        rng.uniform(-40, -10, SIM_CANDIDATES), rng.uniform(1.5, 8, SIM_CANDIDATES),
        rng.uniform(1, 30, SIM_CANDIDATES), rng.uniform(40, 400, SIM_CANDIDATES))]
    audio_settings = {"return_output_audio": True, "limiter_ceiling_db": -6.0}

    def probs(x):
        n = -(-x.size // 480)
        return np.where((np.arange(n) * 0.01) % 0.5 < 0.3, 0.9, 0.05)

    # (name, call(audio, device), fs, seconds held against the CPU)
    calls = [
        ("simulate_auto_eq_chain 48 kHz", lambda x, d: api.simulate_auto_eq_chain(
            x, 48000, legacy, audio_settings, device=d), 48000, 1.0),
        ("simulate_auto_eq_chain 44.1 kHz, de-esser", lambda x, d: api.simulate_auto_eq_chain(
            x, 44100, legacy, dict(audio_settings, deesser_enabled=True), device=d),
         44100, 0.5),
        (f"simulate_auto_eq_chain_batched x {SIM_CANDIDATES}",
         lambda x, d: api.simulate_auto_eq_chain_batched(x, 48000, legacy, None, cands,
                                                         device=d), 48000, 0.5),
        ("simulate_eq_v2", lambda x, d: api.simulate_eq_v2(x, 48000, v2, True, device=d),
         48000, 1.0),
        ("simulate_auto_makeup_control", lambda x, d: api.simulate_auto_makeup_control(
            x, 48000, probs(x), -60.0, 0.8, {"return_output_audio": True}, device=d),
         48000, 1.0),
        ("simulate_gate_suppressor_order, suppressor first",
         lambda x, d: api.simulate_gate_suppressor_order(x, probs(x), True, 0.8, None,
                                                         device=d), 48000, 0.3),
        ("simulate_gate_suppressor_order, gate first",
         lambda x, d: api.simulate_gate_suppressor_order(x, probs(x), False, 0.8, None,
                                                         device=d), 48000, 0.3),
        ("analyze_vad_probabilities 16 kHz", lambda x, d: {"p": silero.analyze_vad_probabilities(
            x, 16000, device=d)}, 16000, 1.0),
        ("analyze_vad_probabilities 48 kHz", lambda x, d: {"p": silero.analyze_vad_probabilities(
            x, 48000, device=d)}, 48000, 1.0),
        ("resample 44.1 -> 48 kHz", lambda x, d: {"output_audio": resample.resample(
            x, 44100, 48000, device=d).cpu().numpy()}, 44100, 1.0),
        ("resample 48 -> 16 kHz", lambda x, d: {"output_audio": resample.resample(
            x, 48000, 16000, device=d).cpu().numpy()}, 48000, 1.0),
    ]
    for i, (name, call, fs, seconds) in enumerate(calls):
        x = sim_take(fs, seconds, 60 + i)
        t0 = time.perf_counter()
        on_card = call(x, DEVICE)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = call(x, "cpu")
        cpu_s = time.perf_counter() - t0
        if isinstance(on_card, list):
            check(len(on_card) == len(on_cpu) == SIM_CANDIDATES, f"{name}: candidates")
            for j in range(SIM_CANDIDATES):
                _diag_err(on_card[j], on_cpu[j], f"{name} candidate {j}", quiet=0 < j)
        else:
            _diag_err(on_card, on_cpu, name)
        long = sim_take(fs, SIM_SECONDS, 80 + i)
        t0 = time.perf_counter()
        out = call(long, DEVICE)
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        flat = out if isinstance(out, list) else [out]
        finite = all(np.isfinite(np.asarray(v, np.float64)).all()
                     for d in flat for k, v in d.items() if not isinstance(v, str))
        check(finite, f"{name}: non-finite output on the {SIM_SECONDS:g} s take")
        print(f"[12] {name}: {seconds:g} s take {card_s:.2f} s on the card (capture "
              f"included), {cpu_s:.1f} s on the CPU; {SIM_SECONDS:g} s take {long_s:.3f} s "
              f"on the card ({card})", flush=True)


LIVE_BLOCKS = 300            # [13](a): blocks through _process_block per suppressor
LIVE_CPU_BLOCKS = 8          # then held against device="cpu" from the card's state
LIVE_SEEK_BLOCKS = 48        # more blocks in which the voiced stretch for them is sought
LIVE_LEAD_BLOCKS = 6         # voiced blocks before them: above the chain's latency
LIVE_TOL_RMS = 1e-3          # card against CPU: error RMS, and error RMS / the CPU's RMS
LIVE_MIN_RMS = 3e-3          # the CPU's output RMS over the compared blocks, at least
LIVE_SPLIT_BLOCKS = 100      # blocks after them timed by stage on the host clock
LIVE_FREE_RUN_S = 5.0        # [13](b): free-run seconds with the threads
LIVE_PACED_S = 10.0          # [13](c): real-time seconds
LIVE_STRESS_ITERATIONS = 200  # [13](d): seeded control storm on the free-running engine
LIVE_BASE = {"biquad_cascade": 4, "limiter_gain_scan": 2, "compressor_scan": 1,
             "gate_scan": 1}
# suppressor -> (noise model or None, expected launches per block at one stream)
LIVE_SETTINGS = {
    "none": (None, LIVE_BASE),
    "rnnoise": ("rnnoise", dict(LIVE_BASE, biquad_cascade=5)),
    "DFN3-LL": ("deepfilter-ll", dict(LIVE_BASE, dfn_features=1, dfn_spec_synth=1)),
    "DFN3 standard": ("deepfilter", dict(LIVE_BASE, dfn_features=1, dfn_spec_synth=1)),
}


def _live_processor(device: str, model):
    from audioforge_tpu_torch.runtime.processor import AudioProcessor

    p = AudioProcessor(device=device)
    p.set_rnnoise_enabled(model is not None)
    if model is not None:
        check(p.set_noise_model(model), f"set_noise_model({model!r}) refused")
    return p


def _live_blocks(p, audio: np.ndarray, n_blocks: int, after_first=None):
    """``n_blocks`` blocks of ``audio`` through ``p._process_block`` with a
    fixed fresh VAD snapshot (no threads). Returns the outputs, the host
    seconds per block, and ``(p, state, config, params, engine)``."""
    from audioforge_tpu_torch.models import suppressor as supp

    config, params, topo, par, _ = p._snapshot_control()
    state = p._fresh_state(config, None)
    engine = supp.engine_init(topo["noise_model"], par["suppressor_strength"],
                              device=p.device)
    delay = np.zeros(engine["latency_samples"], np.float32)
    p._vad_state = {"probability": 0.7, "timestamp": time.perf_counter() + 3600.0,
                    "available": True}
    ys, secs = [], []
    for b in range(n_blocks):
        t0 = time.perf_counter()
        state, y, engine, delay = p._process_block(
            config, params, state, audio[b:b + 1], engine, delay, topo)
        secs.append(time.perf_counter() - t0)
        ys.append(y)
        if b == 0 and after_first is not None:
            after_first()
    p._engine = engine
    return np.stack(ys), np.asarray(secs), (state, config, params, engine, delay, topo)


def _to_cpu(tree):
    """A copy of a live state (chain state, suppressor engine, delay line)
    on the CPU: tensors and arrays copied, a frame graph dropped (the CPU
    processor builds its own eager step at its first frame)."""
    from audioforge_tpu_torch.runtime.replay import BlockReplay

    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu").clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, BlockReplay):
        return None
    return tree


def _live_card_vs_cpu(p, model, ctx, audio: np.ndarray, start: int):
    """Hand the card's live state after block ``start`` to a ``device="cpu"``
    processor and run both over the LIVE_CPU_BLOCKS blocks from ``start``.
    Returns ``(card, cpu, ctx)``: both outputs and the card's context after
    them."""
    state, config, params, engine, delay, topo = ctx
    cpu = _live_processor("cpu", model)
    ccfg, cparams, ctopo, _, _ = cpu._snapshot_control()
    cpu._vad_state = dict(p._vad_state)
    cstate, cengine, cdelay = _to_cpu((state, engine, delay))
    ys, ycpu = [], []
    for b in range(start, start + LIVE_CPU_BLOCKS):
        state, y, engine, delay = p._process_block(
            config, params, state, audio[b:b + 1], engine, delay, topo)
        cstate, yc, cengine, cdelay = cpu._process_block(
            ccfg, cparams, cstate, audio[b:b + 1], cengine, cdelay, ctopo)
        ys.append(y)
        ycpu.append(yc)
    return (np.stack(ys).astype(np.float64), np.stack(ycpu).astype(np.float64),
            (state, config, params, engine, delay, topo))


def _live_host_split(p, ctx, audio: np.ndarray, n_blocks: int) -> str:
    """Mean host ms a block of ``_process_block`` by stage over ``n_blocks``
    more blocks (information): ``front_run`` and ``back_run`` (each a pinned
    copy each way, the replays and the wait), the suppressor engine's calls
    (its numpy staging and the frame graph's round trip), and the rest (the
    VAD snapshot, evidence, metric publication)."""
    from audioforge_tpu_torch.models import suppressor as supp
    from audioforge_tpu_torch.runtime import live_chain as lc

    state, config, params, engine, delay, topo = ctx
    seconds = collections.Counter()
    stages = [(lc, "front_run", "front_run"), (lc, "back_run", "back_run"),
              (supp, "engine_push", "suppressor"), (supp, "engine_process", "suppressor"),
              (supp, "engine_pop", "suppressor")]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in stages]

    def timed(label, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            seconds[label] += time.perf_counter() - t0
            return out
        return run

    for (mod, name, label), (_, _, fn) in zip(stages, originals):
        setattr(mod, name, timed(label, fn))
    try:
        t0 = time.perf_counter()
        for b in range(n_blocks):
            state, _, engine, delay = p._process_block(
                config, params, state, audio[b % audio.shape[0]][None], engine, delay, topo)
        total = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    ms = {k: 1e3 * v / n_blocks for k, v in seconds.items()}
    rest = 1e3 * total / n_blocks - sum(ms.values())
    return (f"total {1e3 * total / n_blocks:.3f}: front_run {ms.get('front_run', 0.0):.3f}, "
            f"suppressor {ms.get('suppressor', 0.0):.3f}, back_run "
            f"{ms.get('back_run', 0.0):.3f}, the rest {rest:.3f}")


class _LoopSource:
    """A virtual input that loops a take."""

    def __init__(self, audio):
        self.audio, self.pos = audio, 0

    def __call__(self, n):
        idx = (self.pos + np.arange(n)) % self.audio.size
        self.pos = (self.pos + n) % self.audio.size
        return self.audio[idx]


def _replay_tally(since_ns: int = 0) -> tuple:
    """The tracer's counts of graph captures and replays so far, and the
    seconds of the ``replay.capture`` spans (warm-up and capture) begun at
    or after ``since_ns`` (the tracer's clock; spans are on in [13])."""
    from audioforge_tpu_torch.runtime import tracing

    snap = tracing.snapshot()
    c = snap["counters"]
    secs = sum(s["end_ns"] - s["start_ns"] for s in snap["spans"]
               if s["name"] == "replay.capture" and s["start_ns"] >= since_ns) / 1e9
    return c.get("replay.captures", 0), c.get("replay.replays", 0), secs


def _live_threads(card: str, name: str, model, audio: np.ndarray, seconds: float,
                  paced: bool, change_at=None) -> dict:
    """Start the engine on a looping virtual source and a counting sink for
    ``seconds`` (``realtime_pacing`` = ``paced``); optionally switch the
    topology (de-esser on) at ``change_at`` s. Returns what it read."""
    from audioforge_tpu_torch.runtime import processor as proc

    sink = {"blocks": 0, "peak": 0.0, "finite": True}

    def count(block):
        sink["blocks"] += 1
        sink["peak"] = max(sink["peak"], float(np.abs(block).max()))
        sink["finite"] &= bool(np.isfinite(block).all())

    proc.register_virtual_input("smoke-mic", lambda: _LoopSource(audio))
    proc.register_virtual_output("smoke-sink", lambda: count)
    p = _live_processor(DEVICE, model)
    p.realtime_pacing = paced
    captures0, replays0, _ = _replay_tally()
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    p.start("smoke-mic", "smoke-sink")
    start_s = time.perf_counter() - t0
    out = {"start_s": start_s}
    blocks0 = p._counters["blocks_processed"]
    if change_at is not None:
        time.sleep(change_at)
        n_before, mem0 = len(p._dsp_times), torch.cuda.memory_allocated()
        captures_before, change_ns = _replay_tally()[0], time.time_ns()
        t_change = time.perf_counter()
        p.set_deesser_enabled(True)
        # the new topology's front and back graphs, captured by the DSP thread
        while (_replay_tally()[0] < captures_before + 2
               and time.perf_counter() - t_change < seconds - change_at):
            time.sleep(0.005)
        captured_s = time.perf_counter() - t_change
        time.sleep(max(0.0, seconds - change_at - captured_s))
        after = list(p._dsp_times)[n_before:]
        captures, _, capture_s = _replay_tally(change_ns)
        out.update(change_ms=max(after) if after else float("nan"),
                   change_captures=captures - captures_before,
                   change_capture_s=capture_s,
                   change_wall_s=captured_s,
                   change_mib=(torch.cuda.memory_allocated() - mem0) / 2**20)
    else:
        time.sleep(seconds)
    d = p.get_runtime_diagnostics()
    blocks = p._counters["blocks_processed"] - blocks0
    times = np.asarray(p._dsp_times, np.float64)
    p.stop()
    captures, replays, capture_s = _replay_tally(t0_ns)
    out.update(diag=d, blocks=blocks, times=times, sink=sink,
               replays=replays - replays0, captures=captures - captures0,
               capture_s=capture_s,
               graphs=len(p._graphs), error=d["last_stream_error"],
               backend_failed=p.noise_backend_failed(),
               backend_error=p.noise_backend_error())
    check(d["rt_error_code"] == 0 and d["last_stream_error"] is None,
          f"[13] {name}: engine error {d['rt_error_name']}: {d['last_stream_error']}")
    check(not out["backend_failed"], f"[13] {name}: noise backend failed: "
          f"{out['backend_error']}")
    check(sink["finite"], f"[13] {name}: non-finite output")
    return out


def _pcts(times: np.ndarray) -> str:
    if not times.size:
        return "no blocks"
    return (f"p50 {np.percentile(times, 50):.3f} / p99 {np.percentile(times, 99):.3f} / "
            f"max {times.max():.3f} ms over {times.size} blocks")


def vad_window_times(n_windows: int = 200) -> tuple:
    """The live engine's VAD worker alone: one 48 kHz stream of the
    streaming VAD (``models/silero.py``) over ``n_windows`` windows of a
    voiced capture. Returns ``(replay_ms, call_ms)``: its window graph's
    replay alone on the card (CUDA events) and the host's milliseconds per
    ``vad_stream_process`` call that infers a window."""
    from audioforge_tpu_torch.models import silero

    st = silero.vad_stream_prepare(silero.vad_stream_init(48000, device=DEVICE))
    win = st["config"]["window_in"]
    audio = mic_capture(1, -(-n_windows * win // BLOCK), 61)[0]
    t0 = time.perf_counter()
    for i in range(n_windows):
        st, prob = silero.vad_stream_process(st, audio[i * win:(i + 1) * win])
        check(0.0 <= prob <= 1.0, f"VAD window {i}: probability {prob}")
    call_ms = 1e3 * (time.perf_counter() - t0) / n_windows
    r = st["replay"]
    return cuda_ms(lambda: (r._idx.zero_(), r.graph.replay()), n_windows), call_ms


def phase13_live_engine(card: str) -> dict:
    """The single-stream live engine (``AudioProcessor``) on the card for
    each suppressor setting: (a) ``_process_block`` directly over
    LIVE_BLOCKS blocks with a VAD snapshot (output finite within the
    ceiling; launches per block as expected; then, in a voiced stretch
    after them, the card's state handed to ``device="cpu"`` and both run
    over LIVE_CPU_BLOCKS blocks: error RMS within LIVE_TOL_RMS, and within
    LIVE_TOL_RMS of the CPU's RMS, which must reach LIVE_MIN_RMS (the
    compared output is live audio, not the start-up silence); no capture after the first block; the
    DeepFilterNet3 backend available and not failed; each graph's replay
    alone and a host split by stage: information), (b) the threads
    free-running for LIVE_FREE_RUN_S s with the VAD worker (no engine error,
    no capture after the start; per-block DSP time, replays per block), (c)
    paced in real time for LIVE_PACED_S s with a topology change half way
    (its captures checked; drops, underruns, p99, the stall and memory:
    information). Then the VAD worker's window alone (:func:`vad_window_times`,
    information) and (d) the seeded control storm. Returns the launches of
    (a) and (b) by kernel."""
    import os

    from audioforge_tpu_torch import kernels
    from audioforge_tpu_torch.models import suppressor as supp
    from audioforge_tpu_torch.runtime import live_chain as lc
    from audioforge_tpu_torch.runtime import ringbuffer, tracing
    from audioforge_tpu_torch.runtime.stress_harness import run_seeded_control_dsp_stress

    check(ringbuffer.native_ring_available(), "[13] the native ring did not build")
    os.environ["AUDIOFORGE_ENABLE_DEEPFILTER"] = "1"  # the product's own opt-in
    total = collections.Counter()
    ceiling = 10.0 ** (lc.effective_limiter_ceiling_db(-0.5, True) / 20.0)
    n_audio = LIVE_BLOCKS + LIVE_SEEK_BLOCKS
    audio = mic_capture(1, n_audio, 31)[0].reshape(n_audio, BLOCK)
    voiced = voiced_blocks(n_audio, 31)
    span = LIVE_LEAD_BLOCKS + LIVE_CPU_BLOCKS
    start = next((b for b in range(LIVE_BLOCKS + LIVE_LEAD_BLOCKS, n_audio - LIVE_CPU_BLOCKS + 1)
                  if voiced[b - LIVE_LEAD_BLOCKS:b + LIVE_CPU_BLOCKS].sum() == span), None)
    check(start is not None, f"[13] no {span} voiced blocks after block {LIVE_BLOCKS}")
    loop = mic_capture(1, 200, 32)[0]
    tracing.enable()  # the captures' spans: their seconds in (b) and (c)
    try:
        for name, (model, per_block) in LIVE_SETTINGS.items():
            t0 = time.perf_counter()
            # (a) deterministic
            p = _live_processor(DEVICE, model)
            captures0, mem0 = _replay_tally()[0], torch.cuda.memory_allocated()
            first = {}

            def after_first():
                torch.cuda.synchronize()
                at = _replay_tally()[0]
                first.update(captures=at - captures0,
                             mib=(torch.cuda.memory_allocated() - mem0) / 2**20, at=at)
                kernels.reset_launch_counts()

            ys, secs, ctx = _live_blocks(p, audio, LIVE_BLOCKS, after_first)
            state, config, params, engine = ctx[:4]
            counts = dict(kernels.launch_counts)
            n = LIVE_BLOCKS - 1
            check(_replay_tally()[0] == first["at"],
                  f"[13] {name}: {_replay_tally()[0] - first['at']} captures after "
                  "the first block")
            check(first["captures"] == (3 if model else 2),
                  f"[13] {name}: {first['captures']} graphs captured at the first block")
            check(bool(np.isfinite(ys).all()), f"[13] {name}: non-finite output")
            peak = float(np.abs(ys).max())
            check(peak <= ceiling + 1e-6, f"[13] {name}: peak {peak} above {ceiling}")
            for kname, total_k in counts.items():
                want = per_block.get(kname, 0) * n
                check(total_k == want, f"[13] {name}: {kname} {total_k} launches over "
                      f"{n} blocks, expected {per_block.get(kname, 0)} per block")
            total.update(counts)
            # the card runs on to the voiced stretch, then card against CPU (before
            # the replays timed alone below advance the card's state)
            state, config, params, engine, delay, topo = ctx
            for b in range(LIVE_BLOCKS, start):
                state, _, engine, delay = p._process_block(
                    config, params, state, audio[b:b + 1], engine, delay, topo)
            ycard, ycpu, ctx = _live_card_vs_cpu(
                p, model, (state, config, params, engine, delay, topo), audio, start)
            engine = ctx[3]
            diff = ycard - ycpu
            rms = float(np.sqrt(np.mean(diff ** 2)))
            ref_rms = float(np.sqrt(np.mean(ycpu ** 2)))
            diag = supp.engine_diagnostics(engine)
            if model is not None and model.startswith("deepfilter"):
                check(diag["backend_available"] and not diag["backend_failed"],
                      f"[13] {name}: DeepFilterNet3 backend {diag}")
            graphs = p._graphs_for(config, params, state)
            replay_ms = {k: cuda_ms(lambda r=r: (r._idx.zero_(), r.graph.replay()), 50)
                         for k, r in graphs.items()}
            if model is not None:
                frame = engine["proc"]["replay"]
                replay_ms["suppressor frame"] = cuda_ms(
                    lambda: (frame._idx.zero_(), frame.graph.replay()), 50)
            split = _live_host_split(p, ctx, audio, LIVE_SPLIT_BLOCKS)
            print(f"[13] {name} (a) {LIVE_BLOCKS} blocks through _process_block: peak "
                  f"{peak:.4f} (ceiling {ceiling:.4f}); launches per block "
                  f"{ {k: v / n for k, v in counts.items() if v} }; graphs captured at "
                  f"the first block {first['captures']}, after it "
                  f"{_replay_tally()[0] - first['at']}; graph memory {first['mib']:.1f} "
                  f"MiB; host ms per block {_pcts(1e3 * secs[1:])}; replay alone on the "
                  f"card (ms) { {k: round(v, 4) for k, v in replay_ms.items()} }; card vs "
                  f"CPU from the card's state at block {start} over {LIVE_CPU_BLOCKS} "
                  f"blocks: error RMS {rms:.3e} (tol {LIVE_TOL_RMS:g}), max "
                  f"{np.abs(diff).max():.3e}, relative to the CPU's RMS "
                  f"{rms / max(ref_rms, 1e-30):.3e} (tol {LIVE_TOL_RMS:g}); the CPU's RMS "
                  f"{ref_rms:.3e} (at least {LIVE_MIN_RMS:g}), peak {np.abs(ycpu).max():.3e}; "
                  f"backend {diag['backend_available']}/failed {diag['backend_failed']} "
                  f"({card})", flush=True)
            print(f"[13] {name} (a) host ms a block of _process_block by stage, mean of "
                  f"{LIVE_SPLIT_BLOCKS} more blocks (info, {card}): {split}", flush=True)
            check(ref_rms >= LIVE_MIN_RMS, f"[13] {name}: the compared blocks are not "
                  f"live (CPU RMS {ref_rms:.3e})")
            check(rms <= LIVE_TOL_RMS and rms <= LIVE_TOL_RMS * ref_rms,
                  f"[13] {name}: card and CPU differ")
            del p, graphs, engine, state

            # (b) free-run with the threads and the VAD worker
            kernels.reset_launch_counts()
            free = _live_threads(card, name, model, loop, LIVE_FREE_RUN_S, False)
            vad_launches = kernels.launch_counts["vad_lstm_head"]
            total["vad_lstm_head"] += vad_launches
            check(vad_launches > 0, f"[13] {name}: the VAD worker launched nothing")
            check(free["blocks"] > 0, f"[13] {name}: no block processed")
            # captured at start only: front, back, the suppressor's frame, the VAD
            check(free["captures"] == (4 if model else 3),
                  f"[13] {name}: {free['captures']} captures in the free run")
            print(f"[13] {name} (b) free-run {LIVE_FREE_RUN_S:g} s: {free['blocks']} blocks "
                  f"({free['blocks'] / LIVE_FREE_RUN_S:.0f} a second), start "
                  f"{free['start_s']:.3f} s, DSP ms per block {_pcts(free['times'])}; "
                  f"replays {free['replays']} ({free['replays'] / max(free['blocks'], 1):.2f}"
                  f" per block, VAD windows included), captures {free['captures']} in "
                  f"{free['capture_s']:.3f} s; vad_lstm_head launches {vad_launches}; "
                  f"sink blocks {free['sink']['blocks']} (the output thread free-runs "
                  f"too) ({card})", flush=True)

            # (c) real time, with a topology change half way
            paced = _live_threads(card, name, model, loop, LIVE_PACED_S, True,
                                  change_at=LIVE_PACED_S / 2)
            d = paced["diag"]
            check(paced["change_captures"] >= 2,
                  f"[13] {name}: the topology change captured no graphs")
            print(f"[13] {name} (c) real time {LIVE_PACED_S:g} s (information): "
                  f"{paced['blocks']} blocks, input dropped samples "
                  f"{d['input_dropped_samples']}, backlog drops "
                  f"{d['input_backlog_recovery_count']} ({d['input_backlog_dropped_samples']}"
                  f" samples), output underruns {d['output_underrun_total']}, DSP ms per "
                  f"block {_pcts(paced['times'])}; engine latency "
                  f"{d['engine_latency_ms']:.2f} ms; topology change (de-esser on) half "
                  f"way: {paced['change_captures']} graphs captured in "
                  f"{paced['change_capture_s']:.3f} s (ready {paced['change_wall_s']:.3f} s "
                  f"after the setter), stall {paced['change_ms']:.2f} ms (the worst DSP "
                  f"block after it), memory {paced['change_mib']:+.1f} MiB, graph cache "
                  f"{paced['graphs']} topologies ({card}); {time.perf_counter() - t0:.1f} s",
                  flush=True)
        replay_ms, call_ms = vad_window_times()
        print(f"[13] the VAD worker's window (information): its graph's replay alone "
              f"{replay_ms:.4f} ms on the card, {call_ms:.3f} ms on the host per window "
              f"({card})", flush=True)
        t0 = time.perf_counter()
        report = run_seeded_control_dsp_stress(0x5EED, LIVE_STRESS_ITERATIONS, device=DEVICE)
        print(f"[13] (d) seeded control storm: {report} ({time.perf_counter() - t0:.1f} s, "
              f"{card})", flush=True)
        check(report.processed_blocks >= 120 and report.max_output_abs <= 16.0,
              "[13] the control storm did not process 120 bounded blocks")
    finally:
        tracing.disable()
        os.environ.pop("AUDIOFORGE_ENABLE_DEEPFILTER", None)
    return dict(total)


# ---------------------------------------------------------------------------
# The sharded preset fleet, the sharded sweep, the dry run and run --preset: [14]
# ---------------------------------------------------------------------------

FLEET_BLOCKS = 60             # [14]: blocks of mic_capture audio through each engine
FLEET_SHARDS = (1, 2, 4)      # shards of the fleet, all on the one card
FLEET_TIMED_CALLS = 200       # step() calls timed on each engine
FLEET_CPU_STREAMS = 8         # card against CPU
FLEET_CPU_BLOCKS = 10
FLEET_PATH = {"biquad_cascade": 5, "limiter_gain_scan": 2, "compressor_scan": 1,
              "gate_scan": 1}  # launches a block of one shard on the voice preset's path
PRESET_RUN_S = 3.0            # run --preset's duration


def preset_fleet_engine(capacity: int, audio: np.ndarray, **where):
    """The voice preset's serving topology at ``capacity`` streams, the
    builtin presets that share it round-robin over the slots, ``audio
    [capacity, samples]`` queued; ``where``: ``device=`` or ``sharding=``.
    Returns ``(engine, sink lists, the presets used)``."""
    from audioforge_tpu_torch import BUILTIN_PRESETS
    from audioforge_tpu_torch.runtime.preset_io import (apply_preset_to_stream,
                                                        serving_config_for_preset)
    from audioforge_tpu_torch.runtime.serving import ServingEngine

    cfg = serving_config_for_preset(BUILTIN_PRESETS["voice"], capacity=capacity)
    eng = ServingEngine(cfg, **where)
    probe = ServingEngine(serving_config_for_preset(BUILTIN_PRESETS["voice"], capacity=1),
                          device="cpu")
    probe.attach()
    names = [k for k, pr in BUILTIN_PRESETS.items() if not apply_preset_to_stream(probe, 0, pr)]
    outs = [[] for _ in range(capacity)]
    for i in range(capacity):
        slot = eng.attach(sink=lambda blk, i=i: outs[i].append(blk))
        check(not apply_preset_to_stream(eng, slot, BUILTIN_PRESETS[names[i % len(names)]]),
              "a preset of the voice topology warned")
        eng.push(slot, audio[i])
    return eng, outs, names


def _fleet_timing(eng, outs, audio: np.ndarray) -> dict:
    """step() p50/p99 over FLEET_TIMED_CALLS calls and step_many(TIMED_SPAN)
    per block (host clock, ``latency_histogram``); the audio is queued again
    every TIMED_SPAN blocks, outside the timed calls."""
    def run(call, n_calls: int, blocks: int) -> dict:
        eng._step_times.clear()
        for i in range(n_calls):
            if i * blocks % TIMED_SPAN == 0:
                for o in outs:
                    o.clear()
                feed(eng, audio)
            call()
        torch.cuda.synchronize()
        return eng.latency_histogram()

    step = run(eng.step, FLEET_TIMED_CALLS, 1)
    many = run(lambda: eng.step_many(TIMED_SPAN), 4, TIMED_SPAN)
    return {"step_p50": step["p50_ms"], "step_p99": step["p99_ms"],
            "many_p50": many["p50_ms"]}


def phase14_sharded_fleet(card: str) -> dict:
    """[14] (a) the voice preset's fleet at 1024 streams (the builtin presets
    of its topology round-robin, mic_capture audio, FLEET_BLOCKS blocks)
    unsharded and over fleet meshes of 2 and 4 shards on the one card: the
    audio against the unsharded run (1e-4 RMS, 1e-3 max), the launches per
    block exactly the shard count times the unsharded engine's, each shard's
    replay alone and all of them back to back (CUDA events), step() p50/p99,
    step_many per block and the peak memory; (b) 8 streams over 2 shards on
    the card against 2 shards on the CPU (1e-3 RMS, as [5] holds); (c) the
    68-candidate sweep with a 2-shard mesh against none (1e-5 on every
    float); (d) ``dryrun_multichip(2)`` on the card; (e) ``run --preset`` as
    a subprocess on the card, and ``capture_preset`` after ``apply_preset``
    equal to the preset. Returns the launches of (a)'s runs."""
    import os
    import tempfile

    from audioforge_tpu_torch import BUILTIN_PRESETS, api, kernels, save_preset
    from audioforge_tpu_torch.parallel import dryrun_multichip, fleet_mesh
    from audioforge_tpu_torch.runtime.preset_io import apply_preset, capture_preset
    from audioforge_tpu_torch.runtime.processor import AudioProcessor

    audio = mic_capture(FLEET, FLEET_BLOCKS, 41)
    total = collections.Counter()
    ref, per_block = None, None
    for shards in FLEET_SHARDS:
        where = ({"device": DEVICE} if shards == 1 else
                 {"sharding": fleet_mesh(devices=[f"{DEVICE}:0"] * shards)})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # earlier phases' tensors, not the fleet's
        t0 = time.perf_counter()
        eng, outs, names = preset_fleet_engine(FLEET, audio, **where)
        eng.step()  # captures every shard's graph
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        for _ in range(9):
            eng.step()
        eng.step_many(FLEET_BLOCKS - 10)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)
        total.update(counts)
        peak = _check_output(outs, FLEET_BLOCKS, FLEET)
        y = np.stack([np.concatenate(o) for o in outs])
        blocks = FLEET_BLOCKS - 1
        got = {k: v / blocks for k, v in counts.items()}
        _check_per_block(counts, {k: v * shards for k, v in FLEET_PATH.items()}, blocks,
                         f"{shards}-shard fleet")
        summed = eng.shard_diagnostics()["launches_per_block"]
        check({k: v for k, v in got.items() if v} == {k: float(v) for k, v in summed.items()},
              f"shard_diagnostics launches {summed} are not the counted {got}")
        if ref is None:
            ref, per_block = y, got
            err_rms = err_max = 0.0
        else:
            check(got == {k: v * shards for k, v in per_block.items()},
                  f"{shards} shards launch {got} a block, not {shards} x {per_block}")
            diff = y.astype(np.float64) - ref
            err_rms, err_max = float(np.sqrt(np.mean(diff ** 2))), float(np.abs(diff).max())
            check(err_rms <= 1e-4 and err_max <= 1e-3,
                  f"{shards}-shard fleet differs from the unsharded one: RMS {err_rms:.3e}, "
                  f"max {err_max:.3e}")
        replays = [cuda_ms(sh._graph.replay, 50) for sh in eng._shards]
        together = cuda_ms(lambda: [sh._graph.replay() for sh in eng._shards], 50)
        times = _fleet_timing(eng, outs, audio)
        mem = (torch.cuda.max_memory_allocated() - held) / 2**20
        print(f"[14] preset fleet at {FLEET}, {shards} shard(s) on {DEVICE}:0 ({card}): "
              f"presets {names}; built and first step {build_s:.2f} s (captures "
              f"{eng.capture_seconds:.3f} s); launches a block {got}; peak {peak:.4f}; against "
              f"unsharded RMS {err_rms:.3e} max {err_max:.3e} (bit-equal "
              f"{bool(np.array_equal(y, ref))}); each shard's replay alone "
              f"{', '.join(f'{r:.3f}' for r in replays)} ms, all shards back to back "
              f"{together:.3f} ms; step() p50 {times['step_p50']:.3f} ms p99 "
              f"{times['step_p99']:.3f} ms over {FLEET_TIMED_CALLS}; step_many({TIMED_SPAN}) "
              f"{times['many_p50']:.3f} ms per block; peak device memory {mem:.0f} MiB above the "
              f"{held / 2**20:.0f} MiB held before the engine",
              flush=True)
        del eng, outs

    # (b) card against CPU, both sharded
    small = mic_capture(FLEET_CPU_STREAMS, FLEET_CPU_BLOCKS, 42)
    ys = {}
    t0 = time.perf_counter()
    for dev in (f"{DEVICE}:0", "cpu"):
        eng, outs, _ = preset_fleet_engine(FLEET_CPU_STREAMS, small,
                                           sharding=fleet_mesh(devices=[dev] * 2))
        eng.step_many(FLEET_CPU_BLOCKS)
        ys[dev] = np.stack([np.concatenate(o) for o in outs])
    diff = ys[f"{DEVICE}:0"].astype(np.float64) - ys["cpu"]
    rms = float(np.sqrt(np.mean(diff ** 2)))
    cpu_rms = float(np.sqrt(np.mean(ys["cpu"].astype(np.float64) ** 2)))
    print(f"[14] card against CPU, {FLEET_CPU_STREAMS} streams over 2 shards, "
          f"{FLEET_CPU_BLOCKS} blocks: RMS diff {rms:.3e} (tol 1e-3), max "
          f"{np.abs(diff).max():.3e}, output RMS {cpu_rms:.3e} (at least "
          f"{LIVE_MIN_RMS:g}); {time.perf_counter() - t0:.1f} s", flush=True)
    check(rms <= 1e-3, "the sharded fleet differs between the card and the CPU")
    check(cpu_rms >= LIVE_MIN_RMS, f"the CPU fleet's output RMS {cpu_rms:.3e} is too "
          "small to compare against")

    # (c) the 68-candidate sweep, 2 shards against none
    rng = np.random.default_rng(12)
    cands = [{"threshold_db": float(t), "ratio": float(r), "attack_ms": float(a),
              "release_ms": float(rel)} for t, r, a, rel in zip(
        rng.uniform(-40, -10, SIM_CANDIDATES), rng.uniform(1.5, 8, SIM_CANDIDATES),
        rng.uniform(1, 30, SIM_CANDIDATES), rng.uniform(40, 400, SIM_CANDIDATES))]
    take = sim_take(FS, SIM_SECONDS, 90)
    bands = [(80.0, -2.0, 1.0), (160.0, 0.0, 1.41), (320.0, 1.5, 1.0), (640.0, 0.0, 1.41),
             (1280.0, 2.0, 1.41), (2500.0, 0.0, 1.41), (5000.0, -1.5, 2.0),
             (8000.0, 0.0, 1.41), (12000.0, 0.0, 1.41), (16000.0, 1.0, 0.7)]
    mesh = fleet_mesh(devices=[f"{DEVICE}:0"] * 2)
    sweeps, secs = {}, {}
    for label, kw in (("none", {"device": DEVICE}), ("2 shards", {"mesh": mesh})):
        api.simulate_auto_eq_chain_batched(take, 48000, bands, None, cands, **kw)
        t0 = time.perf_counter()
        sweeps[label] = api.simulate_auto_eq_chain_batched(take, 48000, bands, None, cands,
                                                           **kw)
        secs[label] = time.perf_counter() - t0
    worst = max(abs(float(a[k]) - float(b[k])) for a, b in zip(sweeps["none"], sweeps["2 shards"])
                for k in a if isinstance(a[k], float) and not k.endswith("runtime_ms"))
    check(len(sweeps["2 shards"]) == SIM_CANDIDATES, "the sharded sweep lost candidates")
    print(f"[14] sweep of {SIM_CANDIDATES} candidates on a {SIM_SECONDS:g} s take: unsharded "
          f"{secs['none']:.3f} s, 2 shards {secs['2 shards']:.3f} s; max difference "
          f"{worst:.3e} (tol 1e-5) ({card})", flush=True)
    check(worst <= 1e-5, "the sharded sweep differs from the unsharded one")

    # (d) the dry run
    t0 = time.perf_counter()
    corpus = dryrun_multichip(2, devices=[f"{DEVICE}:0"] * 2)
    print(f"[14] dryrun_multichip(2) on the card: {corpus}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (e) run --preset on the card, and the preset's round trip
    preset = BUILTIN_PRESETS["aggressive_denoise"]
    proc = AudioProcessor(device=DEVICE)
    check(apply_preset(proc, preset) is None, "apply_preset fell back")
    captured = capture_preset(proc)
    want, got_d = preset.to_dict(), captured.to_dict()
    same = all(got_d[k] == want[k] for k in ("gate", "rnnoise", "deesser", "compressor",
                                             "limiter", "bypass"))
    check(same and captured.eq.band_gains == preset.eq.band_gains
          and captured.eq.band_qs == preset.eq.band_qs,
          "capture_preset after apply_preset differs from the preset")
    with tempfile.TemporaryDirectory() as home:
        old_home = os.environ.get("HOME")
        os.environ["HOME"] = home
        try:
            path = save_preset(preset)
        finally:
            if old_home is None:
                del os.environ["HOME"]
            else:
                os.environ["HOME"] = old_home
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "audioforge_tpu_torch", "run", "--preset", str(path),
             "--duration", str(PRESET_RUN_S)], capture_output=True, text=True,
            timeout=300, env=dict(os.environ, HOME=home))
    print(f"[14] run --preset {path.name} --duration {PRESET_RUN_S:g} on the card: exit "
          f"{done.returncode} in {time.perf_counter() - t0:.1f} s; "
          f"{done.stdout.strip().splitlines()[-1:]}; capture_preset after apply_preset "
          f"equals the preset", flush=True)
    check(done.returncode == 0, f"run --preset failed: {done.stderr[-2000:]}")
    return dict(total)


def timed_phase(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"{label}: {time.perf_counter() - t0:.1f} s wall-clock", flush=True)
    return out


def main() -> int:
    t0 = time.perf_counter()
    card = phase0_device()
    timed_phase("[1] build", phase1_build)
    res = Results(card)
    timed_phase("[2] kernels", lambda: (phase2_pr1_kernels(res), phase2_gate(res),
                                        phase2_deesser(res), phase2_cleanup(res),
                                        phase2_models(res), phase2_offline(res),
                                        phase2_torch_stages(card)))
    timed_phase("[3] default path", phase3_default, card)
    counts = timed_phase("[4] full chain", phase4_full_chain, card)
    # a model stage's kernels: their launches on their own path's run
    vad = timed_phase("[8] VAD-on path", phase_model_path, card, "VAD-on", "[8]")
    dfn_ll = timed_phase("[9] DFN3-LL path", phase_model_path, card, "DFN3-LL", "[9]")
    dfn = timed_phase("[10] DFN3 standard path", phase_model_path, card, "DFN3 standard",
                      "[10]")
    for name in ("vad_front", "vad_lstm_head"):
        counts[name] = vad[name]
    for name in ("dfn_features", "dfn_spec_synth"):
        counts[name] = dfn_ll[name] + dfn[name]
    timed_phase("[5] card against CPU", phase5_card_vs_cpu)
    timed_phase("[6] profile", phase6_profile, card)
    timed_phase("[7] graph against eager", lambda: (phase7_graph_vs_eager(card),
                                                    phase7_dfn_graph_vs_eager(card)))
    timed_phase("[11] offline chain", phase11_offline_chain, card)
    timed_phase("[12] simulators", phase12_simulators, card)
    live = timed_phase("[13] live engine", phase13_live_engine, card)
    for name, k in live.items():
        counts[name] = counts.get(name, 0) + k
    # this slice's path: the fleet's launches, counted from 0 just before it
    fleet = timed_phase("[14] sharded preset fleet", phase14_sharded_fleet, card)
    for name, k in fleet.items():
        counts[name] = counts.get(name, 0) + k
    print(f"all phases: {time.perf_counter() - t0:.1f} s wall-clock", flush=True)
    table = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
              "launches": counts[name], **res.rows[name]}
             for name, (src, rep) in SOURCES.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
