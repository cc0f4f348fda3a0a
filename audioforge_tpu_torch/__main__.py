"""Command line of the port.

- ``devices``: list the virtual audio endpoints.
- ``run``: run the single-stream live engine (``AudioProcessor``) on named
  devices, on the card unless ``--device cpu``.
- ``diagnostics``: start the live engine, let it settle, print its
  diagnostics dict.
- ``serve a.wav b.wav ...``: process N 48 kHz mono 16-bit WAVs together
  through the batched serving engine (live chain and a suppressor per
  stream, the in-step Silero VAD with ``--vad``) and write
  ``<name>.processed.wav`` for each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import wave
from pathlib import Path

import numpy as np


def _read_wav_48k_mono(path):
    """48 kHz, mono, 16-bit PCM only; anything else is an error."""
    with wave.open(str(path), "rb") as handle:
        if handle.getframerate() != 48000 or handle.getnchannels() != 1:
            raise ValueError(f"{path} must be 48 kHz mono")
        if handle.getsampwidth() != 2:
            raise ValueError(f"{path} must be 16-bit PCM (got sample width "
                             f"{handle.getsampwidth() * 8} bits)")
        raw = handle.readframes(handle.getnframes())
    return np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0


def _cmd_devices(_args) -> int:
    from .runtime.processor import list_input_devices, list_output_devices

    for direction, devices in (("input", list_input_devices()),
                               ("output", list_output_devices())):
        for d in devices:
            default = " (default)" if d.is_default else ""
            print(f"{direction}: {d.name}{default} @ {d.sample_rate} Hz")
    return 0


def _cmd_run(args) -> int:
    from .runtime.processor import AudioProcessor

    if args.preset:
        raise NotImplementedError(
            "run --preset needs the preset layer (config/, preset_io), which is "
            "not ported yet (ROADMAP queue 1 item 8)")
    processor = AudioProcessor(device=args.device)
    print(processor.start(args.input_device, args.output_device))
    try:
        deadline = time.monotonic() + args.duration if args.duration else None
        while deadline is None or time.monotonic() < deadline:
            time.sleep(1.0)
            processor.service_recovery()
            if args.verbose:
                d = processor.get_runtime_diagnostics()
                print(
                    f"in {d['input_crest_factor_db']:.0f}dB CF | "
                    f"lufs {d['output_short_term_lufs']:.1f} | "
                    f"gr {d['limiter_gain_reduction_db']:.1f} dB | "
                    f"drops {d['input_dropped_samples']}"
                )
    except KeyboardInterrupt:
        pass
    finally:
        processor.stop()
    return 0


def _cmd_diagnostics(args) -> int:
    from .runtime.processor import AudioProcessor

    processor = AudioProcessor(device=args.device)
    print(processor.start(args.input_device, args.output_device))
    try:
        time.sleep(args.settle)
        print(json.dumps(processor.get_runtime_diagnostics(), indent=2,
                         default=str))
    finally:
        processor.stop()
    return 0


def _cmd_serve(args) -> int:
    from .runtime import live_chain as lc
    from .runtime.serving import BLOCK, ServingConfig, ServingEngine

    paths = [Path(p) for p in args.inputs]
    audios = [_read_wav_48k_mono(p) for p in paths]
    n_blocks = max(-(-a.size // BLOCK) for a in audios)
    cfg = ServingConfig(
        capacity=len(paths),
        suppressor_model=None if args.suppressor == "none" else args.suppressor,
        vad_enabled=args.vad,
        chain=lc.LiveChainConfig(deesser_enabled=args.deesser))
    engine = ServingEngine(cfg, device=args.device)
    outputs = [[] for _ in paths]
    for i, audio in enumerate(audios):
        slot = engine.attach(sink=lambda blk, i=i: outputs[i].append(blk.copy()))
        padded = np.zeros(n_blocks * BLOCK, np.float32)
        padded[: audio.size] = audio
        engine.push(slot, padded)

    start = time.perf_counter()
    done = 0
    while done < n_blocks:
        span = min(args.span, n_blocks - done)
        engine.step_many(span)
        done += span
    elapsed = time.perf_counter() - start

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for path, audio, blocks in zip(paths, audios, outputs):
        y = np.concatenate(blocks)[: audio.size]
        out = out_dir / f"{path.stem}.processed.wav"
        with wave.open(str(out), "wb") as handle:
            handle.setnchannels(1)
            handle.setsampwidth(2)
            handle.setframerate(48000)
            handle.writeframes(
                (np.clip(y, -1.0, 1.0) * 32767.0).astype("<i2").tobytes())
        print(f"wrote {out}")
    audio_s = sum(a.size for a in audios) / 48000.0
    print(f"{len(paths)} streams, {audio_s:.1f} audio-s in {elapsed:.1f}s on "
          f"{engine.device} ({audio_s / max(elapsed, 1e-9):.1f}x realtime "
          "aggregate)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="audioforge_tpu_torch",
        description="PyTorch/CUDA port of audioforge: the live engine and the "
                    "serving engine.")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("devices", help="list virtual audio endpoints")

    run = sub.add_parser("run", help="run the single-stream live engine")
    run.add_argument("--input-device", default=None)
    run.add_argument("--output-device", default=None)
    run.add_argument("--device", default="cuda",
                     help="torch device: cuda (default) or cpu")
    run.add_argument("--preset", default=None,
                     help="path to a preset .json (not ported yet)")
    run.add_argument("--duration", type=float, default=0.0,
                     help="seconds to run (0 = until interrupted)")
    run.add_argument("--verbose", action="store_true")

    diag = sub.add_parser("diagnostics",
                          help="start, settle, print the diagnostics dict")
    diag.add_argument("--input-device", default=None)
    diag.add_argument("--output-device", default=None)
    diag.add_argument("--device", default="cuda",
                      help="torch device: cuda (default) or cpu")
    diag.add_argument("--settle", type=float, default=2.0)

    serve = sub.add_parser(
        "serve", help="process N WAVs together through the batched serving engine")
    serve.add_argument("inputs", nargs="+", help="48 kHz mono 16-bit WAV files")
    serve.add_argument("--output-dir", default="processed")
    serve.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")
    serve.add_argument("--suppressor", default="rnnoise",
                       choices=("none", "rnnoise", "deepfilter-ll", "deepfilter"))
    serve.add_argument("--vad", action="store_true",
                       help="run the batched in-step Silero VAD")
    serve.add_argument("--deesser", action="store_true")
    serve.add_argument("--span", type=int, default=100,
                       help="blocks per step_many call")
    args = parser.parse_args(argv)
    commands = {"devices": _cmd_devices, "run": _cmd_run,
                "diagnostics": _cmd_diagnostics, "serve": _cmd_serve}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
