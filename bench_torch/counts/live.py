"""Operations and bytes of one block of the live engine at one stream
(``AudioProcessor``, the ``live_rnnoise`` configuration): the chain's two
halves and the RNNoise frame, counted as one stream's serving block counts
them (:func:`~bench_torch.counts.step_stages`: the same ``front_block``,
frame and ``back_block``), and the Silero worker's share. The worker infers
one window of 512 samples at 16 kHz, 1,536 at 48 kHz, every 3.2 blocks: its
decimation into the 576-sample window, the model (STFT basis, four Conv1d,
the LSTM cell) and the head, a 480 / 1,536 share of each a block.
"""

from __future__ import annotations

from pathlib import Path

from . import BLOCK, PEAKS, Stage, _archive, _numel, silero_macs, step_stages

WINDOW_IN = 1536             # the worker's window at 48 kHz
WINDOW_SHARE = BLOCK / WINDOW_IN


def serving_view(config: dict) -> dict:
    """The live configuration as the serving counts read one: its chain's
    topology, the suppressor, no in-step VAD."""
    topo = config["controls"]["topology"]
    return {"serving": {"suppressor_model": topo["noise_model"] if topo["suppressor_enabled"]
                        else None, "vad_enabled": False},
            "chain": {"cleanup_mode": topo["cleanup_mode"],
                      "deesser_enabled": topo["deesser_enabled"],
                      "gate_mode": topo["gate_mode"]},
            "archives": config["archives"]}


def vad_window_stages(shapes: dict) -> list:
    """One window of the Silero worker at one stream: the 3:1 decimation of
    1,536 samples by a 31-tap FIR into the 576-sample window (64 of
    context), the model's multiply-adds, the head's LSTM cell, EMA and
    calibration."""
    w = 4 * _numel(shapes, shapes)
    return [Stage("Silero worker: decimation and window", 1,
                  4 * (WINDOW_IN + 30 + 576 + 576), 2 * 512 * 31 + 1024),
            Stage("Silero worker: STFT, encoder and LSTM", 1,
                  w + 4 * (576 + 2 * 258 * 4 + 128 * 4 + 2 * 512),
                  2 * silero_macs(shapes)["layers"]),
            Stage("Silero worker: head", 1, 4 * (512 + 128 + 256 + 6), 128 * 114)]


def live_stages(config: dict, root: Path) -> list:
    """The stages of one block of the live engine at one stream under
    ``config`` (a live configuration file's dict), the worker's windows at
    their share of a block."""
    stages = step_stages(serving_view(config), 1, root)
    shapes = _archive(root / config["archives"]["vad"])
    return stages + [Stage(s.name, s.launches * WINDOW_SHARE, s.bytes, s.f32_ops, s.f64_ops)
                     for s in vad_window_stages(shapes)]


def live_totals(config: dict, root: Path) -> dict:
    """One block at one stream: its f32 and f64 operations, their time at
    the peaks, and the sum of its stages' bounds, in seconds."""
    stages = live_stages(config, root)
    f32 = sum(s.launches * s.f32_ops for s in stages)
    f64 = sum(s.launches * s.f64_ops for s in stages)
    return {"f32_ops": f32, "f64_ops": f64,
            "peak_s": f32 / PEAKS["f32_flops_per_s"] + f64 / PEAKS["f64_flops_per_s"],
            "bound_s": sum(s.bound_s() for s in stages)}
