"""Deterministic control/DSP contention stress harness.

Mirrors `processor/stress_harness.rs:1-30` and
`rust-core/tests/stress_tests.rs:12-34`: a seeded LCG drives a storm of
control mutations (every stage's setters, noise-model switches, bypass
flips, EQ band edits) against a live engine while the DSP thread keeps
processing, and the run must end with finite, bounded output
(max |out| <= 16) and a responsive control surface.

The control path being exercised is the port's: control values written
into the graphs' static parameter tensors between bursts, topology switches
selecting cached graphs, crossfaded EQ edits, and the suppressor engine
swap. Counterpart of ``audioforge_tpu/runtime/stress_harness.py``; the
engine runs on ``device`` (a CUDA device unless asked otherwise).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .processor import (
    AudioProcessor,
    register_virtual_input,
    register_virtual_output,
)

__all__ = ["ControlDspStressReport", "run_seeded_control_dsp_stress"]

MAX_OUTPUT_ABS = 16.0  # `stress_tests.rs:30-34`


@dataclass
class ControlDspStressReport:
    """`stress_harness.rs:4-12`."""

    control_updates: int
    processed_blocks: int
    snapshot_rearms: int
    model_switches: int
    suppressor_resets: int
    max_output_abs: float


class _Lcg:
    """MMIX-constant LCG — deterministic across platforms
    (`stress_harness.rs:14-40`)."""

    def __init__(self, seed: int):
        self.state = max(int(seed), 1) & 0xFFFFFFFFFFFFFFFF

    def next_u64(self) -> int:
        self.state = (
            self.state * 6364136223846793005 + 1442695040888963407
        ) & 0xFFFFFFFFFFFFFFFF
        return self.state

    def unit(self) -> float:
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))

    def range(self, lo: float, hi: float) -> float:
        return lo + (hi - lo) * self.unit()

    def boolean(self) -> bool:
        return (self.next_u64() & 1) != 0

    def choice(self, n: int) -> int:
        return self.next_u64() % n


def run_seeded_control_dsp_stress(
    seed: int, iterations: int, realtime_pacing: bool = False, *,
    device="cuda",
) -> ControlDspStressReport:
    """Drive ``iterations`` seeded control mutations against a running
    engine; returns the contention report. Raises on a non-running engine."""
    if iterations <= 0:
        raise ValueError("iterations must be greater than zero")

    rng = _Lcg(seed)
    peak = {"value": 0.0}

    def sink(block):
        m = float(np.max(np.abs(block))) if len(block) else 0.0
        if m > peak["value"]:
            peak["value"] = m

    class _Source:
        def __init__(self):
            self.n = 0
            self.noise = np.random.default_rng(seed & 0xFFFFFFFF)

        def __call__(self, n):
            t = (self.n + np.arange(n)) / 48000.0
            self.n += n
            return (
                0.4 * np.sin(2.0 * np.pi * 220.0 * t)
                + 0.05 * self.noise.standard_normal(n)
            ).astype(np.float32)

    register_virtual_input("stress-source", _Source)
    register_virtual_output("stress-sink", lambda: sink)

    processor = AudioProcessor(device=device)
    processor.realtime_pacing = realtime_pacing
    processor.start("stress-source", "stress-sink")

    model_switches = 0
    suppressor_resets = 0
    try:
        # Pre-warm: wait until the tone source has actually been processed,
        # so the storm runs against live DSP (the reference's equivalent
        # processes 600 live updates against running DSP,
        # `stress_tests.rs:12-25`).
        warm_deadline = time.time() + 300.0
        while (processor._counters["blocks_processed"] < 10
               and time.time() < warm_deadline):
            time.sleep(0.02)
        if processor._counters["blocks_processed"] == 0:
            raise RuntimeError(
                "stress pre-warm processed no blocks within 300 s"
            )
        for _ in range(iterations):
            kind = rng.choice(10)
            if kind == 0:
                processor.set_gate_threshold(rng.range(-80.0, -10.0))
                processor.set_gate_attack(rng.range(0.1, 100.0))
                processor.set_gate_release(rng.range(10.0, 1000.0))
            elif kind == 1:
                processor.set_compressor_threshold(rng.range(-60.0, 0.0))
                processor.set_compressor_ratio(rng.range(1.0, 20.0))
                processor.set_compressor_makeup_gain(rng.range(0.0, 24.0))
            elif kind == 2:
                processor.set_limiter_ceiling(rng.range(-12.0, 0.0))
                processor.set_limiter_release(rng.range(10.0, 500.0))
            elif kind == 3:
                band = rng.choice(10)
                processor.set_eq_band_gain(band, rng.range(-12.0, 12.0))
            elif kind == 4:
                processor.set_rnnoise_strength(rng.range(0.0, 1.0))
            elif kind == 5:
                # model switch exercises the engine-swap handoff
                target = "rnnoise"
                if processor.set_noise_model(target):
                    model_switches += 1
            elif kind == 6:
                processor.set_bypass(rng.boolean())
            elif kind == 7:
                # de-esser numerics are topology (a graph per design), so
                # draw from a bounded set: the handoff is still exercised
                # without an unbounded capture storm
                processor.set_deesser_threshold_db(
                    (-48.0, -36.0, -24.0, -12.0)[rng.choice(4)]
                )
                processor.set_deesser_ratio((2.0, 4.0, 8.0)[rng.choice(3)])
            elif kind == 8:
                processor.set_rnnoise_enabled(rng.boolean())
                suppressor_resets += 1
            else:
                processor.set_vad_threshold(rng.range(0.05, 0.95))
                processor.set_gate_margin(rng.range(0.0, 20.0))
            if rng.choice(4) == 0:
                time.sleep(0.001)
        processor.set_bypass(False)
        # let the DSP thread drain the final control state AND accumulate a
        # meaningful processed-block count (>= 120 blocks = 1.2 s of audio)
        # so downstream gates can require real work, not a vacuous pass.
        # Gate on PROGRESS, not a fixed deadline: keep waiting while blocks
        # still arrive (a slow host processes fewer a second), bail only
        # after a 240 s stall, with a 600 s absolute cap. A dead engine is
        # already caught by the pre-warm raise above.
        hard_deadline = time.time() + 600.0
        target_blocks = max(
            processor._counters["blocks_processed"] + 5, 120
        )
        last_count = processor._counters["blocks_processed"]
        last_progress = time.time()
        while (processor._counters["blocks_processed"] < target_blocks
               and time.time() < hard_deadline
               and time.time() - last_progress < 240.0):
            time.sleep(0.02)
            now_count = processor._counters["blocks_processed"]
            if now_count != last_count:
                last_count = now_count
                last_progress = time.time()
        blocks = int(processor._counters["blocks_processed"])
    finally:
        processor.stop()

    report = ControlDspStressReport(
        control_updates=iterations,
        processed_blocks=blocks,
        snapshot_rearms=0,  # the control handoff has no seqlock retries
        model_switches=model_switches,
        suppressor_resets=suppressor_resets,
        max_output_abs=float(peak["value"]),
    )
    if not np.isfinite(report.max_output_abs):
        raise RuntimeError("stress run produced non-finite output")
    return report
