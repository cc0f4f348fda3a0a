"""Post-chain output write conditioning: drift retiming + discontinuity fade.

A copy of ``audioforge_tpu/runtime/output_writer.py`` (numpy, behaviour
unchanged). Mirrors `processor/output_writer.rs:112-192` and
`processor/resampling.rs:81-120`:

- **Drift retiming** keeps the output queue near its target centre
  (mid of 30 ms prime / 40 ms high): the fill error feeds an 0.85/0.15 EMA,
  normalised against the distance to the hard-backlog (60 ms) or empty
  bound, scaled by the ±0.008 max adjust, clamped to [0.96, 1.03]; at or
  above the hard backlog the emergency 1.06 catch-up ratio applies. Blocks
  are linearly resampled by that ratio.
- **Discontinuity fade**: after a drop/underrun recovery, the next 6 ms of
  output ramp in linearly to mask the splice.

The retime itself is a host-side numpy kernel — it conditions the playback
staging queue, which lives on the host next to the output callback, not on
the device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["OutputWriteController", "retime_audio_block"]

OUTPUT_PRIME_MS = 30.0  # `processor.rs:64`
OUTPUT_TARGET_HIGH_MS = 40.0  # `processor.rs:65`
OUTPUT_HARD_BACKLOG_MS = 60.0  # `processor.rs:66`
OUTPUT_DRIFT_MAX_RATIO_ADJUST = 0.008  # `processor.rs:67`
OUTPUT_DRIFT_MAX_EXPANSION_RATIO = 0.96  # `processor.rs:68`
OUTPUT_MAX_CATCHUP_RATIO = 1.03  # `dsp_loop.rs:789-790`
OUTPUT_MAX_EMERGENCY_CATCHUP_RATIO = 1.06
DISCONTINUITY_FADE_MS = 6.0  # `dsp_loop.rs:794-795`


def retime_audio_block(block: np.ndarray, speed_ratio: float,
                       max_output_len: int | None = None) -> np.ndarray:
    """Linear-interpolation retime (`resampling.rs:81-120`): output length
    ``round(len/ratio)``; ratio 1.0 (or len unchanged) returns the input."""
    x = np.asarray(block, np.float32)
    if x.size == 0 or (max_output_len is not None and max_output_len == 0):
        return np.zeros(0, np.float32)
    ratio = max(float(speed_ratio), 0.5)
    desired = max(int(round(x.size / ratio)), 1)
    if max_output_len is not None:
        desired = min(desired, int(max_output_len))
    if desired == x.size:
        return x
    if desired == 1:
        return x[:1]
    src = np.minimum(np.arange(desired, dtype=np.float32) * ratio,
                     np.float32(x.size - 1))
    idx0 = np.floor(src).astype(np.int64)
    idx1 = np.minimum(idx0 + 1, x.size - 1)
    frac = src - idx0
    return (x[idx0] + (x[idx1] - x[idx0]) * frac).astype(np.float32)


class OutputWriteController:
    """Per-stream drift/fade state (`output_writer.rs:112-192`)."""

    def __init__(self, sample_rate: float = 48000.0,
                 block_multiple: int = 1):
        fs = float(sample_rate)
        # A host step of H blocks writes H*10 ms at once, so the queue
        # naturally swings by a full step: the control targets scale with
        # the step or the drift law would retime the swing away as if it
        # were clock drift. H=1 keeps the reference's 30/40/60 ms targets.
        step = max(1, int(block_multiple)) * int(round(0.01 * fs))
        low = max(int(round(OUTPUT_PRIME_MS / 1e3 * fs)),
                  step + int(round(0.01 * fs)))
        high = max(int(round(OUTPUT_TARGET_HIGH_MS / 1e3 * fs)),
                   step + int(round(0.02 * fs)))
        self.target_center_samples = -(-(low + high) // 2)
        self.hard_backlog_samples = max(
            int(round(OUTPUT_HARD_BACKLOG_MS / 1e3 * fs)),
            2 * step + int(round(0.02 * fs)))
        self.fade_samples = max(1, int(round(DISCONTINUITY_FADE_MS / 1e3 * fs)))
        self.prime_samples = low
        self._drift_error_ema = 0.0
        self._fade_remaining = 0
        self.retime_adjustment_count = 0
        self.jitter_dropped_samples = 0

    def mark_discontinuity(self) -> None:
        """Arm the 6 ms fade-in after a drop (`dsp_loop.rs:794-795`)."""
        self._fade_remaining = self.fade_samples

    def speed_ratio(self, fill: int, blocks: int = 1) -> float:
        """Queue-fill control law (`output_writer.rs:121-138`).

        ``blocks`` is how many 10 ms blocks this call covers: a fused
        drain burst passes the whole span through one call, so the EMA
        coefficient is compounded to keep the control law's time constant
        in wall time rather than in call count."""
        error = float(fill) - self.target_center_samples
        keep = 0.85 ** max(int(blocks), 1)
        self._drift_error_ema = (
            self._drift_error_ema * keep + error * (1.0 - keep)
        )
        positive_zone = max(
            self.hard_backlog_samples - self.target_center_samples, 1
        )
        negative_zone = max(self.target_center_samples, 1)
        if self._drift_error_ema >= 0.0:
            normalized = min(self._drift_error_ema / positive_zone, 1.0)
        else:
            normalized = max(self._drift_error_ema / negative_zone, -1.0)
        ratio = 1.0 + normalized * OUTPUT_DRIFT_MAX_RATIO_ADJUST
        ratio = min(max(ratio, OUTPUT_DRIFT_MAX_EXPANSION_RATIO),
                    OUTPUT_MAX_CATCHUP_RATIO)
        if fill >= self.hard_backlog_samples:
            ratio = OUTPUT_MAX_EMERGENCY_CATCHUP_RATIO
        return ratio

    def condition(self, block: np.ndarray, fill: int,
                  blocks: int = 1) -> np.ndarray:
        """Retime for drift, then apply any pending discontinuity fade."""
        block = np.asarray(block, np.float32)
        ratio = self.speed_ratio(fill, blocks)
        adjusted = retime_audio_block(block, ratio)
        if adjusted.size != block.size:
            self.retime_adjustment_count += 1
            if adjusted.size < block.size:
                self.jitter_dropped_samples += block.size - adjusted.size

        if self._fade_remaining > 0 and adjusted.size:
            adjusted = adjusted.copy()
            fade_count = min(self._fade_remaining, adjusted.size)
            elapsed = self.fade_samples - self._fade_remaining
            progress = np.clip(
                (elapsed + 1 + np.arange(fade_count)) / float(self.fade_samples),
                0.0, 1.0,
            ).astype(np.float32)
            adjusted[:fade_count] *= progress
            self._fade_remaining -= fade_count
        return adjusted
