"""4x true-peak detector and final safety limiter.

Counterpart of ``audioforge_tpu/ops/true_peak.py``: a 127-tap Kaiser
(beta 10) interpolator split into 4 polyphase branches of 32 taps; the
per-sample estimate is the max of |x| and the 4 interpolated |values|. The
FIR is plain tensor code (``unfold`` of the history-extended block times a
``[32, 4]`` coefficient matrix); the limiter's gain stage (target gain,
release recurrence, delayed input times gain, clamp, gain statistics) is one
:func:`~.scan.limiter_gain_scan` call (one kernel launch on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cache

import numpy as np
import torch

from . import util
from .scan import limiter_gain_scan

__all__ = [
    "PHASES", "TAPS_PER_PHASE", "LIMITER_LOOKAHEAD_SAMPLES",
    "polyphase_coefficients", "detector_init", "detector_process",
    "TruePeakLimiterConfig", "tp_limiter_init", "tp_limiter_process",
]

PHASES = 4
TAPS_PER_PHASE = 32
NUM_TAPS = 127
KAISER_BETA = 10.0
LIMITER_LOOKAHEAD_SAMPLES = 20
_H = TAPS_PER_PHASE - 1


def _kaiser_lowpass(num_taps: int, cutoff: float, beta: float) -> np.ndarray:
    n = np.arange(num_taps, dtype=np.float64)
    center = (num_taps - 1) / 2.0
    offset = n - center
    sinc = np.where(
        np.abs(offset) < 1e-12,
        2.0 * cutoff,
        np.sin(2.0 * np.pi * cutoff * offset)
        / (np.pi * np.where(offset == 0, 1.0, offset)),
    )
    window = (np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - (offset / center) ** 2)))
              / np.i0(beta))
    taps = sinc * window
    return taps / taps.sum()


def polyphase_coefficients(num_taps: int = NUM_TAPS, phases: int = PHASES,
                           beta: float = KAISER_BETA) -> np.ndarray:
    """``[phases, taps_per_phase]`` split of the 4x interpolator; branch p
    holds impulse taps p, p+phases, ... applied newest-first."""
    taps_per_phase = -(-num_taps // phases)
    impulse = _kaiser_lowpass(num_taps, 1.0 / (2.0 * phases), beta) * phases
    out = np.zeros((phases, taps_per_phase), np.float64)
    for p in range(phases):
        branch = impulse[p::phases]
        out[p, : len(branch)] = branch
    return out


# applied to oldest-first windows: column p = branch p reversed
_FIR_OLDEST_FIRST = np.ascontiguousarray(
    polyphase_coefficients().astype(np.float32)[:, ::-1].T)  # [32, 4]


# cached without bound: the serving engine's captured CUDA graph reads the
# taps by address
@cache
def _fir(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_FIR_OLDEST_FIRST, device=device)


def _interp_peaks(ext, T: int):
    """Per-sample true peak of the last ``T`` samples of ``ext [N, H + T]``."""
    fir = _fir(ext.device)
    windows = ext.unfold(-1, TAPS_PER_PHASE, 1)  # [N, T, 32], oldest first
    interp = torch.matmul(windows, fir)  # [N, T, 4]
    return torch.maximum(interp.abs().amax(dim=-1), ext[:, _H:].abs())


def _scrub(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def detector_init(*, n: int, device) -> dict:
    return {"history": torch.zeros((n, _H), dtype=torch.float32, device=device),
            "last_peak": torch.zeros(n, dtype=torch.float32, device=device)}


def detector_process(state, x):
    """Block true peak. Returns ``(new_state, block_peak [N])``."""
    x = _scrub(x)
    ext = torch.cat([state["history"], x], dim=-1)
    block_peak = _interp_peaks(ext, x.shape[-1]).amax(dim=-1)
    return {"history": ext[:, -_H:].contiguous(), "last_peak": block_peak}, block_peak


@dataclass(frozen=True)
class TruePeakLimiterConfig:
    ceiling_db: float = -1.0
    release_ms: float = 20.0
    sample_rate: float = 48000.0

    @property
    def release_coeff(self) -> float:
        return util.time_constant_to_coeff(self.release_ms / 1000.0,
                                           self.sample_rate)


def tp_limiter_init(*, n: int, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "delay": torch.zeros((n, LIMITER_LOOKAHEAD_SAMPLES), **f32),
        "gain": torch.ones(n, **f32),
        "peak_gr_db": torch.zeros(n, **f32),
        "in_hist": torch.zeros((n, _H), **f32),
        "out_hist": torch.zeros((n, _H), **f32),
        "last_input_tp": torch.zeros(n, **f32),
        "last_output_tp": torch.zeros(n, **f32),
    }


def tp_limiter_process(config: TruePeakLimiterConfig, state, x, ceiling_linear):
    """Final safety limiting of ``x: f32 [N, T]`` at the per-stream
    ``ceiling_linear [N]``. Returns ``(new_state, y, stats)``."""
    rc = torch.full_like(ceiling_linear, config.release_coeff)
    x = _scrub(x)
    T = x.shape[-1]
    in_ext = torch.cat([state["in_hist"], x], dim=-1)
    itp = _interp_peaks(in_ext, T)
    dly_ext = torch.cat([state["delay"], x], dim=-1)
    # the target stops 0.1 % under the ceiling; the delayed input is the
    # delay-extended block's first T samples
    y, gain_last, min_gain, events = limiter_gain_scan(
        itp, dly_ext[:, :T], ceiling_linear, rc, state["gain"], 0.999)
    y = _scrub(y)
    out_ext = torch.cat([state["out_hist"], y], dim=-1)
    otp = _interp_peaks(out_ext, T)
    gr_db = torch.where(min_gain < 1.0,
                        -util.linear_to_db(torch.clamp_min(min_gain, 1e-10)), 0.0)
    stats = {
        "limited_events": events,
        "input_true_peak": itp.amax(dim=-1),
        "output_true_peak": otp.amax(dim=-1),
        "max_gain_reduction_db": gr_db,
    }
    new_state = {
        "delay": dly_ext[:, -LIMITER_LOOKAHEAD_SAMPLES:].contiguous(),
        "gain": gain_last,
        "peak_gr_db": torch.maximum(state["peak_gr_db"], gr_db),
        "in_hist": in_ext[:, -_H:].contiguous(),
        "out_hist": out_ext[:, -_H:].contiguous(),
        "last_input_tp": itp[:, -1].contiguous(),
        "last_output_tp": otp[:, -1].contiguous(),
    }
    return new_state, y, stats
