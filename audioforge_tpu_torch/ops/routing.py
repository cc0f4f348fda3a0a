"""Input conditioning: sanitize/clamp, block meters, DC blocker + 80 Hz HP.

Counterpart of the cleanup-OFF path of ``audioforge_tpu/ops/routing.py``
(``:223-270``, ``:530-559``). The DC blocker ``y = x - x1 + 0.995 y1`` and the
fixed 80 Hz high-pass (Q 0.707) run as one two-section ``biquad_cascade``
launch with f64 state, where the JAX package used host-built matmul
operators. Gentle and strong cleanup (hum tracking, rumble detection) are
not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import biquad

__all__ = [
    "CLEANUP_OFF", "CLEANUP_GENTLE", "CLEANUP_STRONG", "CLEANUP_MODES",
    "RoutingConfig", "routing_init", "sanitize_and_clamp_input",
    "sanitize_and_clamp_output", "meter_block_stats", "routing_process",
]

CLEANUP_OFF = 0
CLEANUP_GENTLE = 1
CLEANUP_STRONG = 2
CLEANUP_MODES = {"off": CLEANUP_OFF, "gentle": CLEANUP_GENTLE,
                 "strong": CLEANUP_STRONG}

DC_BLOCK_COEFF = 0.995
PREFILTER_HZ = 80.0
PREFILTER_Q = 0.707


@dataclass(frozen=True)
class RoutingConfig:
    sample_rate: float = 48000.0
    cleanup_mode: int = CLEANUP_OFF

    def __post_init__(self):
        if self.cleanup_mode not in CLEANUP_MODES.values():
            raise ValueError(f"unknown cleanup mode {self.cleanup_mode!r}")


@lru_cache(maxsize=4)
def _off_path_sections(sample_rate: float) -> np.ndarray:
    """DC blocker (b = [1, -1, 0], a = [1, -0.995, 0]) then the 80 Hz HP."""
    dc = np.array([1.0, -1.0, 0.0, -DC_BLOCK_COEFF, 0.0])
    hp = biquad.design(biquad.HIGH_PASS, PREFILTER_HZ, 0.0, PREFILTER_Q,
                       sample_rate)
    return np.stack([dc, hp]).astype(np.float32)


def routing_init(config: RoutingConfig, *, n: int, device) -> dict:
    """State the off path reads: the DC blocker's last input/output, the
    80 Hz HP's f64 DF2T state, and the (never tracked) hum line."""
    f = lambda: torch.zeros(n, dtype=torch.float32, device=device)
    return {
        "dc_x1": f(),
        "dc_y1": f(),
        "prefilter_z": torch.zeros((n, 2), dtype=torch.float64, device=device),
        "hum_line_hz": f(),
    }


def _peak_db(peak):
    return torch.where(peak > 0,
                       20.0 * torch.log10(torch.clamp_min(peak, 1e-30)),
                       -torch.inf)


def sanitize_and_clamp_input(x):
    """Returns (y, clip_count, clip_peak_db)."""
    x = torch.where(torch.isfinite(x), x, 0.0)
    amp = x.abs()
    clipped = amp > 1.0
    count = clipped.sum(dim=-1).to(torch.int32)
    peak = torch.where(clipped, amp, 0.0).amax(dim=-1)
    return torch.clamp(x, -1.0, 1.0), count, _peak_db(peak)


def sanitize_and_clamp_output(x, ceiling_linear):
    """``ceiling_linear``: per-stream ``[N]``. Returns (y, count, peak_db)."""
    ceiling = torch.clamp(ceiling_linear.to(torch.float32), 0.0, 1.0)[:, None]
    finite = torch.isfinite(x)
    x = torch.where(finite, x, 0.0)
    amp = x.abs()
    clipped = finite & (amp > ceiling)
    count = clipped.sum(dim=-1).to(torch.int32)
    peak = torch.where(clipped, amp, 0.0).amax(dim=-1)
    return torch.clamp(x, -ceiling, ceiling), count, _peak_db(peak)


def meter_block_stats(x, rms_acc, meter_coeff):
    """Per-block peak/rms/crest with the carried one-pole mean-square
    accumulator ``acc' = c^T acc + sum_k (1-c) c^(T-1-k) x_k^2``.
    Returns (stats, new_rms_acc)."""
    peak = x.abs().amax(dim=-1)
    c = meter_coeff.to(torch.float32)
    T = x.shape[-1]
    powers = x * x
    k = torch.arange(T, dtype=torch.float32, device=x.device)
    wts = torch.pow(c, T - 1.0 - k) * (1.0 - c)
    acc = torch.pow(c, float(T)) * rms_acc + (powers * wts).sum(dim=-1)
    peak_db = torch.where(peak > 0,
                          20.0 * torch.log10(torch.clamp_min(peak, 1e-30)), -120.0)
    rms_db = torch.where(acc > 0,
                         10.0 * torch.log10(torch.clamp_min(acc, 1e-30)), -120.0)
    stats = {
        "peak_db": peak_db,
        "rms_db": rms_db,
        "crest_factor_db": torch.clamp(peak_db - rms_db, 0.0, 80.0),
        "mean_power": powers.mean(dim=-1),
    }
    return stats, acc


def routing_process(config: RoutingConfig, state, x):
    """DC block + fixed 80 Hz high-pass of ``x: f32 [N, T]``. Returns
    ``(new_state, y, metrics)``."""
    if config.cleanup_mode != CLEANUP_OFF:
        raise NotImplementedError(
            "gentle/strong input cleanup is not ported yet (ROADMAP queue 1, "
            "routing cleanup)")
    n = x.shape[0]
    sections = _off_path_sections(config.sample_rate)
    a1_dc = float(sections[0, 3])  # -0.995 as stored (f32)
    # DC blocker in DF2T form: z1 = -a1 * y1 - x1, z2 = 0
    dc_z = torch.stack([
        -a1_dc * state["dc_y1"].to(torch.float64) - state["dc_x1"].to(torch.float64),
        torch.zeros(n, dtype=torch.float64, device=x.device)], dim=-1)
    z = torch.stack([dc_z, state["prefilter_z"]], dim=1)
    y, z_out = biquad.apply_fixed(sections, z, x)
    x_last = x[:, -1]
    # the DC section's last output, recovered from its final state
    # z1 = -x_last - a1 * y_last
    dc_y_last = (z_out[:, 0, 0] + x_last.to(torch.float64)) / -a1_dc
    new_state = {
        "dc_x1": x_last.contiguous(),
        "dc_y1": dc_y_last.to(torch.float32),
        "prefilter_z": z_out[:, 1].contiguous(),
        "hum_line_hz": state["hum_line_hz"],
    }
    zeros = torch.zeros(n, dtype=torch.float32, device=x.device)
    metrics = {
        "hum_detected": torch.zeros(n, dtype=torch.bool, device=x.device),
        "rumble_detected": torch.zeros(n, dtype=torch.bool, device=x.device),
        "hum_line_hz": state["hum_line_hz"],
        "hum_strength": zeros,
        "selected_hp_hz": torch.full_like(zeros, PREFILTER_HZ),
    }
    return new_state, y, metrics
