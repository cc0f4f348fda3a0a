"""Streaming BS.1770 momentary loudness meter (block cadence).

Counterpart of ``audioforge_tpu/ops/loudness.py:48-187``: the K-weighting
pair (high shelf + high pass, designed from the analog prototypes) runs as
one two-section ``biquad_cascade`` launch with f64 state, and the 400 ms
window is a ring of per-block mean-square energies.

The meter's ``coeffs`` leaf is shared by every stream (``[2, 5]``, no stream
axis); the serving state marks it as such.
"""

from __future__ import annotations

import numpy as np
import torch

from . import biquad

__all__ = ["k_weighting_coefficients", "meter_init", "meter_process"]

_SHELF_F0 = 1681.9744509555319
_SHELF_GAIN_DB = 3.999843853973347
_SHELF_Q = 0.7071752369554196
_HP_F0 = 38.13547087602444
_HP_Q = 0.5003270373238773


def k_weighting_coefficients(sample_rate: float) -> np.ndarray:
    """``(2, 5)`` f64 normalised biquad coefficients [b0, b1, b2, a1, a2]."""
    fs = float(sample_rate)
    K = np.tan(np.pi * _SHELF_F0 / fs)
    Vh = 10.0 ** (_SHELF_GAIN_DB / 20.0)
    Vb = Vh ** 0.4996667741545416
    q = _SHELF_Q
    a0 = 1.0 + K / q + K * K
    shelf = np.array([
        (Vh + Vb * K / q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / q + K * K) / a0,
        2.0 * (K * K - 1.0) / a0,
        (1.0 - K / q + K * K) / a0,
    ])
    K = np.tan(np.pi * _HP_F0 / fs)
    q = _HP_Q
    a0 = 1.0 + K / q + K * K
    hp = np.array([1.0, -2.0, 1.0, 2.0 * (K * K - 1.0) / a0,
                   (1.0 - K / q + K * K) / a0])
    return np.stack([shelf, hp])


def meter_init(sample_rate: float = 48000.0, block_samples: int = 480, *,
               n: int, device) -> dict:
    n_ring = max(1, int(round(0.4 * sample_rate / block_samples)))
    coeffs = k_weighting_coefficients(sample_rate).astype(np.float32)
    return {
        "kz": torch.zeros((n, 2, 2), dtype=torch.float64, device=device),
        "ring": torch.zeros((n, n_ring), dtype=torch.float32, device=device),
        "filled": torch.zeros(n, dtype=torch.int32, device=device),
        "coeffs": torch.as_tensor(coeffs, device=device),
    }


def meter_process(state, x):
    """Feed ``x: f32 [N, T]``; returns ``(new_state, momentary_lufs [N])``
    (-100 until the 400 ms window has filled)."""
    y, kz = biquad.apply_fixed(state["coeffs"], state["kz"], x)
    energy = torch.mean(y * y, dim=-1)
    ring = torch.cat([state["ring"][:, 1:], energy[:, None]], dim=-1)
    n_ring = ring.shape[-1]
    filled = torch.clamp_max(state["filled"] + 1, n_ring)
    power = torch.mean(ring, dim=-1)
    lufs = torch.where(filled >= n_ring,
                       -0.691 + 10.0 * torch.log10(torch.clamp_min(power, 1e-30)),
                       -100.0)
    return ({"kz": kz, "ring": ring, "filled": filled,
             "coeffs": state["coeffs"]}, lufs)
