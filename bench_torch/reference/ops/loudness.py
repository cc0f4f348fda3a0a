"""BS.1770-4 loudness: the streaming momentary meter (block cadence) and
the offline gated integrated and momentary loudness of a take.

Counterpart of ``audioforge_tpu/ops/loudness.py``: the K-weighting pair (high
shelf + high pass, designed from the analog prototypes) runs in the meter as
one two-section ``biquad_cascade`` launch with f64 state, and the 400 ms
window is a ring of per-block mean-square energies. The offline helpers
(:func:`integrated_loudness_lufs`, :func:`momentary_slices_lufs`) are host
numpy/scipy, as in the reference.

The meter's ``coeffs`` leaf is shared by every stream (``[2, 5]``, no stream
axis); the serving state marks it as such.
"""

from __future__ import annotations

import numpy as np
import torch

from . import biquad


VALID_SAMPLE_RATES = (8000, 16000, 32000, 44100, 48000, 88200, 96000)

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


def _k_weight_np(x: np.ndarray, sample_rate: float) -> np.ndarray:
    """Host f64 K-weighting of a take."""
    from scipy.signal import lfilter

    y = x.astype(np.float64)
    for stage in k_weighting_coefficients(sample_rate):
        y = lfilter(stage[:3], np.concatenate([[1.0], stage[3:]]), y)
    return y


def _block_powers(y: np.ndarray, sample_rate: int, hop_s: float) -> np.ndarray:
    block = int(round(0.4 * sample_rate))
    hop = max(1, int(round(hop_s * sample_rate)))
    if len(y) < block:
        return np.empty(0)
    n = 1 + (len(y) - block) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(block)[None, :]
    return np.mean(y[idx] ** 2, axis=1)


def integrated_loudness_lufs(samples, sample_rate: int) -> float:
    """Gated mono integrated loudness: 400 ms blocks at 75 % overlap, the
    -70 LUFS absolute gate, then the -10 LU relative gate. Raises on a rate
    outside :data:`VALID_SAMPLE_RATES`, an empty or non-finite take, or a
    take with nothing above the gates."""
    sample_rate = int(sample_rate)
    if sample_rate not in VALID_SAMPLE_RATES:
        raise ValueError(f"invalid sample rate: {sample_rate}")
    x = np.asarray(samples, np.float64)
    if x.size == 0:
        raise ValueError("at least one sample is required")
    if not np.all(np.isfinite(x)):
        raise ValueError("samples must be finite")
    power = _block_powers(_k_weight_np(x, sample_rate), sample_rate, 0.1)
    if power.size == 0:
        raise ValueError("audio did not produce a finite gated loudness")
    loud = -0.691 + 10.0 * np.log10(np.maximum(power, 1e-30))
    abs_mask = loud > -70.0
    if not np.any(abs_mask):
        raise ValueError("audio did not produce a finite gated loudness")
    rel_threshold = -0.691 + 10.0 * np.log10(np.mean(power[abs_mask])) - 10.0
    mask = abs_mask & (loud > rel_threshold)
    if not np.any(mask):
        raise ValueError("audio did not produce a finite gated loudness")
    return float(-0.691 + 10.0 * np.log10(np.mean(power[mask])))


def momentary_slices_lufs(samples, sample_rate: int, hop_s: float = 0.1) -> np.ndarray:
    """Momentary (400 ms) loudness at ``hop_s`` cadence (host f64)."""
    y = _k_weight_np(np.asarray(samples, np.float64), sample_rate)
    power = _block_powers(y, sample_rate, hop_s)
    return -0.691 + 10.0 * np.log10(np.maximum(power, 1e-30))


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
