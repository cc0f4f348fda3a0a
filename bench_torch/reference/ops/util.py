"""Shared DSP math helpers (counterpart of ``audioforge_tpu/ops/util.py``).

The coefficient helpers take Python floats (host-side design in double);
:func:`linear_to_db` also takes a tensor (elementwise, in its dtype).
"""

from __future__ import annotations

import math

import numpy as np
import torch


DB_EPS = 1e-10


def time_constant_to_coeff(time_constant_s: float, sample_rate: float) -> float:
    """One-pole coefficient ``exp(-1 / (tau * fs))``; 0 for ``tau <= 0``."""
    if time_constant_s <= 0.0:
        return 0.0
    return math.exp(-1.0 / (float(time_constant_s) * float(sample_rate)))


def db_to_linear(db: float) -> float:
    return 10.0 ** (float(db) / 20.0)


def linear_to_db(linear, floor_db=-120.0):
    """Linear -> dB. A tensor is floored at ``floor_db``; a Python float is
    only floored at ``DB_EPS`` (as in the reference)."""
    if isinstance(linear, torch.Tensor):
        out = 20.0 * torch.log10(torch.clamp_min(linear.abs(), DB_EPS))
        return torch.clamp_min(out, floor_db)
    return 20.0 * math.log10(max(abs(float(linear)), DB_EPS))


def f32(v: float) -> float:
    """``v`` rounded to f32, as the reference's ``jnp.float32(v)``."""
    return float(np.float32(v))


def f32_pair(c: float) -> tuple[float, float]:
    """``(f32(c), f32(1 - f32(c)))``: a smoothing coefficient and its
    complement as the reference's f32 arithmetic forms them."""
    return f32(c), float(np.float32(1.0) - np.float32(c))
