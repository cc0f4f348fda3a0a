"""Validation helpers and ranges for preset/app-config persistence.

Mirrors `python/mic_eq/config_parts/validation.py`: every numeric crossing
the persistence boundary is finite-checked and range-clamped with explicit
errors (nothing silently repaired).
"""

from __future__ import annotations

import math

from .shared import PresetValidationError

VALIDATION_RANGES = {
    "gate": {
        "threshold_db": (-80.0, -10.0),
        "attack_ms": (0.1, 100.0),
        "release_ms": (10.0, 1000.0),
        "gate_mode": (0, 2),
        "vad_threshold": (0.3, 0.7),
        "vad_hold_time_ms": (0.0, 500.0),
        "vad_pre_gain": (1.0, 10.0),
        "auto_threshold_enabled": (bool, None),
        "gate_margin_db": (0.0, 20.0),
    },
    "eq": {
        "band_freq": (20.0, 20000.0),
        "band_gain": (-12.0, 12.0),
        "band_q": (0.1, 10.0),
    },
    "rnnoise": {
        "strength": (0.0, 1.0),
        "model": ["rnnoise", "deepfilter-ll", "deepfilter"],
    },
    "deesser": {
        "auto_amount": (0.0, 1.0),
        "low_cut_hz": (2000.0, 12000.0),
        "high_cut_hz": (2200.0, 16000.0),
        "threshold_db": (-60.0, -6.0),
        "ratio": (1.0, 20.0),
        "attack_ms": (0.1, 50.0),
        "release_ms": (5.0, 500.0),
        "max_reduction_db": (0.0, 24.0),
    },
    "compressor": {
        "threshold_db": (-60.0, 0.0),
        "ratio": (1.0, 20.0),
        "attack_ms": (0.1, 100.0),
        "release_ms": (10.0, 1000.0),
        "makeup_gain_db": (0.0, 24.0),
        "adaptive_release": (bool, None),
        "auto_makeup_enabled": (bool, None),
        "target_lufs": (-24.0, -12.0),
        "sidechain_highpass_enabled": (bool, None),
    },
    "limiter": {
        "ceiling_db": (-12.0, 0.0),
        "release_ms": (10.0, 500.0),
    },
}

__all__ = [
    "VALIDATION_RANGES",
    "_validate_bool",
    "_validate_range",
    "_coerce_config_bool",
    "_coerce_window_geometry",
]


def _validate_bool(value, param_name: str, section: str) -> bool:
    if isinstance(value, bool):
        return value
    raise PresetValidationError(
        f"Invalid {param_name} in {section}: {value!r} (must be true or false)"
    )


def _validate_range(value, low, high, param_name: str, section: str) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise PresetValidationError(
            f"Invalid {param_name} in {section}: {value!r} (must be a number)"
        )
    parsed = float(value)
    if not math.isfinite(parsed):
        raise PresetValidationError(
            f"Invalid {param_name} in {section}: {value!r} (must be finite)"
        )
    if not low <= parsed <= high:
        raise PresetValidationError(
            f"Invalid {param_name} in {section}: {parsed} "
            f"(must be between {low} and {high})"
        )
    return parsed


def _coerce_config_bool(value, default: bool) -> bool:
    return value if isinstance(value, bool) else default


def _coerce_window_geometry(value) -> dict[str, int] | None:
    """Window geometry with minimum usable size (`validation.py:73-89`)."""
    if not isinstance(value, dict):
        return None
    out: dict[str, int] = {}
    for key in ("x", "y", "width", "height"):
        raw = value.get(key)
        if isinstance(raw, bool) or not isinstance(raw, (int, float)):
            return None
        numeric = float(raw)
        if not math.isfinite(numeric):
            return None
        out[key] = int(round(numeric))
    out["width"] = max(640, out["width"])
    out["height"] = max(480, out["height"])
    return out
