"""Builtin catalogs: EQ band layout, target curves, analysis gates.

Mirrors `python/mic_eq/config_parts/catalogs.py` and the constants exported
from `config_parts/settings.py:11-47`.
"""

from __future__ import annotations

from dataclasses import dataclass

EQ_FREQUENCIES = [80, 160, 320, 640, 1280, 2500, 5000, 8000, 12000, 16000]
AUTO_EQ_DEFAULT_Q = 4.33
EQ_SCHEMA_VERSION = 2

ANALYSIS_MIN_PEAK_COUNT = 3
ANALYSIS_MIN_DYNAMIC_RANGE = 20
ANALYSIS_MIN_SNR = 12
ANALYSIS_MAX_SPECTRAL_FLATNESS = 0.8


@dataclass(frozen=True)
class TargetCurve:
    name: str
    description: str
    band_targets: list[float]


TARGET_CURVES = {
    "broadcast": TargetCurve(
        name="Broadcast-style Voice",
        description="House curve for clear, balanced broadcast-style speech",
        band_targets=[-2.0, -1.0, 0.0, 1.0, 2.0, 3.0, 2.0, 1.0, 0.0, -1.0],
    ),
    "podcast": TargetCurve(
        name="Podcast / Voice-Over",
        description="Enhanced presence for intimate vocal recording",
        band_targets=[0.0, 0.0, 1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0, 0.0],
    ),
    "streaming": TargetCurve(
        name="Streaming / Gaming",
        description="Cuts through game audio mix with aggressive presence",
        band_targets=[-1.0, 0.0, 1.0, 2.0, 4.0, 5.0, 4.0, 2.0, 0.0, -2.0],
    ),
    "flat": TargetCurve(
        name="Neutral Reference",
        description="Neutral house target for broad microphone-response correction",
        band_targets=[0.0] * 10,
    ),
}


# Bundled presets (`catalogs.py:8-105`): key -> (name, description,
# gate overrides, eq enabled, band gains, band Qs).
_BUILTIN_PRESET_TABLE = {
    "voice": (
        "Voice Clarity",
        "Optimized for voice communication - cuts low end rumble and boosts presence",
        {},
        True,
        [-3.0, -2.0, 0.0, 1.0, 2.0, 3.0, 2.0, 0.0, -1.0, -2.0],
        [0.7, 1.0, 1.2, 1.4, 1.6, 2.0, 1.8, 1.2, 0.9, 0.7],
    ),
    "bass_cut": (
        "Bass Cut",
        "High-pass effect to remove low frequency rumble and proximity effect",
        {},
        True,
        [-12.0, -6.0, -2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.5, 0.7, 0.9, 1.41, 1.41, 1.41, 1.41, 1.41, 1.41, 1.41],
    ),
    "presence": (
        "Presence Boost",
        "Enhances voice presence and intelligibility",
        {},
        True,
        [0.0, 0.0, 0.0, 0.0, 2.0, 4.0, 3.0, 1.0, 0.0, 0.0],
        [1.41, 1.41, 1.41, 1.41, 2.0, 2.5, 2.0, 1.5, 1.41, 1.41],
    ),
    "flat": (
        "Flat",
        "No EQ processing - flat frequency response",
        {},
        True,
        [0.0] * 10,
        [1.41] * 10,
    ),
    "minimal": (
        "Minimal Processing",
        "Gate and RNNoise only - no EQ",
        {"threshold_db": -45.0, "attack_ms": 5.0, "release_ms": 150.0},
        False,
        [0.0] * 10,
        [1.41] * 10,
    ),
    "aggressive_denoise": (
        "Aggressive Denoise",
        "Maximum noise reduction with tight gate",
        {"threshold_db": -35.0, "attack_ms": 5.0, "release_ms": 50.0},
        True,
        [-6.0, -3.0, 0.0, 0.0, 1.0, 2.0, 1.0, -1.0, -3.0, -6.0],
        [0.6, 0.8, 1.2, 1.4, 1.8, 2.0, 1.6, 1.2, 0.8, 0.6],
    ),
}


def build_builtin_presets(preset_cls, gate_settings_cls, eq_settings_cls,
                          rnnoise_settings_cls) -> dict:
    """Bundled presets via injected config dataclasses (`catalogs.py:8-105`).

    Classes are injected rather than imported to keep this module free of
    a settings dependency, matching the reference's layering.
    """
    from .shared import CURRENT_VERSION

    out = {}
    for key, (name, description, gate_kw, eq_on, gains, qs) in (
            _BUILTIN_PRESET_TABLE.items()):
        out[key] = preset_cls(
            name=name,
            description=description,
            version=CURRENT_VERSION,
            gate=gate_settings_cls(**gate_kw),
            eq=eq_settings_cls(enabled=eq_on, band_gains=list(gains),
                               band_qs=list(qs)),
            rnnoise=rnnoise_settings_cls(enabled=True, strength=1.0,
                                         model="rnnoise"),
        )
    return out


def build_target_curves(target_curve_cls) -> dict:
    """Target-curve catalog via an injected dataclass (`catalogs.py:108-135`)."""
    return {
        key: target_curve_cls(name=c.name, description=c.description,
                              band_targets=list(c.band_targets))
        for key, c in TARGET_CURVES.items()
    }
