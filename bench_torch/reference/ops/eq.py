"""10-band parametric EQ as one crossfaded biquad cascade.

Counterpart of ``audioforge_tpu/ops/eq.py``: the same default band layout
(low shelf 80 Hz, bells 160 Hz - 12 kHz, high shelf 16 kHz, Q 1.41), section
design and compact live layout (one slot per band, four for pass filters).
The JAX package splits the cascade by band index into a double-word group
and a plain-f32 group (``eq.py:328-333``); here every section runs with f64
state, so the whole cascade is one unit and one ``biquad_cascade`` launch.

The offline chain's static cascade (:func:`compact_cascade`) drops identity
sections and keeps the reference's order (the sections its pole test sends
to the double-word scan, then the rest) in one ``(S, 5)`` array; the split
is an order here, not a precision.

The reference's precision split has no counterpart, because it is a TPU
workaround (ROADMAP F2): ``EQ_DF32_BANDS``, ``DF32_SECTIONS``,
``band_slot_count``, ``layout_sections`` and ``band_slot`` (locating a band in
its precision group), and ``cascade_apply`` / ``cascade_apply_split`` (the
fused offline scan's cascade; the offline chain here runs the staged kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import biquad


NUM_BANDS = 10
MAX_PASS_SECTIONS = 4
NUM_SECTIONS = NUM_BANDS * MAX_PASS_SECTIONS  # the reference's full layout
DEFAULT_FREQUENCIES = (
    80.0, 160.0, 320.0, 640.0, 1280.0, 2500.0, 5000.0, 8000.0, 12000.0, 16000.0
)
DEFAULT_Q = 1.41
SUPPORTED_PASS_SLOPES = (12, 24, 36, 48)
EQ_GAIN_MIN_DB = -12.0
EQ_GAIN_MAX_DB = 12.0
EQ_Q_MIN = 0.1
EQ_Q_MAX = 10.0
EQ_FREQ_MIN_HZ = 20.0
EQ_NYQUIST_MARGIN_HZ = 1.0

FILTER_TYPE_NAMES = {0: "low_shelf", 1: "bell", 2: "high_shelf", 3: "notch",
                     4: "high_pass", 5: "low_pass"}
_PASS_TYPES = (4, 5)
_EQ_TYPE_TO_BIQUAD = {0: biquad.LOW_SHELF, 1: biquad.PEAKING,
                      2: biquad.HIGH_SHELF, 3: biquad.NOTCH,
                      4: biquad.HIGH_PASS, 5: biquad.LOW_PASS}


_NAME_TO_ID = {v: k for k, v in FILTER_TYPE_NAMES.items()}


@dataclass(frozen=True)
class EqBandConfig:
    filter_type: int = 1  # bell
    frequency_hz: float = 1000.0
    gain_db: float = 0.0
    q: float = DEFAULT_Q
    slope_db_per_octave: int = 12
    enabled: bool = True

    @staticmethod
    def type_id(value) -> int:
        """A filter type's id from its id or its schema-v2 name."""
        if isinstance(value, str):
            return _NAME_TO_ID[value]
        return int(value)


def default_bands() -> list[EqBandConfig]:
    bands = []
    for i, freq in enumerate(DEFAULT_FREQUENCIES):
        ftype = 0 if i == 0 else (2 if i == NUM_BANDS - 1 else 1)
        bands.append(EqBandConfig(ftype, freq, 0.0, DEFAULT_Q, 12, True))
    return bands


def validate_band(config: EqBandConfig, sample_rate: float) -> None:
    if config.filter_type not in FILTER_TYPE_NAMES:
        raise ValueError(f"unknown filter type {config.filter_type}")
    nyquist = sample_rate / 2.0
    if not (EQ_FREQ_MIN_HZ <= config.frequency_hz
            <= nyquist - EQ_NYQUIST_MARGIN_HZ):
        raise ValueError(
            f"frequency {config.frequency_hz} Hz outside "
            f"[{EQ_FREQ_MIN_HZ}, {nyquist - EQ_NYQUIST_MARGIN_HZ}]")
    if not (EQ_GAIN_MIN_DB <= config.gain_db <= EQ_GAIN_MAX_DB):
        raise ValueError(f"gain {config.gain_db} dB outside ±12 dB")
    if not (EQ_Q_MIN <= config.q <= EQ_Q_MAX):
        raise ValueError(f"Q {config.q} outside [{EQ_Q_MIN}, {EQ_Q_MAX}]")
    if (config.filter_type in _PASS_TYPES
            and config.slope_db_per_octave not in SUPPORTED_PASS_SLOPES):
        raise ValueError(
            f"slope {config.slope_db_per_octave} dB/oct unsupported; "
            f"expected one of {SUPPORTED_PASS_SLOPES}")


def _butterworth_section_q(section_index: int, section_count: int) -> float:
    order = 2 * section_count
    angle = (2 * section_index + 1) * np.pi / (2 * order)
    return 1.0 / (2.0 * np.cos(angle))


def _required_sections(config: EqBandConfig) -> int:
    if not config.enabled:
        return 0
    if config.filter_type in _PASS_TYPES:
        return config.slope_db_per_octave // 12
    return 1


def band_section_design(config: EqBandConfig, sample_rate: float) -> np.ndarray:
    """Host f64 coefficients for a band's MAX_PASS_SECTIONS slots; unused
    slots are exact bypass."""
    out = np.zeros((MAX_PASS_SECTIONS, 5), np.float64)
    out[:, 0] = 1.0
    n = _required_sections(config)
    btype = _EQ_TYPE_TO_BIQUAD[config.filter_type]
    for k in range(n):
        if config.filter_type in _PASS_TYPES:
            gain, q = 0.0, _butterworth_section_q(k, n)
        else:
            gain = 0.0 if config.filter_type == 3 else config.gain_db
            q = config.q
        out[k] = biquad.design(btype, config.frequency_hz, gain, q, sample_rate)
    return out


def bands_to_sections(bands, sample_rate: float) -> np.ndarray:
    """Every band's MAX_PASS_SECTIONS slots -> ``(NUM_BANDS * 4, 5)`` f64."""
    return np.concatenate([band_section_design(b, sample_rate) for b in bands],
                          axis=0)


def _is_identity_section(row) -> bool:
    """The exact bypass slot, or a zero-gain design whose numerator equals
    its denominator: both pass audio unchanged."""
    b0, b1, b2, a1, a2 = (float(v) for v in row)
    return abs(b0 - 1.0) < 1e-12 and abs(b1 - a1) < 1e-12 and abs(b2 - a2) < 1e-12


DF32_POLE_ANGLE_RAD = 0.03
DF32_POLE_RADIUS_MARGIN = 0.0025


def _needs_df32(row) -> bool:
    """The reference's pole test for its double-word scan: poles at a small
    angle (low frequency) or close to the unit circle."""
    _, _, _, a1, a2 = (float(v) for v in row)
    if a2 <= 0.0:
        return True
    radius = np.sqrt(a2)
    if radius >= 1.0:
        return True
    theta = np.arccos(np.clip(-a1 / (2.0 * radius), -1.0, 1.0))
    return theta < DF32_POLE_ANGLE_RAD or (1.0 - radius) < DF32_POLE_RADIUS_MARGIN


def compact_cascade(coeffs) -> tuple[np.ndarray, np.ndarray]:
    """Drop identity sections from a static cascade (host f64). Returns
    ``(c_lo, c_hi)``: the sections the reference runs in double-word f32,
    then the rest, each in cascade order. The offline chain runs
    ``c_lo`` then ``c_hi`` as one cascade."""
    keep_lo, keep_hi = [], []
    for row in np.asarray(coeffs, np.float64):
        if not _is_identity_section(row):
            (keep_lo if _needs_df32(row) else keep_hi).append(row)
    return (np.asarray(keep_lo, np.float64).reshape(len(keep_lo), 5),
            np.asarray(keep_hi, np.float64).reshape(len(keep_hi), 5))


def magnitude_response_db(bands, frequencies, sample_rate: float) -> np.ndarray:
    """Exact cascaded magnitude response in dB at ``frequencies`` (host
    f64)."""
    per_section = biquad.magnitude_response_db(
        bands_to_sections(bands, sample_rate),
        np.asarray(frequencies, np.float64), sample_rate)
    return per_section.sum(axis=0)


def eq_layout(bands=None) -> tuple:
    """Section slots per band: four for pass filters, one otherwise."""
    bands = default_bands() if bands is None else bands
    return tuple(MAX_PASS_SECTIONS if b.filter_type in _PASS_TYPES else 1
                 for b in bands)


def eq_init(bands=None, sample_rate: float = 48000.0, layout=None, *,
            n: int, device) -> dict:
    """Unit state ``[n, S]`` for the compact cascade of ``bands``."""
    bands = default_bands() if bands is None else bands
    layout = eq_layout(bands) if layout is None else tuple(layout)
    if len(layout) != len(bands):
        raise ValueError("layout/bands length mismatch")
    rows = []
    for i, (b, cap) in enumerate(zip(bands, layout)):
        if _required_sections(b) > cap:
            raise ValueError(
                f"band {i} needs {_required_sections(b)} sections but "
                f"layout holds {cap}")
        rows.append(band_section_design(b, sample_rate)[:cap])
    return biquad.unit_init(np.concatenate(rows, axis=0), n, device)


def eq_set_band(state, band_index: int, config: EqBandConfig,
                sample_rate: float, layout=None) -> dict:
    """Crossfade one band to ``config`` for every stream. Raises when the
    band's slots cannot hold the new design."""
    validate_band(config, sample_rate)
    layout = eq_layout() if layout is None else tuple(layout)
    start, cap = sum(layout[:band_index]), layout[band_index]
    if _required_sections(config) > cap:
        raise ValueError(
            f"band {band_index} config needs {_required_sections(config)} "
            f"sections but its layout slot holds {cap} — rebuild the EQ "
            "state with eq_init(bands)")
    target = band_section_design(config, sample_rate)[:cap]
    sec = slice(start, start + cap)
    sub = biquad.unit_schedule({k: v[:, sec] for k, v in state.items()}, target,
                               biquad.crossfade_samples(sample_rate))
    out = {k: v.clone() for k, v in state.items()}
    for k, v in sub.items():
        out[k][:, sec] = v
    return out


def eq_set_bands(state, bands, sample_rate: float, layout=None) -> dict:
    """:func:`eq_set_band` for band 0, 1, ... of ``bands`` in turn."""
    for i, b in enumerate(bands):
        state = eq_set_band(state, i, b, sample_rate, layout=layout)
    return state


def eq_reset(state) -> dict:
    """Clear every section's filter state and commit pending targets."""
    return biquad.unit_reset_state(state)


def eq_process(state, x):
    """Cascade ``x: f32 [N, T]`` through every section in one launch.
    Returns ``(new_state, y)``."""
    return biquad.unit_process(state, x)
