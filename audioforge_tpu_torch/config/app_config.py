"""Application config persistence (device routing, UI state, first-run setup).

Behavioral contract of `python/mic_eq/config_parts/app_config.py`:

- `AppConfig` holds the last device route (names + rename-stable
  identities), channel/cleanup modes, preset bookkeeping, voice-setup
  dynamics preferences, per-route latency-calibration profiles, per-route
  preset bindings, and the first-run setup state machine
  (`app_config.py:154-219`).
- Everything loaded from disk is coerced with safe defaults — a corrupt
  config never crashes the app, it degrades to defaults
  (`app_config.py:221-339`, `365-383`).
- Existing installs that predate first-run setup are marked
  ``completed_with_skips`` so they never see the wizard
  (`app_config.py:226-229`, `323-332`).

The implementation here is spec-table driven: every simple persisted field
declares its default and sanitiser once in ``_SCALAR_FIELDS``; only the
cross-field logic (identity fallbacks, route-keyed dicts, the wizard
migration) is hand-written.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from dataclasses import dataclass, field, fields
from pathlib import Path

from .settings import LatencyCalibrationProfile
from .shared import (
    DeviceIdentity,
    PresetValidationError,
    _reject_json_constant,
    build_device_route_key,
    build_latency_profile_key,
    coerce_device_identity,
    get_config_file,
    parse_latency_profile_key,
)
from .validation import _coerce_config_bool, _coerce_window_geometry

INPUT_CHANNEL_MODES = frozenset(
    {"average", "left", "right", "max_rms", "phase_safe_mono"}
)
INPUT_CLEANUP_MODES = frozenset({"off", "gentle", "strong"})
DYNAMICS_INTENSITIES = frozenset({"gentle", "balanced", "dense", "custom"})
DEVICE_PRESET_PROVENANCE = frozenset({"explicit_user", "legacy_migration"})
FIRST_RUN_SETUP_STATES = frozenset(
    {"not_started", "in_progress", "completed", "completed_with_skips"}
)
FIRST_RUN_SETUP_STEPS = ("devices", "route", "latency", "voice")
FIRST_RUN_STEP_STATES = frozenset({"pending", "completed", "skipped"})

__all__ = [
    "AppConfig",
    "DevicePresetBinding",
    "INPUT_CHANNEL_MODES",
    "INPUT_CLEANUP_MODES",
    "DYNAMICS_INTENSITIES",
    "FIRST_RUN_SETUP_STATES",
    "FIRST_RUN_SETUP_STEPS",
    "load_config",
    "save_config",
]


# ------------------------------------------------------------ sanitisers


def _enum(allowed: frozenset, default: str):
    def coerce(value):
        return value if isinstance(value, str) and value in allowed else default
    return coerce


def _bounded_float(default: float, low: float, high: float):
    def coerce(value):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return default
        parsed = float(value)
        return parsed if math.isfinite(parsed) and low <= parsed <= high else default
    return coerce


def _bounded_int(default: int, low: int, high: int):
    def coerce(value):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return default
        numeric = float(value)
        if not math.isfinite(numeric):
            return default
        parsed = int(numeric)
        return parsed if low <= parsed <= high else default
    return coerce


def _bool_default(default: bool):
    def coerce(value):
        return _coerce_config_bool(value, default)
    return coerce


def _text(value):
    return value if isinstance(value, str) else ""


def _splitter_sizes(value):
    if not isinstance(value, (list, tuple)) or len(value) != 2:
        return None
    to_int = _bounded_int(-1, 0, 1_000_000)
    parsed = [to_int(size) for size in value]
    return parsed if min(parsed) >= 0 else None


# Simple persisted fields: name -> sanitiser. from_dict applies these
# uniformly; anything NOT in this table has bespoke handling below.
_SCALAR_FIELDS = {
    "input_channel_mode": _enum(INPUT_CHANNEL_MODES, "average"),
    "input_cleanup_mode": _enum(INPUT_CLEANUP_MODES, "off"),
    "last_preset": _text,
    "startup_preset": _text,
    "window_geometry": _coerce_window_geometry,
    "main_splitter_sizes": _splitter_sizes,
    "main_control_tab_index": _bounded_int(0, 0, 64),
    "use_measured_latency": _bool_default(True),
    "voice_setup_dynamics_intensity": _enum(DYNAMICS_INTENSITIES, "balanced"),
    "voice_setup_custom_p95_db": _bounded_float(3.5, 1.0, 8.0),
    "voice_setup_custom_peak_cap_db": _bounded_float(8.0, 1.5, 12.0),
    "auto_apply_device_presets": _bool_default(True),
}

@dataclass(frozen=True, slots=True)
class DevicePresetBinding:
    """Preset bound to a device route; ids carry a ``builtin:``/``custom:``
    prefix (`app_config.py:60-84`)."""

    preset_id: str
    provenance: str = "explicit_user"

    def to_dict(self) -> dict[str, str]:
        return {"preset_id": self.preset_id, "provenance": self.provenance}

    @classmethod
    def from_value(cls, value) -> "DevicePresetBinding | None":
        if isinstance(value, str):
            preset_id, provenance = value.strip(), "legacy_migration"
        elif isinstance(value, dict):
            preset_id = str(value.get("preset_id", "")).strip()
            provenance = str(value.get("provenance", "explicit_user")).strip()
        else:
            return None
        if not preset_id:
            return None
        if provenance not in DEVICE_PRESET_PROVENANCE:
            provenance = "legacy_migration"
        return cls(preset_id=preset_id, provenance=provenance)


def _route_keyed(raw, parse_value, rebuild_key):
    """Decode a route-keyed dict: drop entries whose value fails to parse
    or whose key parses to no route; surviving keys are re-serialised into
    the canonical structured format (migrating legacy ``a||b`` keys)."""
    out = {}
    if not isinstance(raw, dict):
        return out
    for key, value in raw.items():
        parsed = parse_value(value)
        if parsed is None:
            continue
        devices = parse_latency_profile_key(str(key))
        if devices is None:
            continue
        out[rebuild_key(*devices)] = parsed
    return out


def _parse_profile(value):
    try:
        return LatencyCalibrationProfile.from_dict(value)
    except (KeyError, TypeError, ValueError, PresetValidationError):
        return None


def _safe_device_name(value, identity: DeviceIdentity | None) -> str:
    if isinstance(value, str):
        name = value.strip()
        if name and len(name) <= 4096 and "\x00" not in name:
            return name
    return identity.name if identity is not None else ""


def _identity_with_fallback(data: dict, side: str) -> DeviceIdentity | None:
    """Prefer the structured identity; fall back to the bare name field."""
    parsed = coerce_device_identity(data.get(f"last_{side}_device_identity"))
    if parsed is None:
        parsed = coerce_device_identity(data.get(f"last_{side}_device"))
    return parsed


@dataclass
class AppConfig:
    """Persisted application settings (`app_config.py:154-180`)."""

    last_input_device: str = ""
    last_output_device: str = ""
    last_input_device_identity: DeviceIdentity | None = None
    last_output_device_identity: DeviceIdentity | None = None
    input_channel_mode: str = "average"
    input_cleanup_mode: str = "off"
    last_preset: str = ""
    startup_preset: str = ""
    window_geometry: dict | None = None
    main_splitter_sizes: list[int] | None = None
    main_control_tab_index: int = 0
    use_measured_latency: bool = True
    voice_setup_dynamics_intensity: str = "balanced"
    voice_setup_custom_p95_db: float = 3.5
    voice_setup_custom_peak_cap_db: float = 8.0
    latency_calibration_profiles: dict[str, LatencyCalibrationProfile] = field(
        default_factory=dict
    )
    auto_apply_device_presets: bool = True
    device_preset_bindings: dict[str, DevicePresetBinding] = field(
        default_factory=dict
    )
    first_run_setup_state: str = "not_started"
    first_run_setup_step: str = "devices"
    first_run_setup_steps: dict[str, str] = field(
        default_factory=lambda: {step: "pending" for step in FIRST_RUN_SETUP_STEPS}
    )

    def to_dict(self) -> dict:
        out = {}
        for spec in fields(self):
            value = getattr(self, spec.name)
            if isinstance(value, DeviceIdentity):
                value = value.to_dict()
            elif spec.name == "latency_calibration_profiles":
                value = {k: p.to_dict() for k, p in value.items()}
            elif spec.name == "device_preset_bindings":
                value = {k: b.to_dict() for k, b in value.items()}
            elif spec.name == "first_run_setup_steps":
                value = dict(value)
            out[spec.name] = value
        return out

    @classmethod
    def from_dict(cls, data) -> "AppConfig":
        if not isinstance(data, dict):
            return cls()

        kwargs = {
            name: coerce(data.get(name))
            for name, coerce in _SCALAR_FIELDS.items()
        }

        input_identity = _identity_with_fallback(data, "input")
        output_identity = _identity_with_fallback(data, "output")
        kwargs.update(
            last_input_device=_safe_device_name(
                data.get("last_input_device"), input_identity
            ),
            last_output_device=_safe_device_name(
                data.get("last_output_device"), output_identity
            ),
            last_input_device_identity=input_identity,
            last_output_device_identity=output_identity,
            latency_calibration_profiles=_route_keyed(
                data.get("latency_calibration_profiles") or {},
                _parse_profile, build_latency_profile_key,
            ),
            device_preset_bindings=_route_keyed(
                data.get("device_preset_bindings") or {},
                DevicePresetBinding.from_value, build_device_route_key,
            ),
        )

        # First-run wizard state machine. Installs predating the wizard are
        # recognised by having any persisted field but no setup state; they
        # skip the wizard forever (`app_config.py:226-229`).
        pre_wizard_fields = (set(_SCALAR_FIELDS)
                             | {"last_input_device", "last_output_device",
                                "last_input_device_identity",
                                "last_output_device_identity",
                                "latency_calibration_profiles",
                                "device_preset_bindings"})
        migrated = ("first_run_setup_state" not in data
                    and bool(pre_wizard_fields & set(data)))
        if migrated:
            kwargs.update(
                first_run_setup_state="completed_with_skips",
                first_run_setup_steps={
                    step: "skipped" for step in FIRST_RUN_SETUP_STEPS
                },
            )
        else:
            raw_steps = data.get("first_run_setup_steps")
            steps_in = raw_steps if isinstance(raw_steps, dict) else {}
            kwargs.update(
                first_run_setup_state=_enum(
                    FIRST_RUN_SETUP_STATES, "not_started"
                )(str(data.get("first_run_setup_state"))),
                first_run_setup_steps={
                    step: (str(steps_in.get(step))
                           if str(steps_in.get(step)) in FIRST_RUN_STEP_STATES
                           else "pending")
                    for step in FIRST_RUN_SETUP_STEPS
                },
            )
        step = str(data.get("first_run_setup_step"))
        kwargs["first_run_setup_step"] = (
            step if step in FIRST_RUN_SETUP_STEPS else "devices"
        )
        return cls(**kwargs)


def save_config(config: AppConfig) -> None:
    """Atomic config write: temp file + fsync + rename
    (`app_config.py:342-362`)."""
    filepath = get_config_file()
    filepath.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(
        prefix=f".{filepath.name}.", suffix=".tmp", dir=filepath.parent,
        text=True,
    )
    tmp = Path(tmp_name)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as handle:
            json.dump(config.to_dict(), handle, indent=2, allow_nan=False)
            handle.flush()
            os.fsync(handle.fileno())
        os.replace(tmp, filepath)
    except Exception:
        tmp.unlink(missing_ok=True)
        raise


def load_config() -> AppConfig:
    """Load config; any corruption degrades to defaults
    (`app_config.py:365-383`)."""
    filepath = get_config_file()
    if not filepath.exists():
        return AppConfig()
    try:
        with open(filepath, "r", encoding="utf-8") as handle:
            data = json.load(handle, parse_constant=_reject_json_constant)
        return AppConfig.from_dict(data)
    except (
        OSError,
        OverflowError,
        json.JSONDecodeError,
        KeyError,
        TypeError,
        ValueError,
        PresetValidationError,
    ):
        return AppConfig()
