"""Privacy-safe, versioned support snapshots.

Mirrors `python/mic_eq/diagnostics_export.py` (`README.md:158-162`):

- **Field-allowlisted**: every root section is validated against a fixed
  schema before serialisation; unexpected fields are an error, not a leak.
- **HMAC-pseudonymized device identity**: raw device names never appear;
  each report derives ``device-<hmac16>`` from a report-local random key.
- **No audio, paths, env, or secrets**: system strings that look like
  filesystem paths are redacted; enum fields collapse unknown values to
  ``"other"``; numbers must be finite.
- **Size-bounded**: serialised snapshots are rejected above 128 KiB.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import math
import os
import platform
import secrets
import tempfile
from collections.abc import Mapping
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

__all__ = [
    "MAX_SERIALIZED_BYTES",
    "SCHEMA_NAME",
    "SCHEMA_VERSION",
    "build_diagnostics_snapshot",
    "diagnostics_filename",
    "serialize_diagnostics_snapshot",
    "write_diagnostics_snapshot",
]

SCHEMA_NAME = "audioforge-support-snapshot"
SCHEMA_VERSION = 1
MAX_SERIALIZED_BYTES = 128 * 1024
MIN_PSEUDONYM_KEY_BYTES = 16

_CONFIG_ENUMS = {
    "input_channel_mode": frozenset(
        {"average", "left", "right", "max_rms", "phase_safe_mono"}
    ),
    "input_cleanup_mode": frozenset({"off", "gentle", "strong"}),
    "voice_setup_dynamics_intensity": frozenset(
        {"gentle", "balanced", "dense", "custom"}
    ),
    "first_run_setup_state": frozenset(
        {"not_started", "in_progress", "completed", "completed_with_skips"}
    ),
    "first_run_setup_step": frozenset({"devices", "route", "latency", "voice"}),
}
_CONFIG_NUMBERS = (
    "main_control_tab_index",
    "voice_setup_custom_p95_db",
    "voice_setup_custom_peak_cap_db",
)
_CONFIG_BOOLS = ("use_measured_latency", "auto_apply_device_presets")

_PROCESSING_FIELDS = {
    "gate": frozenset({
        "enabled", "threshold_db", "attack_ms", "release_ms", "gate_mode",
        "vad_threshold", "vad_hold_time_ms", "vad_pre_gain",
        "auto_threshold_enabled", "gate_margin_db",
    }),
    "eq": frozenset({"schema_version", "enabled", "bands"}),
    "rnnoise": frozenset({"enabled", "strength", "model"}),
    "deesser": frozenset({
        "enabled", "auto_enabled", "auto_amount", "low_cut_hz", "high_cut_hz",
        "threshold_db", "ratio", "attack_ms", "release_ms", "max_reduction_db",
    }),
    "compressor": frozenset({
        "enabled", "threshold_db", "ratio", "attack_ms", "release_ms",
        "makeup_gain_db", "adaptive_release", "base_release_ms",
        "auto_makeup_enabled", "target_lufs", "sidechain_highpass_enabled",
    }),
    "limiter": frozenset({
        "enabled", "ceiling_db", "release_ms", "careful_output_enabled",
    }),
}
_PROCESSING_ENUMS = {
    ("rnnoise", "model"): frozenset({"rnnoise", "deepfilter-ll", "deepfilter"}),
}
_EQ_BAND_FIELDS = frozenset({
    "filter_type", "frequency_hz", "gain_db", "q", "bandwidth_mode",
    "bandwidth_octaves", "slope_db_per_octave", "stage", "enabled",
})
_EQ_BAND_ENUMS = {
    "filter_type": frozenset(
        {"bell", "notch", "low_shelf", "high_shelf", "high_pass", "low_pass"}
    ),
    "bandwidth_mode": frozenset({"q", "octaves"}),
    "stage": frozenset({"combined", "correction", "tone"}),
}
_RUNTIME_NUMBERS = frozenset({
    "input_dropped_samples", "input_backlog_dropped_samples",
    "input_backlog_recovery_count", "input_callback_error_count",
    "input_fixed_buffer_frames", "input_phase_estimated_delay_samples",
    "input_phase_warning_count", "input_stereo_correlation",
    "jitter_dropped_samples", "lock_contention_count",
    "output_callback_error_count", "output_clip_event_count",
    "output_clip_peak_db", "output_fixed_buffer_frames",
    "output_recovery_count", "output_recovery_event_count",
    "output_resampler_delay_samples", "output_retime_adjustment_count",
    "output_sample_rate", "output_short_term_lufs",
    "output_short_write_dropped_samples", "output_true_peak_db",
    "output_true_peak_event_count", "output_true_peak_gain_reduction_db",
    "output_true_peak_headroom_db", "output_underrun_streak",
    "output_underrun_total", "rt_buffer_overflow_count",
    "stream_restart_count", "suppressor_non_finite_count",
    "total_latency_ms", "engine_latency_ms", "route_latency_ms",
    "gate_chatter_event_count", "gate_fused_score",
    "deesser_detector_confidence", "limiter_gain_reduction_db",
    "limiter_peak_gain_reduction_db", "noise_attenuation_limit_db",
    "noise_post_filter_beta",
})
_RUNTIME_BOOLS = frozenset({
    "gate_auto_relax_active", "input_cleanup_hum_detected",
    "input_cleanup_rumble_detected", "input_phase_polarity_flipped",
    "input_resampler_active", "limiter_careful_output_enabled",
    "noise_backend_available", "noise_backend_failed",
    "output_resampler_active", "raw_monitor_enabled", "recovery_suppressed",
})
_RUNTIME_ENUMS = {
    "input_channel_mode": frozenset(
        {"average", "left", "right", "max_rms", "phase_safe_mono"}
    ),
    "input_cleanup_mode": frozenset({"off", "gentle", "strong"}),
    "input_phase_rescue_strategy": frozenset(
        {"none", "delay_left", "delay_right", "polarity_flip"}
    ),
    "noise_model": frozenset({"rnnoise", "deepfilter-ll", "deepfilter"}),
    "rt_error_name": frozenset({
        "none", "input_queue_full", "output_queue_full", "non_finite",
        "processor_unavailable",
    }),
}
_ROOT_FIELDS = frozenset({
    "schema", "generated_at_utc", "application", "system", "audio_engine",
    "configuration", "processing", "runtime", "privacy",
})
_SYSTEM_FIELDS = frozenset({
    "operating_system", "os_release", "os_version", "architecture",
    "python_version", "python_implementation",
})
_CONFIG_FIELDS = frozenset({
    *_CONFIG_ENUMS, *_CONFIG_NUMBERS, *_CONFIG_BOOLS,
    "saved_latency_profile_count", "device_preset_binding_count",
})
_RUNTIME_FIELDS = frozenset({
    *_RUNTIME_NUMBERS, *_RUNTIME_BOOLS, *_RUNTIME_ENUMS,
    "backend_error_present", "stream_error_present", "restart_reason_present",
})


def _mapping_value(source, key: str):
    if isinstance(source, Mapping):
        return source.get(key)
    return getattr(source, key, None)


def _finite_number(value):
    if isinstance(value, bool):
        return None
    if isinstance(value, int):
        return value
    if isinstance(value, float) and math.isfinite(value):
        return value
    return None


def _safe_enum(value, allowed) -> str:
    return str(value) if isinstance(value, str) and value in allowed else "other"


def _device_identity(device):
    """Identity material + default flag. The Core-Audio-style endpoint ID
    wins when present (rename-stable, like the reference's persistence
    policy); otherwise a tuple of weaker traits disambiguates same-named
    devices. The material never leaves this process unhashed."""
    if device is None:
        return None
    if isinstance(device, str):
        trimmed = device.strip()
        if not trimmed:
            return None
        return ("name", trimmed.casefold()), False

    def trait(key, default=None):
        if isinstance(device, Mapping):
            return device.get(key, default)
        return getattr(device, key, default)

    label = str(trait("name", "") or "").strip()
    if not label:
        return None
    host = str(trait("host_api", "") or "").strip().casefold()
    direction = str(trait("direction", "") or "").strip().casefold()
    endpoint = str(trait("endpoint_id", "") or "").strip()
    if endpoint:
        material = ("endpoint", host, direction, endpoint)
    else:
        material = (
            "fallback", host, direction, label.casefold(),
            repr(trait("name_ordinal")), repr(trait("sample_rate")),
            repr(trait("channels")),
        )
    return material, bool(trait("is_default", False))


def _pseudonymized_device(device, pseudonym_key: bytes):
    """``device-<hmac16>`` from a report-local key: pseudonyms are stable
    within one report (same device hashes alike) and meaningless across
    reports."""
    identity = _device_identity(device)
    if identity is None:
        return None
    material, is_default = identity
    mac = hmac.new(pseudonym_key, "\x1f".join(material).encode("utf-8"),
                   hashlib.sha256)
    return {
        "pseudonym": f"device-{mac.hexdigest()[:16]}",
        "is_default": is_default,
    }


def _sanitized_config(config) -> dict:
    result: dict = {}
    for key, allowed in _CONFIG_ENUMS.items():
        result[key] = _safe_enum(_mapping_value(config, key), allowed)
    for key in _CONFIG_BOOLS:
        value = _mapping_value(config, key)
        if isinstance(value, bool):
            result[key] = value
    for key in _CONFIG_NUMBERS:
        value = _finite_number(_mapping_value(config, key))
        if value is not None:
            result[key] = value
    profiles = _mapping_value(config, "latency_calibration_profiles")
    result["saved_latency_profile_count"] = (
        len(profiles) if isinstance(profiles, Mapping) else 0
    )
    bindings = _mapping_value(config, "device_preset_bindings")
    result["device_preset_binding_count"] = (
        len(bindings) if isinstance(bindings, Mapping) else 0
    )
    return result


def _sanitized_eq_bands(value):
    if not isinstance(value, list) or len(value) > 32:
        return None
    bands = []
    for raw_band in value:
        if not isinstance(raw_band, Mapping):
            continue
        band: dict = {}
        for band_key in sorted(_EQ_BAND_FIELDS):
            band_value = raw_band.get(band_key)
            band_enum = _EQ_BAND_ENUMS.get(band_key)
            if band_enum is not None:
                band[band_key] = _safe_enum(band_value, band_enum)
            elif isinstance(band_value, bool) or band_value is None:
                band[band_key] = band_value
            else:
                number = _finite_number(band_value)
                if number is not None:
                    band[band_key] = number
        bands.append(band)
    return bands


def _coerced_scalar(value):
    """bool passes through, finite numbers pass through, short numeric
    sequences pass if EVERY element is finite; everything else drops."""
    if isinstance(value, bool):
        return value
    if isinstance(value, (list, tuple)):
        numbers = [_finite_number(item) for item in value[:32]]
        return numbers if all(n is not None for n in numbers) else None
    return _finite_number(value)


def _sanitized_processing(processing_settings) -> dict:
    result: dict = {}
    for section, allowed_fields in _PROCESSING_FIELDS.items():
        raw_section = _mapping_value(processing_settings, section)
        if not isinstance(raw_section, Mapping):
            continue
        clean: dict = {}
        for key in sorted(allowed_fields):
            value = raw_section.get(key)
            enum_values = _PROCESSING_ENUMS.get((section, key))
            if enum_values is not None:
                clean[key] = _safe_enum(value, enum_values)
                continue
            if section == "eq" and key == "bands":
                bands = _sanitized_eq_bands(value)
                if bands is not None:
                    clean[key] = bands
                continue
            coerced = _coerced_scalar(value)
            if coerced is not None:
                clean[key] = coerced
        result[section] = clean
    bypass = _mapping_value(processing_settings, "bypass")
    if isinstance(bypass, bool):
        result["bypass"] = bypass
    return result


def _sanitized_runtime(diagnostics: Mapping) -> dict:
    result: dict = {}
    for key in sorted(_RUNTIME_NUMBERS):
        if key in diagnostics:
            result[key] = _finite_number(diagnostics[key])
    for key in sorted(_RUNTIME_BOOLS):
        value = diagnostics.get(key)
        if isinstance(value, bool):
            result[key] = value
    for key, allowed in sorted(_RUNTIME_ENUMS.items()):
        if key in diagnostics:
            result[key] = _safe_enum(diagnostics[key], allowed)
    result["backend_error_present"] = bool(diagnostics.get("noise_backend_error"))
    result["stream_error_present"] = bool(diagnostics.get("last_stream_error"))
    result["restart_reason_present"] = bool(
        diagnostics.get("last_restart_reason")
    )
    return result


def _system_snapshot() -> dict[str, str]:
    return {
        "operating_system": platform.system(),
        "os_release": platform.release(),
        "os_version": platform.version(),
        "architecture": platform.machine(),
        "python_version": platform.python_version(),
        "python_implementation": platform.python_implementation(),
    }


# substrings that mark a system string as path-like or multi-line; any hit
# redacts the whole value (matched case-insensitively)
_PATHLIKE_MARKERS = (":\\", ":/", "\\\\", "/home/", "/users/", "\n", "\r")


def _safe_system_text(value) -> str:
    """Redact anything that looks like a filesystem path
    (`diagnostics_export.py:446-460`)."""
    text = str(value)[:256]
    probe = text.casefold()
    if any(marker in probe for marker in _PATHLIKE_MARKERS):
        return "redacted"
    return text


def _timestamp_utc(value: datetime | None) -> str:
    timestamp = value or datetime.now(timezone.utc)
    if timestamp.tzinfo is None:
        raise ValueError("diagnostics timestamp must be timezone-aware")
    return timestamp.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")


def build_diagnostics_snapshot(
    *,
    app_version: str,
    runtime_diagnostics: Mapping,
    config,
    processing_settings,
    input_device,
    output_device,
    processing_sample_rate_hz: int,
    output_sample_rate_hz: int,
    running: bool,
    generated_at: datetime | None = None,
    pseudonym_key: bytes | None = None,
    system_info: Mapping[str, str] | None = None,
) -> dict[str, Any]:
    """Build an allowlisted support snapshot without local identifiers
    (`diagnostics_export.py:470-527`)."""
    key = pseudonym_key or secrets.token_bytes(32)
    if len(key) < MIN_PSEUDONYM_KEY_BYTES:
        raise ValueError("diagnostics pseudonym key is too short")
    processing_rate = _finite_number(processing_sample_rate_hz)
    output_rate = _finite_number(output_sample_rate_hz)
    if processing_rate is None or output_rate is None:
        raise ValueError("diagnostics sample rates must be finite integers")
    safe_system = {
        field: _safe_system_text(value)
        for field, value in (system_info or _system_snapshot()).items()
        if field in _SYSTEM_FIELDS
    }
    snapshot: dict[str, Any] = {
        "schema": {"name": SCHEMA_NAME, "version": SCHEMA_VERSION},
        "generated_at_utc": _timestamp_utc(generated_at),
        "application": {"name": "AudioForge", "version": str(app_version)},
        "system": safe_system,
        "audio_engine": {
            "running": bool(running),
            "processing_sample_rate_hz": processing_rate,
            "output_sample_rate_hz": output_rate,
            "input_device": _pseudonymized_device(input_device, key),
            "output_device": _pseudonymized_device(output_device, key),
        },
        "configuration": _sanitized_config(config),
        "processing": _sanitized_processing(processing_settings),
        "runtime": _sanitized_runtime(runtime_diagnostics),
        "privacy": {
            "raw_audio_included": False,
            "environment_variables_included": False,
            "arbitrary_paths_included": False,
            "raw_device_names_included": False,
            "secrets_included": False,
            "pseudonyms_are_report_local": True,
        },
    }
    serialize_diagnostics_snapshot(snapshot)  # validate before returning
    return snapshot


# section name -> the exhaustive field allowlist it must stay within
_SECTION_ALLOWLISTS = {
    "application": frozenset({"name", "version"}),
    "system": _SYSTEM_FIELDS,
    "audio_engine": frozenset({
        "running", "processing_sample_rate_hz", "output_sample_rate_hz",
        "input_device", "output_device",
    }),
    "configuration": _CONFIG_FIELDS,
    "processing": frozenset({*_PROCESSING_FIELDS, "bypass"}),
    "runtime": _RUNTIME_FIELDS,
    "privacy": frozenset({
        "raw_audio_included", "environment_variables_included",
        "arbitrary_paths_included", "raw_device_names_included",
        "secrets_included", "pseudonyms_are_report_local",
    }),
}


def _require_allowlisted(section, allowed, label: str) -> None:
    if not isinstance(section, Mapping) or not set(section) <= allowed:
        raise ValueError(
            f"diagnostics snapshot contains unexpected {label} fields")


def serialize_diagnostics_snapshot(snapshot: Mapping) -> bytes:
    """Validate against the allowlist schema and serialise
    (`diagnostics_export.py:530-609`). Validation is allowlist-exhaustive:
    an unexpected field anywhere is an error, never a silent leak."""
    if set(snapshot) != _ROOT_FIELDS:
        raise ValueError("diagnostics snapshot contains unexpected root fields")
    schema = snapshot.get("schema")
    if not isinstance(schema, Mapping):
        raise ValueError("diagnostics snapshot is missing its schema")
    if (schema.get("name"), schema.get("version")) != (SCHEMA_NAME,
                                                       SCHEMA_VERSION):
        raise ValueError("unsupported diagnostics snapshot schema")
    for name, allowed in _SECTION_ALLOWLISTS.items():
        _require_allowlisted(snapshot.get(name), allowed, name)
    processing = snapshot["processing"]
    for name, allowed in _PROCESSING_FIELDS.items():
        stage = processing.get(name)
        if stage is not None:
            _require_allowlisted(stage, allowed, "processing")
    eq = processing.get("eq")
    bands = eq.get("bands") if isinstance(eq, Mapping) else None
    if bands is not None:
        if not isinstance(bands, list):
            raise ValueError(
                "diagnostics snapshot contains unexpected EQ band fields")
        for band in bands:
            _require_allowlisted(band, _EQ_BAND_FIELDS, "EQ band")
    try:
        encoded = (
            json.dumps(snapshot, indent=2, sort_keys=True, allow_nan=False)
            + "\n"
        ).encode("utf-8")
    except (TypeError, ValueError) as error:
        raise ValueError("diagnostics snapshot is not finite JSON") from error
    if len(encoded) > MAX_SERIALIZED_BYTES:
        raise ValueError("diagnostics snapshot exceeds the size limit")
    return encoded


def diagnostics_filename(app_version: str,
                         generated_at: datetime | None = None) -> str:
    timestamp = generated_at or datetime.now(timezone.utc)
    if timestamp.tzinfo is None:
        raise ValueError("diagnostics filename timestamp must be timezone-aware")
    stamp = timestamp.astimezone(timezone.utc).strftime("%Y%m%d-%H%M%SZ")
    safe_version = "".join(
        ch for ch in str(app_version)
        if ch.isascii() and (ch.isalnum() or ch in ".-_")
    )
    return f"AudioForge-diagnostics-v{safe_version or 'unknown'}-{stamp}.json"


def write_diagnostics_snapshot(path, snapshot: Mapping) -> None:
    """Atomically write one validated snapshot."""
    destination = Path(path)
    destination.parent.mkdir(parents=True, exist_ok=True)
    payload = serialize_diagnostics_snapshot(snapshot)
    fd, tmp_name = tempfile.mkstemp(
        prefix=f".{destination.name}.", suffix=".tmp", dir=destination.parent
    )
    tmp = Path(tmp_name)
    try:
        with os.fdopen(fd, "wb") as handle:
            handle.write(payload)
            handle.flush()
            os.fsync(handle.fileno())
        os.replace(tmp, destination)
    except Exception:
        tmp.unlink(missing_ok=True)
        raise
