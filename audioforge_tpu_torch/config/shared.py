"""Shared config primitives: versioning, persistence paths, device identity.

Behavioral contract of `python/mic_eq/config_parts/shared.py`: version
string 1.11.2, APPDATA-style config dir with one-time legacy-dir migration
(`shared.py:38-75`), rename-stable ``DeviceIdentity`` keyed on
Core-Audio-style endpoint ids (`shared.py:77-185`), and deterministic
per-route latency-profile keys (legacy ``a||b`` names or canonical JSON).
The persisted field names, key formats, and sanitisation outcomes are the
compat surface; the implementation is the framework's own.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from dataclasses import dataclass, field
from pathlib import Path

CURRENT_VERSION = "1.11.2"
APPDATA_DIR_NAME = "AudioForge"
LEGACY_APPDATA_DIR_NAME = "MicEq"

__all__ = [
    "APPDATA_DIR_NAME",
    "CURRENT_VERSION",
    "DeviceIdentity",
    "LEGACY_APPDATA_DIR_NAME",
    "PresetValidationError",
    "_reject_json_constant",
    "_version_tuple",
    "build_device_route_key",
    "build_latency_profile_key",
    "coerce_device_identity",
    "get_config_file",
    "get_preset_imports_dir",
    "get_presets_dir",
    "legacy_latency_profile_key",
    "parse_latency_profile_key",
]


class PresetValidationError(Exception):
    """Raised when preset or config validation fails with actionable detail."""


def _reject_json_constant(value: str) -> None:
    raise PresetValidationError(f"Invalid JSON constant in preset/config: {value}")


def _version_tuple(version: str) -> tuple[int, int, int]:
    """``"1.11.2" -> (1, 11, 2)``; malformed segments become 0 so version
    ordering never throws on user-edited files."""
    def seg(text: str) -> int:
        try:
            return int(text)
        except ValueError:
            return 0

    parts = [seg(p) for p in str(version).split(".")[:3]]
    parts += [0] * (3 - len(parts))
    return parts[0], parts[1], parts[2]


# ------------------------------------------------------------------ paths


def _config_base_dir() -> Path:
    if os.name == "nt":
        return Path(os.environ.get("APPDATA", Path.home()))
    return Path.home() / ".config"


def _config_dir() -> Path:
    """Config root, migrating the legacy MicEq tree once if present."""
    base = _config_base_dir()
    root = base / APPDATA_DIR_NAME
    if not root.exists():
        legacy = base / LEGACY_APPDATA_DIR_NAME
        if legacy.exists():
            try:
                shutil.copytree(legacy, root)
            except OSError:
                pass  # fall through to a fresh directory
    root.mkdir(parents=True, exist_ok=True)
    return root


def _ensured_subdir(parent: Path, name: str) -> Path:
    sub = parent / name
    sub.mkdir(parents=True, exist_ok=True)
    return sub


def get_presets_dir() -> Path:
    return _ensured_subdir(_config_dir(), "presets")


def get_preset_imports_dir() -> Path:
    return _ensured_subdir(get_presets_dir().parent, "imports")


def get_config_file() -> Path:
    return _config_dir() / "config.json"


# -------------------------------------------------------- device identity

# sanitisation bounds for the optional numeric diagnostics fields
_FIELD_MAXIMA = {
    "sample_rate": 0xFFFFFFFF,
    "channels": 0xFFFF,
    "name_ordinal": 0xFFFFFFFF,
}
_DIRECTIONS = frozenset({"", "input", "output"})


def _clean_str(value) -> str:
    return value.strip() if isinstance(value, str) else ""


def _clean_opt_int(value, maximum: int) -> int | None:
    """Accept int/float/str encodings of a whole number in [0, maximum];
    anything else (bool included) is dropped, never raises."""
    if isinstance(value, bool) or not isinstance(value, (int, float, str)):
        return None
    try:
        numeric = float(value)
    except (TypeError, ValueError, OverflowError):
        return None
    if not (math.isfinite(numeric) and numeric.is_integer()):
        return None
    as_int = int(numeric)
    return as_int if 0 <= as_int <= maximum else None


@dataclass
class DeviceIdentity:
    """Persisted audio device identity; endpoint ids keep bindings stable
    across renames (`shared.py:77-185`)."""

    name: str = ""
    # default-route status is transient policy, excluded from equality
    is_default: bool = field(default=False, compare=False)
    endpoint_id: str = ""
    host_api: str = ""
    direction: str = ""
    # mutable format fields are diagnostics, not route-key material
    sample_rate: int | None = None
    channels: int | None = None
    name_ordinal: int | None = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "is_default": self.is_default,
            "endpoint_id": self.endpoint_id,
            "host_api": self.host_api,
            "direction": self.direction,
            "sample_rate": self.sample_rate,
            "channels": self.channels,
            "name_ordinal": self.name_ordinal,
        }

    def stable_dict(self) -> dict:
        """Rename-stable projection for route/profile keys: endpoint id when
        present, otherwise the whitespace-normalised casefolded name plus
        any disambiguators that exist."""
        if self.endpoint_id:
            return {
                "endpoint_id": self.endpoint_id,
                "host_api": self.host_api.casefold(),
                "direction": self.direction.casefold(),
            }
        optional = {
            "host_api": self.host_api.casefold() or None,
            "direction": self.direction.casefold() or None,
            "name_ordinal": self.name_ordinal,
        }
        return {
            "name": " ".join(self.name.casefold().split()),
            **{k: v for k, v in optional.items() if v is not None},
        }

    @classmethod
    def from_dict(cls, data) -> "DeviceIdentity | None":
        if isinstance(data, cls):
            return data if data.name else None
        if isinstance(data, str):
            trimmed = data.strip()
            return cls(name=trimmed) if trimmed else None
        if not isinstance(data, dict):
            return None

        name = data.get("name", "")
        if not isinstance(name, str) or not name.strip():
            return None

        direction = _clean_str(data.get("direction", "")).casefold()
        if direction not in _DIRECTIONS:
            direction = ""
        default_flag = data.get("is_default", False)
        kwargs = {
            "name": name.strip(),
            "is_default": default_flag if isinstance(default_flag, bool) else False,
            "endpoint_id": _clean_str(data.get("endpoint_id", "")),
            "host_api": _clean_str(data.get("host_api", "")),
            "direction": direction,
        }
        for key, maximum in _FIELD_MAXIMA.items():
            kwargs[key] = _clean_opt_int(data.get(key), maximum)
        return cls(**kwargs)


def coerce_device_identity(data) -> DeviceIdentity | None:
    if data is None or isinstance(data, (DeviceIdentity, dict, str)):
        return DeviceIdentity.from_dict(data)
    return None


# ------------------------------------------------------------- route keys


def legacy_latency_profile_key(input_name: str, output_name: str) -> str:
    return f"{input_name}||{output_name}"


def build_device_route_key(input_device, output_device) -> str:
    """Canonical JSON key for an endpoint pair; ``None`` sides persist as
    JSON null so half-bound routes stay representable."""
    sides = {
        side: dev.stable_dict() if dev is not None else None
        for side, dev in (("input", input_device), ("output", output_device))
    }
    return json.dumps(sides, sort_keys=True, separators=(",", ":"))


def build_latency_profile_key(input_device, output_device) -> str:
    return build_device_route_key(input_device, output_device)


def _identity_from_key_side(value):
    """Decode one side of a structured route key. Returns (identity, ok):
    ``None`` is a valid empty side; an undecodable payload is invalid."""
    if value is None:
        return None, True
    if isinstance(value, dict) and value.get("endpoint_id") and not value.get("name"):
        # stable endpoint keys omit rename-prone names; synthesise a
        # non-persisted placeholder so the normal validator accepts it
        value = dict(value, name=f"endpoint:{value['endpoint_id']}")
    parsed = coerce_device_identity(value)
    return parsed, parsed is not None


def parse_latency_profile_key(key: str):
    """Parse a latency profile key — legacy ``a||b`` name pairs or the
    structured JSON format (`shared.py:196-260`). Returns ``(input, output)``
    identities or None when the key is unusable."""
    text = str(key)
    if "||" in text:
        left, right = text.split("||", 1)
        pair = (coerce_device_identity(left), coerce_device_identity(right))
        return None if None in pair else pair

    try:
        payload = json.loads(text)
    except json.JSONDecodeError:
        return None
    if not isinstance(payload, dict) or set(payload) != {"input", "output"}:
        return None

    din, ok_in = _identity_from_key_side(payload.get("input"))
    dout, ok_out = _identity_from_key_side(payload.get("output"))
    if not (ok_in and ok_out) or din is None or dout is None:
        return None
    return din, dout
