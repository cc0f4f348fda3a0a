"""Preset schema with per-value provenance, migrations, and persistence.

Mirrors `python/mic_eq/config_parts/presets.py`:

- Every persisted value carries provenance ``explicit`` or
  ``migration_default`` so migrations preserve explicit user values
  (`presets.py:43-87`; `README.md:61-63`).
- The version-gated migration chain adds missing sections/fields per
  release (rnnoise strength @1.1, model @1.2, compressor auto-makeup @1.3,
  gate auto-threshold + the 0.5->0.48 vad-threshold correction @1.6,
  de-esser @1.7, the 0.4->0.48 vad-threshold re-correction before 1.10 —
  skipped for explicitly-set values) and then strictly re-validates every
  section (`presets.py:127-548`).
- Atomic file persistence (temp + fsync + rename) and path-confined loads
  (`presets.py:550-617`).
"""

from __future__ import annotations

import json
import os
import tempfile
from copy import deepcopy
from dataclasses import asdict, dataclass, field
from pathlib import Path

from .settings import (
    CompressorSettings,
    DeEsserSettings,
    EQSettings,
    GateSettings,
    LimiterSettings,
    RNNoiseSettings,
)
from .shared import (
    CURRENT_VERSION,
    PresetValidationError,
    _reject_json_constant,
    _version_tuple,
    get_preset_imports_dir,
    get_presets_dir,
)
from .validation import VALIDATION_RANGES, _validate_bool, _validate_range

_SECTIONS = ("gate", "eq", "rnnoise", "deesser", "compressor", "limiter")
PROVENANCE_EXPLICIT = "explicit"
PROVENANCE_MIGRATION_DEFAULT = "migration_default"
_VALID_PROVENANCE = {PROVENANCE_EXPLICIT, PROVENANCE_MIGRATION_DEFAULT}

__all__ = [
    "Preset",
    "PROVENANCE_EXPLICIT",
    "PROVENANCE_MIGRATION_DEFAULT",
    "generate_auto_eq_preset_name",
    "list_presets",
    "load_preset",
    "save_preset",
]

# Version checkpoints that bump the version string without structural change.
_PASSTHROUGH_VERSIONS = (
    "1.7.1", "1.7.2", "1.7.3", "1.7.4", "1.8.0", "1.8.1", "1.8.2", "1.8.3",
    "1.8.4", "1.8.5", "1.8.6", "1.8.7", "1.8.8", "1.8.9", "1.9.0", "1.10.0",
    "1.10.1", "1.11.0", "1.11.1", "1.11.2",
)


def _value_paths(data: dict) -> set[str]:
    """Enumerate every persisted value path (`presets.py:51-69`)."""
    paths: set[str] = set()
    for section in _SECTIONS:
        values = data.get(section)
        if isinstance(values, dict):
            if section == "eq" and isinstance(values.get("bands"), list):
                if "enabled" in values:
                    paths.add("eq.enabled")
                for i, band in enumerate(values["bands"]):
                    if isinstance(band, dict):
                        paths.update(f"eq.bands.{i}.{k}" for k in band)
            else:
                paths.update(f"{section}.{k}" for k in values)
    if "bypass" in data:
        paths.add("bypass")
    return paths


def _validated_provenance(value) -> dict[str, str]:
    if value is None:
        return {}
    if not isinstance(value, dict):
        raise PresetValidationError("Preset value_provenance must be an object")
    out = {}
    for path, source in value.items():
        if not isinstance(path, str) or source not in _VALID_PROVENANCE:
            raise PresetValidationError(
                "Preset value_provenance contains an invalid path or source"
            )
        out[path] = str(source)
    return out


@dataclass
class Preset:
    """Complete processing preset (`presets.py:87-120`)."""

    name: str = "Default"
    description: str = ""
    version: str = CURRENT_VERSION
    gate: GateSettings = field(default_factory=GateSettings)
    eq: EQSettings = field(default_factory=EQSettings)
    rnnoise: RNNoiseSettings = field(default_factory=RNNoiseSettings)
    deesser: DeEsserSettings = field(default_factory=DeEsserSettings)
    compressor: CompressorSettings = field(default_factory=CompressorSettings)
    limiter: LimiterSettings = field(default_factory=LimiterSettings)
    bypass: bool = False
    value_provenance: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        payload = {
            "name": self.name,
            "description": self.description,
            "version": self.version,
            "gate": asdict(self.gate),
            "eq": self.eq.to_dict(),
            "rnnoise": asdict(self.rnnoise),
            "deesser": asdict(self.deesser),
            "compressor": asdict(self.compressor),
            "limiter": asdict(self.limiter),
            "bypass": self.bypass,
        }
        provenance = dict(self.value_provenance)
        for path in _value_paths(payload):
            provenance.setdefault(path, PROVENANCE_EXPLICIT)
        payload["value_provenance"] = dict(sorted(provenance.items()))
        return payload

    def mark_value_explicit(self, path: str) -> None:
        if path not in _value_paths(self.to_dict()):
            raise ValueError(f"Unknown preset value path: {path}")
        self.value_provenance[path] = PROVENANCE_EXPLICIT

    @classmethod
    def from_dict(cls, data: dict) -> "Preset":
        try:
            data = deepcopy(data)
            if not isinstance(data, dict):
                raise ValueError("preset root must be an object")
            if not isinstance(data.get("name", "Unnamed"), str):
                raise ValueError("preset name must be a string")
            if not isinstance(data.get("description", ""), str):
                raise ValueError("preset description must be a string")
            provenance = _validated_provenance(data.get("value_provenance"))
            for path in _value_paths(data):
                provenance.setdefault(path, PROVENANCE_EXPLICIT)
            vt = _version_tuple(data.get("version", "1.0.0"))
            if vt > _version_tuple(CURRENT_VERSION):
                raise ValueError("preset version is newer than this build")

            # --- migration chain (`presets.py:147-268`) ---
            if vt < _version_tuple("1.1.0"):
                data.setdefault("rnnoise", {"enabled": True})
                data["rnnoise"].setdefault("strength", 1.0)
                data["version"] = "1.1.0"
                vt = _version_tuple("1.1.0")
            if vt < _version_tuple("1.2.0"):
                data.setdefault("rnnoise", {"enabled": True, "strength": 1.0})
                data["rnnoise"].setdefault("model", "rnnoise")
                data["version"] = "1.2.0"
                vt = _version_tuple("1.2.0")
            if vt < _version_tuple("1.3.0"):
                if "compressor" in data:
                    data["compressor"].setdefault("auto_makeup_enabled", False)
                    data["compressor"].setdefault("target_lufs", -18.0)
                    data["compressor"].setdefault("sidechain_highpass_enabled", True)
                else:
                    data["compressor"] = asdict(CompressorSettings())
                data["version"] = "1.3.0"
                vt = _version_tuple("1.3.0")
            for v in ("1.4.0", "1.5.0"):
                if vt < _version_tuple(v):
                    data["version"] = v
                    vt = _version_tuple(v)
            if vt < _version_tuple("1.6.0"):
                if "gate" in data:
                    data["gate"].setdefault("auto_threshold_enabled", True)
                    data["gate"].setdefault("gate_margin_db", 10.0)
                    # migrate the legacy 0.5 default unless explicitly set
                    if (
                        data["gate"].get("vad_threshold", 0.5) == 0.5
                        and provenance.get("gate.vad_threshold") != PROVENANCE_EXPLICIT
                    ):
                        data["gate"]["vad_threshold"] = 0.48
                else:
                    data["gate"] = {
                        "auto_threshold_enabled": True,
                        "gate_margin_db": 10.0,
                        "vad_threshold": 0.48,
                    }
                data["version"] = "1.6.0"
                vt = _version_tuple("1.6.0")
            if vt < _version_tuple("1.7.0"):
                if "deesser" in data:
                    for k, v in asdict(DeEsserSettings()).items():
                        data["deesser"].setdefault(k, v)
                else:
                    data["deesser"] = asdict(DeEsserSettings())
                data["version"] = "1.7.0"
                vt = _version_tuple("1.7.0")
            if vt < _version_tuple("1.10.0"):
                gate = data.get("gate")
                if (
                    isinstance(gate, dict)
                    and gate.get("vad_threshold") == 0.4
                    and provenance.get("gate.vad_threshold") != PROVENANCE_EXPLICIT
                ):
                    gate["vad_threshold"] = 0.48
            for v in _PASSTHROUGH_VERSIONS:
                if vt < _version_tuple(v):
                    data["version"] = v
                    vt = _version_tuple(v)

            for path in _value_paths(data):
                provenance.setdefault(path, PROVENANCE_MIGRATION_DEFAULT)

            # --- strict re-validation of every section ---
            gd = data.get("gate", {})
            gr = VALIDATION_RANGES["gate"]
            gate = GateSettings(
                enabled=_validate_bool(gd.get("enabled", True), "enabled", "gate"),
                threshold_db=_validate_range(gd.get("threshold_db", -40.0),
                                             *gr["threshold_db"], "threshold_db", "gate"),
                attack_ms=_validate_range(gd.get("attack_ms", 10.0),
                                          *gr["attack_ms"], "attack_ms", "gate"),
                release_ms=_validate_range(gd.get("release_ms", 100.0),
                                           *gr["release_ms"], "release_ms", "gate"),
                gate_mode=int(_validate_range(gd.get("gate_mode", 0),
                                              *gr["gate_mode"], "gate_mode", "gate")),
                vad_threshold=_validate_range(gd.get("vad_threshold", 0.48),
                                              *gr["vad_threshold"], "vad_threshold",
                                              "gate"),
                vad_hold_time_ms=_validate_range(gd.get("vad_hold_time_ms", 200.0),
                                                 *gr["vad_hold_time_ms"],
                                                 "vad_hold_time_ms", "gate"),
                vad_pre_gain=_validate_range(gd.get("vad_pre_gain", 1.0),
                                             *gr["vad_pre_gain"], "vad_pre_gain",
                                             "gate"),
                auto_threshold_enabled=_validate_bool(
                    gd.get("auto_threshold_enabled", True),
                    "auto_threshold_enabled", "gate"),
                gate_margin_db=_validate_range(gd.get("gate_margin_db", 10.0),
                                               *gr["gate_margin_db"],
                                               "gate_margin_db", "gate"),
            )

            eq_data = data.get("eq", {})
            eq = EQSettings.from_dict(eq_data)

            cd = data.get("compressor", {})
            cr = VALIDATION_RANGES["compressor"]
            comp = CompressorSettings(
                enabled=_validate_bool(cd.get("enabled", True), "enabled", "compressor"),
                threshold_db=_validate_range(cd.get("threshold_db", -20.0),
                                             *cr["threshold_db"], "threshold_db",
                                             "compressor"),
                ratio=_validate_range(cd.get("ratio", 4.0), *cr["ratio"],
                                      "ratio", "compressor"),
                attack_ms=_validate_range(cd.get("attack_ms", 10.0),
                                          *cr["attack_ms"], "attack_ms", "compressor"),
                release_ms=_validate_range(cd.get("release_ms", 200.0),
                                           *cr["release_ms"], "release_ms",
                                           "compressor"),
                makeup_gain_db=_validate_range(cd.get("makeup_gain_db", 0.0),
                                               *cr["makeup_gain_db"],
                                               "makeup_gain_db", "compressor"),
                adaptive_release=_validate_bool(cd.get("adaptive_release", False),
                                                "adaptive_release", "compressor"),
                base_release_ms=_validate_range(cd.get("base_release_ms", 50.0),
                                                20.0, 200.0, "base_release_ms",
                                                "compressor"),
                auto_makeup_enabled=_validate_bool(
                    cd.get("auto_makeup_enabled", False),
                    "auto_makeup_enabled", "compressor"),
                target_lufs=_validate_range(cd.get("target_lufs", -18.0),
                                            *cr["target_lufs"], "target_lufs",
                                            "compressor"),
                sidechain_highpass_enabled=_validate_bool(
                    cd.get("sidechain_highpass_enabled", True),
                    "sidechain_highpass_enabled", "compressor"),
            )

            ld = data.get("limiter", {})
            lr = VALIDATION_RANGES["limiter"]
            lim = LimiterSettings(
                enabled=_validate_bool(ld.get("enabled", True), "enabled", "limiter"),
                ceiling_db=_validate_range(ld.get("ceiling_db", -0.5),
                                           *lr["ceiling_db"], "ceiling_db", "limiter"),
                release_ms=_validate_range(ld.get("release_ms", 50.0),
                                           *lr["release_ms"], "release_ms", "limiter"),
                careful_output_enabled=_validate_bool(
                    ld.get("careful_output_enabled", True),
                    "careful_output_enabled", "limiter"),
            )

            rd = data.get("rnnoise", {})
            rr = VALIDATION_RANGES["rnnoise"]
            model = rd.get("model", "rnnoise")
            if model not in rr["model"]:
                model = "rnnoise"
            rn = RNNoiseSettings(
                enabled=_validate_bool(rd.get("enabled", True), "enabled", "rnnoise"),
                strength=_validate_range(rd.get("strength", 1.0), *rr["strength"],
                                         "strength", "rnnoise"),
                model=model,
            )

            dd = data.get("deesser", {})
            dr = VALIDATION_RANGES["deesser"]
            low_cut = _validate_range(dd.get("low_cut_hz", 4000.0),
                                      *dr["low_cut_hz"], "low_cut_hz", "deesser")
            high_cut = _validate_range(dd.get("high_cut_hz", 11000.0),
                                       *dr["high_cut_hz"], "high_cut_hz", "deesser")
            if high_cut <= low_cut + 200.0:
                high_cut = min(16000.0, low_cut + 200.0)
                low_cut = min(low_cut, high_cut - 200.0)
            de = DeEsserSettings(
                enabled=_validate_bool(dd.get("enabled", False), "enabled", "deesser"),
                auto_enabled=_validate_bool(dd.get("auto_enabled", True),
                                            "auto_enabled", "deesser"),
                auto_amount=_validate_range(dd.get("auto_amount", 0.5),
                                            *dr["auto_amount"], "auto_amount",
                                            "deesser"),
                low_cut_hz=low_cut,
                high_cut_hz=high_cut,
                threshold_db=_validate_range(dd.get("threshold_db", -28.0),
                                             *dr["threshold_db"], "threshold_db",
                                             "deesser"),
                ratio=_validate_range(dd.get("ratio", 4.0), *dr["ratio"],
                                      "ratio", "deesser"),
                attack_ms=_validate_range(dd.get("attack_ms", 2.0),
                                          *dr["attack_ms"], "attack_ms", "deesser"),
                release_ms=_validate_range(dd.get("release_ms", 80.0),
                                           *dr["release_ms"], "release_ms", "deesser"),
                max_reduction_db=_validate_range(dd.get("max_reduction_db", 6.0),
                                                 *dr["max_reduction_db"],
                                                 "max_reduction_db", "deesser"),
            )

            validated = {
                "gate": asdict(gate),
                "eq": eq.to_dict(),
                "rnnoise": asdict(rn),
                "deesser": asdict(de),
                "compressor": asdict(comp),
                "limiter": asdict(lim),
                "bypass": data.get("bypass", False),
            }
            # carry legacy array provenance onto schema-v2 band fields
            if isinstance(eq_data, dict) and "bands" not in eq_data:
                for legacy_name, band_name in (
                    ("band_freqs", "frequency_hz"),
                    ("band_gains", "gain_db"),
                    ("band_qs", "q"),
                ):
                    source = provenance.pop(f"eq.{legacy_name}", None)
                    if source is None or legacy_name not in eq_data:
                        continue
                    for i in range(len(eq.bands)):
                        provenance.setdefault(f"eq.bands.{i}.{band_name}", source)
            for path in _value_paths(validated):
                provenance.setdefault(path, PROVENANCE_MIGRATION_DEFAULT)
            unknown = set(provenance) - _value_paths(validated)
            if unknown:
                raise ValueError(
                    "value_provenance contains unknown paths: "
                    + ", ".join(sorted(unknown))
                )

            return cls(
                name=data.get("name", "Unnamed"),
                description=data.get("description", ""),
                version=data.get("version", CURRENT_VERSION),
                gate=gate, eq=eq, rnnoise=rn, deesser=de, compressor=comp,
                limiter=lim,
                bypass=_validate_bool(data.get("bypass", False), "bypass", "preset"),
                value_provenance=provenance,
            )
        except (KeyError, TypeError, ValueError, AttributeError) as exc:
            raise PresetValidationError(
                f"Preset data is invalid or corrupted: {exc}"
            ) from exc


def save_preset(preset: Preset, filepath: Path | None = None) -> Path:
    """Atomic write: temp + fsync + rename (`presets.py:550-577`)."""
    if filepath is None:
        safe = "".join(c if c.isalnum() or c in " -_" else "_" for c in preset.name)
        safe = safe.strip().replace(" ", "_") or "preset"
        filepath = get_presets_dir() / f"{safe}.json"
    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(prefix=f".{filepath.name}.", suffix=".tmp",
                                    dir=filepath.parent, text=True)
    tmp = Path(tmp_name)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as handle:
            json.dump(preset.to_dict(), handle, indent=2, allow_nan=False)
            handle.flush()
            os.fsync(handle.fileno())
        os.replace(tmp, filepath)
    except Exception:
        tmp.unlink(missing_ok=True)
        raise
    return filepath


def load_preset(filepath: Path) -> Preset:
    """Path-confined, constant-rejecting preset load (`presets.py:579-617`)."""
    requested = Path(filepath)
    if requested.suffix.lower() != ".json":
        raise PresetValidationError(
            f"Invalid preset file: '{requested.name}' - must be a .json file"
        )
    if not requested.exists():
        raise PresetValidationError(f"Preset file not found: '{requested.name}'")
    try:
        resolved = requested.resolve(strict=True)
    except OSError as exc:
        raise PresetValidationError(
            f"Invalid preset path: '{requested.name}' - {exc}"
        ) from exc
    if not resolved.is_file():
        raise PresetValidationError(
            f"Invalid preset path: '{requested.name}' - not a file"
        )
    roots = [get_presets_dir().resolve(), get_preset_imports_dir().resolve()]
    if not any(r == resolved or r in resolved.parents for r in roots):
        raise PresetValidationError(
            f"Invalid preset path: '{requested.name}' - path must be inside "
            f"allowed preset roots: {', '.join(str(r) for r in roots)}"
        )
    with open(resolved, "r", encoding="utf-8") as handle:
        data = json.load(handle, parse_constant=_reject_json_constant)
    return Preset.from_dict(data)


def list_presets() -> list[tuple[str, Path]]:
    out = []
    for fp in get_presets_dir().glob("*.json"):
        try:
            out.append((load_preset(fp).name, fp))
        except (json.JSONDecodeError, KeyError, PresetValidationError, TypeError,
                ValueError):
            continue
    return sorted(out, key=lambda item: item[0].lower())


def generate_auto_eq_preset_name(target_curve: str) -> str:
    names = {"broadcast": "Broadcast", "podcast": "Podcast",
             "streaming": "Streaming", "flat": "Flat"}
    return f"Auto-EQ {names.get(target_curve.lower(), target_curve.title())}"
