"""Typed, versioned stage settings and the EQ schema v2.

Mirrors `python/mic_eq/config_parts/settings.py`:

- EQ schema v2: typed bands {filter_type, frequency, gain, Q-or-bandwidth-
  octaves, slope, enabled}, strict field sets, octave-bandwidth <-> Q
  consistency at 48 kHz, legacy array views and migration
  (`settings.py:11-47,132-543`).
- Gate / RNNoise / DeEsser / Compressor / Limiter settings dataclasses with
  the reference defaults; `LatencyCalibrationProfile`.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Mapping, Sequence

from .catalogs import AUTO_EQ_DEFAULT_Q, EQ_FREQUENCIES, EQ_SCHEMA_VERSION

EQ_BAND_COUNT = 10
EQ_FILTER_TYPES = frozenset(
    {"low_shelf", "bell", "high_shelf", "notch", "high_pass", "low_pass"}
)
EQ_BANDWIDTH_MODES = frozenset({"q", "octaves"})
EQ_STAGES = frozenset({"combined"})
EQ_SLOPES_DB_PER_OCTAVE = frozenset({12, 24, 36, 48})
EQ_RUNTIME_SAMPLE_RATE = 48000.0

__all__ = [
    "EQ_BAND_COUNT",
    "EQ_BANDWIDTH_MODES",
    "EQ_FILTER_TYPES",
    "EQ_RUNTIME_SAMPLE_RATE",
    "EQ_SLOPES_DB_PER_OCTAVE",
    "EQ_STAGES",
    "CompressorSettings",
    "DeEsserSettings",
    "EQBandSettings",
    "EQSettings",
    "GateSettings",
    "LatencyCalibrationProfile",
    "LimiterSettings",
    "RNNoiseSettings",
    "q_from_bandwidth_octaves",
]


def q_from_bandwidth_octaves(frequency_hz: float, bandwidth_octaves: float,
                             sample_rate: float = EQ_RUNTIME_SAMPLE_RATE) -> float:
    """Exact digital-domain bandwidth->Q conversion at the runtime rate
    (`settings.py:58-90`): the octave bandwidth is interpreted around the
    warped center frequency."""
    w0 = 2.0 * math.pi * frequency_hz / sample_rate
    n = float(bandwidth_octaves)
    # RBJ: 1/Q = 2*sinh(ln(2)/2 * N * w0/sin(w0))
    arg = math.log(2.0) / 2.0 * n * (w0 / math.sin(w0)) if w0 > 0 else math.log(2.0) / 2.0 * n
    return 1.0 / (2.0 * math.sinh(arg))


def _finite_float(value, *, name, low, high) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"{name} must be a finite number")
    parsed = float(value)
    if not math.isfinite(parsed):
        raise ValueError(f"{name} must be a finite number")
    if not low <= parsed <= high:
        raise ValueError(f"{name} must be between {low} and {high}")
    return parsed


def _strict_bool(value, *, name) -> bool:
    if not isinstance(value, bool):
        raise ValueError(f"{name} must be true or false")
    return value


@dataclass
class GateSettings:
    enabled: bool = True
    threshold_db: float = -40.0
    attack_ms: float = 10.0
    release_ms: float = 100.0
    gate_mode: int = 0
    vad_threshold: float = 0.48
    vad_hold_time_ms: float = 200.0
    vad_pre_gain: float = 1.0
    auto_threshold_enabled: bool = True
    gate_margin_db: float = 10.0


@dataclass(frozen=True)
class EQBandSettings:
    """One immutable serialized EQ band (`settings.py:132-298`)."""

    filter_type: str
    frequency_hz: float
    gain_db: float
    q: float
    bandwidth_mode: str = "q"
    bandwidth_octaves: float | None = None
    slope_db_per_octave: int = 12
    stage: str = "combined"
    enabled: bool = True

    def __post_init__(self):
        if self.filter_type not in EQ_FILTER_TYPES:
            raise ValueError(f"unsupported EQ filter type: {self.filter_type}")
        _finite_float(self.frequency_hz, name="frequency_hz", low=20.0, high=20000.0)
        _finite_float(self.gain_db, name="gain_db", low=-12.0, high=12.0)
        _finite_float(self.q, name="q", low=0.1, high=10.0)
        if self.bandwidth_mode not in EQ_BANDWIDTH_MODES:
            raise ValueError(f"unsupported EQ bandwidth mode: {self.bandwidth_mode}")
        if self.bandwidth_octaves is not None:
            _finite_float(self.bandwidth_octaves, name="bandwidth_octaves",
                          low=0.1, high=8.0)
        if self.bandwidth_mode == "octaves" and self.bandwidth_octaves is None:
            raise ValueError(
                "bandwidth_octaves is required when bandwidth_mode is octaves"
            )
        if self.bandwidth_mode == "q" and self.bandwidth_octaves is not None:
            raise ValueError("bandwidth_octaves must be null when bandwidth_mode is q")
        if self.bandwidth_mode == "octaves":
            if self.filter_type not in {"bell", "notch"}:
                raise ValueError(
                    "octave bandwidth is supported only for bell and notch"
                )
            eq_q = q_from_bandwidth_octaves(self.frequency_hz, self.bandwidth_octaves)
            if not 0.1 <= eq_q <= 10.0:
                raise ValueError(
                    "octave bandwidth resolves outside the supported Q range"
                )
            if not math.isclose(float(self.q), eq_q, rel_tol=1e-6, abs_tol=1e-8):
                raise ValueError(
                    "q must match the octave-bandwidth equivalent at 48 kHz"
                )
        if self.slope_db_per_octave not in EQ_SLOPES_DB_PER_OCTAVE:
            raise ValueError(f"unsupported EQ slope: {self.slope_db_per_octave}")
        if self.stage not in EQ_STAGES:
            raise ValueError(f"unsupported EQ stage: {self.stage}")
        _strict_bool(self.enabled, name="enabled")

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data, *, index: int) -> "EQBandSettings":
        if not isinstance(data, Mapping):
            raise ValueError(f"eq.bands.{index} must be an object")
        allowed = {
            "filter_type", "frequency_hz", "gain_db", "q", "bandwidth_mode",
            "bandwidth_octaves", "slope_db_per_octave", "stage", "enabled",
        }
        unknown = set(data) - allowed
        if unknown:
            raise ValueError(
                f"eq.bands.{index} contains unknown fields: "
                + ", ".join(sorted(str(k) for k in unknown))
            )
        missing = allowed - set(data)
        if missing:
            raise ValueError(
                f"eq.bands.{index} is missing fields: " + ", ".join(sorted(missing))
            )
        ftype = data["filter_type"]
        mode = data["bandwidth_mode"]
        stage = data["stage"]
        slope = data["slope_db_per_octave"]
        if not isinstance(ftype, str):
            raise ValueError(f"eq.bands.{index}.filter_type must be a string")
        if not isinstance(mode, str):
            raise ValueError(f"eq.bands.{index}.bandwidth_mode must be a string")
        if not isinstance(stage, str):
            raise ValueError(f"eq.bands.{index}.stage must be a string")
        if isinstance(slope, bool) or not isinstance(slope, int):
            raise ValueError(f"eq.bands.{index}.slope_db_per_octave must be an integer")
        bw = data["bandwidth_octaves"]
        return cls(
            filter_type=ftype,
            frequency_hz=_finite_float(data["frequency_hz"],
                                       name=f"eq.bands.{index}.frequency_hz",
                                       low=20.0, high=20000.0),
            gain_db=_finite_float(data["gain_db"], name=f"eq.bands.{index}.gain_db",
                                  low=-12.0, high=12.0),
            q=_finite_float(data["q"], name=f"eq.bands.{index}.q", low=0.1, high=10.0),
            bandwidth_mode=mode,
            bandwidth_octaves=(
                None if bw is None
                else _finite_float(bw, name=f"eq.bands.{index}.bandwidth_octaves",
                                   low=0.1, high=8.0)
            ),
            slope_db_per_octave=slope,
            stage=stage,
            enabled=_strict_bool(data["enabled"], name=f"eq.bands.{index}.enabled"),
        )


def _default_filter_type(index: int) -> str:
    if index == 0:
        return "low_shelf"
    if index == EQ_BAND_COUNT - 1:
        return "high_shelf"
    return "bell"


def _validated_legacy_array(value, *, name, low, high) -> list[float]:
    if not isinstance(value, (list, tuple)) or len(value) != EQ_BAND_COUNT:
        raise ValueError(f"{name} must contain {EQ_BAND_COUNT} values")
    return [
        _finite_float(v, name=f"{name}.{i}", low=low, high=high)
        for i, v in enumerate(value)
    ]


def _legacy_bands(freqs, gains, qs) -> tuple[EQBandSettings, ...]:
    if not (len(freqs) == len(gains) == len(qs) == EQ_BAND_COUNT):
        raise ValueError(f"EQ settings must contain {EQ_BAND_COUNT} bands")
    return tuple(
        EQBandSettings(
            filter_type=_default_filter_type(i),
            frequency_hz=_finite_float(f, name=f"band_freqs.{i}", low=20.0, high=20000.0),
            gain_db=_finite_float(g, name=f"band_gains.{i}", low=-12.0, high=12.0),
            q=_finite_float(q, name=f"band_qs.{i}", low=0.1, high=10.0),
        )
        for i, (f, g, q) in enumerate(zip(freqs, gains, qs))
    )


@dataclass(init=False)
class EQSettings:
    """Versioned EQ schema with immutable bands and legacy list views
    (`settings.py:346-520`)."""

    enabled: bool
    schema_version: int
    bands: tuple[EQBandSettings, ...]

    def __init__(self, enabled: bool = True, band_freqs=None, band_gains=None,
                 band_qs=None, *, schema_version: int = EQ_SCHEMA_VERSION, bands=None):
        self.enabled = _strict_bool(enabled, name="eq.enabled")
        if schema_version != EQ_SCHEMA_VERSION:
            raise ValueError(f"unsupported EQ schema version: {schema_version}")
        self.schema_version = schema_version
        if bands is not None:
            if any(v is not None for v in (band_freqs, band_gains, band_qs)):
                raise ValueError("EQ bands cannot be combined with legacy band arrays")
            parsed = tuple(bands)
            if len(parsed) != EQ_BAND_COUNT or not all(
                isinstance(b, EQBandSettings) for b in parsed
            ):
                raise ValueError(f"EQ settings must contain {EQ_BAND_COUNT} typed bands")
            self.bands = parsed
        else:
            self.bands = _legacy_bands(
                EQ_FREQUENCIES if band_freqs is None else band_freqs,
                [0.0] * EQ_BAND_COUNT if band_gains is None else band_gains,
                [1.41] * EQ_BAND_COUNT if band_qs is None else band_qs,
            )

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "enabled": self.enabled,
            "bands": [b.to_dict() for b in self.bands],
        }

    @classmethod
    def from_dict(cls, data) -> "EQSettings":
        if not isinstance(data, Mapping):
            raise ValueError("eq must be an object")
        new_fields = {"schema_version", "enabled", "bands"}
        legacy_fields = {"enabled", "band_freqs", "band_gains", "band_qs"}
        fields = set(data)
        if "bands" in data or "schema_version" in data:
            unknown = fields - new_fields
            if unknown:
                raise ValueError(
                    "eq contains unknown fields: "
                    + ", ".join(sorted(str(k) for k in unknown))
                )
            if fields != new_fields:
                raise ValueError(
                    "eq is missing fields: "
                    + ", ".join(sorted(str(k) for k in new_fields - fields))
                )
            sv = data["schema_version"]
            if isinstance(sv, bool) or not isinstance(sv, int):
                raise ValueError("eq.schema_version must be an integer")
            raw_bands = data["bands"]
            if not isinstance(raw_bands, list):
                raise ValueError("eq.bands must be an array")
            return cls(
                enabled=_strict_bool(data["enabled"], name="eq.enabled"),
                schema_version=sv,
                bands=[EQBandSettings.from_dict(b, index=i) for i, b in enumerate(raw_bands)],
            )
        unknown = fields - legacy_fields
        if unknown:
            raise ValueError(
                "legacy eq contains unknown fields: "
                + ", ".join(sorted(str(k) for k in unknown))
            )
        return cls(
            enabled=_strict_bool(data.get("enabled", True), name="eq.enabled"),
            band_freqs=_validated_legacy_array(
                data.get("band_freqs", EQ_FREQUENCIES),
                name="eq.band_freqs", low=20.0, high=20000.0),
            band_gains=_validated_legacy_array(
                data.get("band_gains", [0.0] * EQ_BAND_COUNT),
                name="eq.band_gains", low=-12.0, high=12.0),
            band_qs=_validated_legacy_array(
                data.get("band_qs", [1.41] * EQ_BAND_COUNT),
                name="eq.band_qs", low=0.1, high=10.0),
        )

    def _replace_values(self, field_name: str, values: Sequence) -> None:
        if len(values) != EQ_BAND_COUNT:
            raise ValueError(f"{field_name} must contain {EQ_BAND_COUNT} values")
        limits = {
            "frequency_hz": ("band_freqs", 20.0, 20000.0),
            "gain_db": ("band_gains", -12.0, 12.0),
            "q": ("band_qs", 0.1, 10.0),
        }
        new_bands = []
        for i, (band, value) in enumerate(zip(self.bands, values)):
            if field_name in limits:
                label, lo, hi = limits[field_name]
                value = _finite_float(value, name=f"{label}.{i}", low=lo, high=hi)
            new_bands.append(replace(band, **{field_name: value}))
        self.bands = tuple(new_bands)

    @property
    def band_freqs(self):
        return [b.frequency_hz for b in self.bands]

    @band_freqs.setter
    def band_freqs(self, values):
        self._replace_values("frequency_hz", values)

    @property
    def band_gains(self):
        return [b.gain_db for b in self.bands]

    @band_gains.setter
    def band_gains(self, values):
        self._replace_values("gain_db", values)

    @property
    def band_qs(self):
        return [b.q for b in self.bands]

    @band_qs.setter
    def band_qs(self, values):
        self._replace_values("q", values)


@dataclass
class RNNoiseSettings:
    enabled: bool = True
    strength: float = 1.0
    model: str = "rnnoise"


@dataclass
class DeEsserSettings:
    enabled: bool = False
    auto_enabled: bool = True
    auto_amount: float = 0.5
    low_cut_hz: float = 4000.0
    high_cut_hz: float = 11000.0
    threshold_db: float = -28.0
    ratio: float = 4.0
    attack_ms: float = 2.0
    release_ms: float = 80.0
    max_reduction_db: float = 6.0


@dataclass
class CompressorSettings:
    enabled: bool = True
    threshold_db: float = -20.0
    ratio: float = 4.0
    attack_ms: float = 10.0
    release_ms: float = 200.0
    makeup_gain_db: float = 0.0
    adaptive_release: bool = False
    base_release_ms: float = 50.0
    auto_makeup_enabled: bool = False
    target_lufs: float = -18.0
    sidechain_highpass_enabled: bool = True


@dataclass
class LimiterSettings:
    enabled: bool = True
    ceiling_db: float = -0.5
    release_ms: float = 50.0
    careful_output_enabled: bool = True


@dataclass
class LatencyCalibrationProfile:
    """Measured per-route latency profile (`settings.py:604-700`)."""

    measured_round_trip_ms: float
    estimated_one_way_ms: float
    applied_compensation_ms: float
    confidence: float
    agreement_ms: float = 0.0
    ambiguity_score: float = 0.0
    repetition_count: int = 0
    sample_rate: int = 48000
    timestamp_utc: str = ""
    route_latency_ms: float = 0.0
    directional_latency_ms: float | None = None
    route_kind: str = "output_to_input"
    compensation_basis: str = "measured_output_to_input_route"
    engine_latency_ms: float = 0.0
    total_latency_ms: float = 0.0
    engine_config_signature: str = ""

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, data) -> "LatencyCalibrationProfile":
        if not isinstance(data, Mapping):
            raise ValueError("latency profile must be an object")

        def f(name, default=0.0):
            return _finite_float(data.get(name, default),
                                 name=f"latency profile {name}", low=0.0, high=60000.0)

        def i(name, default, lo, hi):
            v = data.get(name, default)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return default
            n = float(v)
            if not math.isfinite(n) or not n.is_integer():
                return default
            return int(n) if lo <= int(n) <= hi else default

        directional = data.get("directional_latency_ms")
        return cls(
            measured_round_trip_ms=f("measured_round_trip_ms"),
            estimated_one_way_ms=f("estimated_one_way_ms"),
            applied_compensation_ms=f("applied_compensation_ms"),
            confidence=_finite_float(data.get("confidence", 0.0),
                                     name="latency profile confidence",
                                     low=0.0, high=1.0),
            agreement_ms=f("agreement_ms"),
            ambiguity_score=_finite_float(data.get("ambiguity_score", 0.0),
                                          name="latency profile ambiguity_score",
                                          low=0.0, high=1.0),
            repetition_count=i("repetition_count", 0, 0, 1000),
            sample_rate=i("sample_rate", 48000, 8000, 384000),
            timestamp_utc=str(data.get("timestamp_utc", "")),
            route_latency_ms=f("route_latency_ms"),
            directional_latency_ms=(
                None if directional is None
                else _finite_float(directional,
                                   name="latency profile directional_latency_ms",
                                   low=0.0, high=60000.0)
            ),
            route_kind=str(data.get("route_kind", "output_to_input")),
            compensation_basis=str(
                data.get("compensation_basis", "measured_output_to_input_route")
            ),
            engine_latency_ms=f("engine_latency_ms"),
            total_latency_ms=f("total_latency_ms"),
            engine_config_signature=str(data.get("engine_config_signature", "")),
        )
