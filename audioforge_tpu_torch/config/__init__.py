"""Config / persistence layer: versioned app config, presets with per-value
provenance, EQ schema v2, builtin catalogs.

Facade mirroring `python/mic_eq/config.py`: one import surface over the
focused submodules (catalogs, shared, validation, settings, presets,
app_config).
"""

from .catalogs import (  # noqa: F401
    ANALYSIS_MAX_SPECTRAL_FLATNESS,
    ANALYSIS_MIN_DYNAMIC_RANGE,
    ANALYSIS_MIN_PEAK_COUNT,
    ANALYSIS_MIN_SNR,
    AUTO_EQ_DEFAULT_Q,
    EQ_FREQUENCIES,
    EQ_SCHEMA_VERSION,
    TARGET_CURVES,
    TargetCurve,
    build_builtin_presets,
    build_target_curves,
)
from .shared import (  # noqa: F401
    APPDATA_DIR_NAME,
    CURRENT_VERSION,
    DeviceIdentity,
    LEGACY_APPDATA_DIR_NAME,
    PresetValidationError,
    build_device_route_key,
    build_latency_profile_key,
    coerce_device_identity,
    get_config_file,
    get_preset_imports_dir,
    get_presets_dir,
    legacy_latency_profile_key,
    parse_latency_profile_key,
)
from .validation import (  # noqa: F401
    VALIDATION_RANGES,
    _coerce_config_bool,
    _coerce_window_geometry,
    _validate_bool,
    _validate_range,
)
from .settings import (  # noqa: F401
    EQ_BAND_COUNT,
    EQ_BANDWIDTH_MODES,
    EQ_FILTER_TYPES,
    EQ_RUNTIME_SAMPLE_RATE,
    EQ_SLOPES_DB_PER_OCTAVE,
    EQ_STAGES,
    CompressorSettings,
    DeEsserSettings,
    EQBandSettings,
    EQSettings,
    GateSettings,
    LatencyCalibrationProfile,
    LimiterSettings,
    RNNoiseSettings,
    q_from_bandwidth_octaves,
)
from .presets import (  # noqa: F401
    PROVENANCE_EXPLICIT,
    PROVENANCE_MIGRATION_DEFAULT,
    Preset,
    generate_auto_eq_preset_name,
    list_presets,
    load_preset,
    save_preset,
)
from .app_config import (  # noqa: F401
    DYNAMICS_INTENSITIES,
    FIRST_RUN_SETUP_STATES,
    FIRST_RUN_SETUP_STEPS,
    INPUT_CHANNEL_MODES,
    INPUT_CLEANUP_MODES,
    AppConfig,
    DevicePresetBinding,
    load_config,
    save_config,
)

BUILTIN_PRESETS = build_builtin_presets(
    Preset, GateSettings, EQSettings, RNNoiseSettings
)
