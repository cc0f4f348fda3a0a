"""Parity of the port's copies of the framework-free modules: ``config/``,
``diagnostics_export.py`` and ``app_logging.py`` of ``audioforge_tpu_torch``
against those of ``audioforge_tpu``, on the same inputs.

Every builtin preset's ``to_dict()``; save and load round trips with each
package reading the other's files (both keep the same directory under
``HOME``); invalid presets raising the same exception type name and message;
old-version migrations; ``AppConfig`` load and save; the serialised
diagnostics snapshot with a fixed ``generated_at``, ``pseudonym_key`` and
``system_info`` (equal bytes); ``app_logging.get_log_file()``.
"""

import json
from datetime import datetime, timezone

import pytest

import audioforge_tpu.config as jcfg
import audioforge_tpu_torch.config as tcfg
from audioforge_tpu import app_logging as jlog
from audioforge_tpu import diagnostics_export as jde
from audioforge_tpu_torch import app_logging as tlog
from audioforge_tpu_torch import diagnostics_export as tde

WHEN = datetime(2026, 8, 16, 12, 0, 0, tzinfo=timezone.utc)
KEY = b"0123456789abcdef0123456789abcdef"
SYSTEM = {"operating_system": "Linux", "os_release": "6.0", "os_version": "#1 SMP",
          "architecture": "x86_64", "python_version": "3.12.0",
          "python_implementation": "CPython"}


@pytest.fixture()
def config_home(tmp_path, monkeypatch):
    """Point the config dir at a temp HOME so tests never touch real state."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("XDG_CONFIG_HOME", raising=False)
    return tmp_path


def test_builtin_presets_match():
    assert list(tcfg.BUILTIN_PRESETS) == list(jcfg.BUILTIN_PRESETS)
    for key, preset in jcfg.BUILTIN_PRESETS.items():
        assert tcfg.BUILTIN_PRESETS[key].to_dict() == preset.to_dict(), key
    assert {k: v.band_targets for k, v in tcfg.TARGET_CURVES.items()} == {
        k: v.band_targets for k, v in jcfg.TARGET_CURVES.items()}


@pytest.mark.parametrize("writer,reader", [(tcfg, jcfg), (jcfg, tcfg)],
                         ids=["port-writes", "reference-writes"])
def test_save_load_round_trip_across_packages(config_home, writer, reader):
    for key, preset in writer.BUILTIN_PRESETS.items():
        path = writer.save_preset(preset)
        assert config_home in path.parents
        loaded = reader.load_preset(path)
        assert loaded.to_dict() == preset.to_dict(), key
    assert tcfg.list_presets() == jcfg.list_presets()
    assert len(tcfg.list_presets()) == len(writer.BUILTIN_PRESETS)


_INVALID = [
    {"name": "e", "gate": {"threshold_db": -200.0}},
    {"name": "e", "compressor": {"ratio": 100.0}},
    {"name": "f", "gate": {"enabled": 1}},
    {"name": "v", "version": "99.0.0"},
    {"name": "p", "value_provenance": {"gate.nope": "explicit"}},
    {"name": "q", "value_provenance": {"gate.threshold_db": "guessed"}},
    {"name": "b", "eq": {"schema_version": 2, "bands": [{"filter_type": "wobble"}]}},
    {"name": "n", "limiter": {"ceiling_db": float("nan")}},
    {"name": "d", "deesser": {"ratio": "3"}},
    {"name": "o", "eq": {"bands": [{"bandwidth_mode": "octaves", "q": 1.0,
                                     "bandwidth_octaves": 0.1}] * 10,
                         "schema_version": 2}},
]


@pytest.mark.parametrize("data", _INVALID, ids=[f"invalid{i}" for i in range(len(_INVALID))])
def test_invalid_presets_raise_alike(data):
    errors = []
    for cfg in (jcfg, tcfg):
        with pytest.raises(Exception) as info:
            cfg.Preset.from_dict(json.loads(json.dumps(data)))
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


_OLD = [
    {"name": "old", "version": "1.0.0"},
    {"name": "eq", "version": "1.0.0", "eq_band_gains": [2.0] * 10,
     "eq_band_qs": [1.2] * 10},
    {"name": "c", "version": "1.2.0", "compressor": {"threshold_db": -30.0}},
    {"name": "g", "version": "1.5.0", "gate": {"threshold_db": -33.0, "vad_threshold": 0.5}},
    {"name": "d", "version": "1.6.0", "deesser": {"ratio": 5.0}},
    {"name": "v", "version": "1.9.0", "gate": {"vad_threshold": 0.4}},
    {"name": "p", "version": "1.11.0", "gate": {"threshold_db": -41.0}},
]


@pytest.mark.parametrize("data", _OLD, ids=[d["version"] + d["name"] for d in _OLD])
def test_migrations_match(data):
    got = tcfg.Preset.from_dict(json.loads(json.dumps(data)))
    want = jcfg.Preset.from_dict(json.loads(json.dumps(data)))
    assert got.to_dict() == want.to_dict()
    assert got.value_provenance == want.value_provenance
    assert got.version == tcfg.CURRENT_VERSION == jcfg.CURRENT_VERSION


def test_app_config_load_and_save_across_packages(config_home):
    raw = {"version": "1.0.0", "last_input_device": "Mic", "window_geometry": [1, 2, 30, 40],
           "latency_profiles": {"Mic||Speakers": {"measured_latency_ms": 41.5}},
           "device_preset_bindings": {"Mic": "voice"}, "input_cleanup_mode": "loud"}
    got, want = tcfg.AppConfig.from_dict(dict(raw)), jcfg.AppConfig.from_dict(dict(raw))
    assert got.to_dict() == want.to_dict()
    assert tcfg.AppConfig().to_dict() == jcfg.AppConfig().to_dict()
    tcfg.save_config(got)
    assert jcfg.load_config().to_dict() == want.to_dict()
    jcfg.save_config(jcfg.AppConfig())
    assert tcfg.load_config().to_dict() == jcfg.AppConfig().to_dict()
    assert tcfg.get_config_file() == jcfg.get_config_file()


def _snapshot(de, cfg, runtime):
    return de.build_diagnostics_snapshot(
        app_version="0.1.0", runtime_diagnostics=runtime, config=cfg.AppConfig(),
        processing_settings=cfg.BUILTIN_PRESETS["voice"].to_dict(),
        input_device={"name": "Secret Mic 3000", "endpoint_id": "ep1", "host_api": "virtual",
                      "direction": "input", "is_default": True},
        output_device="Private Speakers", processing_sample_rate_hz=48000,
        output_sample_rate_hz=48000, running=True, generated_at=WHEN, pseudonym_key=KEY,
        system_info=SYSTEM)


def test_diagnostics_snapshot_bytes_match(tmp_path):
    runtime = {"input_dropped_samples": 0, "output_underrun_total": 3,
               "noise_model": "rnnoise", "noise_backend_available": True,
               "noise_backend_failed": False, "last_stream_error": None,
               "input_channel_mode": "average", "rt_error_name": "none",
               "gate_fused_score": 0.4, "home_directory": "/home/x"}
    got = tde.serialize_diagnostics_snapshot(_snapshot(tde, tcfg, runtime))
    want = jde.serialize_diagnostics_snapshot(_snapshot(jde, jcfg, runtime))
    assert got == want
    assert b"Secret Mic" not in got and b"/home/x" not in got
    assert tde.diagnostics_filename("0.1.0", WHEN) == jde.diagnostics_filename("0.1.0", WHEN)
    snap = _snapshot(tde, tcfg, runtime)
    snap["runtime"]["home_directory"] = "/home/x"
    with pytest.raises(ValueError, match="unexpected runtime fields"):
        tde.serialize_diagnostics_snapshot(snap)
    path = tmp_path / "snap.json"
    tde.write_diagnostics_snapshot(path, _snapshot(tde, tcfg, runtime))
    assert path.read_bytes() == want


def test_log_file_matches(config_home, monkeypatch):
    assert tlog.get_log_file() == jlog.get_log_file()
    assert config_home in tlog.get_log_file().parents
    monkeypatch.setenv("XDG_CONFIG_HOME", str(config_home / "xdg"))
    assert tlog.get_log_file() == jlog.get_log_file() == (
        config_home / "xdg" / "AudioForge" / "logs" / "app.log")
