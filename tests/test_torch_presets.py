"""The port's preset layer against the JAX package's, on the CPU.

- ``apply_preset`` then ``capture_preset`` on ``AudioProcessor(device="cpu")``
  and on the JAX processor: equal dicts for every builtin preset.
- ``serving_config_for_preset``: the same topology fields.
- 4 streams with 4 builtin presets (``apply_preset_to_stream``) through the
  JAX engine and through the port's engine sharded over 2 CPU shards, 3
  blocks: 1e-4 RMS, 1e-3 max. The reference's chain is built with
  ``cleanup_mode=0`` (ROADMAP F1: its string "off" runs strong cleanup).
- A diagnostics snapshot from the port processor's own
  ``get_runtime_diagnostics()``; ``run --preset <file> --device cpu``; the
  package root's names; and, in a fresh interpreter, no ``jax`` and no
  ``audioforge_tpu`` after importing every module of this slice.
"""

import dataclasses
import subprocess
import sys
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.usefixtures("no_persistent_cache")

import audioforge_tpu
import audioforge_tpu.config as jcfg
import audioforge_tpu_torch
import audioforge_tpu_torch.config as tcfg
from audioforge_tpu import diagnostics_export as jde
from audioforge_tpu.runtime import preset_io as jpio
from audioforge_tpu.runtime import processor as jproc
from audioforge_tpu.runtime import serving as jsv
from audioforge_tpu_torch import diagnostics_export as tde
from audioforge_tpu_torch.__main__ import main as cli_main
from audioforge_tpu_torch.parallel import fleet_mesh
from audioforge_tpu_torch.runtime import preset_io as tpio
from audioforge_tpu_torch.runtime import processor as tproc
from audioforge_tpu_torch.runtime import serving as tsv

ROOT = Path(__file__).resolve().parents[1]
BLOCK = tsv.BLOCK
PRESETS = list(jcfg.BUILTIN_PRESETS)
# builtin presets that share the "voice" topology (no warning on its engine)
FLEET_PRESETS = ("voice", "bass_cut", "presence", "aggressive_denoise")
WHEN = datetime(2026, 8, 16, 12, 0, 0, tzinfo=timezone.utc)
KEY = b"0123456789abcdef0123456789abcdef"
SYSTEM = {"operating_system": "Linux", "architecture": "x86_64"}


@pytest.fixture()
def config_home(tmp_path, monkeypatch):
    """Point the config dir at a temp HOME so tests never touch real state."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("XDG_CONFIG_HOME", raising=False)
    return tmp_path


@pytest.mark.parametrize("name", PRESETS)
def test_apply_then_capture_matches_reference(name):
    jp, tp = jproc.AudioProcessor(), tproc.AudioProcessor(device="cpu")
    assert (tpio.apply_preset(tp, tcfg.BUILTIN_PRESETS[name])
            == jpio.apply_preset(jp, jcfg.BUILTIN_PRESETS[name]))
    got = tpio.capture_preset(tp, name="captured").to_dict()
    assert got == jpio.capture_preset(jp, name="captured").to_dict()
    want = tcfg.BUILTIN_PRESETS[name].to_dict()
    for section in ("gate", "rnnoise", "deesser", "compressor", "limiter"):
        assert got[section] == want[section], section
    assert got["eq"]["enabled"] == want["eq"]["enabled"]


def test_apply_preset_falls_back_like_the_reference():
    for cfg, pio, proc in ((jcfg, jpio, jproc.AudioProcessor()),
                           (tcfg, tpio, tproc.AudioProcessor(device="cpu"))):
        preset = cfg.Preset(name="df")
        preset.rnnoise.model = "deepfilter"
        assert pio.apply_preset(proc, preset) == "deepfilter was unavailable; using RNNoise"
        assert proc.get_noise_model() == "rnnoise"
        preset.rnnoise.model = "deepfilter-ll"
        with pytest.raises(RuntimeError, match="unavailable"):
            pio.apply_preset(proc, preset, require_exact=True)


_TOPOLOGY = ("gate_enabled", "gate_mode", "auto_threshold_enabled", "deesser_enabled",
             "eq_enabled", "compressor_enabled", "adaptive_release", "auto_makeup_enabled",
             "sidechain_highpass_enabled", "limiter_enabled", "careful_output_enabled")


@pytest.mark.parametrize("vad", [None, True, False])
@pytest.mark.parametrize("name", PRESETS)
def test_serving_config_for_preset_matches_reference(name, vad):
    got = tpio.serving_config_for_preset(tcfg.BUILTIN_PRESETS[name], capacity=4,
                                         vad_enabled=vad)
    want = jpio.serving_config_for_preset(jcfg.BUILTIN_PRESETS[name], capacity=4,
                                          vad_enabled=vad)
    assert isinstance(got, tsv.ServingConfig)
    assert (got.capacity, got.suppressor_model, got.vad_enabled) == (
        want.capacity, want.suppressor_model, want.vad_enabled)
    for field in _TOPOLOGY:
        assert getattr(got.chain, field) == getattr(want.chain, field), field


def _fleet_audio(n_blocks):
    rng = np.random.default_rng(12)
    t = np.arange(n_blocks * BLOCK) / 48000.0
    out = []
    for i in range(len(FLEET_PRESETS)):
        voiced = sum(np.sin(2 * np.pi * (130.0 + 40 * i) * h * t + h) / h for h in range(1, 6))
        out.append(0.3 * voiced + 0.01 * rng.standard_normal(t.size))
    return np.asarray(out, np.float32)


def test_preset_fleet_matches_reference():
    n_blocks, n = 3, len(FLEET_PRESETS)
    cfg_t = tpio.serving_config_for_preset(tcfg.BUILTIN_PRESETS["voice"], capacity=n)
    cfg_j = jpio.serving_config_for_preset(jcfg.BUILTIN_PRESETS["voice"], capacity=n)
    cfg_j = dataclasses.replace(cfg_j, chain=dataclasses.replace(cfg_j.chain, cleanup_mode=0))
    engines = {"j": jsv.ServingEngine(cfg_j),
               "t": tsv.ServingEngine(cfg_t, sharding=fleet_mesh(devices=["cpu"] * 2))}
    presets = {"j": jcfg.BUILTIN_PRESETS, "t": tcfg.BUILTIN_PRESETS}
    pio = {"j": jpio, "t": tpio}
    audio = _fleet_audio(n_blocks)
    outs = {k: [[] for _ in range(n)] for k in engines}
    for k, eng in engines.items():
        for i, name in enumerate(FLEET_PRESETS):
            slot = eng.attach(sink=lambda b, k=k, i=i: outs[k][i].append(b.copy()))
            assert pio[k].apply_preset_to_stream(eng, slot, presets[k][name]) == []
            eng.push(slot, audio[i])
        for _ in range(n_blocks):
            eng.step()
    ref = np.stack([np.concatenate(o) for o in outs["j"]])
    got = np.stack([np.concatenate(o) for o in outs["t"]])
    err = got.astype(np.float64) - ref
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.abs(err).max() <= 1e-3
    assert np.abs(got).max() > 1e-3
    # the presets differ per stream: bass_cut's low shelf against voice's
    eng = engines["t"]
    assert not torch.equal(eng._shards[0]._state["chain"]["eq"]["coeffs"][0],
                           eng._shards[0]._state["chain"]["eq"]["coeffs"][1])


def test_minimal_preset_warns_on_the_voice_topology():
    eng = tsv.ServingEngine(
        tpio.serving_config_for_preset(tcfg.BUILTIN_PRESETS["voice"], capacity=2),
        device="cpu")
    slot = eng.attach()
    warnings = tpio.apply_preset_to_stream(eng, slot, tcfg.BUILTIN_PRESETS["minimal"])
    assert warnings == jpio.apply_preset_to_stream(
        jsv.ServingEngine(jpio.serving_config_for_preset(jcfg.BUILTIN_PRESETS["voice"],
                                                         capacity=2)),
        0, jcfg.BUILTIN_PRESETS["minimal"])
    assert len(warnings) == 1 and "eq_enabled" in warnings[0]


def test_snapshot_from_the_port_processor():
    jp, tp = jproc.AudioProcessor(), tproc.AudioProcessor(device="cpu")
    jpio.apply_preset(jp, jcfg.BUILTIN_PRESETS["aggressive_denoise"])
    tpio.apply_preset(tp, tcfg.BUILTIN_PRESETS["aggressive_denoise"])
    snaps = []
    for de, cfg, proc, pio in ((jde, jcfg, jp, jpio), (tde, tcfg, tp, tpio)):
        snaps.append(de.serialize_diagnostics_snapshot(de.build_diagnostics_snapshot(
            app_version="0.1.0", runtime_diagnostics=proc.get_runtime_diagnostics(),
            config=cfg.AppConfig(), processing_settings=pio.capture_preset(proc).to_dict(),
            input_device="Mic", output_device="Speakers", processing_sample_rate_hz=48000,
            output_sample_rate_hz=48000, running=False, generated_at=WHEN,
            pseudonym_key=KEY, system_info=SYSTEM)))
    assert snaps[0] == snaps[1]
    assert set(tp.get_runtime_diagnostics()) == set(jp.get_runtime_diagnostics())


def test_run_preset_on_the_cpu(config_home, capsys):
    path = tcfg.save_preset(tcfg.BUILTIN_PRESETS["voice"])
    assert cli_main(["run", "--preset", str(path), "--device", "cpu", "--duration", "1"]) == 0
    assert "Started" in capsys.readouterr().out


def test_root_names_match_reference():
    assert set(audioforge_tpu_torch.__all__) == set(audioforge_tpu.__all__)
    for name in audioforge_tpu_torch.__all__:
        assert hasattr(audioforge_tpu_torch, name), name
    assert audioforge_tpu_torch.BUILTIN_PRESETS["voice"].to_dict() == (
        audioforge_tpu.BUILTIN_PRESETS["voice"].to_dict())


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import audioforge_tpu_torch, audioforge_tpu_torch.config, audioforge_tpu_torch.parallel\n"
        "import audioforge_tpu_torch.parallel.fleet, audioforge_tpu_torch.parallel.dryrun\n"
        "import audioforge_tpu_torch.runtime.preset_io, audioforge_tpu_torch.app_logging\n"
        "import audioforge_tpu_torch.diagnostics_export, audioforge_tpu_torch.__main__\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'audioforge_tpu' or m.startswith('audioforge_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
