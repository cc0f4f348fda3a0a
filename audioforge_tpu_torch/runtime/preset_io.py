"""Apply/capture presets on the live engine and the serving engine.

Counterpart of ``audioforge_tpu/runtime/preset_io.py``, against the port's
``AudioProcessor``, ``ServingEngine`` and ``ops.eq``. Headless equivalents
of the main window's preset plumbing (`ui/main_window.py:3256-3420`):
``apply_preset`` pushes every section of a validated preset through the
processor's control surface (noise-model fallback to RNNoise when the
requested backend is absent, unless ``require_exact``), and
``capture_preset`` reads the current control state back into a Preset for
history snapshots and save-as.
"""

from __future__ import annotations

from ..config import Preset
from ..config.settings import (
    CompressorSettings,
    DeEsserSettings,
    EQSettings,
    GateSettings,
    LimiterSettings,
    RNNoiseSettings,
)

__all__ = [
    "apply_preset",
    "capture_preset",
    "serving_config_for_preset",
    "apply_preset_to_stream",
]


def apply_preset(processor, preset: Preset, *, require_exact: bool = False):
    """Apply every preset section to the processor. Returns a warning
    string when the preset's noise model fell back to RNNoise, else None."""
    warning = None

    gate = preset.gate
    processor.set_gate_enabled(gate.enabled)
    processor.set_gate_threshold(gate.threshold_db)
    processor.set_gate_attack(gate.attack_ms)
    processor.set_gate_release(gate.release_ms)
    processor.set_gate_mode(gate.gate_mode)
    processor.set_vad_threshold(gate.vad_threshold)
    processor.set_vad_hold_time(gate.vad_hold_time_ms)
    processor.set_vad_pre_gain(gate.vad_pre_gain)
    processor.set_auto_threshold(gate.auto_threshold_enabled)
    processor.set_gate_margin(gate.gate_margin_db)

    processor.set_eq_enabled(preset.eq.enabled)
    processor.apply_eq_settings_v2([
        (b.filter_type, b.frequency_hz, b.gain_db, b.q,
         b.slope_db_per_octave, b.enabled)
        for b in preset.eq.bands
    ])

    processor.set_rnnoise_enabled(preset.rnnoise.enabled)
    processor.set_rnnoise_strength(preset.rnnoise.strength)
    model = preset.rnnoise.model
    if not processor.set_noise_model(model):
        if require_exact:
            raise RuntimeError(f"Noise model {model!r} is unavailable")
        if model != "rnnoise":
            processor.set_noise_model("rnnoise")
            warning = f"{model} was unavailable; using RNNoise"

    dee = preset.deesser
    processor.set_deesser_enabled(dee.enabled)
    processor.set_deesser_auto_enabled(dee.auto_enabled)
    processor.set_deesser_auto_amount(dee.auto_amount)
    processor.set_deesser_low_cut_hz(dee.low_cut_hz)
    processor.set_deesser_high_cut_hz(dee.high_cut_hz)
    processor.set_deesser_threshold_db(dee.threshold_db)
    processor.set_deesser_ratio(dee.ratio)
    processor.set_deesser_attack_ms(dee.attack_ms)
    processor.set_deesser_release_ms(dee.release_ms)
    processor.set_deesser_max_reduction_db(dee.max_reduction_db)

    comp = preset.compressor
    processor.set_compressor_enabled(comp.enabled)
    processor.set_compressor_threshold(comp.threshold_db)
    processor.set_compressor_ratio(comp.ratio)
    processor.set_compressor_attack(comp.attack_ms)
    processor.set_compressor_release(comp.release_ms)
    processor.set_compressor_makeup_gain(comp.makeup_gain_db)
    processor.set_compressor_adaptive_release(comp.adaptive_release)
    processor.set_compressor_base_release(comp.base_release_ms)
    processor.set_compressor_auto_makeup_enabled(comp.auto_makeup_enabled)
    processor.set_compressor_target_lufs(comp.target_lufs)
    processor.set_compressor_sidechain_highpass_enabled(
        comp.sidechain_highpass_enabled
    )

    lim = preset.limiter
    processor.set_limiter_enabled(lim.enabled)
    processor.set_limiter_ceiling(lim.ceiling_db)
    processor.set_limiter_release(lim.release_ms)
    processor.set_limiter_careful_output_enabled(lim.careful_output_enabled)

    processor.set_bypass(preset.bypass)
    return warning


def capture_preset(processor, *, name: str = "Current",
                   description: str = "") -> Preset:
    """Read the processor's control state back into a validated Preset."""
    par = processor._params
    topo = processor._topology
    dee = processor._deesser
    bands = []
    for i in range(10):
        ftype, freq, gain, q, slope, enabled = processor.get_eq_band_config(i)
        bands.append({
            "filter_type": ftype, "frequency_hz": freq, "gain_db": gain,
            "q": q, "bandwidth_mode": "q", "bandwidth_octaves": None,
            "slope_db_per_octave": slope, "stage": "combined",
            "enabled": enabled,
        })
    preset = Preset(
        name=name,
        description=description,
        gate=GateSettings(
            enabled=topo["gate_enabled"],
            threshold_db=par["gate_threshold_db"],
            attack_ms=par["gate_attack_ms"],
            release_ms=par["gate_release_ms"],
            gate_mode=topo["gate_mode"],
            vad_threshold=par["vad_threshold"],
            vad_hold_time_ms=par["vad_hold_time_ms"],
            vad_pre_gain=par["vad_pre_gain"],
            auto_threshold_enabled=topo["auto_threshold_enabled"],
            gate_margin_db=par["gate_margin_db"],
        ),
        eq=EQSettings.from_dict(
            {"schema_version": 2, "enabled": topo["eq_enabled"],
             "bands": bands}
        ),
        rnnoise=RNNoiseSettings(
            enabled=topo["suppressor_enabled"],
            strength=par["suppressor_strength"],
            model=topo["noise_model"],
        ),
        deesser=DeEsserSettings(
            enabled=topo["deesser_enabled"],
            auto_enabled=dee["auto_enabled"],
            auto_amount=dee["auto_amount"],
            low_cut_hz=dee["low_cut_hz"],
            high_cut_hz=dee["high_cut_hz"],
            threshold_db=dee["threshold_db"],
            ratio=dee["ratio"],
            attack_ms=dee["attack_ms"],
            release_ms=dee["release_ms"],
            max_reduction_db=dee["max_reduction_db"],
        ),
        compressor=CompressorSettings(
            enabled=topo["compressor_enabled"],
            threshold_db=par["compressor_threshold_db"],
            ratio=par["compressor_ratio"],
            attack_ms=par["compressor_attack_ms"],
            release_ms=par["compressor_release_ms"],
            makeup_gain_db=par["compressor_makeup_gain_db"],
            adaptive_release=topo["adaptive_release"],
            base_release_ms=par["compressor_base_release_ms"],
            auto_makeup_enabled=topo["auto_makeup_enabled"],
            target_lufs=par["compressor_target_lufs"],
            sidechain_highpass_enabled=topo["sidechain_highpass_enabled"],
        ),
        limiter=LimiterSettings(
            enabled=topo["limiter_enabled"],
            ceiling_db=par["limiter_ceiling_db"],
            release_ms=par["limiter_release_ms"],
            careful_output_enabled=topo["careful_output_enabled"],
        ),
        bypass=processor.is_bypass(),
    )
    # round-trip validation so captured state is always loadable
    return Preset.from_dict(preset.to_dict())


def serving_config_for_preset(preset: Preset, *, capacity: int = 16,
                              vad_enabled: bool | None = None):
    """Build a :class:`~.serving.ServingConfig` whose STATIC topology
    matches a preset (stage enables, gate mode, compressor modes, noise
    model). Per-stream continuous knobs then come from
    :func:`apply_preset_to_stream` — the serving split of the live
    engine's apply_preset (topology = compiled variant, knobs = traced)."""
    from . import live_chain as lc
    from .serving import ServingConfig

    gate = preset.gate
    comp = preset.compressor
    chain = lc.LiveChainConfig(
        gate_enabled=gate.enabled,
        gate_mode=gate.gate_mode,
        auto_threshold_enabled=gate.auto_threshold_enabled,
        deesser_enabled=preset.deesser.enabled,
        eq_enabled=preset.eq.enabled,
        compressor_enabled=comp.enabled,
        adaptive_release=comp.adaptive_release,
        auto_makeup_enabled=comp.auto_makeup_enabled,
        sidechain_highpass_enabled=comp.sidechain_highpass_enabled,
        limiter_enabled=preset.limiter.enabled,
        careful_output_enabled=preset.limiter.careful_output_enabled,
    )
    return ServingConfig(
        capacity=capacity,
        chain=chain,
        suppressor_model=(preset.rnnoise.model if preset.rnnoise.enabled
                          else None),
        vad_enabled=(gate.gate_mode != 0 if vad_enabled is None
                     else vad_enabled),
    )


def apply_preset_to_stream(engine, slot: int, preset: Preset):
    """Apply a preset's CONTINUOUS controls to one serving stream:
    per-stream chain params, EQ program, and suppressor strength. The
    engine's static topology is not changed — mismatches between the
    preset's stage enables/modes and the engine's ``ServingConfig`` are
    returned as warning strings (build the engine with
    :func:`serving_config_for_preset` to avoid them)."""
    warnings: list[str] = []
    cfg = engine.config
    chain = cfg.chain
    gate = preset.gate
    comp = preset.compressor
    lim = preset.limiter

    for name, want, have in (
        ("gate_enabled", gate.enabled, chain.gate_enabled),
        ("gate_mode", gate.gate_mode, chain.gate_mode),
        ("auto_threshold_enabled", gate.auto_threshold_enabled,
         chain.auto_threshold_enabled),
        ("deesser_enabled", preset.deesser.enabled, chain.deesser_enabled),
        ("eq_enabled", preset.eq.enabled, chain.eq_enabled),
        ("compressor_enabled", comp.enabled, chain.compressor_enabled),
        ("adaptive_release", comp.adaptive_release, chain.adaptive_release),
        ("auto_makeup_enabled", comp.auto_makeup_enabled,
         chain.auto_makeup_enabled),
        ("sidechain_highpass_enabled", comp.sidechain_highpass_enabled,
         chain.sidechain_highpass_enabled),
        ("limiter_enabled", lim.enabled, chain.limiter_enabled),
        ("careful_output_enabled", lim.careful_output_enabled,
         chain.careful_output_enabled),
    ):
        if want != have:
            warnings.append(
                f"preset {name}={want!r} differs from the engine topology "
                f"({have!r}); per-stream topology is static"
            )
    want_model = preset.rnnoise.model if preset.rnnoise.enabled else None
    if want_model != cfg.suppressor_model:
        warnings.append(
            f"preset noise model {want_model!r} differs from the engine's "
            f"{cfg.suppressor_model!r}"
        )

    engine.set_stream_params(
        slot,
        gate_threshold_db=gate.threshold_db,
        gate_attack_ms=gate.attack_ms,
        gate_release_ms=gate.release_ms,
        vad_threshold=gate.vad_threshold,
        vad_hold_time_ms=gate.vad_hold_time_ms,
        gate_margin_db=gate.gate_margin_db,
        compressor_threshold_db=comp.threshold_db,
        compressor_ratio=comp.ratio,
        compressor_attack_ms=comp.attack_ms,
        compressor_release_ms=comp.release_ms,
        compressor_makeup_gain_db=comp.makeup_gain_db,
        compressor_target_lufs=comp.target_lufs,
        limiter_ceiling_db=lim.ceiling_db,
        limiter_release_ms=lim.release_ms,
    )
    from ..ops.eq import EqBandConfig

    engine.set_stream_eq(slot, [
        EqBandConfig(
            EqBandConfig.type_id(b.filter_type), b.frequency_hz, b.gain_db,
            b.q, b.slope_db_per_octave, b.enabled,
        )
        for b in preset.eq.bands
    ] if preset.eq.enabled else None)
    if cfg.suppressor_model is not None:
        engine.set_stream_suppressor(
            slot, strength=preset.rnnoise.strength,
            enabled=preset.rnnoise.enabled,
        )
    return warnings
