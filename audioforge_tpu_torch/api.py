"""The offline simulators and helpers of the reference's Python API.

Counterpart of ``audioforge_tpu/api.py``: the same functions, signatures,
validation errors and diagnostics keys, plus one keyword, ``device``, where a
function runs audio (a CUDA device unless asked otherwise; without a card
those raise). The heavy part of each simulator is one take-level loop that
replays one captured CUDA graph a block on the card
(:mod:`.runtime.replay`); the aggregation is host numpy, as in the
reference. ``simulate_auto_eq_chain_batched(mesh=...)`` (candidates sharded
over several devices) is not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import kernels
from .models import rnnoise as rn
from .models import vad_gate as vadm
from .ops import compressor as comp_ops
from .ops import deesser as des_ops
from .ops import eq as eq_ops
from .ops import gate as gate_ops
from .ops import limiter as lim_ops
from .ops import loudness as loud_ops
from .ops import true_peak as tp_ops
from .runtime import chain as chain_rt
from .runtime.replay import run_take

__all__ = [
    "eq_magnitude_response",
    "eq_magnitude_response_v2",
    "simulate_eq_v2",
    "measure_integrated_loudness",
    "simulate_auto_eq_chain",
    "simulate_auto_eq_chain_batched",
    "simulate_auto_makeup_control",
    "simulate_gate_suppressor_order",
    "compressor_pumping_score",
    "percentile",
]

NUM_BANDS = eq_ops.NUM_BANDS
_RT_PROCESS_BUFFER_CAPACITY = 4096  # the reference's fixed realtime buffer


def percentile(values, p: float) -> float:
    """Sorted linear-interpolated percentile."""
    v = np.sort(np.asarray(values, np.float32))
    if v.size == 0:
        return 0.0
    pos = (v.size - 1) * float(np.clip(p, 0.0, 1.0))
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    if lo == hi:
        return float(v[lo])
    frac = pos - lo
    return float(v[lo] + frac * (v[hi] - v[lo]))


def _linear_to_db(x) -> float:
    return float(20.0 * np.log10(max(abs(float(x)), 1e-10)))


def _validate_sample_rate(sample_rate):
    if not np.isfinite(sample_rate) or sample_rate <= 0:
        raise ValueError("sample_rate must be positive and finite")


def _legacy_bands(bands, sample_rate):
    """(frequency, gain, Q) triples applied to the default band types."""
    if len(bands) != NUM_BANDS:
        raise ValueError(f"expected {NUM_BANDS} EQ bands, got {len(bands)}")
    nyquist = sample_rate / 2.0
    out = []
    defaults = eq_ops.default_bands()
    for index, (frequency_hz, gain_db, q) in enumerate(bands):
        if not np.isfinite(frequency_hz) or frequency_hz <= 0 or frequency_hz >= nyquist:
            raise ValueError(f"band {index} frequency must be between 0 Hz and Nyquist")
        if not np.isfinite(gain_db):
            raise ValueError(f"band {index} gain must be finite")
        if not np.isfinite(q) or q <= 0:
            raise ValueError(f"band {index} Q must be finite and positive")
        d = defaults[index]
        out.append(eq_ops.EqBandConfig(d.filter_type, float(frequency_hz), float(gain_db),
                                       float(q), d.slope_db_per_octave, True))
    return out


def _v2_bands(bands, sample_rate):
    """Parse (type_name, freq, gain, q, slope, enabled) tuples."""
    _validate_sample_rate(sample_rate)
    if len(bands) != NUM_BANDS:
        raise ValueError(f"expected {NUM_BANDS} EQ bands, got {len(bands)}")
    out = []
    for index, (ftype, freq, gain, q, slope, enabled) in enumerate(bands):
        try:
            type_id = eq_ops.EqBandConfig.type_id(ftype)
        except KeyError:
            raise ValueError(f"band {index} has unsupported EQ filter type: {ftype}") from None
        cfg = eq_ops.EqBandConfig(type_id, float(freq), float(gain), float(q), int(slope),
                                  bool(enabled))
        eq_ops.validate_band(cfg, sample_rate)
        out.append(cfg)
    return out


def _validate_response_freqs(frequencies_hz, sample_rate):
    f = np.asarray(frequencies_hz, np.float64)
    nyquist = sample_rate / 2.0
    if not np.all(np.isfinite(f)) or np.any(f < 0) or np.any(f > nyquist):
        raise ValueError("response frequencies must be finite and between 0 Hz and Nyquist")
    return f


def eq_magnitude_response(frequencies_hz, bands, sample_rate):
    """Exact cascaded EQ response for legacy (freq, gain, Q) bands."""
    _validate_sample_rate(sample_rate)
    configs = _legacy_bands(bands, sample_rate)
    freqs = _validate_response_freqs(frequencies_hz, sample_rate)
    return list(eq_ops.magnitude_response_db(configs, freqs, sample_rate))


def eq_magnitude_response_v2(frequencies_hz, bands, sample_rate):
    """Exact cascaded EQ response for schema-v2 bands."""
    configs = _v2_bands(bands, sample_rate)
    freqs = _validate_response_freqs(frequencies_hz, sample_rate)
    return list(eq_ops.magnitude_response_db(configs, freqs, sample_rate))


def _frame_blocks(audio, block):
    n = len(audio)
    nb = max(1, -(-n // block))
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = audio
    return padded.reshape(nb, block), nb


def _true_peak(x: np.ndarray, dev) -> float:
    """The true peak of a whole take, as one detector block."""
    t = torch.as_tensor(x if len(x) else np.zeros(1, np.float32), device=dev)[None]
    _, peak = tp_ops.detector_process(tp_ops.detector_init(n=1, device=dev), t)
    return float(peak[0])


def simulate_eq_v2(audio, sample_rate, bands, return_output_audio=False, *, device="cuda"):
    """Render audio through the EQ alone (4800-sample blocks). Returns the
    reference's diagnostics dict."""
    configs = _v2_bands(bands, sample_rate)
    x = np.asarray(audio, np.float32)
    if not np.all(np.isfinite(x)):
        raise ValueError("audio must contain only finite samples")
    dev = kernels.resolve_device(device, "simulate_eq_v2")

    state = eq_ops.eq_init(configs, sample_rate, n=1, device=dev)
    started = time.perf_counter()
    blocks, nb = _frame_blocks(x, 4800)

    def step(st, block):
        st, y = eq_ops.eq_process(st, block["x"])
        return st, {"y": y}

    _, rows = run_take(step, state, {"x": torch.as_tensor(blocks, device=dev)[:, None]}, nb)
    output = rows["y"].cpu().numpy().reshape(-1)[: len(x)]
    runtime_ms = (time.perf_counter() - started) * 1000.0

    itp, otp = _true_peak(x, dev), _true_peak(output, dev)
    n = max(len(x), 1)
    response_frequencies = 20.0 * (20000.0 / 20.0) ** (np.arange(512) / 511.0)
    max_response_db = float(np.max(
        eq_ops.magnitude_response_db(configs, response_frequencies, sample_rate)))
    diagnostics = {
        "input_sample_peak": float(np.max(np.abs(x))) if len(x) else 0.0,
        "output_sample_peak": float(np.max(np.abs(output))) if len(output) else 0.0,
        "input_true_peak": itp,
        "output_true_peak": otp,
        "input_rms": float(np.sqrt(np.sum(x.astype(np.float64) ** 2) / n)),
        "output_rms": float(np.sqrt(np.sum(output.astype(np.float64) ** 2) / n)),
        "max_response_db": max_response_db,
        "runtime_ms": runtime_ms,
        "sample_count": len(x),
        "algorithmic_latency_samples": 0,
        "non_finite_output": bool(np.any(~np.isfinite(output))),
    }
    if return_output_audio:
        diagnostics["output_audio"] = output.tolist()
    return diagnostics


def measure_integrated_loudness(audio, sample_rate):
    """BS.1770 gated mono integrated loudness (host)."""
    return loud_ops.integrated_loudness_lufs(np.asarray(audio, np.float32), sample_rate)


def compressor_pumping_score(gr_trace_db, cadence_hz):
    """Band-passed (2-8 Hz) gain-reduction modulation score."""
    gr = np.asarray(gr_trace_db, np.float32)
    if gr.size < 3 or not np.isfinite(cadence_hz) or cadence_hz <= 0:
        return 0.0
    if not np.all(np.isfinite(gr)):
        return float("inf")
    dt = 1.0 / float(cadence_hz)
    hp_rc = 1.0 / (2.0 * np.pi * 2.0)
    lp_rc = 1.0 / (2.0 * np.pi * 8.0)
    hp_a = hp_rc / (hp_rc + dt)
    lp_a = dt / (lp_rc + dt)
    prev = gr[0]
    hp = 0.0
    bp = 0.0
    bp_abs = []
    deltas = []
    for v in gr[1:]:
        hp = hp_a * (hp + v - prev)
        bp += lp_a * (hp - bp)
        bp_abs.append(abs(bp))
        deltas.append(abs(v - prev))
        prev = v
    bp_abs = np.asarray(bp_abs, np.float32)
    robust_limit = percentile(bp_abs, 0.95)
    robust_rms = float(np.sqrt(np.mean(np.minimum(bp_abs, robust_limit) ** 2)))
    return robust_rms + percentile(np.asarray(deltas, np.float32), 0.95)


def _settings_get(settings, key, default):
    if settings is None:
        return default
    return settings.get(key, default)


def _analysis_block(sample_rate) -> int:
    return max(1, min(int(round(sample_rate * 0.020)), _RT_PROCESS_BUFFER_CAPACITY))


def _chain_config_from_settings(sample_rate, settings):
    """The chain's static config and the compressor's host parameters from a
    ``simulate_auto_eq_chain`` settings dict."""
    deesser_enabled = bool(_settings_get(settings, "deesser_enabled", False))
    compressor_enabled = bool(_settings_get(settings, "compressor_enabled", True))
    limiter_enabled = bool(_settings_get(settings, "limiter_enabled", True))
    limiter_ceiling_db = float(_settings_get(settings, "limiter_ceiling_db", -0.5))
    careful = bool(_settings_get(settings, "limiter_careful_output_enabled", True))
    effective_ceiling_db = chain_rt.effective_limiter_ceiling_db(limiter_ceiling_db, careful)
    effective_ceiling_db = min(effective_ceiling_db, 0.0)  # the ceiling clamps to <= 0 dB
    adaptive = bool(_settings_get(settings, "compressor_adaptive_release", False))

    deesser_cfg = des_ops.DeEsserConfig(
        sample_rate=sample_rate,
        enabled=deesser_enabled,
        auto_enabled=bool(_settings_get(settings, "deesser_auto_enabled", True)),
        auto_amount=float(_settings_get(settings, "deesser_auto_amount", 0.5)),
        threshold_db=float(_settings_get(settings, "deesser_threshold_db", -28.0)),
        ratio=float(_settings_get(settings, "deesser_ratio", 4.0)),
        max_reduction_db=float(_settings_get(settings, "deesser_max_reduction_db", 6.0)),
        low_cut_hz=float(_settings_get(settings, "deesser_low_cut_hz", 4000.0)),
        high_cut_hz=float(_settings_get(settings, "deesser_high_cut_hz", 11000.0)),
    )
    comp_cfg = comp_ops.CompressorConfig(
        sample_rate=sample_rate,
        enabled=compressor_enabled,
        adaptive_release=adaptive,
        auto_makeup_enabled=bool(_settings_get(settings, "compressor_auto_makeup_enabled",
                                               False)),
        sidechain_highpass_enabled=bool(
            _settings_get(settings, "compressor_sidechain_highpass_enabled", True)),
        block_samples=_analysis_block(sample_rate),
    )
    # the offline compressor is built at (-18, 3, 5 ms, 100 ms, 0, knee 6) and
    # then reconfigured, which pins the detector release at 100 ms and the
    # knee at 6 dB
    comp_params = comp_ops.compressor_params(
        comp_cfg,
        threshold_db=float(_settings_get(settings, "compressor_threshold_db", -20.0)),
        ratio=float(_settings_get(settings, "compressor_ratio", 4.0)),
        attack_ms=float(_settings_get(settings, "compressor_attack_ms", 10.0)),
        release_ms=float(_settings_get(
            settings,
            "compressor_base_release_ms" if adaptive else "compressor_release_ms",
            50.0 if adaptive else 200.0)),
        makeup_gain_db=float(_settings_get(settings, "compressor_makeup_gain_db", 0.0)),
        knee_db=6.0,
        target_lufs=float(_settings_get(settings, "compressor_target_lufs", -18.0)),
        detector_release_ms=100.0,
    )
    limiter_cfg = lim_ops.LimiterConfig(
        ceiling_db=effective_ceiling_db,
        release_ms=float(_settings_get(settings, "limiter_release_ms", 50.0)),
        lookahead_ms=float(_settings_get(settings, "limiter_lookahead_ms", 2.0)),
        sample_rate=sample_rate,
        enabled=limiter_enabled,
    )
    cfg = chain_rt.ChainConfig(
        sample_rate=sample_rate,
        deesser_enabled=deesser_enabled,
        eq_enabled=True,
        compressor_enabled=compressor_enabled,
        limiter_enabled=limiter_enabled,
        eq_before_deesser=bool(_settings_get(settings, "eq_before_deesser", False)),
        deesser=deesser_cfg,
        compressor=comp_cfg,
        limiter=limiter_cfg,
        tp_release_ms=(float(_settings_get(settings, "limiter_release_ms", 50.0))
                       if limiter_enabled else 80.0),
    )
    return cfg, comp_params, effective_ceiling_db


def _eq_bands_from(bands, settings, sample_rate):
    if settings is not None and settings.get("eq_bands_v2") is not None:
        return _v2_bands(settings["eq_bands_v2"], sample_rate)
    return _legacy_bands(bands, sample_rate)


def _take_blocks(audio, block):
    """Finite-scrubbed take -> ``(blocks [nb, block], nb, valid [nb], n)``
    with the valid sample count of each block (the last may be partial)."""
    x = np.asarray(audio, np.float32)
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    n = len(x)
    blocks, nb = _frame_blocks(x, block)
    valid = np.full(nb, block, np.int64)
    if n % block and n > 0:
        valid[-1] = n % block
    return blocks, nb, valid, n


def _rows_db(sq, valid):
    return 20.0 * np.log10(np.maximum(np.sqrt(sq / np.maximum(valid, 1)), 1e-10))


def _diagnostics(stats, out_blocks, in_sq, in_rows_db, n, valid, active_mask,
                 active_threshold_db, effective_ceiling_db, runtime_ms):
    """One stream's (or candidate's) diagnostics from its stats rows and
    output blocks."""
    out_sq = (out_blocks.astype(np.float64) ** 2).sum(axis=1)
    out_rows_db = _rows_db(out_sq, valid)
    comp_rows = stats["compressor_gain_reduction_db"]
    des_rows = stats["deesser_gain_reduction_db"]
    output = out_blocks.reshape(-1)[:n]
    active_comp = np.maximum(comp_rows[active_mask], 0.0)
    active_des = np.maximum(des_rows[active_mask], 0.0)
    if active_comp.size < 3:
        active_comp = np.maximum(comp_rows, 0.0)
        active_des = np.maximum(des_rows, 0.0)
    valid_rows = in_rows_db > -100.0
    osp = float(stats["output_sample_peak"].max(initial=0.0))
    pre_tp = float(stats["true_peak_limiter_input_peak"].max(initial=0.0))
    otp = float(stats["output_true_peak"].max(initial=0.0))
    osp_db, pre_db, otp_db = _linear_to_db(osp), _linear_to_db(pre_tp), _linear_to_db(otp)
    diagnostics = {
        "input_sample_peak_db": _linear_to_db(stats["input_sample_peak"].max(initial=0.0)),
        "input_rms_db": _linear_to_db(float(np.sqrt(in_sq.sum() / max(n, 1)))),
        "output_sample_peak_db": osp_db,
        "pre_limiter_true_peak_db": pre_db,
        "output_true_peak_db": otp_db,
        "output_rms_db": _linear_to_db(float(np.sqrt(out_sq.sum() / max(n, 1)))),
        "limiter_effective_ceiling_db": float(effective_ceiling_db),
        "sample_headroom_db": float(effective_ceiling_db - osp_db),
        "pre_limiter_true_peak_headroom_db": float(effective_ceiling_db - pre_db),
        "true_peak_headroom_db": float(effective_ceiling_db - otp_db),
        "limiter_gain_reduction_db": float(
            stats["limiter_peak_gain_reduction_db"].max(initial=0.0)),
        "true_peak_limiter_gain_reduction_db": float(
            stats["true_peak_limiter_gain_reduction_db"].max(initial=0.0)),
        "true_peak_limited_events": int(stats["true_peak_limited_events"].sum()),
        "compressor_gain_reduction_db": float(comp_rows.max(initial=0.0)),
        "deesser_gain_reduction_db": float(des_rows.max(initial=0.0)),
        "compressor_gain_reduction_median_db": percentile(active_comp, 0.50),
        "compressor_gain_reduction_p95_db": percentile(active_comp, 0.95),
        "compressor_gain_reduction_active_ratio": (
            float(np.mean(active_comp >= 0.10)) if active_comp.size else 0.0),
        "active_output_gain_db": percentile(
            (out_rows_db - in_rows_db)[active_mask & valid_rows], 0.50),
        "silence_output_gain_db": percentile(-np.maximum(comp_rows[~active_mask], 0.0), 0.50),
        "silence_level_delta_db": percentile(
            (out_rows_db - in_rows_db)[(~active_mask) & valid_rows], 0.50),
        "compressor_pumping_score_db": float(
            compressor_pumping_score(np.maximum(comp_rows, 0.0), 50.0)),
        "non_finite_output": bool(np.any(~np.isfinite(output))),
        "candidate_runtime_ms": runtime_ms,
        "deesser_gain_reduction_median_db": percentile(active_des, 0.50),
        "deesser_gain_reduction_p95_db": percentile(active_des, 0.95),
        "analysis_block_ms": 20.0,
        "active_analysis_threshold_db": float(active_threshold_db),
        "active_analysis_block_count": int(active_comp.size),
        "processed_samples": int(n),
    }
    return diagnostics, output


def _active_split(in_rows_db):
    """The active/silence split of the input's analysis blocks."""
    input_floor_db = percentile(in_rows_db, 0.20)
    input_p90_db = percentile(in_rows_db, 0.90)
    active_threshold_db = max(input_floor_db + 6.0, input_p90_db - 24.0, -60.0)
    return in_rows_db >= active_threshold_db, active_threshold_db


def _run_chain(cfg, comp_params, eq_bands, blocks, dev):
    """The chain over ``blocks [B, nb, T]`` on ``dev``. Returns host
    ``(ys [B, nb, T], stats [B, nb])``."""
    b = blocks.shape[0]
    state = chain_rt.chain_init(cfg, comp_params, eq_bands, batch_shape=(b,), device=dev)
    _, ys, stats = chain_rt.chain_run(cfg, comp_params, state, blocks, return_audio=True)
    return ys.cpu().numpy(), {k: v.cpu().numpy() for k, v in stats.items()}


def simulate_auto_eq_chain(audio, sample_rate, bands, settings=None, *, device="cuda"):
    """Render audio through de-esser/EQ/compressor/limiter/true-peak limiter
    and return the reference's diagnostics dict. ``bands``: 10 legacy
    (frequency, gain_db, q) triples, overridden by schema-v2
    ``settings["eq_bands_v2"]`` when present."""
    started = time.perf_counter()
    _validate_sample_rate(sample_rate)
    sample_rate = float(sample_rate)
    eq_bands = _eq_bands_from(bands, settings, sample_rate)
    cfg, comp_params, effective_ceiling_db = _chain_config_from_settings(sample_rate, settings)
    return_output_audio = bool(_settings_get(settings, "return_output_audio", False))
    dev = kernels.resolve_device(device, "simulate_auto_eq_chain")

    blocks, nb, valid, n = _take_blocks(audio, _analysis_block(sample_rate))
    if n == 0:
        valid[:] = 0
    ys, stats = _run_chain(cfg, comp_params, eq_bands,
                           torch.as_tensor(blocks, device=dev)[None], dev)
    # the padded tail adds no energy; the partial block's RMS is over its
    # valid samples
    in_sq = (blocks.astype(np.float64) ** 2).sum(axis=1)
    in_rows_db = _rows_db(in_sq, valid)
    active_mask, active_threshold_db = _active_split(in_rows_db)
    diagnostics, output = _diagnostics(
        {k: v[0] for k, v in stats.items()}, ys[0], in_sq, in_rows_db, n, valid,
        active_mask, active_threshold_db, effective_ceiling_db, 0.0)
    diagnostics["candidate_runtime_ms"] = (time.perf_counter() - started) * 1000.0
    if return_output_audio:
        diagnostics["output_audio"] = output.tolist()
    return diagnostics


def simulate_auto_eq_chain_batched(audio, sample_rate, bands, settings, param_sets,
                                   mesh=None, *, device="cuda"):
    """Evaluate many compressor parameterisations of the same chain in one
    batched run: the candidates are streams. ``param_sets`` is a list of
    dicts {threshold_db, ratio, attack_ms, release_ms}; every other setting
    is shared. Returns one diagnostics dict a candidate (the keys of
    :func:`simulate_auto_eq_chain`, without output audio)."""
    if mesh is not None:
        raise NotImplementedError(
            "simulate_auto_eq_chain_batched(mesh=...) shards the candidates over "
            "several devices and is not ported yet (ROADMAP queue 1 item 7, "
            "multi-GPU)")
    started = time.perf_counter()
    _validate_sample_rate(sample_rate)
    sample_rate = float(sample_rate)
    eq_bands = _eq_bands_from(bands, settings, sample_rate)
    cfg, base_params, effective_ceiling_db = _chain_config_from_settings(sample_rate,
                                                                         settings)
    B = len(param_sets)
    if B == 0:
        return []
    dev = kernels.resolve_device(device, "simulate_auto_eq_chain_batched")
    fs = sample_rate
    f32 = lambda values: np.asarray(values, np.float32)
    comp_params = dict(base_params)
    comp_params["threshold_db"] = f32([float(p["threshold_db"]) for p in param_sets])
    comp_params["ratio"] = f32([max(float(p["ratio"]), 1.0) for p in param_sets])
    comp_params["attack_coeff"] = f32(
        [np.exp(-1000.0 / (max(float(p["attack_ms"]), 1e-6) * fs)) for p in param_sets])
    comp_params["base_release_ms"] = f32([float(p["release_ms"]) for p in param_sets])

    blocks, nb, valid, n = _take_blocks(audio, _analysis_block(sample_rate))
    x = torch.as_tensor(blocks, device=dev)
    ys, stats = _run_chain(cfg, comp_params, eq_bands, x[None].expand(B, nb, -1), dev)

    in_sq = (blocks.astype(np.float64) ** 2).sum(axis=1)  # the shared input
    in_rows_db = _rows_db(in_sq, valid)
    active_mask, active_threshold_db = _active_split(in_rows_db)
    runtime_ms = (time.perf_counter() - started) * 1000.0 / B
    return [_diagnostics({k: v[b] for k, v in stats.items()}, ys[b], in_sq, in_rows_db,
                         n, valid, active_mask, active_threshold_db,
                         effective_ceiling_db, runtime_ms)[0]
            for b in range(B)]


def simulate_auto_makeup_control(audio, sample_rate, vad_probabilities, noise_floor_db,
                                 noise_reliability, settings=None, *, device="cuda"):
    """Stream a capture through the auto-makeup compressor at the fixed 10 ms
    control cadence (480-sample blocks)."""
    CONTROL_BLOCK_SIZE = 480
    _validate_sample_rate(sample_rate)
    sample_rate = float(sample_rate)
    if (not np.isfinite(noise_floor_db) or not np.isfinite(noise_reliability)
            or not (0.0 <= noise_reliability <= 1.0)):
        raise ValueError("noise evidence must be finite and reliability must be between 0 and 1")
    probs = np.asarray(vad_probabilities, np.float64)
    if probs.size and (not np.all(np.isfinite(probs)) or np.any(probs < 0) or np.any(probs > 1)):
        raise ValueError("VAD probabilities must be finite and between 0 and 1")
    x = np.asarray(audio, np.float32)
    block_count = -(-len(x) // CONTROL_BLOCK_SIZE)
    if probs.size and probs.size != block_count:
        raise ValueError(f"expected {block_count} VAD probabilities at the 10 ms control "
                         f"cadence, got {probs.size}")
    vad_reliability = float(_settings_get(settings, "vad_reliability", 1.0))
    if not np.isfinite(vad_reliability) or not (0.0 <= vad_reliability <= 1.0):
        raise ValueError("vad_reliability must be finite and between 0 and 1")
    return_output_audio = bool(_settings_get(settings, "return_output_audio", False))
    dev = kernels.resolve_device(device, "simulate_auto_makeup_control")

    comp_cfg = comp_ops.CompressorConfig(
        sample_rate=sample_rate,
        enabled=True,
        adaptive_release=bool(_settings_get(settings, "adaptive_release", True)),
        auto_makeup_enabled=True,
        sidechain_highpass_enabled=bool(_settings_get(settings, "sidechain_highpass_enabled",
                                                      True)),
        block_samples=CONTROL_BLOCK_SIZE,
    )
    host_params = comp_ops.compressor_params(
        comp_cfg,
        threshold_db=float(_settings_get(settings, "threshold_db", -24.0)),
        ratio=float(_settings_get(settings, "ratio", 3.0)),
        attack_ms=float(_settings_get(settings, "attack_ms", 10.0)),
        release_ms=float(_settings_get(settings, "release_ms", 180.0)),
        makeup_gain_db=float(_settings_get(settings, "makeup_gain_db", 0.0)),
        knee_db=6.0,
        target_lufs=float(np.clip(_settings_get(settings, "target_lufs", -18.0), -24.0, -12.0)),
        noise_reference_reliability=noise_reliability,
    )
    comp_params = chain_rt.comp_param_tensors(host_params, 1, dev)

    blocks, nb = _frame_blocks(x, CONTROL_BLOCK_SIZE) if len(x) else (
        np.zeros((0, CONTROL_BLOCK_SIZE), np.float32), 0)
    have_evidence = probs.size > 0
    ev_probs = probs if have_evidence else np.zeros(nb)

    state = comp_ops.compressor_init(comp_cfg, n=1, device=dev)
    state["current_release_ms"] = comp_params["base_release_ms"].clone()
    state["smoothed_makeup_gain"] = comp_params["makeup_gain_db"].clone()
    const = lambda v: torch.full((1,), v, dtype=torch.float32, device=dev)
    evidence = {"vad_reliability": const(vad_reliability),
                "noise_floor_db": const(noise_floor_db),
                "live_noise_reliability": const(noise_reliability)}

    def step(st, block):
        ev = dict(evidence, vad_probability=block["p"]) if have_evidence else None
        st, y, m = comp_ops.compressor_process(comp_cfg, comp_params, st, block["x"],
                                               evidence=ev)
        return st, {"y": y, "makeup": m["makeup_gain_db"],
                    "activity": st["speech_activity_score"],
                    "reliability": st["activity_reliability"],
                    "gr": m["gain_reduction_db"]}

    started = time.perf_counter()
    if nb:
        inputs = {"x": torch.as_tensor(blocks, device=dev)[:, None],
                  "p": torch.as_tensor(np.asarray(ev_probs, np.float32), device=dev)[:, None]}
        _, rows = run_take(step, state, inputs, nb)
        rows = {k: v.cpu().numpy() for k, v in rows.items()}
        ys = rows.pop("y")[:, 0]
        rows = {k: v[:, 0] for k, v in rows.items()}
    else:
        ys = np.zeros((0, CONTROL_BLOCK_SIZE), np.float32)
        rows = {k: np.zeros(0, np.float32) for k in ("makeup", "activity", "reliability", "gr")}
    total_ms = (time.perf_counter() - started) * 1000.0

    valid = np.full(nb, CONTROL_BLOCK_SIZE, np.int64)
    if len(x) % CONTROL_BLOCK_SIZE and len(x) > 0:
        valid[-1] = len(x) % CONTROL_BLOCK_SIZE
    in_rms = np.sqrt((blocks.astype(np.float64) ** 2).sum(axis=1) / np.maximum(valid, 1))
    out_rms = np.sqrt((ys.astype(np.float64) ** 2).sum(axis=1) / np.maximum(valid, 1))

    per_block_ms = total_ms / max(nb, 1)
    output = ys.reshape(-1)[: len(x)]
    diagnostics = {
        "control_block_size": CONTROL_BLOCK_SIZE,
        "control_cadence_hz": sample_rate / CONTROL_BLOCK_SIZE,
        "processed_samples": len(x),
        "makeup_gain_db": rows["makeup"].tolist(),
        "activity": rows["activity"].tolist(),
        "reliability": rows["reliability"].tolist(),
        "gain_reduction_db": rows["gr"].tolist(),
        "input_rms_db": [_linear_to_db(v) for v in in_rms],
        "output_rms_db": [_linear_to_db(v) for v in out_rms],
        # one take-level run: the per-block runtimes are its wall time
        # spread over the blocks (keys kept for report compatibility)
        "p95_block_runtime_ms": per_block_ms,
        "p99_block_runtime_ms": per_block_ms,
        "max_block_runtime_ms": per_block_ms,
    }
    if return_output_audio:
        diagnostics["output_audio"] = output.tolist()
    return diagnostics


# --------------------------------------------------------------------------
# Gate / suppressor ordering study
# --------------------------------------------------------------------------

_GATE_ORDER_FRAME = 480  # RNNoise cadence at 48 kHz


def _gate_pass_over_blocks(gate_cfg, vad_cfg, vad_threshold, blocks, probs):
    """The VAD-assisted gate over ``blocks: [nb, 480]`` (a tensor) with one
    external posterior a block (``probs [nb]``), on their device. Returns
    ``(out, gains, floors, reliabilities, chatter)`` as tensors."""
    dev = blocks.device
    f = lambda v: torch.full((1,), v, dtype=torch.float32, device=dev)
    gate_params = {k: f(v) for k, v in gate_ops.gate_params(gate_cfg).items()}
    vad_params = {"vad_threshold": f(vad_cfg.vad_threshold), "margin_db": f(vad_cfg.margin_db),
                  "hold_time_ms": f(vad_cfg.hold_time_ms)}
    available = torch.ones(1, dtype=torch.bool, device=dev)
    threshold = f(vad_threshold)
    state = {"gate": gate_ops.gate_init(n=1, device=dev),
             "vad": vadm.vad_gate_init(vad_cfg, n=1, device=dev)}

    def step(st, block):
        x, prob = block["x"], block["p"]
        vs, vout = vadm.vad_gate_process(vad_cfg, st["vad"], vadm.compute_rms_db(x), prob,
                                         available, _GATE_ORDER_FRAME, vad_params)
        gs, y, _ = gate_ops.gate_process(gate_cfg, st["gate"], x, prob, available,
                                         vout["gate_open"], threshold, gate_params)
        return {"gate": gs, "vad": vs}, {
            "y": y, "gain": gs["current_gain"], "floor": vout["noise_floor_db"],
            "reliability": vout["reliability"]}

    final, rows = run_take(step, state, {"x": blocks[:, None], "p": probs[:, None]},
                           blocks.shape[0])
    return (rows["y"][:, 0], rows["gain"][:, 0], rows["floor"][:, 0],
            rows["reliability"][:, 0], final["gate"]["chatter_event_count"][0])


def _suppressor_pass(audio, strength, device):
    """RNNoise over the whole signal through the staging processor (soft-clip
    PCM scaling, 15 ms strength smoothing)."""
    state = rn.processor_init(strength=float(strength), device=device)
    state, _ = rn.processor_push(state, audio)
    state, _ = rn.processor_process(state, take=True)
    state, out = rn.processor_pop(state, len(audio))
    if len(out) < len(audio):
        out = np.concatenate([out, np.zeros(len(audio) - len(out), np.float32)])
    return out


def simulate_gate_suppressor_order(audio, vad_probabilities, suppressor_before_gate,
                                   suppressor_strength, settings=None, *, device="cuda"):
    """Compare the smart gate / suppressor order on a recorded take. The gate
    reads only the suppressor's audio, so each stage runs once over the
    whole take, in the requested order."""
    strength = float(suppressor_strength)
    if not np.isfinite(strength) or not 0.0 <= strength <= 1.0:
        raise ValueError("suppressor_strength must be finite and between 0 and 1")
    audio = np.ascontiguousarray(np.asarray(audio, np.float32)).ravel()
    n = len(audio)
    block_count = -(-n // _GATE_ORDER_FRAME)
    probs = np.asarray(vad_probabilities, np.float32).ravel()
    if len(probs) != block_count or not np.all(
            np.isfinite(probs) & (probs >= 0.0) & (probs <= 1.0)):
        raise ValueError(f"expected {block_count} finite VAD probabilities at the "
                         "10 ms RNNoise cadence")
    dev = kernels.resolve_device(device, "simulate_gate_suppressor_order")

    threshold_db = float(_settings_get(settings, "gate_threshold_db", -40.0))
    attack_ms = float(_settings_get(settings, "gate_attack_ms", 10.0))
    release_ms = float(_settings_get(settings, "gate_release_ms", 100.0))
    vad_threshold = float(_settings_get(settings, "gate_vad_threshold", 0.48))
    gate_cfg = gate_ops.GateConfig(threshold_db=threshold_db, attack_ms=attack_ms,
                                   release_ms=release_ms, sample_rate=48000.0,
                                   mode=gate_ops.VAD_ASSISTED)
    vad_cfg = vadm.VadGateConfig(gate_mode=vadm.VAD_ASSISTED, vad_threshold=vad_threshold,
                                 manual_threshold_db=threshold_db)

    started = time.perf_counter()
    padded = np.zeros(block_count * _GATE_ORDER_FRAME, np.float32)
    padded[:n] = audio

    def gate_pass(x):
        out, gains, floors, rels, chatter = _gate_pass_over_blocks(
            gate_cfg, vad_cfg, vad_threshold,
            torch.as_tensor(x.reshape(block_count, _GATE_ORDER_FRAME), device=dev),
            torch.as_tensor(probs, device=dev))
        return (out.cpu().numpy().ravel(), gains.cpu().numpy(), float(floors[-1]),
                float(rels[-1]), int(chatter))

    if suppressor_before_gate:
        denoised = _suppressor_pass(padded, strength, dev)
        out, gate_gain, floor_db, reliability, chatter = gate_pass(denoised)
    else:
        gated, gate_gain, floor_db, reliability, chatter = gate_pass(padded)
        out = _suppressor_pass(gated, strength, dev)

    return {
        "output_audio": np.asarray(out[:n], np.float32).tolist(),
        "gate_gain": np.asarray(gate_gain, np.float32).tolist(),
        "gate_chatter_event_count": chatter,
        "gate_noise_floor_db": floor_db,
        "gate_noise_floor_reliability": reliability,
        "suppressor_latency_samples": rn.LATENCY_SAMPLES,
        "runtime_ms": (time.perf_counter() - started) * 1000.0,
    }
