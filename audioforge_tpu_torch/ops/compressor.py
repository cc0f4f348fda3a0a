"""Downward compressor with blended detection and speech-aware auto makeup.

Counterpart of ``audioforge_tpu/ops/compressor.py``. The per-sample
recurrence (``make_sample_step``, scanned at ``compressor.py:577``) is the
hand-written ``compressor_scan`` kernel on the card (``csrc/compressor_scan.cu``)
and the loop :func:`compressor_scan_plain` on the CPU; the block-cadence
parts (activity estimate, gated loudness meter, auto makeup) are plain
PyTorch at block cadence. The reference's ``make_sample_step`` (the step
its fused offline scan inlines) has no counterpart: every caller here runs
the staged kernel.

Per-stream parameters are ``[N]`` f32 tensors (the serving engine stacks
them); the ``meter.coeffs`` leaf of the state is shared by every stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from . import loudness, util

__all__ = [
    "CompressorConfig", "compressor_params", "compressor_init", "compressor_reset",
    "compressor_scan", "compressor_scan_plain", "compressor_process",
    "SCAN_PARAM_KEYS", "SCAN_STATE_KEYS",
]

DETECTOR_PEAK_WEIGHT = 0.6
DETECTOR_RMS_WEIGHT = 0.4
ADAPTIVE_FAST_RELEASE_MS = 50.0
ADAPTIVE_SLOW_CHARGE_MS = 250.0
ADAPTIVE_SLOW_RELEASE_MS = 400.0
SLOW_RELEASE_TRIGGER_DB = 3.0
SPEECH_ACTIVE_RMS_MIN_DB = -55.0
SPEECH_ACTIVE_RMS_MAX_DB = -6.0
AUTO_MAKEUP_ACTIVE_MIN = 0.20
AUTO_MAKEUP_RELIABILITY_MIN = 0.35
AUTO_MAKEUP_ACTIVITY_SMOOTH_MS = 200.0
NOISE_RELATIVE_ACTIVITY_START_DB = 3.0
NOISE_RELATIVE_ACTIVITY_FULL_DB = 15.0
MAKEUP_SILENCE_RELAX_MS = 1500.0
MAKEUP_SILENCE_HOLD_MS = 700.0
MAKEUP_MAX_SLEW_DB_PER_S = 3.0
MAKEUP_LUFS_SMOOTH_MS = 600.0
SIDECHAIN_HIGHPASS_DEFAULT_HZ = 120.0
SIDECHAIN_BAND_ENV_MS = 18.0
PLOSIVE_RATIO_START = 1.25
PLOSIVE_RATIO_FULL = 5.0
PLOSIVE_MIN_DETECTOR_GAIN = 0.35

# kernel param rows (csrc/compressor_scan.cu P_*), makeup_lin last
SCAN_PARAM_KEYS = ("threshold_db", "ratio", "attack_coeff",
                   "detector_release_coeff", "base_release_ms", "knee_db",
                   "sidechain_hp_coeff")
# the per-sample scan carry (csrc/compressor_scan.cu S_*)
SCAN_STATE_KEYS = ("peak_envelope_db", "rms_envelope_sq", "current_gr_db",
                   "fast_release_env_db", "slow_release_env_db",
                   "current_release_ms", "sc_prev_in", "sc_prev_out",
                   "low_band_env_sq", "voiced_band_env_sq",
                   "presence_band_env_sq", "plosive_ratio")


@dataclass(frozen=True)
class CompressorConfig:
    sample_rate: float = 48000.0
    enabled: bool = True
    adaptive_release: bool = False
    auto_makeup_enabled: bool = False
    sidechain_highpass_enabled: bool = False
    block_samples: int = 480


def _coeff(ms: float, fs: float) -> float:
    return util.time_constant_to_coeff(ms / 1000.0, fs)


def compressor_params(config: CompressorConfig, threshold_db=-20.0, ratio=4.0,
                      attack_ms=10.0, release_ms=200.0, makeup_gain_db=0.0,
                      knee_db=0.0, target_lufs=-18.0,
                      noise_reference_reliability=0.0,
                      sidechain_highpass_hz=SIDECHAIN_HIGHPASS_DEFAULT_HZ,
                      detector_release_ms=None) -> dict:
    """Host control values (stacked per stream by the caller)."""
    fs = config.sample_rate
    cutoff = min(max(sidechain_highpass_hz, 20.0), fs * 0.45)
    omega = 2.0 * np.pi * cutoff / max(fs, 1.0)
    det_rel = release_ms if detector_release_ms is None else detector_release_ms
    return {
        "threshold_db": threshold_db,
        "ratio": max(ratio, 1.0),
        "attack_coeff": _coeff(attack_ms, fs),
        "detector_release_coeff": _coeff(det_rel, fs),
        "base_release_ms": release_ms,
        "makeup_gain_db": makeup_gain_db,
        "knee_db": max(knee_db, 0.0),
        "target_lufs": target_lufs,
        "noise_reference_reliability": noise_reference_reliability,
        "sidechain_hp_coeff": 1.0 / (1.0 + omega),
    }


def compressor_init(config: CompressorConfig, *, n: int, device) -> dict:
    f = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
    state = {k: f(0.0) for k in SCAN_STATE_KEYS}
    state.update(peak_envelope_db=f(-120.0), current_release_ms=f(200.0))
    for k in ("smoothed_makeup_gain", "speech_activity_score",
              "activity_reliability", "silence_run_ms",
              "limiter_feedback_gr_db"):
        state[k] = f(0.0)
    state.update(makeup_lufs_smoothed=f(-100.0), current_lufs=f(-100.0))
    state["meter"] = loudness.meter_init(config.sample_rate,
                                         config.block_samples, n=n,
                                         device=device)
    return state


def compressor_reset(config: CompressorConfig, state, params) -> dict:
    """`compressor.rs:786-808`: a fresh state of the same streams on the
    same device, its release at ``params["base_release_ms"]`` and its
    smoothed makeup at the manual ``params["makeup_gain_db"]``
    (`compressor.rs:174`); ``params`` host values or ``[N]`` tensors."""
    g = state["current_gr_db"]
    n, dev = g.shape[0], g.device
    out = compressor_init(config, n=n, device=dev)
    for key, src in (("current_release_ms", "base_release_ms"),
                     ("smoothed_makeup_gain", "makeup_gain_db")):
        out[key] = torch.as_tensor(params[src], dtype=torch.float32,
                                   device=dev).expand(n).clone()
    return out


def _scan_consts(config: CompressorConfig) -> dict:
    fs = config.sample_rate
    return {
        "rms_c": util.f32(_coeff(20.0, fs)),
        "band_c": util.f32(_coeff(SIDECHAIN_BAND_ENV_MS, fs)),
        "rel_smooth_c": util.f32(_coeff(100.0, fs)),
        "fast_c": util.f32(_coeff(ADAPTIVE_FAST_RELEASE_MS, fs)),
        "charge_c": util.f32(_coeff(ADAPTIVE_SLOW_CHARGE_MS, fs)),
        "slow_c": util.f32(_coeff(ADAPTIVE_SLOW_RELEASE_MS, fs)),
    }


def _gain_reduction(params, detector_db):
    """Soft-knee static curve (``compressor.py:251``)."""
    comp = 1.0 - 1.0 / params["ratio"]
    thr, knee = params["threshold_db"], params["knee_db"]
    hard = torch.where(detector_db <= thr, 0.0, (detector_db - thr) * comp)
    half = knee / 2.0
    xk = detector_db - (thr - half)
    soft = torch.where(
        detector_db <= thr - half, 0.0,
        torch.where(detector_db >= thr + half, (detector_db - thr) * comp,
                    comp * xk * xk / (2.0 * torch.clamp_min(knee, 1e-9))))
    return torch.where(knee <= 0.0, hard, soft)


def compressor_scan_plain(config: CompressorConfig, params, makeup_lin, state, x):
    """Plain PyTorch twin of the ``compressor_scan`` kernel: the per-sample
    step of ``make_sample_step`` over ``x: f32 [N, T]``. ``state`` holds
    :data:`SCAN_STATE_KEYS`; returns ``(final_state, y)``.

    Like the kernel, it runs only the recurrences sample by sample (the
    sidechain high-pass, the band and RMS envelopes, the peak envelope, the
    release and gain-reduction smoothing) and the feed-forward math between
    them over the whole block."""
    k = _scan_consts(config)
    fs = config.sample_rate
    band_c, band_1 = util.f32_pair(k["band_c"])
    rms_c, rms_1 = util.f32_pair(k["rms_c"])
    rs_c, rs_1 = util.f32_pair(k["rel_smooth_c"])
    fast_c, fast_1 = util.f32_pair(k["fast_c"])
    charge_c, charge_1 = util.f32_pair(k["charge_c"])
    slow_c = k["slow_c"]
    atk = params["attack_coeff"]
    atk_1 = 1.0 - atk
    det_rel = params["detector_release_coeff"]
    T = x.shape[-1]
    s = dict(state)
    cols = lambda seq: torch.stack(seq, dim=-1)

    # ---- sidechain high-pass and its band envelopes
    if config.sidechain_highpass_enabled:
        hp_c = params["sidechain_hp_coeff"]
        prev_in, prev_out, det = s["sc_prev_in"], s["sc_prev_out"], []
        for t in range(T):
            x_t = x[:, t]
            prev_out = hp_c * (prev_out + x_t - prev_in)
            prev_in = x_t
            det.append(prev_out)
        s["sc_prev_in"], s["sc_prev_out"] = prev_in, prev_out
        det_in = cols(det)
        low_c = x - det_in
        presence_c = 0.65 * det_in + 0.35 * (det_in - low_c)
        drives = torch.stack([band_1 * low_c * low_c, band_1 * det_in * det_in,
                              band_1 * presence_c * presence_c])  # [3, N, T]
        env = torch.stack([s["low_band_env_sq"], s["voiced_band_env_sq"],
                           s["presence_band_env_sq"]])
        envs = []
        for t in range(T):
            env = band_c * env + drives[:, :, t]
            envs.append(env)
        env_t = torch.stack(envs, dim=-1)  # [3, N, T]
        s["low_band_env_sq"], s["voiced_band_env_sq"], s["presence_band_env_sq"] = env.unbind(0)
        low_rms = torch.sqrt(env_t[0])
        voiced_rms = torch.clamp_min(torch.sqrt(env_t[1]), 1e-8)
        pres_rms = torch.sqrt(env_t[2])
        plosive = torch.clamp(low_rms / voiced_rms, 0.0, 32.0)
        s["plosive_ratio"] = plosive[:, -1]
        amount = torch.clamp((plosive - PLOSIVE_RATIO_START)
                             / (PLOSIVE_RATIO_FULL - PLOSIVE_RATIO_START), 0.0, 1.0)
        penalty = 1.0 - amount * (1.0 - PLOSIVE_MIN_DETECTOR_GAIN)
        pres_ratio = torch.clamp(pres_rms / voiced_rms, 0.0, 4.0)
        pres_weight = 1.0 + 0.18 * torch.clamp(pres_ratio - 0.75, 0.0, 1.0)
        det_weight = torch.clamp(penalty * pres_weight, PLOSIVE_MIN_DETECTOR_GAIN, 1.15)
    else:
        det_in = x
        s["plosive_ratio"] = torch.zeros_like(x[:, 0])
        det_weight = torch.ones_like(x)

    # ---- peak and RMS envelopes of the detector input
    inst_peak_db = util.linear_to_db(torch.clamp_min(det_in.abs(), 1e-10), -200.0)
    rms_drive = rms_1 * det_in * det_in
    pe, rms, pes, rmss = s["peak_envelope_db"], s["rms_envelope_sq"], [], []
    for t in range(T):
        inst = inst_peak_db[:, t]
        peak_c = torch.where(inst > pe, atk, det_rel)
        pe = peak_c * pe + (1.0 - peak_c) * inst
        rms = rms_c * rms + rms_drive[:, t]
        pes.append(pe)
        rmss.append(rms)
    s["peak_envelope_db"], s["rms_envelope_sq"] = pe, rms
    blended = (DETECTOR_PEAK_WEIGHT * torch.pow(10.0, cols(pes) / 20.0)
               + DETECTOR_RMS_WEIGHT * torch.clamp_min(torch.sqrt(cols(rmss)), 1e-10))
    detector_db = util.linear_to_db(
        torch.clamp_min(blended, 1e-10) * torch.clamp_min(det_weight, 1e-10), -200.0)
    target_gr = _gain_reduction({k: params[k][:, None] for k in
                                 ("ratio", "threshold_db", "knee_db")}, detector_db)

    # ---- release time and gain-reduction smoothing
    cur_rel, gr = s["current_release_ms"], s["current_gr_db"]
    fast_env, slow_env = s["fast_release_env_db"], s["slow_release_env_db"]
    grs = []
    for t in range(T):
        tg = target_gr[:, t]
        if config.adaptive_release:
            sustained = torch.clamp(slow_env / (SLOW_RELEASE_TRIGGER_DB + 3.0), 0.0, 1.0)
            transient = torch.clamp((fast_env - slow_env) / (SLOW_RELEASE_TRIGGER_DB + 4.0),
                                    0.0, 1.0)
            syllabic = torch.clamp(sustained * sustained * (1.0 - 0.35 * transient), 0.0, 1.0)
            target_rel_ms = ADAPTIVE_FAST_RELEASE_MS + syllabic * (
                ADAPTIVE_SLOW_RELEASE_MS - ADAPTIVE_FAST_RELEASE_MS)
        else:
            target_rel_ms = params["base_release_ms"]
        cur_rel = torch.where((target_rel_ms - cur_rel).abs() > 1.0,
                              rs_c * cur_rel + rs_1 * target_rel_ms, target_rel_ms)
        if config.adaptive_release:
            fast_env = torch.where(tg > gr, atk * gr + atk_1 * tg,
                                   fast_c * fast_env + fast_1 * tg)
            slow_env = torch.where(tg > SLOW_RELEASE_TRIGGER_DB,
                                   charge_c * slow_env + charge_1 * tg, slow_c * slow_env)
            gr = torch.maximum(fast_env, slow_env)
        else:
            rx = -1000.0 / (torch.clamp_min(cur_rel, 1e-6) * fs)
            gr_c = torch.where(tg > gr, atk, 1.0 + rx + 0.5 * rx * rx)
            gr = gr_c * gr + (1.0 - gr_c) * tg
        grs.append(gr)
    s["current_release_ms"], s["current_gr_db"] = cur_rel, gr
    if config.adaptive_release:
        s["fast_release_env_db"], s["slow_release_env_db"] = fast_env, slow_env
    else:
        s["fast_release_env_db"], s["slow_release_env_db"] = gr, torch.zeros_like(gr)
    y = x * torch.pow(10.0, -cols(grs) / 20.0) * makeup_lin[:, None]
    return s, y


def compressor_scan(config: CompressorConfig, params, makeup_lin, state, x):
    """:func:`compressor_scan_plain` for a CPU tensor; the ``compressor_scan``
    CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return compressor_scan_plain(config, params, makeup_lin, state, x)
    if x.device.type != "cuda":
        raise ValueError(f"compressor_scan: unsupported device {x.device}")
    n, T = x.shape
    dev = x.device
    p = torch.stack([params[k] for k in SCAN_PARAM_KEYS] + [makeup_lin])
    s_in = torch.stack([state[k] for k in SCAN_STATE_KEYS])
    kernels.check_tensor("compressor_scan x", x, torch.float32, (n, T), dev)
    kernels.check_tensor("compressor_scan params", p, torch.float32,
                         (len(SCAN_PARAM_KEYS) + 1, n), dev)
    kernels.check_tensor("compressor_scan state", s_in, torch.float32,
                         (len(SCAN_STATE_KEYS), n), dev)
    y = torch.empty_like(x)
    s_out = torch.empty_like(s_in)
    k = _scan_consts(config)
    kernels.launch("compressor_scan", x.data_ptr(), p.data_ptr(),
                   s_in.data_ptr(), y.data_ptr(), s_out.data_ptr(), n, T,
                   k["rms_c"], k["band_c"], k["rel_smooth_c"], k["fast_c"],
                   k["charge_c"], k["slow_c"], float(config.sample_rate),
                   int(config.adaptive_release),
                   int(config.sidechain_highpass_enabled),
                   kernels.stream_of(dev))
    return dict(zip(SCAN_STATE_KEYS, s_out.unbind(0))), y


# --------------------------------------------------------------------------
# Block cadence
# --------------------------------------------------------------------------


def _smoothstep(edge0, edge1, value):
    span = edge1 - edge0
    t = torch.clamp((value - edge0) / torch.where(span <= 0, 1.0, span), 0.0, 1.0)
    return torch.where(span <= 0, 0.0, t * t * (3.0 - 2.0 * t))


def _speech_activity_from_rms_db(rms_db):
    onset = torch.clamp((rms_db - SPEECH_ACTIVE_RMS_MIN_DB) / 12.0, 0.0, 1.0)
    overload = torch.clamp((SPEECH_ACTIVE_RMS_MAX_DB - rms_db) / 6.0, 0.0, 1.0)
    inside = ((rms_db >= SPEECH_ACTIVE_RMS_MIN_DB)
              & (rms_db <= SPEECH_ACTIVE_RMS_MAX_DB))
    return torch.where(inside, torch.minimum(onset, overload), 0.0)


def _finite_unit(v):
    return torch.where(torch.isfinite(v), torch.clamp(v, 0.0, 1.0), 0.0)


def _estimate_activity(params, rms_db, evidence):
    """``compressor.py:218``; ``evidence`` is None or a dict of ``[N]``
    tensors {vad_probability, vad_reliability, noise_floor_db,
    live_noise_reliability}."""
    absolute = _speech_activity_from_rms_db(rms_db)
    if evidence is None:
        return absolute, torch.ones_like(absolute)
    vad_prob_raw = evidence["vad_probability"].to(torch.float32)
    vad_rel = _finite_unit(evidence["vad_reliability"].to(torch.float32))
    vad_rel = torch.where(torch.isfinite(vad_prob_raw), vad_rel, 0.0)
    vad_prob = _finite_unit(vad_prob_raw)
    configured = _finite_unit(params["noise_reference_reliability"])
    live = _finite_unit(evidence["live_noise_reliability"].to(torch.float32))
    noise_rel = torch.where(configured > 0.0, torch.minimum(live, configured), live)
    floor_db = evidence["noise_floor_db"].to(torch.float32)
    floor_ok = torch.isfinite(floor_db) & (floor_db >= -120.0) & (floor_db <= 0.0)
    relative = torch.where(
        floor_ok,
        _smoothstep(floor_db + NOISE_RELATIVE_ACTIVITY_START_DB,
                    floor_db + NOISE_RELATIVE_ACTIVITY_FULL_DB, rms_db),
        0.0)
    noise_rel = torch.where(floor_ok, noise_rel, 0.0)
    fallback = noise_rel * relative + (1.0 - noise_rel) * absolute
    activity = vad_rel * vad_prob + (1.0 - vad_rel) * fallback
    reliability = torch.maximum(vad_rel, 0.75 * noise_rel)
    return torch.clamp(activity, 0.0, 1.0), torch.clamp(reliability, 0.0, 1.0)


def finalize_block(config, params, state, final, y, T, activity, reliability,
                   lim_fb):
    """Activity-gated loudness metering and the auto-makeup controller
    (``compressor.py:422``). Returns ``(new_state, metrics)``."""
    fs = config.sample_rate
    meter_gate = ((activity > AUTO_MAKEUP_ACTIVE_MIN)
                  & (reliability >= AUTO_MAKEUP_RELIABILITY_MIN))
    new_meter, _ = loudness.meter_process(state["meter"], y)
    meter = {}
    for k, new in new_meter.items():
        old = state["meter"][k]
        if k == "coeffs":  # shared constants, never gated
            meter[k] = old
            continue
        cond = meter_gate.reshape(meter_gate.shape + (1,) * (new.ndim - 1))
        meter[k] = torch.where(cond, new, old)

    makeup_c, makeup_1 = util.f32_pair(_coeff(200.0, fs) ** T)
    smg = state["smoothed_makeup_gain"]
    if not config.auto_makeup_enabled:
        target = params["makeup_gain_db"]
        new_smg = torch.where((target - smg).abs() > 0.1,
                              makeup_c * smg + makeup_1 * target, target)
        new_score = state["speech_activity_score"]
        new_rel = state["activity_reliability"]
        cur_lufs = state["current_lufs"]
        new_silence_run = torch.zeros_like(state["silence_run_ms"])
        new_lufs_sm = state["makeup_lufs_smoothed"]
    else:
        silence_c, silence_1 = util.f32_pair(_coeff(MAKEUP_SILENCE_RELAX_MS, fs) ** T)
        activity_c, activity_1 = util.f32_pair(
            _coeff(AUTO_MAKEUP_ACTIVITY_SMOOTH_MS, fs) ** T)
        lufs_c, lufs_1 = util.f32_pair(_coeff(MAKEUP_LUFS_SMOOTH_MS, fs) ** T)
        n_ring = meter["ring"].shape[-1]
        mpow = torch.mean(meter["ring"], dim=-1)
        cur_lufs = torch.where(
            meter["filled"] >= n_ring,
            -0.691 + 10.0 * torch.log10(torch.clamp_min(mpow, 1e-30)), -100.0)
        new_score = (activity_c * state["speech_activity_score"]
                     + activity_1 * torch.clamp(activity, 0.0, 1.0))
        new_rel = torch.clamp(reliability, 0.0, 1.0)
        prev_lufs = state["makeup_lufs_smoothed"]
        have_reading = cur_lufs > -99.0
        have_prev = prev_lufs > -99.0
        new_lufs_sm = torch.where(
            have_reading,
            torch.where(have_prev,
                        lufs_c * prev_lufs + lufs_1 * cur_lufs,
                        cur_lufs),
            prev_lufs)
        silence = new_score < AUTO_MAKEUP_ACTIVE_MIN
        block_ms = util.f32(T * 1000.0 / fs)
        new_silence_run = torch.where(silence, state["silence_run_ms"] + block_ms,
                                      0.0)
        silence_engaged = new_silence_run >= MAKEUP_SILENCE_HOLD_MS
        relaxed = silence_c * smg + silence_1 * params["makeup_gain_db"]
        silence_smg = torch.where(silence_engaged, relaxed, smg)
        low_rel = new_rel < AUTO_MAKEUP_RELIABILITY_MIN
        cap = params["makeup_gain_db"] + 3.0 * (new_rel / AUTO_MAKEUP_RELIABILITY_MIN)
        lowrel_smg = torch.where(smg > cap, makeup_c * smg + makeup_1 * cap, smg)
        required = params["target_lufs"] - torch.where(
            have_prev | have_reading, new_lufs_sm, cur_lufs)
        rel_cap = torch.clamp(12.0 * new_rel, 3.0, 12.0)
        head_cap = torch.clamp(torch.clamp(12.0 - lim_fb * 2.0, min=0.0),
                               max=rel_cap)
        clamped = torch.clamp(torch.clamp(smg + required, min=0.0), max=head_cap)
        active_smg = torch.where((clamped - smg).abs() > 0.1,
                                 makeup_c * smg + makeup_1 * clamped, clamped)
        new_smg = torch.where(silence, silence_smg,
                              torch.where(low_rel, lowrel_smg, active_smg))
        max_slew = util.f32(MAKEUP_MAX_SLEW_DB_PER_S * T / fs)
        new_smg = torch.clamp(new_smg, smg - max_slew, smg + max_slew)

    new_state = dict(final, meter=meter, smoothed_makeup_gain=new_smg,
                     speech_activity_score=new_score,
                     activity_reliability=new_rel,
                     silence_run_ms=new_silence_run,
                     makeup_lufs_smoothed=new_lufs_sm, current_lufs=cur_lufs,
                     limiter_feedback_gr_db=lim_fb)
    metrics = {
        "gain_reduction_db": final["current_gr_db"],
        "makeup_gain_db": new_smg,
        "lufs": cur_lufs,
        "activity": activity,
        "reliability": reliability,
        "plosive_ratio": final["plosive_ratio"],
    }
    return new_state, metrics


def compressor_process(config: CompressorConfig, params, state, x,
                       evidence=None, limiter_feedback_db=None):
    """Compress ``x: f32 [N, T]``. ``evidence``: optional dict of ``[N]``
    tensors for the auto makeup; ``limiter_feedback_db``: the previous
    block's limiter GR ``[N]``. Returns ``(new_state, y, metrics)``."""
    if not config.enabled:
        new_state = dict(state,
                         current_gr_db=torch.zeros_like(state["current_gr_db"]))
        zeros = torch.zeros_like(state["current_gr_db"])
        return new_state, x, {
            "gain_reduction_db": zeros, "makeup_gain_db": state["smoothed_makeup_gain"],
            "lufs": state["current_lufs"], "activity": zeros,
            "reliability": zeros, "plosive_ratio": state["plosive_ratio"]}
    if limiter_feedback_db is None:
        limiter_feedback_db = torch.zeros_like(state["limiter_feedback_gr_db"])
    lim_fb = torch.clamp(limiter_feedback_db.to(torch.float32), 0.0, 24.0)
    power = torch.mean(x * x, dim=-1)
    block_rms_db = util.linear_to_db(torch.clamp_min(torch.sqrt(power), 1e-10),
                                     -200.0)
    activity, reliability = _estimate_activity(params, block_rms_db, evidence)
    makeup_lin = torch.pow(10.0, state["smoothed_makeup_gain"] / 20.0)
    final, y = compressor_scan(config, params, makeup_lin,
                               {k: state[k] for k in SCAN_STATE_KEYS}, x)
    new_state, metrics = finalize_block(config, params, state, final, y,
                                        x.shape[-1], activity, reliability, lim_fb)
    return new_state, y, metrics
