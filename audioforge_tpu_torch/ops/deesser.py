"""Dynamic-EQ de-esser with 3-band sibilance detection.

Counterpart of ``audioforge_tpu/ops/deesser.py``: the detector band
(4-11 kHz by default) split three ways, each with an HP+LP sidechain and an
envelope follower; a voice-body reference; per-band confidence; the auto
(baseline-excess tracker) or manual (threshold/ratio) gain computer; the
total reduction rescaled to ``max_reduction_db`` and applied as three
dynamic peaking biquads whose gain follows the band reduction per sample.

The TPU split this into three phases only to get parallel scans (detector
biquads, the 13-state envelope scan, time-varying biquads). Here they run
sample by sample in one launch: the hand-written ``deesser_scan`` kernel
(``csrc/deesser_scan.cu``: the block staged in shared memory, the
recurrences one lane per band, the per-sample math of every sample spread
over the block's warps, the dynamic bands as a wavefront) on the card and
:func:`deesser_scan_plain` on the CPU. Filter and envelope state is f32, as
in the reference. The reference's phase pieces of its fused offline scan,
``detector_filter_block`` and ``make_envelope_step``, have no counterpart:
every caller here runs the staged kernel.

State (stream axis first)::

    det_z [N, 3, 2, 2]  HP/LP sidechain DF2T state per band
    dyn_z [N, 3, 2]     dynamic peaking DF2T state per band
    band_env, band_confidence, baseline_excess_db, reduction_db  [N, 3]
    broadband_env, current_reduction_db, detector_confidence     [N]
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from . import biquad, util

__all__ = [
    "BAND_COUNT", "DeEsserConfig", "deesser_init", "deesser_reset",
    "deesser_process", "deesser_scan", "deesser_scan_plain",
    "dynamic_band_constants", "dynamic_peaking_coeffs", "SCAN_STATE_KEYS",
    "pack_scan_state", "unpack_scan_state",
]

VOICE_REFERENCE_SIDECHAIN_DISCOUNT = 0.6
DETECTOR_RATIO_GATE_DB = 1.5
DETECTOR_RATIO_FULL_DB = 10.0
DETECTOR_LEVEL_GATE_DB = -62.0
DETECTOR_LEVEL_FULL_DB = -24.0
DETECTOR_VOICE_GATE_DB = -58.0
DETECTOR_VOICE_FULL_DB = -34.0
AUTO_BASELINE_FALL_MS = 13.88
AUTO_BASELINE_RISE_MS = 34.72
AUTO_BASELINE_INACTIVE_DECAY_MS = 20.82
BAND_COUNT = 3
DEFAULT_LOW_CUT_HZ = 4000.0
DEFAULT_HIGH_CUT_HZ = 11000.0
BROADBAND_NARROWNESS_GATE = 0.34
BROADBAND_NARROWNESS_FULL = 0.68

# the kernel's state rows (csrc/deesser_scan.cu DS_*): name and width
SCAN_STATE_KEYS = (("det_z", 12), ("dyn_z", 6), ("band_env", 3),
                   ("band_confidence", 3), ("baseline_excess_db", 3),
                   ("reduction_db", 3), ("broadband_env", 1),
                   ("current_reduction_db", 1), ("detector_confidence", 1))
_STATE_ROWS = sum(w for _, w in SCAN_STATE_KEYS)


@dataclass(frozen=True)
class DeEsserConfig:
    sample_rate: float = 48000.0
    enabled: bool = False
    auto_enabled: bool = True
    auto_amount: float = 0.5
    threshold_db: float = -28.0
    ratio: float = 4.0
    max_reduction_db: float = 6.0
    low_cut_hz: float = DEFAULT_LOW_CUT_HZ
    high_cut_hz: float = DEFAULT_HIGH_CUT_HZ

    def band_bounds(self):
        """Equal three-way split of the detector span."""
        low = min(max(self.low_cut_hz, 2000.0), 12000.0)
        high = self.high_cut_hz
        if high <= low + 200.0:
            high = min(max(low + 200.0, 2200.0), 16000.0)
        span = max(high - low, 600.0)
        a = low + span / 3.0
        b = low + span * 2.0 / 3.0
        return [(low, a), (a, b), (b, high)]

    def band_centers_qs(self):
        centers, qs = [], []
        for lo, hi in self.band_bounds():
            c = float(np.sqrt(lo * hi))
            bw = max(hi - lo, 200.0)
            centers.append(c)
            qs.append(float(np.clip(c / bw, 0.5, 6.0)))
        return centers, qs


def _coeff(ms, fs):
    return util.time_constant_to_coeff(ms / 1000.0, fs)


def _lerp(a, b, t):
    return a + (b - a) * t


def _detector_coeffs(config: DeEsserConfig) -> np.ndarray:
    """``(3, 2, 5)`` HP+LP sidechain coefficients per band (f32)."""
    out = np.zeros((BAND_COUNT, 2, 5), np.float64)
    for i, (lo, hi) in enumerate(config.band_bounds()):
        out[i, 0] = biquad.design(biquad.HIGH_PASS, lo, 0.0, 0.707, config.sample_rate)
        out[i, 1] = biquad.design(biquad.LOW_PASS, hi, 0.0, 0.707, config.sample_rate)
    return out.astype(np.float32)


def dynamic_band_constants(config: DeEsserConfig):
    """Static ``(cos w0, alpha)`` per dynamic-EQ band (host f64)."""
    centers, qs = config.band_centers_qs()
    fs = config.sample_rate
    out = []
    for c_hz, q in zip(centers, qs):
        w0 = 2.0 * np.pi * c_hz / fs
        out.append((float(np.cos(w0)), float(np.sin(w0) / (2.0 * q))))
    return out


def dynamic_peaking_coeffs(reduction_db, neg2cos: float, alpha: float):
    """Peaking-cut coefficients ``[..., 5]`` for a reduction tensor; only
    the gain varies. ``neg2cos`` is the f32 ``-2 cos w0``."""
    A = torch.pow(10.0, -reduction_db / 40.0)
    a0 = 1.0 + alpha / A
    return torch.stack([(1.0 + alpha * A) / a0, neg2cos / a0,
                        (1.0 - alpha * A) / a0, neg2cos / a0,
                        (1.0 - alpha / A) / a0], dim=-1)


@lru_cache(maxsize=16)
def _consts(config: DeEsserConfig) -> np.ndarray:
    """Every constant of the recurrence as f32, in the order of the
    kernel's ``DeesserConsts``: detector coefficients (30), the dynamic
    bands' ``-2 cos w0`` (3) and ``alpha`` (3), seven smoothing
    coefficients, then trigger offset, slope, auto cap, confidence floor,
    max reduction, threshold, ratio threshold and compression factor."""
    fs = config.sample_rate
    dyn = dynamic_band_constants(config)
    amount = float(np.clip(config.auto_amount, 0.0, 1.0))
    conf_floor = _lerp(0.28, 0.06, amount) if config.auto_enabled else 0.22
    values = [
        *_detector_coeffs(config).reshape(-1),
        *(-2.0 * c for c, _ in dyn), *(a for _, a in dyn),
        _coeff(1.5, fs), _coeff(60.0, fs), _coeff(2.0, fs), _coeff(80.0, fs),
        _coeff(AUTO_BASELINE_FALL_MS, fs), _coeff(AUTO_BASELINE_RISE_MS, fs),
        _coeff(AUTO_BASELINE_INACTIVE_DECAY_MS, fs),
        _lerp(8.0, 0.8, amount), _lerp(0.08, 1.9, amount),
        min(_lerp(0.8, 14.0, amount), config.max_reduction_db * 0.75),
        float(np.clip(conf_floor, 0.0, 0.95)),
        config.max_reduction_db, config.threshold_db,
        float(np.clip((config.threshold_db + 60.0) * 0.10, 0.0, 6.0)),
        1.0 - 1.0 / max(config.ratio, 1.0),
    ]
    out = np.asarray(values, np.float32)
    out.flags.writeable = False
    return out


def deesser_init(config: DeEsserConfig, *, n: int, device) -> dict:
    f = lambda *shape: torch.zeros((n, *shape), dtype=torch.float32, device=device)
    return {
        "det_z": f(BAND_COUNT, 2, 2),
        "band_env": f(BAND_COUNT),
        "band_confidence": f(BAND_COUNT),
        "baseline_excess_db": f(BAND_COUNT),
        "reduction_db": f(BAND_COUNT),
        "broadband_env": f(),
        "current_reduction_db": f(),
        "detector_confidence": f(),
        "dyn_z": f(BAND_COUNT, 2),
    }


def deesser_reset(config: DeEsserConfig, state) -> dict:
    """A fresh de-esser state of the same streams on the same device."""
    e = state["broadband_env"]
    return deesser_init(config, n=e.shape[0], device=e.device)


def _norm(value, start, end):
    return torch.clamp((value - start) / (end - start), 0.0, 1.0)


def _smooth(prev, inp, a_c, r_c):
    c = torch.where(inp > prev, a_c, r_c)
    return c * prev + (1.0 - c) * inp


def deesser_scan_plain(config: DeEsserConfig, state, x):
    """Plain PyTorch twin of the ``deesser_scan`` kernel: detector biquads,
    envelope/confidence/gain step and dynamic peaking bands, sample by
    sample over ``x: f32 [N, T]``. Returns ``(new_state, y)``."""
    k = [float(v) for v in _consts(config)]
    det = torch.tensor(k[:30], device=x.device).reshape(BAND_COUNT, 2, 5)
    neg2cos, alpha = k[30:33], k[33:36]
    det_atk, det_rel, atk, rel, base_fall, base_rise, base_decay = k[36:43]
    (trigger_offset, slope, auto_cap, conf_floor, max_red, thr, ratio_thr,
     comp_factor) = k[43:51]

    hp, lp = det[:, 0], det[:, 1]  # [3, 5]
    z_hp = state["det_z"][:, :, 0].clone()  # [N, 3, 2]
    z_lp = state["det_z"][:, :, 1].clone()
    dyn_z = [state["dyn_z"][:, b].clone() for b in range(BAND_COUNT)]
    broad_env = state["broadband_env"]
    band_env = state["band_env"]
    confidence = state["band_confidence"]
    baseline = state["baseline_excess_db"]
    reduction = state["reduction_db"]
    total_reduction = state["current_reduction_db"]
    agg_conf = state["detector_confidence"]
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        x_t = x[:, t]
        # ---- phase 1: HP then LP sidechain per band
        h, z1, z2 = biquad.df2t_step(hp, z_hp[..., 0], z_hp[..., 1], x_t[:, None])
        z_hp = torch.stack([z1, z2], dim=-1)
        side, z1, z2 = biquad.df2t_step(lp, z_lp[..., 0], z_lp[..., 1], h)
        z_lp = torch.stack([z1, z2], dim=-1)
        # ---- phase 2: envelopes, confidence, gain computer
        broad_env = _smooth(broad_env, x_t.abs(), det_atk, det_rel)
        band_env = _smooth(band_env, side.abs(), det_atk, det_rel)
        total_env = band_env.sum(dim=-1)
        max_env = band_env.amax(dim=-1)
        band_db = util.linear_to_db(torch.clamp_min(band_env, 1e-10), -200.0)
        voice_ref = torch.clamp_min(
            broad_env - total_env * VOICE_REFERENCE_SIDECHAIN_DISCOUNT, 1e-8)
        voice_db = util.linear_to_db(voice_ref, -200.0)
        narrowness = torch.where(total_env > 1e-10,
                                 max_env / torch.clamp_min(total_env, 1e-30), 0.0)
        spectral_ratio = torch.clamp_min(band_db - voice_db[:, None], 0.0)
        dominance = torch.where(
            (max_env > 1e-10)[:, None],
            torch.sqrt(band_env / torch.clamp_min(max_env[:, None], 1e-30)), 0.0)
        ratio_conf = _norm(spectral_ratio, DETECTOR_RATIO_GATE_DB,
                           DETECTOR_RATIO_FULL_DB)
        level_conf = _norm(band_db, DETECTOR_LEVEL_GATE_DB, DETECTOR_LEVEL_FULL_DB)
        voice_conf = _norm(voice_db, DETECTOR_VOICE_GATE_DB,
                           DETECTOR_VOICE_FULL_DB)[:, None]
        narrow_support = torch.where((spectral_ratio > 6.0) & (band_db > -45.0),
                                     0.75, 0.0)
        voice_support = torch.maximum(voice_conf, narrow_support)
        balance_conf = torch.where(ratio_conf > 0.12,
                                   torch.maximum(ratio_conf, voice_support * 0.65),
                                   ratio_conf)
        broadband_penalty = _lerp(0.35, 1.0, balance_conf)
        narrow_gain = _lerp(0.35, 1.0, _norm(narrowness, BROADBAND_NARROWNESS_GATE,
                                             BROADBAND_NARROWNESS_FULL))[:, None]
        conf_target = ((0.62 * ratio_conf + 0.18 * level_conf
                        + 0.20 * voice_support)
                       * broadband_penalty * narrow_gain) * dominance
        confidence = _smooth(confidence, torch.clamp(conf_target, 0.0, 1.0),
                             det_atk, det_rel)
        if config.auto_enabled:
            voice_active = (voice_db > -55.0)[:, None] | (band_db > -55.0)
            baseline_target = torch.clamp(spectral_ratio * 0.45, 0.0, 24.0)
            bc = torch.where(baseline_target < baseline, base_fall, base_rise)
            baseline_active = bc * baseline + (1 - bc) * baseline_target
            baseline = torch.where(voice_active, baseline_active,
                                   baseline * base_decay)
            conf_gain = _norm(confidence, conf_floor, 1.0)
            over = torch.clamp_min(spectral_ratio - baseline - trigger_offset, 0.0)
            target_red = torch.clamp(over * slope * conf_gain, 0.0, auto_cap)
        else:
            conf_gain = _norm(confidence, 0.22, 1.0)
            ratio_over = spectral_ratio - ratio_thr
            over = torch.minimum(band_db - thr, ratio_over)
            target_red = torch.where(
                (band_db > thr) & (ratio_over > 0.0),
                torch.clamp(comp_factor * over * conf_gain, 0.0, max_red * 0.75),
                0.0)
        total_target = target_red.sum(dim=-1, keepdim=True)
        scale = torch.where(total_target > max(max_red, 0.0),
                            max_red / torch.clamp_min(total_target, 1e-30), 1.0)
        target_red = target_red * scale
        reduction = _smooth(reduction, target_red, atk, rel)
        total_reduction = torch.clamp_max(reduction.sum(dim=-1), max_red)
        agg_conf = torch.clamp(confidence.amax(dim=-1), 0.0, 1.0)
        # ---- phase 3: dynamic peaking bands in series
        v = x_t
        for b in range(BAND_COUNT):
            c = dynamic_peaking_coeffs(reduction[:, b], neg2cos[b], alpha[b])
            v, z1, z2 = biquad.df2t_step(c, dyn_z[b][:, 0], dyn_z[b][:, 1], v)
            dyn_z[b] = torch.stack([z1, z2], dim=-1)
        y[:, t] = v
    new_state = {
        "det_z": torch.stack([z_hp, z_lp], dim=2),
        "band_env": band_env,
        "band_confidence": confidence,
        "baseline_excess_db": baseline,
        "reduction_db": reduction,
        "broadband_env": broad_env,
        "current_reduction_db": total_reduction,
        "detector_confidence": agg_conf,
        "dyn_z": torch.stack(dyn_z, dim=1),
    }
    return new_state, y


def deesser_scan(config: DeEsserConfig, state, x):
    """:func:`deesser_scan_plain` for a CPU tensor; the ``deesser_scan``
    CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return deesser_scan_plain(config, state, x)
    if x.device.type != "cuda":
        raise ValueError(f"deesser_scan: unsupported device {x.device}")
    return _deesser_launch(config, state, x)


def pack_scan_state(state) -> torch.Tensor:
    """The kernel's key-major state ``f32 [33, N]`` (``SCAN_STATE_KEYS``
    rows) from the state dict."""
    return torch.cat([state[key].reshape(-1, w) for key, w in SCAN_STATE_KEYS],
                     dim=1).t().contiguous()


def unpack_scan_state(rows: torch.Tensor, like) -> dict:
    """The state dict, shaped like ``like``, from ``f32 [33, N]`` rows."""
    parts = rows.t().split([w for _, w in SCAN_STATE_KEYS], dim=1)
    return {key: r.reshape(like[key].shape)
            for (key, _), r in zip(SCAN_STATE_KEYS, parts)}


def _deesser_launch(config: DeEsserConfig, state, x):
    n, T = x.shape
    dev = x.device
    s_in = pack_scan_state(state)
    kernels.check_tensor("deesser_scan x", x, torch.float32, (n, T), dev)
    kernels.check_tensor("deesser_scan state", s_in, torch.float32,
                         (_STATE_ROWS, n), dev)
    consts = _consts(config)
    y = torch.empty_like(x)
    s_out = torch.empty_like(s_in)
    kernels.launch("deesser_scan", x.data_ptr(), s_in.data_ptr(), y.data_ptr(),
                   s_out.data_ptr(), n, T, consts.ctypes.data, consts.size,
                   int(config.auto_enabled), kernels.stream_of(dev))
    return unpack_scan_state(s_out, state), y


def deesser_process(config: DeEsserConfig, state, x):
    """De-ess ``x: f32 [N, T]``. Returns ``(new_state, y, metrics)``."""
    if not config.enabled:
        new_state = dict(
            state,
            current_reduction_db=torch.zeros_like(state["current_reduction_db"]),
            detector_confidence=torch.zeros_like(state["detector_confidence"]))
        return new_state, x, {
            "reduction_db": new_state["current_reduction_db"],
            "confidence": new_state["detector_confidence"],
            "band_reduction_db": state["reduction_db"]}
    new_state, y = deesser_scan(config, state, x)
    metrics = {
        "reduction_db": new_state["current_reduction_db"],
        "confidence": new_state["detector_confidence"],
        "band_reduction_db": new_state["reduction_db"],
    }
    return new_state, y, metrics
