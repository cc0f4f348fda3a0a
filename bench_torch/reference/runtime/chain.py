"""The offline chain over whole takes: de-esser <-> EQ, compressor, lookahead
limiter and true-peak limiter, with the nine per-block stats of the port's
``runtime/chain.py``.

The port runs a take block by block, one CUDA graph replay a block, each
block starting from the state the one before left. This reference runs each
stage over the whole take at once, from fresh state, which is the same
recurrence, and takes the per-block stats from the per-sample arrays:

- the recurrences that are linear and time-invariant (the de-esser's
  detector biquads, the compressor's sidechain high-pass and envelopes) run
  as the reference's float64 block operators (``ops/biquad.py``), and the EQ
  as the reference's cascade (``biquad.apply_fixed``, float64 state);
- the others (the envelope followers, the de-esser's baseline and dynamic
  bands, the compressor's peak envelope and release, the limiters' gain)
  run sample by sample in plain Python floats (float64), a row at a time;
- the feed-forward math between them runs in NumPy (float64) over the take;
- the true-peak interpolators are the reference's float32 products
  (``ops/true_peak.py``); audio between stages is float32.

Stages before the compressor see no compressor parameter, so :func:`render`
runs them once a distinct input and hands their output to every row of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import biquad
from ..ops import compressor as comp_ops
from ..ops import deesser as des_ops
from ..ops import eq as eq_ops
from ..ops import limiter as lim_ops
from ..ops import true_peak as tp_ops
from ..ops import util

STAT_KEYS = (
    "input_sample_peak", "deesser_gain_reduction_db", "compressor_gain_reduction_db",
    "limiter_peak_gain_reduction_db", "true_peak_limiter_input_peak",
    "true_peak_limiter_gain_reduction_db", "true_peak_limited_events",
    "output_sample_peak", "output_true_peak",
)


@dataclass(frozen=True)
class ChainConfig:
    """Static chain structure; the compressor's numeric parameters are
    per-row values."""

    sample_rate: float = 48000.0
    deesser_enabled: bool = False
    eq_enabled: bool = True
    compressor_enabled: bool = False
    limiter_enabled: bool = True
    eq_before_deesser: bool = False
    deesser: des_ops.DeEsserConfig = field(default_factory=des_ops.DeEsserConfig)
    compressor: comp_ops.CompressorConfig = field(default_factory=comp_ops.CompressorConfig)
    limiter: lim_ops.LimiterConfig = field(default_factory=lambda: lim_ops.LimiterConfig(
        ceiling_db=-0.5, release_ms=50.0, lookahead_ms=2.0))
    tp_release_ms: float = 80.0


# ---------------------------------------------------------------- the loops
def _linear(coeffs: tuple, x: np.ndarray) -> np.ndarray:
    """A static DF2T section ``(b0, b1, b2, a1, a2)`` over the rows of
    ``x [R, n]`` from zero state, float64."""
    y, _ = biquad._static_section(tuple(float(c) for c in coeffs),
                                  torch.from_numpy(np.ascontiguousarray(x, np.float64)),
                                  torch.zeros((x.shape[0], 2), dtype=torch.float64))
    return y.numpy()


def _one_pole(c: float, drive: np.ndarray) -> np.ndarray:
    """``y_t = c y_{t-1} + drive_t`` from 0."""
    return _linear((1.0, 0.0, 0.0, -c, 0.0), drive)


def _follow(inp: np.ndarray, rise: float, fall: float, p: float = 0.0) -> np.ndarray:
    """``p = c p + (1 - c) v`` with ``c = rise`` where ``v > p`` and ``fall``
    elsewhere, over the row ``inp [n]``."""
    r1, f1 = 1.0 - rise, 1.0 - fall
    out = [0.0] * len(inp)
    for i, v in enumerate(inp.tolist()):
        p = rise * p + r1 * v if v > p else fall * p + f1 * v
        out[i] = p
    return np.array(out)


def _rows(fn, *arrays) -> np.ndarray:
    """``fn`` over each row of the ``[R, n]`` arrays."""
    return np.stack([fn(*row) for row in zip(*arrays)])


def _db(v: np.ndarray) -> np.ndarray:
    """The tensor ``util.linear_to_db`` with its -200 dB floor."""
    return np.maximum(20.0 * np.log10(np.maximum(np.abs(v), util.DB_EPS)), -200.0)


def _norm(v, start, end):
    return np.clip((v - start) / (end - start), 0.0, 1.0)


def _lerp(a, b, t):
    return a + (b - a) * t


# ---------------------------------------------------------------- de-esser
def _baseline(target: np.ndarray, active: np.ndarray, fall: float, rise: float,
              decay: float) -> np.ndarray:
    """The auto mode's baseline excess over one band of one row: it tracks
    the target while the band or the voice is active and decays
    elsewhere."""
    out = [0.0] * len(target)
    b = 0.0
    for i, (v, on) in enumerate(zip(target.tolist(), active.tolist())):
        if on:
            c = fall if v < b else rise
            b = c * b + (1.0 - c) * v
        else:
            b = b * decay
        out[i] = b
    return np.array(out)


def _varying_biquad(b0, b1, b2, a1, a2, x) -> np.ndarray:
    """A DF2T section whose coefficients change every sample, from zero
    state, over one row."""
    out = [0.0] * len(x)
    z1 = z2 = 0.0
    for i, (c0, c1, c2, d1, d2, v) in enumerate(zip(b0.tolist(), b1.tolist(), b2.tolist(),
                                                    a1.tolist(), a2.tolist(), x.tolist())):
        y = c0 * v + z1
        z1 = c1 * v - d1 * y + z2
        z2 = c2 * v - d2 * y
        out[i] = y
    return np.array(out)


def deesser(config: des_ops.DeEsserConfig, x: np.ndarray) -> tuple:
    """The de-esser of ``ops/deesser.py`` over ``x [R, n]`` from fresh state:
    ``(y [R, n], total reduction in dB [R, n])``."""
    k = [float(v) for v in des_ops._consts(config)]
    det = np.asarray(k[:30]).reshape(des_ops.BAND_COUNT, 2, 5)
    neg2cos, alpha = k[30:33], k[33:36]
    det_atk, det_rel, atk, rel, base_fall, base_rise, base_decay = k[36:43]
    (trigger_offset, slope, auto_cap, conf_floor, max_red, thr, ratio_thr,
     comp_factor) = k[43:51]
    bands = range(des_ops.BAND_COUNT)
    side = np.stack([_linear(det[b, 1], _linear(det[b, 0], x)) for b in bands], 1)
    follow = lambda inp: _rows(lambda r: _follow(r, det_atk, det_rel), inp)
    broad_env = follow(np.abs(x))
    band_env = np.stack([follow(np.abs(side[:, b])) for b in bands], 1)  # [R, 3, n]
    total_env, max_env = band_env.sum(1), band_env.max(1)
    band_db = _db(np.maximum(band_env, 1e-10))
    voice_db = _db(np.maximum(broad_env - total_env * des_ops.VOICE_REFERENCE_SIDECHAIN_DISCOUNT,
                              1e-8))
    narrowness = np.where(total_env > 1e-10, max_env / np.maximum(total_env, 1e-30), 0.0)
    spectral_ratio = np.maximum(band_db - voice_db[:, None], 0.0)
    dominance = np.where((max_env > 1e-10)[:, None],
                         np.sqrt(band_env / np.maximum(max_env[:, None], 1e-30)), 0.0)
    ratio_conf = _norm(spectral_ratio, des_ops.DETECTOR_RATIO_GATE_DB,
                       des_ops.DETECTOR_RATIO_FULL_DB)
    level_conf = _norm(band_db, des_ops.DETECTOR_LEVEL_GATE_DB, des_ops.DETECTOR_LEVEL_FULL_DB)
    voice_conf = _norm(voice_db, des_ops.DETECTOR_VOICE_GATE_DB,
                       des_ops.DETECTOR_VOICE_FULL_DB)[:, None]
    narrow_support = np.where((spectral_ratio > 6.0) & (band_db > -45.0), 0.75, 0.0)
    voice_support = np.maximum(voice_conf, narrow_support)
    balance_conf = np.where(ratio_conf > 0.12, np.maximum(ratio_conf, voice_support * 0.65),
                            ratio_conf)
    narrow_gain = _lerp(0.35, 1.0, _norm(narrowness, des_ops.BROADBAND_NARROWNESS_GATE,
                                         des_ops.BROADBAND_NARROWNESS_FULL))[:, None]
    conf_target = ((0.62 * ratio_conf + 0.18 * level_conf + 0.20 * voice_support)
                   * _lerp(0.35, 1.0, balance_conf) * narrow_gain) * dominance
    confidence = np.stack([follow(np.clip(conf_target[:, b], 0.0, 1.0)) for b in bands], 1)
    if config.auto_enabled:
        active = (voice_db > -55.0)[:, None] | (band_db > -55.0)
        target = np.clip(spectral_ratio * 0.45, 0.0, 24.0)
        baseline = np.stack([_rows(lambda t, a: _baseline(t, a, base_fall, base_rise, base_decay),
                                   target[:, b], active[:, b]) for b in bands], 1)
        over = np.maximum(spectral_ratio - baseline - trigger_offset, 0.0)
        target_red = np.clip(over * slope * _norm(confidence, conf_floor, 1.0), 0.0, auto_cap)
    else:
        ratio_over = spectral_ratio - ratio_thr
        over = np.minimum(band_db - thr, ratio_over)
        target_red = np.where((band_db > thr) & (ratio_over > 0.0),
                              np.clip(comp_factor * over * _norm(confidence, 0.22, 1.0), 0.0,
                                      max_red * 0.75), 0.0)
    total_target = target_red.sum(1, keepdims=True)
    target_red = target_red * np.where(total_target > max(max_red, 0.0),
                                       max_red / np.maximum(total_target, 1e-30), 1.0)
    reduction = np.stack([_rows(lambda t: _follow(t, atk, rel), target_red[:, b])
                          for b in bands], 1)  # [R, 3, n]
    total = np.minimum(reduction.sum(1), max_red)
    A = np.power(10.0, -reduction / 40.0)
    al = np.asarray(alpha)[None, :, None]
    n2c = np.asarray(neg2cos)[None, :, None]
    a0 = 1.0 + al / A
    coeffs = ((1.0 + al * A) / a0, n2c / a0, (1.0 - al * A) / a0, n2c / a0,
              (1.0 - al / A) / a0)  # each [R, 3, n]
    y = x
    for b in bands:
        y = _rows(_varying_biquad, *(c[:, b] for c in coeffs), y)
    return y, total


# ---------------------------------------------------------------- compressor
def _peak_envelope(inst: np.ndarray, atk: float, rel: float) -> np.ndarray:
    return _follow(inst, atk, rel, -120.0)


def _adaptive_release(tg: np.ndarray, atk: float, k: dict) -> np.ndarray:
    """The adaptive release's gain reduction over one row of target gain
    reduction ``tg``."""
    fast_c, fast_1 = util.f32_pair(k["fast_c"])
    charge_c, charge_1 = util.f32_pair(k["charge_c"])
    slow_c, atk_1, trig = k["slow_c"], 1.0 - atk, comp_ops.SLOW_RELEASE_TRIGGER_DB
    out = [0.0] * len(tg)
    fast = slow = gr = 0.0
    for i, t in enumerate(tg.tolist()):
        fast = atk * gr + atk_1 * t if t > gr else fast_c * fast + fast_1 * t
        slow = charge_c * slow + charge_1 * t if t > trig else slow_c * slow
        gr = fast if fast > slow else slow
        out[i] = gr
    return np.array(out)


def _fixed_release(tg: np.ndarray, atk: float, base_ms: float, fs: float, k: dict) -> np.ndarray:
    """The fixed release's gain reduction over one row: the release time
    glides to ``base_ms``."""
    rs_c, rs_1 = util.f32_pair(k["rel_smooth_c"])
    out = [0.0] * len(tg)
    cur, gr = base_ms, 0.0
    for i, t in enumerate(tg.tolist()):
        cur = rs_c * cur + rs_1 * base_ms if abs(base_ms - cur) > 1.0 else base_ms
        rx = -1000.0 / (max(cur, 1e-6) * fs)
        c = atk if t > gr else 1.0 + rx + 0.5 * rx * rx
        gr = c * gr + (1.0 - c) * t
        out[i] = gr
    return np.array(out)


def _gain_reduction(detector_db, threshold_db, ratio, knee_db):
    """The soft-knee static curve of ``ops/compressor.py``, a row's
    parameters ``[R, 1]``."""
    comp = 1.0 - 1.0 / ratio
    hard = np.where(detector_db <= threshold_db, 0.0, (detector_db - threshold_db) * comp)
    half = knee_db / 2.0
    xk = detector_db - (threshold_db - half)
    soft = np.where(detector_db <= threshold_db - half, 0.0,
                    np.where(detector_db >= threshold_db + half,
                             (detector_db - threshold_db) * comp,
                             comp * xk * xk / (2.0 * np.maximum(knee_db, 1e-9))))
    return np.where(knee_db <= 0.0, hard, soft)


def compressor_gain(config: comp_ops.CompressorConfig, params: dict, x: np.ndarray) -> tuple:
    """The compressor's per-sample gain reduction in dB over ``x [R, n]`` from
    fresh state, and the plosive ratio; ``params`` are ``[R]`` arrays."""
    k = comp_ops._scan_consts(config)
    band_c, band_1 = util.f32_pair(k["band_c"])
    rms_c, rms_1 = util.f32_pair(k["rms_c"])
    if config.sidechain_highpass_enabled:
        hp = np.unique(params["sidechain_hp_coeff"])
        assert hp.size == 1, "one sidechain high-pass for every row"
        hp = float(hp[0])
        det_in = _linear((hp, -hp, 0.0, -hp, 0.0), x)
        low = x - det_in
        presence = 0.65 * det_in + 0.35 * (det_in - low)
        low_rms, voiced_sq, pres_rms = (np.sqrt(_one_pole(band_c, band_1 * v * v))
                                        for v in (low, det_in, presence))
        voiced_rms = np.maximum(voiced_sq, 1e-8)
        plosive = np.clip(low_rms / voiced_rms, 0.0, 32.0)
        amount = np.clip((plosive - comp_ops.PLOSIVE_RATIO_START)
                         / (comp_ops.PLOSIVE_RATIO_FULL - comp_ops.PLOSIVE_RATIO_START), 0.0, 1.0)
        penalty = 1.0 - amount * (1.0 - comp_ops.PLOSIVE_MIN_DETECTOR_GAIN)
        pres_weight = 1.0 + 0.18 * np.clip(np.clip(pres_rms / voiced_rms, 0.0, 4.0) - 0.75,
                                           0.0, 1.0)
        weight = np.clip(penalty * pres_weight, comp_ops.PLOSIVE_MIN_DETECTOR_GAIN, 1.15)
    else:
        det_in, plosive, weight = x, np.zeros_like(x), np.ones_like(x)
    inst = _db(np.maximum(np.abs(det_in), 1e-10))
    atk, det_rel = params["attack_coeff"], params["detector_release_coeff"]
    peak = np.stack([_peak_envelope(inst[r], float(atk[r]), float(det_rel[r]))
                     for r in range(x.shape[0])])
    rms = _one_pole(rms_c, rms_1 * det_in * det_in)
    blended = (comp_ops.DETECTOR_PEAK_WEIGHT * np.power(10.0, peak / 20.0)
               + comp_ops.DETECTOR_RMS_WEIGHT * np.maximum(np.sqrt(rms), 1e-10))
    detector_db = _db(np.maximum(blended, 1e-10) * np.maximum(weight, 1e-10))
    col = lambda key: np.asarray(params[key], np.float64)[:, None]
    tg = _gain_reduction(detector_db, col("threshold_db"), col("ratio"), col("knee_db"))
    if config.adaptive_release:
        gr = np.stack([_adaptive_release(tg[r], float(atk[r]), k) for r in range(x.shape[0])])
    else:
        gr = np.stack([_fixed_release(tg[r], float(atk[r]), float(params["base_release_ms"][r]),
                                      config.sample_rate, k) for r in range(x.shape[0])])
    return gr, plosive


def compressor(config: comp_ops.CompressorConfig, params: dict, x: np.ndarray, T: int) -> tuple:
    """The compressor over ``x`` (float32 ``[R, nb * T]``) from fresh state:
    ``(y, gain reduction a block [R, nb])``. The makeup gain starts at the
    manual makeup; without auto makeup it stays there, and with it the
    reference's block cadence (``finalize_block``, with its loudness meter)
    moves it a block at a time."""
    R, n = x.shape
    gr, plosive = compressor_gain(config, params, x.astype(np.float64))
    gain = np.power(10.0, -gr / 20.0)
    makeup_db = np.asarray(params["makeup_gain_db"], np.float32)
    if not config.auto_makeup_enabled:
        makeup = np.power(10.0, makeup_db.astype(np.float64) / 20.0)[:, None]
        return (x * gain * makeup).astype(np.float32), gr[:, T - 1::T]
    p = {key: torch.as_tensor(np.asarray(v, np.float32)) for key, v in params.items()}
    state = comp_ops.compressor_init(config, n=R, device="cpu")
    state["smoothed_makeup_gain"] = torch.from_numpy(makeup_db.copy())
    zeros = torch.zeros(R)
    y = np.empty_like(x)
    for b in range(n // T):
        s = slice(b * T, (b + 1) * T)
        xb = torch.from_numpy(x[:, s])
        block_rms_db = util.linear_to_db(
            torch.clamp_min(torch.sqrt(torch.mean(xb * xb, dim=-1)), 1e-10), -200.0)
        activity, reliability = comp_ops._estimate_activity(p, block_rms_db, None)
        makeup = np.power(10.0, state["smoothed_makeup_gain"].numpy().astype(np.float64) / 20.0)
        y[:, s] = (x[:, s] * gain[:, s] * makeup[:, None]).astype(np.float32)
        final = {"current_gr_db": torch.as_tensor(gr[:, s.stop - 1], dtype=torch.float32),
                 "plosive_ratio": torch.as_tensor(plosive[:, s.stop - 1], dtype=torch.float32)}
        state, _ = comp_ops.finalize_block(config, p, state, final, torch.from_numpy(y[:, s]), T,
                                           activity, reliability, zeros)
    return y, gr[:, T - 1::T]


# ---------------------------------------------------------------- limiters
def _max_affine(v: np.ndarray, rho: float) -> np.ndarray:
    """``u_t = max(v_t, rho u_{t-1} + (1 - rho) v_t)`` from 0 over one row."""
    r1 = 1.0 - rho
    out = [0.0] * len(v)
    u = 0.0
    for i, a in enumerate(v.tolist()):
        u = rho * u + r1 * a
        if a > u:
            u = a
        out[i] = u
    return np.array(out)


def _gain_scan(peak, xd, ceiling: float, rc: float, scale: float, T: int) -> tuple:
    """The limiters' gain stage over whole rows (``ops/scan.py``
    ``limiter_gain_scan``) from unity gain: ``(y float32, least gain a block,
    1 a block where a target lay under the gain before it)``."""
    target = np.where(peak > ceiling,
                      np.clip(ceiling * scale / np.maximum(peak, 1e-30), 0.0, 1.0), 1.0)
    gain = 1.0 - _rows(lambda v: _max_affine(v, rc), 1.0 - target)
    y = np.clip(xd * gain, -ceiling, ceiling).astype(np.float32)
    before = np.concatenate([np.ones_like(gain[:, :1]), gain[:, :-1]], axis=1)
    R = gain.shape[0]
    events = (target < before).reshape(R, -1, T).any(-1).astype(np.int32)
    return y, gain.reshape(R, -1, T).min(-1), events


def _gr_db(least_gain: np.ndarray) -> np.ndarray:
    return np.where(least_gain < 1.0, -_db(np.maximum(least_gain, 1e-10)), 0.0)


def _true_peaks(x: np.ndarray) -> np.ndarray:
    """The true peak of every sample of the rows of ``x`` (float32) from an
    empty history: the reference's float32 interpolators, a row at a time."""
    out = np.empty(x.shape, np.float32)
    for r in range(x.shape[0]):
        ext = torch.cat([torch.zeros(1, tp_ops._H), torch.from_numpy(x[r:r + 1])], dim=-1)
        out[r] = tp_ops._interp_peaks(ext, x.shape[1])[0].numpy()
    return out


def _scrub(x: np.ndarray) -> np.ndarray:
    return np.where(np.isfinite(x), x, 0.0).astype(np.float32)


def _tail(config: ChainConfig, y: np.ndarray, T: int, stats: dict) -> np.ndarray:
    """Limiter -> true-peak limiter -> output metering over float32 rows."""
    R, n = y.shape
    block_max = lambda v: v.reshape(R, -1, T).max(-1)
    if config.limiter_enabled:
        lim = config.limiter
        ceiling = util.f32(util.db_to_linear(lim.ceiling_db))
        W = lim.lookahead_samples
        ext = np.concatenate([np.zeros((R, W), np.float32), y], axis=1)
        peak = np.lib.stride_tricks.sliding_window_view(np.abs(ext), W + 1, axis=1).max(-1)
        rc = util.f32(lim_ops.limiter_params(lim)["release_coeff"])
        y, least, _ = _gain_scan(peak.astype(np.float64), ext[:, :n].astype(np.float64),
                                 ceiling, rc, 1.0, T)
        stats["limiter_peak_gain_reduction_db"] = _gr_db(least)
        tp_cfg = tp_ops.TruePeakLimiterConfig(ceiling_db=lim.ceiling_db,
                                              release_ms=config.tp_release_ms,
                                              sample_rate=config.sample_rate)
        y = _scrub(y)
        itp = _true_peaks(y)
        d = tp_ops.LIMITER_LOOKAHEAD_SAMPLES
        delayed = np.concatenate([np.zeros((R, d), np.float32), y], axis=1)[:, :n]
        y, least, events = _gain_scan(itp.astype(np.float64), delayed.astype(np.float64),
                                      ceiling, util.f32(tp_cfg.release_coeff), 0.999, T)
        y = _scrub(y)
        stats["true_peak_limiter_input_peak"] = block_max(itp)
        stats["true_peak_limiter_gain_reduction_db"] = _gr_db(least)
        stats["true_peak_limited_events"] = events
    else:
        for key in ("limiter_peak_gain_reduction_db", "true_peak_limiter_input_peak",
                    "true_peak_limiter_gain_reduction_db"):
            stats[key] = np.zeros((R, n // T))
        stats["true_peak_limited_events"] = np.zeros((R, n // T), np.int32)
    stats["output_sample_peak"] = block_max(np.abs(y))
    stats["output_true_peak"] = block_max(_true_peaks(_scrub(y)))
    return y


# ---------------------------------------------------------------- the take
def eq_coeffs(bands: list, sample_rate: float) -> np.ndarray:
    """The EQ's compacted static cascade ``(S, 5)`` float32 (identity
    sections dropped, the reference's order kept), as the port's
    ``chain_init`` builds it."""
    c_lo, c_hi = eq_ops.compact_cascade(eq_ops.bands_to_sections(bands, sample_rate))
    return np.concatenate([c_lo, c_hi], axis=0).astype(np.float32)


def render(config: ChainConfig, params: dict, bands: list, takes: np.ndarray,
           take_of: np.ndarray, T: int) -> tuple:
    """Row ``r`` is take ``take_of[r]`` of ``takes`` (float32 ``[U, nb * T]``,
    finite) under the compressor parameters ``params[k][r]``, from fresh
    state. Returns ``(y float32 [R, nb, T], {stat: [R, nb]})``."""
    U, n = takes.shape
    pre = {"input_sample_peak": np.abs(takes).reshape(U, -1, T).max(-1),
           "deesser_gain_reduction_db": np.zeros((U, n // T))}
    y = takes

    def run_deesser(v):
        out, total = deesser(config.deesser, v.astype(np.float64))
        pre["deesser_gain_reduction_db"] = total[:, T - 1::T]
        return out.astype(np.float32)

    def run_eq(v):
        c = eq_coeffs(bands, config.sample_rate)
        if c.shape[0] == 0:
            return v
        z = torch.zeros((U, c.shape[0], 2), dtype=torch.float64)
        out, _ = biquad.apply_fixed(torch.from_numpy(c), z, torch.from_numpy(v))
        return out.numpy()

    stages = ((config.eq_enabled, run_eq), (config.deesser_enabled, run_deesser))
    for enabled, run in (stages if config.eq_before_deesser else stages[::-1]):
        if enabled:
            y = run(y)
    take_of = np.asarray(take_of)
    y = y[take_of]
    stats = {k: v[take_of] for k, v in pre.items()}
    if config.compressor_enabled:
        y, stats["compressor_gain_reduction_db"] = compressor(config.compressor, params, y, T)
    else:
        stats["compressor_gain_reduction_db"] = np.zeros((len(take_of), n // T))
    y = _tail(config, y, T, stats)
    stats = {k: stats[k] for k in STAT_KEYS}
    return y.reshape(len(take_of), -1, T), stats
