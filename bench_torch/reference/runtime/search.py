"""A compressor search's render and its diagnostics, as the port's
``api.simulate_auto_eq_chain_batched`` gives them: the flat settings dict
read into the chain's configuration, the candidates' compressor parameters,
the take cut into 20 ms blocks, and a candidate's diagnostics from its
output blocks and stats. A frozen plain copy of that arithmetic, on the
reference's ops and :mod:`.chain`."""

from __future__ import annotations

import numpy as np

from ..ops import compressor as comp_ops
from ..ops import deesser as des_ops
from ..ops import eq as eq_ops
from ..ops import limiter as lim_ops
from . import chain

CAREFUL_OUTPUT_CEILING_DB = -1.5
_BUFFER_CAPACITY = 4096  # the reference's fixed realtime buffer


def _get(settings, key, default):
    return default if settings is None else settings.get(key, default)


def analysis_block(sample_rate: float) -> int:
    return max(1, min(int(round(sample_rate * 0.020)), _BUFFER_CAPACITY))


def chain_config(sample_rate: float, settings: dict) -> tuple:
    """``(ChainConfig, compressor parameters, effective ceiling in dB)`` of a
    flat settings dict."""
    fs = float(sample_rate)
    ceiling = float(_get(settings, "limiter_ceiling_db", -0.5))
    if bool(_get(settings, "limiter_careful_output_enabled", True)):
        ceiling = min(ceiling, CAREFUL_OUTPUT_CEILING_DB)
    ceiling = min(ceiling, 0.0)
    adaptive = bool(_get(settings, "compressor_adaptive_release", False))
    limiter_enabled = bool(_get(settings, "limiter_enabled", True))
    des = des_ops.DeEsserConfig(
        sample_rate=fs, enabled=bool(_get(settings, "deesser_enabled", False)),
        auto_enabled=bool(_get(settings, "deesser_auto_enabled", True)),
        auto_amount=float(_get(settings, "deesser_auto_amount", 0.5)),
        threshold_db=float(_get(settings, "deesser_threshold_db", -28.0)),
        ratio=float(_get(settings, "deesser_ratio", 4.0)),
        max_reduction_db=float(_get(settings, "deesser_max_reduction_db", 6.0)),
        low_cut_hz=float(_get(settings, "deesser_low_cut_hz", 4000.0)),
        high_cut_hz=float(_get(settings, "deesser_high_cut_hz", 11000.0)))
    comp = comp_ops.CompressorConfig(
        sample_rate=fs, enabled=bool(_get(settings, "compressor_enabled", True)),
        adaptive_release=adaptive,
        auto_makeup_enabled=bool(_get(settings, "compressor_auto_makeup_enabled", False)),
        sidechain_highpass_enabled=bool(
            _get(settings, "compressor_sidechain_highpass_enabled", True)),
        block_samples=analysis_block(fs))
    # the offline compressor pins its detector release at 100 ms and its knee
    # at 6 dB
    params = comp_ops.compressor_params(
        comp, threshold_db=float(_get(settings, "compressor_threshold_db", -20.0)),
        ratio=float(_get(settings, "compressor_ratio", 4.0)),
        attack_ms=float(_get(settings, "compressor_attack_ms", 10.0)),
        release_ms=float(_get(settings, "compressor_base_release_ms" if adaptive
                              else "compressor_release_ms", 50.0 if adaptive else 200.0)),
        makeup_gain_db=float(_get(settings, "compressor_makeup_gain_db", 0.0)),
        knee_db=6.0, target_lufs=float(_get(settings, "compressor_target_lufs", -18.0)),
        detector_release_ms=100.0)
    lim = lim_ops.LimiterConfig(
        ceiling_db=ceiling, release_ms=float(_get(settings, "limiter_release_ms", 50.0)),
        lookahead_ms=float(_get(settings, "limiter_lookahead_ms", 2.0)), sample_rate=fs,
        enabled=limiter_enabled)
    cfg = chain.ChainConfig(
        sample_rate=fs, deesser_enabled=des.enabled, eq_enabled=True,
        compressor_enabled=comp.enabled, limiter_enabled=limiter_enabled,
        eq_before_deesser=bool(_get(settings, "eq_before_deesser", False)),
        deesser=des, compressor=comp, limiter=lim,
        tp_release_ms=(float(_get(settings, "limiter_release_ms", 50.0))
                       if limiter_enabled else 80.0))
    return cfg, params, ceiling


def legacy_bands(bands: list) -> list:
    """``(frequency, gain_db, q)`` triples on the default band types."""
    return [eq_ops.EqBandConfig(d.filter_type, float(f), float(g), float(q),
                                d.slope_db_per_octave, True)
            for d, (f, g, q) in zip(eq_ops.default_bands(), bands)]


def candidate_params(base: dict, param_sets: list, sample_rate: float) -> dict:
    """Every key of the compressor parameters as float32 ``[R]``: the
    candidates' threshold, ratio, attack and release over the shared
    ``base``."""
    R = len(param_sets)
    f32 = lambda v: np.asarray(v, np.float32)
    out = {k: np.full(R, np.float32(v)) for k, v in base.items()}
    out["threshold_db"] = f32([float(p["threshold_db"]) for p in param_sets])
    out["ratio"] = f32([max(float(p["ratio"]), 1.0) for p in param_sets])
    out["attack_coeff"] = f32([np.exp(-1000.0 / (max(float(p["attack_ms"]), 1e-6)
                                                 * sample_rate)) for p in param_sets])
    out["base_release_ms"] = f32([float(p["release_ms"]) for p in param_sets])
    return {k: v.astype(np.float64) for k, v in out.items()}


def take_blocks(audio: np.ndarray, block: int) -> tuple:
    """The finite-scrubbed take zero-padded to whole blocks:
    ``(blocks [nb, block], valid samples a block [nb], n)``."""
    x = np.asarray(audio, np.float32)
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    n = len(x)
    nb = max(1, -(-n // block))
    blocks = np.zeros(nb * block, np.float32)
    blocks[:n] = x
    valid = np.full(nb, block, np.int64)
    if n % block and n > 0:
        valid[-1] = n % block
    return blocks.reshape(nb, block), valid, n


# ---------------------------------------------------------------- diagnostics
def percentile(values, p: float) -> float:
    """Sorted linear-interpolated percentile."""
    v = np.sort(np.asarray(values, np.float32))
    if v.size == 0:
        return 0.0
    pos = (v.size - 1) * float(np.clip(p, 0.0, 1.0))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if lo == hi:
        return float(v[lo])
    return float(v[lo] + (pos - lo) * (v[hi] - v[lo]))


def _to_db(x) -> float:
    return float(20.0 * np.log10(max(abs(float(x)), 1e-10)))


def _rows_db(sq, valid):
    return 20.0 * np.log10(np.maximum(np.sqrt(sq / np.maximum(valid, 1)), 1e-10))


def pumping_score(gr_db, cadence_hz: float) -> float:
    """Band-passed (2-8 Hz) gain-reduction modulation score."""
    gr = np.asarray(gr_db, np.float32)
    if gr.size < 3 or not np.isfinite(cadence_hz) or cadence_hz <= 0:
        return 0.0
    if not np.all(np.isfinite(gr)):
        return float("inf")
    dt = 1.0 / float(cadence_hz)
    hp_rc, lp_rc = 1.0 / (2.0 * np.pi * 2.0), 1.0 / (2.0 * np.pi * 8.0)
    hp_a, lp_a = hp_rc / (hp_rc + dt), dt / (lp_rc + dt)
    prev, hp, bp, bp_abs, deltas = gr[0], 0.0, 0.0, [], []
    for v in gr[1:]:
        hp = hp_a * (hp + v - prev)
        bp += lp_a * (hp - bp)
        bp_abs.append(abs(bp))
        deltas.append(abs(v - prev))
        prev = v
    bp_abs = np.asarray(bp_abs, np.float32)
    limit = percentile(bp_abs, 0.95)
    return (float(np.sqrt(np.mean(np.minimum(bp_abs, limit) ** 2)))
            + percentile(np.asarray(deltas, np.float32), 0.95))


class Take:
    """The input side of a take's diagnostics: its blocks' energy and the
    active/silence split."""

    def __init__(self, blocks: np.ndarray, valid: np.ndarray, n: int):
        self.valid, self.n = valid, n
        self.in_sq = (blocks.astype(np.float64) ** 2).sum(axis=1)
        self.in_rows_db = _rows_db(self.in_sq, valid)
        floor_db = percentile(self.in_rows_db, 0.20)
        p90_db = percentile(self.in_rows_db, 0.90)
        self.active_threshold_db = max(floor_db + 6.0, p90_db - 24.0, -60.0)
        self.active = self.in_rows_db >= self.active_threshold_db


def diagnostics(stats: dict, out_blocks: np.ndarray, take: Take, ceiling_db: float) -> dict:
    """One candidate's diagnostics from its stats rows ``[nb]`` and output
    blocks ``[nb, block]`` (the runtime entry left out)."""
    out_sq = (out_blocks.astype(np.float64) ** 2).sum(axis=1)
    out_rows_db = _rows_db(out_sq, take.valid)
    comp_rows = stats["compressor_gain_reduction_db"]
    des_rows = stats["deesser_gain_reduction_db"]
    output = out_blocks.reshape(-1)[:take.n]
    active, n = take.active, take.n
    active_comp = np.maximum(comp_rows[active], 0.0)
    active_des = np.maximum(des_rows[active], 0.0)
    if active_comp.size < 3:
        active_comp = np.maximum(comp_rows, 0.0)
        active_des = np.maximum(des_rows, 0.0)
    valid_rows = take.in_rows_db > -100.0
    osp_db = _to_db(stats["output_sample_peak"].max(initial=0.0))
    pre_db = _to_db(stats["true_peak_limiter_input_peak"].max(initial=0.0))
    otp_db = _to_db(stats["output_true_peak"].max(initial=0.0))
    gain_db = out_rows_db - take.in_rows_db
    return {
        "input_sample_peak_db": _to_db(stats["input_sample_peak"].max(initial=0.0)),
        "input_rms_db": _to_db(float(np.sqrt(take.in_sq.sum() / max(n, 1)))),
        "output_sample_peak_db": osp_db,
        "pre_limiter_true_peak_db": pre_db,
        "output_true_peak_db": otp_db,
        "output_rms_db": _to_db(float(np.sqrt(out_sq.sum() / max(n, 1)))),
        "limiter_effective_ceiling_db": float(ceiling_db),
        "sample_headroom_db": float(ceiling_db - osp_db),
        "pre_limiter_true_peak_headroom_db": float(ceiling_db - pre_db),
        "true_peak_headroom_db": float(ceiling_db - otp_db),
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
        "active_output_gain_db": percentile(gain_db[active & valid_rows], 0.50),
        "silence_output_gain_db": percentile(-np.maximum(comp_rows[~active], 0.0), 0.50),
        "silence_level_delta_db": percentile(gain_db[(~active) & valid_rows], 0.50),
        "compressor_pumping_score_db": float(pumping_score(np.maximum(comp_rows, 0.0), 50.0)),
        "non_finite_output": bool(np.any(~np.isfinite(output))),
        "deesser_gain_reduction_median_db": percentile(active_des, 0.50),
        "deesser_gain_reduction_p95_db": percentile(active_des, 0.95),
        "analysis_block_ms": 20.0,
        "active_analysis_threshold_db": float(take.active_threshold_db),
        "active_analysis_block_count": int(active_comp.size),
        "processed_samples": int(n),
    }
