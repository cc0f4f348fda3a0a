"""Input conditioning: sanitize/clamp, block meters, DC blocker, high-pass
and gentle/strong hum and rumble cleanup.

Counterpart of ``audioforge_tpu/ops/routing.py``.

- Cleanup off (``:530-559``): the DC blocker ``y = x - x1 + 0.995 y1`` and
  the fixed 80 Hz high-pass (Q 0.707) run as one two-section
  ``biquad_cascade`` launch with f64 state, where the JAX package used
  host-built matmul operators.
- Gentle/strong cleanup (``:296-645``): the hum analysis is block-level
  tensor math (the 26-bin oscillator bank as masked ``cos``/``sin``
  products, the 250 ms window finish: candidate gating, parabolic
  interpolation, phase continuity with the +-32 alias search, hum hold).
  The per-sample part, the rumble envelopes on the raw block and the DC
  blocker -> hum notch -> mix -> harmonic notch -> mix chain, is the
  hand-written ``cleanup_scan`` kernel (``csrc/cleanup_scan.cu``) on the
  card and :func:`cleanup_scan_plain` on the CPU, with the notches' state in
  f64 where the TPU needed compensated f32 scans. The owned adaptive
  high-pass follows as a one-section crossfaded biquad unit, since it
  depends on the rumble hold at the end of the block.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cache, lru_cache

import numpy as np
import torch

from . import biquad


CLEANUP_OFF = 0
CLEANUP_GENTLE = 1
CLEANUP_STRONG = 2
CLEANUP_MODE_IDS = {CLEANUP_OFF: "off", CLEANUP_GENTLE: "gentle", CLEANUP_STRONG: "strong"}
CLEANUP_MODES = {"off": CLEANUP_OFF, "gentle": CLEANUP_GENTLE,
                 "strong": CLEANUP_STRONG}

DC_BLOCK_COEFF = 0.995
PREFILTER_HZ = 80.0
PREFILTER_Q = 0.707

HUM_MIN_HZ = 49.0
HUM_MAX_HZ = 61.0
HUM_TRACK_STEP_HZ = 1.0
HUM_TRACK_BINS = 13
NOTCH_Q = 36.0
HUM_WINDOW_S = 0.25
NOTCH_FADE_S = 0.020

# the kernel's rows (csrc/cleanup_scan.cu CF_*, CI_*)
_SCAN_FLOAT_KEYS = ("lowpass_state", "low_env", "slow_low_env", "broadband_env",
                    "dc_x1", "dc_y1", "hum_strength", "harmonic_strength")
_SCAN_INT_KEYS = ("rumble_hold", "boundary", "hold0", "hold_after", "cand0",
                  "cand_new", "wobs0", "wobs_new", "hum_fade", "harmonic_fade")
_NOTCHES = ("hum_notch", "harmonic_notch")


@dataclass(frozen=True)
class RoutingConfig:
    sample_rate: float = 48000.0
    cleanup_mode: int = CLEANUP_OFF

    def __post_init__(self):
        if self.cleanup_mode not in CLEANUP_MODES.values():
            raise ValueError(f"unknown cleanup mode {self.cleanup_mode!r}")

    @property
    def window_samples(self) -> int:
        return max(1, int(round(self.sample_rate * HUM_WINDOW_S)))

    @property
    def notch_fade_samples(self) -> int:
        return max(1, int(round(self.sample_rate * NOTCH_FADE_S)))


@lru_cache(maxsize=4)
def _off_path_sections(sample_rate: float) -> np.ndarray:
    """DC blocker (b = [1, -1, 0], a = [1, -0.995, 0]) then the 80 Hz HP."""
    dc = np.array([1.0, -1.0, 0.0, -DC_BLOCK_COEFF, 0.0])
    hp = biquad.design(biquad.HIGH_PASS, PREFILTER_HZ, 0.0, PREFILTER_Q,
                       sample_rate)
    return np.stack([dc, hp]).astype(np.float32)


@lru_cache(maxsize=8)
def _hp_coeffs(hz: float, sample_rate: float) -> tuple:
    """The owned high-pass at ``hz`` (Q 0.707), f32 values."""
    c = biquad.design(biquad.HIGH_PASS, hz, 0.0, PREFILTER_Q, sample_rate)
    return tuple(float(v) for v in np.asarray(c, np.float32))


# cached without bound, as _bank_omegas is
@cache
def _hp_rows(sample_rate: float, raised_hz: float, device: torch.device) -> tuple:
    """The owned high-pass at rest (80 Hz) and raised to ``raised_hz``, f32
    ``[5]`` rows on ``device``."""
    return tuple(torch.tensor(_hp_coeffs(hz, sample_rate), device=device)
                 for hz in (PREFILTER_HZ, raised_hz))


def _notch_coeffs(freq_hz, sample_rate: float):
    """f32 notch design for ``freq_hz: f32 [...]`` (Q 36), ``[..., 5]``."""
    omega = 2.0 * np.pi * freq_hz / max(sample_rate, 1.0)
    sin_w, cos_w = torch.sin(omega), torch.cos(omega)
    alpha = sin_w / (2.0 * max(NOTCH_Q, 1.0))
    a0 = 1.0 + alpha
    return torch.stack([1.0 / a0, -2.0 * cos_w / a0, 1.0 / a0,
                        -2.0 * cos_w / a0, (1.0 - alpha) / a0], dim=-1)


def _smooth_notch_init(freq_hz: float, sample_rate: float, n: int, device) -> dict:
    """SmoothNotch state: dual lanes (active, pending) with f64 state."""
    freq = torch.full((n,), freq_hz, dtype=torch.float32, device=device)
    c = _notch_coeffs(freq, sample_rate)
    return {
        "coeffs": torch.stack([c, c], dim=1),  # [N, 2, 5]
        "z": torch.zeros((n, 2, 2), dtype=torch.float64, device=device),
        "freq": freq,
        "pending_freq": freq.clone(),
        "fade_remaining": torch.zeros(n, dtype=torch.int32, device=device),
    }


def _smooth_notch_retune(state, freq_hz, sample_rate: float, fade_total: int) -> dict:
    """Retune when the target moved >= 0.15 Hz: the pending lane takes the
    new coefficients and starts from zero state."""
    freq = torch.clamp(freq_hz, 20.0, sample_rate * 0.45)
    need = (freq - state["pending_freq"]).abs() >= 0.15
    coeffs = state["coeffs"].clone()
    coeffs[:, 1] = torch.where(need[:, None], _notch_coeffs(freq, sample_rate),
                               coeffs[:, 1])
    z = state["z"].clone()
    z[:, 1] = torch.where(need[:, None], 0.0, z[:, 1])
    return {
        "coeffs": coeffs,
        "z": z,
        "freq": state["freq"],
        "pending_freq": torch.where(need, freq, state["pending_freq"]),
        "fade_remaining": torch.where(need, fade_total,
                                      state["fade_remaining"]).to(torch.int32),
    }


def _smooth_notch_promote(state, z_out, T: int) -> dict:
    """After a block: promote the pending lane where its fade ended."""
    remaining = state["fade_remaining"]
    new_remaining = torch.clamp_min(remaining - T, 0)
    promoted = (remaining > 0) & (new_remaining == 0)
    pm = promoted[:, None]
    coeffs = state["coeffs"]
    return {
        "coeffs": torch.stack([torch.where(pm, coeffs[:, 1], coeffs[:, 0]),
                               coeffs[:, 1]], dim=1),
        "z": torch.stack([torch.where(pm, z_out[:, 1], z_out[:, 0]),
                          z_out[:, 1]], dim=1),
        "freq": torch.where(promoted, state["pending_freq"], state["freq"]),
        "pending_freq": state["pending_freq"],
        "fade_remaining": new_remaining.to(torch.int32),
    }


def routing_init(config: RoutingConfig, *, n: int, device) -> dict:
    """The full routing state of ``n`` streams (every cleanup mode's)."""
    fs = config.sample_rate
    f = lambda v, *shape: torch.full((n, *shape), v, dtype=torch.float32,
                                     device=device)
    i = lambda v: torch.full((n,), v, dtype=torch.int32, device=device)
    b = lambda: torch.zeros(n, dtype=torch.bool, device=device)
    return {
        "dc_x1": f(0.0),
        "dc_y1": f(0.0),
        "prefilter_z": torch.zeros((n, 2), dtype=torch.float64, device=device),
        "lowpass_state": f(0.0),
        "low_env": f(0.0),
        "slow_low_env": f(0.0),
        "broadband_env": f(0.0),
        "rumble_hold": i(0),
        "iq": f(0.0, 2, HUM_TRACK_BINS, 2),
        "bin_phase": f(0.0, 2, HUM_TRACK_BINS),
        "window_pos": i(0),
        "windows_observed": i(0),
        "candidate_windows": i(0),
        "total_energy": f(0.0),
        "hum_hold": i(0),
        "hum_line_hz": f(0.0),
        "prev_abs_phase": f(0.0),
        "phase_valid": b(),
        "hum_strength": f(0.0),
        "harmonic_strength": f(0.0),
        "adaptive_hp": biquad.unit_init([_hp_coeffs(PREFILTER_HZ, fs)], n, device),
        "adaptive_hp_hz": f(PREFILTER_HZ),
        "hum_notch": _smooth_notch_init(55.0, fs, n, device),
        "harmonic_notch": _smooth_notch_init(110.0, fs, n, device),
        "hum_detected": b(),
        "rumble_detected": b(),
        "selected_hp_hz": f(PREFILTER_HZ),
        "meter_rms_acc": f(0.0),
    }


def routing_reset(config: RoutingConfig, state) -> dict:
    """A fresh routing state of the same streams on the same device."""
    d = state["dc_x1"]
    return routing_init(config, n=d.shape[0], device=d.device)


def _peak_db(peak):
    return torch.where(peak > 0,
                       20.0 * torch.log10(torch.clamp_min(peak, 1e-30)),
                       -torch.inf)


def sanitize_and_clamp_input(x):
    """Returns (y, clip_count, clip_peak_db)."""
    x = torch.where(torch.isfinite(x), x, 0.0)
    amp = x.abs()
    clipped = amp > 1.0
    count = clipped.sum(dim=-1).to(torch.int32)
    peak = torch.where(clipped, amp, 0.0).amax(dim=-1)
    return torch.clamp(x, -1.0, 1.0), count, _peak_db(peak)


def sanitize_and_clamp_output(x, ceiling_linear):
    """``ceiling_linear``: per-stream ``[N]``. Returns (y, count, peak_db)."""
    ceiling = torch.clamp(ceiling_linear.to(torch.float32), 0.0, 1.0)[:, None]
    finite = torch.isfinite(x)
    x = torch.where(finite, x, 0.0)
    amp = x.abs()
    clipped = finite & (amp > ceiling)
    count = clipped.sum(dim=-1).to(torch.int32)
    peak = torch.where(clipped, amp, 0.0).amax(dim=-1)
    return torch.clamp(x, -ceiling, ceiling), count, _peak_db(peak)


def meter_block_stats(x, rms_acc, meter_coeff):
    """Per-block peak/rms/crest with the carried one-pole mean-square
    accumulator ``acc' = c^T acc + sum_k (1-c) c^(T-1-k) x_k^2``.
    Returns (stats, new_rms_acc)."""
    peak = x.abs().amax(dim=-1)
    c = meter_coeff.to(torch.float32)
    T = x.shape[-1]
    powers = x * x
    k = torch.arange(T, dtype=torch.float32, device=x.device)
    wts = torch.pow(c, T - 1.0 - k) * (1.0 - c)
    acc = torch.pow(c, float(T)) * rms_acc + (powers * wts).sum(dim=-1)
    peak_db = torch.where(peak > 0,
                          20.0 * torch.log10(torch.clamp_min(peak, 1e-30)), -120.0)
    rms_db = torch.where(acc > 0,
                         10.0 * torch.log10(torch.clamp_min(acc, 1e-30)), -120.0)
    stats = {
        "peak_db": peak_db,
        "rms_db": rms_db,
        "crest_factor_db": torch.clamp(peak_db - rms_db, 0.0, 80.0),
        "mean_power": powers.mean(dim=-1),
    }
    return stats, acc


def _wrap_phase(p):
    """``mod(p + pi, 2 pi) - pi`` with the floored modulo taken as the
    reference takes it: an exact ``fmod``, then the divisor added to a
    negative remainder."""
    r = torch.fmod(p + np.pi, 2.0 * np.pi)
    return torch.where(r < 0, r + 2.0 * np.pi, r) - np.pi


# device constants are cached without bound: the serving engine's captured
# CUDA graph reads them by address, so an entry dropped from the cache would be
# freed under it
@cache
def _bank_omegas(sample_rate: float, device: torch.device) -> torch.Tensor:
    """Radians per sample of the 13 primary and 13 harmonic bins, f32."""
    freqs = HUM_MIN_HZ + HUM_TRACK_STEP_HZ * np.arange(HUM_TRACK_BINS)
    omegas = np.concatenate([freqs, 2.0 * freqs]) * (2.0 * np.pi / sample_rate)
    return torch.tensor(omegas, dtype=torch.float32, device=device)


def _take(a, idx):
    return torch.gather(a, -1, idx[:, None])[:, 0]


def _hum_bank(bin_phase, omegas, boundary, x):
    """The oscillator bank over one block ``x [N, T]``: the I and Q sums of
    the 26 bins ``[N, 2, 26]`` and the energy ``[N, 2]``, each over the
    samples before (index 0) and from (index 1) ``boundary [N]``, where the
    analysis window completes."""
    n, T = x.shape
    t_idx = torch.arange(T, dtype=torch.float32, device=x.device)
    angles = bin_phase.reshape(n, -1)[:, :, None] + omegas[:, None] * t_idx
    pre_mask = (t_idx < boundary[:, None]).to(torch.float32)
    masked = torch.stack([x * pre_mask, x * (1.0 - pre_mask)], dim=1)  # [N, 2, T]
    i_sums = torch.einsum("nmt,nbt->nmb", masked, torch.cos(angles))
    q_sums = torch.einsum("nmt,nbt->nmb", masked, torch.sin(angles))
    energy = (masked * x[:, None]).sum(dim=-1)
    return i_sums, q_sums, energy


def _hum_analysis(config: RoutingConfig, state, x):
    """The oscillator bank's I/Q sums over the block and, where the 250 ms
    window completes inside it, the window finish: candidate gating,
    log-power parabolic interpolation, phase continuity with the +-32 alias
    search and the hum hold. Returns ``(updates, ctx)``: the analysis state
    after the block, and the boundary values from which the rumble scan
    derives its per-sample context."""
    fs = config.sample_rate
    n, T = x.shape
    W = config.window_samples
    if T > W:
        raise ValueError("block longer than the hum analysis window")
    gentle = config.cleanup_mode == CLEANUP_GENTLE
    B = HUM_TRACK_BINS
    omegas = _bank_omegas(fs, x.device)
    pos0 = state["window_pos"]
    boundary = W - pos0  # samples until the window completes (> 0)
    i_sums, q_sums, energy = _hum_bank(state["bin_phase"], omegas, boundary, x)
    iq0 = state["iq"].reshape(n, 2 * B, 2)
    i_win = iq0[..., 0] + i_sums[:, 0]
    q_win = iq0[..., 1] + q_sums[:, 0]
    crosses = (pos0 + T) >= W

    nw = float(W)
    power = (i_win ** 2 + q_win ** 2) * (2.0 / (nw * nw))
    p_primary, p_harm = power[:, :B], power[:, B:]
    meas_phase = torch.atan2(q_win, i_win)
    total_power = (state["total_energy"] + energy[:, 0]) / nw + 1e-9
    best_idx = torch.argmax(p_primary + 0.65 * p_harm, dim=-1)
    best_pp, best_hp = _take(p_primary, best_idx), _take(p_harm, best_idx)
    best_phase = _take(meas_phase[:, :B], best_idx)
    best_freq = HUM_MIN_HZ + best_idx.to(torch.float32) * HUM_TRACK_STEP_HZ
    ratio_thr, power_thr = (0.075, 1.8e-5) if gentle else (0.040, 8.0e-6)
    candidate = (((best_pp > power_thr) | (best_hp > power_thr * 0.70))
                 & ((best_pp / total_power > ratio_thr)
                    | (best_hp / total_power > ratio_thr * 0.85))
                 & (best_freq > 0.0))
    cand0 = state["candidate_windows"]
    cand_windows = torch.where(
        crosses, torch.where(candidate, torch.clamp_max(cand0 + 1, 3), 0),
        cand0).to(torch.int32)
    phase_valid0 = torch.where(crosses & ~candidate, False, state["phase_valid"])
    confirmed = crosses & (cand_windows >= 2)

    logp = torch.log(torch.clamp_min(p_primary, 1e-12))
    idx_ok = (best_idx > 0) & (best_idx < B - 1)
    idx_c = torch.clamp(best_idx, 1, B - 2)
    left, center, right = (_take(logp, idx_c + off) for off in (-1, 0, 1))
    denom = left - 2.0 * center + right
    sharp = denom.abs() > 1e-6
    offset = torch.where(
        idx_ok & sharp,
        torch.clamp(0.5 * (left - right) / torch.where(sharp, denom, 1.0), -0.5, 0.5),
        0.0)
    spectral_freq = torch.clamp(best_freq + offset * HUM_TRACK_STEP_HZ,
                                HUM_MIN_HZ, HUM_MAX_HZ)

    win_s = W / fs
    bin_phase = state["bin_phase"]
    centre_phase = _wrap_phase(
        _take(bin_phase[:, 0], best_idx)
        + _take(omegas[:B].expand(n, B), best_idx) * (W / 2.0 - pos0.to(torch.float32)))
    abs_phase = _wrap_phase(-best_phase + centre_phase)
    phase_delta = _wrap_phase(abs_phase - state["prev_abs_phase"])
    base_freq = phase_delta / (2.0 * np.pi * win_s)
    alias = torch.arange(-32, 33, dtype=torch.float32, device=x.device) / win_s
    cands = base_freq[:, None] + alias
    best_alias = _take(cands, torch.argmin((cands - spectral_freq[:, None]).abs(), dim=-1))
    phase_freq = torch.clamp(best_alias, HUM_MIN_HZ, HUM_MAX_HZ)
    measured = torch.where(phase_valid0, 0.75 * spectral_freq + 0.25 * phase_freq,
                           spectral_freq)
    line0 = state["hum_line_hz"]
    new_line = torch.clamp(torch.where(line0 <= 0.0, measured,
                                       line0 + 0.35 * (measured - line0)),
                           HUM_MIN_HZ, HUM_MAX_HZ)

    hold0 = state["hum_hold"]
    boundary_i = torch.clamp_max(boundary, T)
    hold_after = torch.where(confirmed, int(round(fs * 0.75)),
                             torch.clamp_min(hold0 - boundary_i, 0))
    hum_hold = torch.where(crosses, torch.clamp_min(hold_after - (T - boundary_i), 0),
                           torch.clamp_min(hold0 - T, 0))
    wobs0 = state["windows_observed"]
    windows_observed = wobs0 + crosses.to(torch.int32)
    iq_new = torch.where(crosses[:, None, None],
                         torch.stack([i_sums[:, 1], q_sums[:, 1]], dim=-1),
                         torch.stack([i_win, q_win], dim=-1))
    updates = {
        "iq": iq_new.reshape(n, 2, B, 2),
        "bin_phase": _wrap_phase(bin_phase + omegas.reshape(2, B) * float(T)),
        "window_pos": torch.where(crosses, pos0 + T - W, pos0 + T).to(torch.int32),
        "windows_observed": windows_observed.to(torch.int32),
        "candidate_windows": cand_windows,
        "total_energy": torch.where(crosses, energy[:, 1],
                                    state["total_energy"] + energy[:, 0]),
        "hum_hold": hum_hold.to(torch.int32),
        "hum_line_hz": torch.where(confirmed, new_line, line0),
        "prev_abs_phase": torch.where(confirmed, abs_phase, state["prev_abs_phase"]),
        "phase_valid": confirmed | phase_valid0,
    }
    ctx = {"boundary": boundary, "hold0": hold0, "hold_after": hold_after,
           "cand0": cand0, "cand_new": cand_windows, "wobs0": wobs0,
           "wobs_new": windows_observed}
    return updates, ctx


def _scan_consts(config: RoutingConfig) -> tuple:
    """``(lp_c, env_thr, burst_thr, rumble_hold_set, fade_total, dc_coeff)``
    in the order of the ``cleanup_scan`` launcher's arguments."""
    fs = config.sample_rate
    lp_c = float(np.float32(np.clip(2.0 * np.pi * 150.0 / fs, 0.0, 1.0)))
    if config.cleanup_mode == CLEANUP_GENTLE:
        env_thr, burst_thr, hold_set = 0.055, 2.8, int(round(fs * 0.18))
    else:
        env_thr, burst_thr, hold_set = 0.035, 2.1, int(round(fs * 0.30))
    return (lp_c, float(np.float32(env_thr)), float(np.float32(burst_thr)),
            hold_set, config.notch_fade_samples, DC_BLOCK_COEFF)


def cleanup_scan_plain(config: RoutingConfig, state, ctx, x):
    """Plain PyTorch twin of the ``cleanup_scan`` kernel over ``x: f32
    [N, T]``: the rumble envelopes on the raw block (their hold / candidate /
    window-count context at sample t derived from ``ctx``), then DC blocker
    -> hum notch -> mix -> harmonic notch -> mix with f64 notch state.
    ``state`` holds the rumble and DC leaves, both retuned notches and the
    new strengths. Returns ``(out, y)``: the rumble and DC leaves after the
    block and each notch's lanes' state ``z [N, 2, 2]`` (the pending lane
    held where no fade is in flight)."""
    lp_c, env_thr, burst_thr, hold_set, fade_total, dc_coeff = _scan_consts(config)
    f64 = torch.float64
    lps, low, slow, broad = (state[k] for k in _SCAN_FLOAT_KEYS[:4])
    rh = state["rumble_hold"]
    x1 = state["dc_x1"].to(f64)
    y1 = state["dc_y1"].to(f64)
    coeffs = [state[k]["coeffs"].to(f64) for k in _NOTCHES]
    zs = [state[k]["z"].clone() for k in _NOTCHES]
    fading = [state[k]["fade_remaining"] > 0 for k in _NOTCHES]
    done = [(fade_total - state[k]["fade_remaining"]).to(f64) + 1.0 for k in _NOTCHES]
    strength = [torch.clamp(state[k], 0.0, 1.0).to(f64)
                for k in ("hum_strength", "harmonic_strength")]
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        x_t = x[:, t]
        pre = t < ctx["boundary"]
        hh = torch.where(pre, torch.clamp_min(ctx["hold0"] - t, 0),
                         torch.clamp_min(ctx["hold_after"] - (t - ctx["boundary"]), 0))
        cw = torch.where(pre, ctx["cand0"], ctx["cand_new"])
        wo = torch.where(pre, ctx["wobs0"], ctx["wobs_new"])
        lps = lps + lp_c * (x_t - lps)
        la = lps.abs()
        low = low + torch.where(la > low, 0.08, 0.006) * (la - low)
        slow = slow + 0.0012 * (la - slow)
        broad = broad + 0.02 * (x_t.abs() - broad)
        burst = low / torch.clamp_min(slow, 0.006)
        dom = low / torch.clamp_min(broad, 0.01)
        startup = (wo == 0) & (low > 0.45)
        established = (wo > 0) & (slow > 0.012)
        trigger = ((startup | established) & (hh == 0) & (cw == 0)
                   & (low > env_thr) & (burst > burst_thr) & (dom > 0.62))
        rh = torch.where(trigger, hold_set, torch.clamp_min(rh - 1, 0))

        xd = x_t.to(f64)
        v = xd - x1 + dc_coeff * y1
        x1, y1 = xd, v
        for j in range(2):
            lanes, z1, z2 = biquad.df2t_step(coeffs[j], zs[j][..., 0], zs[j][..., 1],
                                             v[:, None])
            w = torch.clamp((done[j] + t) / fade_total, 0.0, 1.0)
            out = torch.where(fading[j], lanes[:, 0] + (lanes[:, 1] - lanes[:, 0]) * w,
                              lanes[:, 0])
            z_new = torch.stack([z1, z2], dim=-1)
            zs[j] = torch.where(fading[j][:, None, None], z_new,
                                torch.stack([z_new[:, 0], zs[j][:, 1]], dim=1))
            v = v + (out - v) * strength[j]
        y[:, t] = v.to(torch.float32)
    out = {"lowpass_state": lps, "low_env": low, "slow_low_env": slow,
           "broadband_env": broad, "rumble_hold": rh.to(torch.int32),
           "dc_x1": x1.to(torch.float32), "dc_y1": y1.to(torch.float32),
           "hum_notch": zs[0], "harmonic_notch": zs[1]}
    return out, y


def cleanup_scan(config: RoutingConfig, state, ctx, x):
    """:func:`cleanup_scan_plain` for a CPU tensor; the ``cleanup_scan``
    CUDA kernel for a CUDA tensor."""
    return cleanup_scan_plain(config, state, ctx, x)


def _off_path(config: RoutingConfig, state, x):
    """DC block + fixed 80 Hz high-pass, one two-section cascade launch."""
    n = x.shape[0]
    sections = _off_path_sections(config.sample_rate)
    a1_dc = float(sections[0, 3])  # -0.995 as stored (f32)
    # DC blocker in DF2T form: z1 = -a1 * y1 - x1, z2 = 0
    dc_z = torch.stack([
        -a1_dc * state["dc_y1"].to(torch.float64) - state["dc_x1"].to(torch.float64),
        torch.zeros(n, dtype=torch.float64, device=x.device)], dim=-1)
    z = torch.stack([dc_z, state["prefilter_z"]], dim=1)
    y, z_out = biquad.apply_fixed(sections, z, x)
    x_last = x[:, -1]
    # the DC section's last output, recovered from its final state
    # z1 = -x_last - a1 * y_last
    dc_y_last = (z_out[:, 0, 0] + x_last.to(torch.float64)) / -a1_dc
    new_state = dict(state, dc_x1=x_last.contiguous(),
                     dc_y1=dc_y_last.to(torch.float32),
                     prefilter_z=z_out[:, 1].contiguous())
    zeros = torch.zeros(n, dtype=torch.float32, device=x.device)
    metrics = {
        "hum_detected": torch.zeros(n, dtype=torch.bool, device=x.device),
        "rumble_detected": torch.zeros(n, dtype=torch.bool, device=x.device),
        "hum_line_hz": state["hum_line_hz"],
        "hum_strength": zeros,
        "selected_hp_hz": torch.full_like(zeros, PREFILTER_HZ),
    }
    return new_state, y, metrics


def routing_process(config: RoutingConfig, state, x):
    """DC block and input cleanup of ``x: f32 [N, T]`` (sanitised). The hum
    and rumble analysis reads the raw block, as the reference orders it.
    Returns ``(new_state, y, metrics)``."""
    if config.cleanup_mode == CLEANUP_OFF:
        return _off_path(config, state, x)
    fs = config.sample_rate
    gentle = config.cleanup_mode == CLEANUP_GENTLE
    new_state = dict(state)
    updates, ctx = _hum_analysis(config, state, x)
    new_state.update(updates)

    hum_detected = updates["hum_hold"] > 0
    attack = 0.22 if gentle else 0.34

    def smooth_toward(cur, target):
        return cur + torch.where(target > cur, attack, 0.035) * (target - cur)

    zeros = torch.zeros_like(state["hum_strength"])
    hum_strength = smooth_toward(
        state["hum_strength"], torch.where(hum_detected, 0.55 if gentle else 0.85, zeros))
    harm_strength = smooth_toward(
        state["harmonic_strength"],
        torch.where(hum_detected, 0.0 if gentle else 0.60, zeros))
    fade_n = config.notch_fade_samples
    line = updates["hum_line_hz"]
    line_ok = line > 0.0
    notches = {}
    for key, mult in zip(_NOTCHES, (1.0, 2.0)):
        notches[key] = _smooth_notch_retune(
            state[key], torch.where(line_ok, line * mult, state[key]["pending_freq"]),
            fs, fade_n)

    scan_in = {k: state[k] for k in _SCAN_FLOAT_KEYS[:6] + ("rumble_hold",)}
    scan_in.update(notches, hum_strength=hum_strength,
                   harmonic_strength=harm_strength)
    out, y = cleanup_scan(config, scan_in, ctx, x)
    for key in _NOTCHES:
        new_state[key] = _smooth_notch_promote(notches[key], out.pop(key), x.shape[-1])
    new_state.update(out)

    rumble_detected = out["rumble_hold"] > 0
    raised_hz = 100.0 if gentle else 120.0
    selected_hp = torch.where(rumble_detected, raised_hz, PREFILTER_HZ).to(torch.float32)
    retune_hp = (selected_hp - state["adaptive_hp_hz"]).abs() > 0.5
    lo, hi = _hp_rows(fs, raised_hz, x.device)
    target_c = torch.where((selected_hp > PREFILTER_HZ)[:, None], hi, lo)
    hp = state["adaptive_hp"]
    scheduled = biquad.unit_schedule(hp, target_c[:, None],
                                     biquad.crossfade_samples(fs))
    hp = {k: torch.where(retune_hp.reshape((-1,) + (1,) * (v.ndim - 1)),
                         scheduled[k], v) for k, v in hp.items()}
    new_state["adaptive_hp"], y = biquad.unit_process(hp, y)

    new_state.update(adaptive_hp_hz=selected_hp, hum_strength=hum_strength,
                     harmonic_strength=harm_strength, hum_detected=hum_detected,
                     rumble_detected=rumble_detected, selected_hp_hz=selected_hp)
    metrics = {
        "hum_detected": hum_detected,
        "rumble_detected": rumble_detected,
        "hum_line_hz": updates["hum_line_hz"],
        "hum_strength": hum_strength,
        "selected_hp_hz": selected_hp,
    }
    return new_state, y, metrics
