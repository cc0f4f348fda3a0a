"""VAD auto-gate controller: hold/debounce and auto noise-floor tracking.

Counterpart of ``audioforge_tpu/models/vad_gate.py``: block-cadence tensor
math over ``[N]`` streams (a 250-frame history with a 61-bin 1 dB histogram,
20th-percentile floor with slew limits, threshold = floor + margin, hold and
debounce timers).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["VadGateConfig", "vad_gate_init", "vad_gate_reset", "vad_gate_process",
           "compute_rms_db"]

NOISE_FLOOR_HISTORY_FRAMES = 250
NOISE_FLOOR_BIN_COUNT = 61
NOISE_FLOOR_BIN_MIN_DB = -80.0
NOISE_FLOOR_BIN_STEP_DB = 1.0
NOISE_FLOOR_ELIGIBLE_PROB_MAX = 0.3
NOISE_FLOOR_UP_SLEW_DB_PER_FRAME = 0.5
NOISE_FLOOR_DOWN_SLEW_DB_PER_FRAME = 0.1

THRESHOLD_ONLY = 0
VAD_ASSISTED = 1
VAD_ONLY = 2


@dataclass(frozen=True)
class VadGateConfig:
    sample_rate: int = 48000
    gate_mode: int = THRESHOLD_ONLY
    vad_threshold: float = 0.5
    margin_db: float = 10.0
    min_threshold_db: float = -80.0
    max_threshold_db: float = -10.0
    manual_threshold_db: float = -40.0
    auto_threshold_enabled: bool = True
    hold_time_ms: float = 200.0
    debounce_time_ms: float = 50.0
    enabled: bool = True


def vad_gate_init(config: VadGateConfig, *, n: int, device) -> dict:
    f = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "noise_floor": f(-60.0),
        "hold_timer": f(0.0),
        "timer_running": torch.zeros(n, dtype=torch.bool, device=device),
        "prev_gate_open": torch.zeros(n, dtype=torch.bool, device=device),
        "closed_counter": f(config.sample_rate * 0.05),
        "hist": torch.zeros((n, NOISE_FLOOR_HISTORY_FRAMES), dtype=torch.float32,
                            device=device),
        "hist_len": torch.zeros(n, **i32),
        "hist_cursor": torch.zeros(n, **i32),
        "bins": torch.zeros((n, NOISE_FLOOR_BIN_COUNT), **i32),
        "current_probability": f(0.0),
    }


def vad_gate_reset(config: VadGateConfig, state) -> dict:
    """A fresh controller state of the same streams on the same device."""
    f = state["noise_floor"]
    return vad_gate_init(config, n=f.shape[0], device=f.device)


def _bin_index(sample_db):
    raw = torch.round((sample_db - NOISE_FLOOR_BIN_MIN_DB) / NOISE_FLOOR_BIN_STEP_DB)
    return torch.clamp(raw, 0, NOISE_FLOOR_BIN_COUNT - 1).to(torch.int64)


def _percentile_from_bins(bins, hist_len, percentile):
    """Returns (bin dB value, found) for the first bin whose cumulative count
    exceeds ``floor(hist_len * percentile)``."""
    target = torch.minimum(
        torch.floor(hist_len.to(torch.float32) * percentile).to(torch.int32),
        torch.clamp_min(hist_len - 1, 0))
    hit = torch.cumsum(bins, dim=-1) > target[:, None]
    idx = hit.to(torch.int32).argmax(dim=-1)
    value = NOISE_FLOOR_BIN_MIN_DB + idx.to(torch.float32) * NOISE_FLOOR_BIN_STEP_DB
    return value, hit.any(dim=-1)


def noise_floor_reliability(state):
    hist_len = state["hist_len"]
    maturity = torch.clamp(hist_len.to(torch.float32) / NOISE_FLOOR_HISTORY_FRAMES,
                           0.0, 1.0)
    p20, _ = _percentile_from_bins(state["bins"], hist_len, 0.20)
    p80, _ = _percentile_from_bins(state["bins"], hist_len, 0.80)
    t = torch.clamp((torch.clamp_min(p80 - p20, 0.0) - 3.0) / 7.0, 0.0, 1.0)
    stationarity = 1.0 - t * t * (3.0 - 2.0 * t)
    rel = torch.clamp(maturity * stationarity, 0.0, 1.0)
    return torch.where(hist_len > 0, rel, 0.0)


def vad_gate_process(config: VadGateConfig, state, rms_db, probability,
                     probability_available, block_samples: int, params):
    """One control-block update over ``[N]`` streams. ``params``: per-stream
    {vad_threshold, margin_db, hold_time_ms}. Returns ``(new_state, out)``
    with out {gate_open, probability, threshold_db, noise_floor_db,
    reliability}."""
    if not config.enabled:
        return state, {
            "gate_open": torch.zeros_like(state["prev_gate_open"]),
            "probability": torch.zeros_like(state["current_probability"]),
            "threshold_db": torch.full_like(state["noise_floor"],
                                            config.manual_threshold_db),
            "noise_floor_db": state["noise_floor"],
            "reliability": torch.zeros_like(state["noise_floor"]),
        }
    vad_threshold = params["vad_threshold"]
    margin_db = params["margin_db"]
    hold_time_ms = params["hold_time_ms"]
    avail = probability_available.to(torch.bool)
    prob = torch.where(avail, torch.clamp(probability.to(torch.float32), 0.0, 1.0),
                       0.0)
    rms_db = rms_db.to(torch.float32)

    # ---- noise floor update
    eligible = ((prob < NOISE_FLOOR_ELIGIBLE_PROB_MAX) & (rms_db > -100.0)
                & config.auto_threshold_enabled)
    hist_len = state["hist_len"]
    full = hist_len >= NOISE_FLOOR_HISTORY_FRAMES
    write_idx = torch.where(full, state["hist_cursor"], hist_len).to(torch.int64)
    old_val = torch.gather(state["hist"], 1, write_idx[:, None])[:, 0]
    bins_idx = torch.arange(NOISE_FLOOR_BIN_COUNT, device=rms_db.device)
    one_hot_new = (bins_idx == _bin_index(rms_db)[:, None]).to(torch.int32)
    one_hot_old = (bins_idx == _bin_index(old_val)[:, None]).to(torch.int32)
    delta_bins = one_hot_new - torch.where(full[:, None], one_hot_old, 0)
    new_bins = torch.where(eligible[:, None], state["bins"] + delta_bins,
                           state["bins"])
    slots = torch.arange(NOISE_FLOOR_HISTORY_FRAMES, device=rms_db.device)
    new_hist = torch.where(eligible[:, None] & (slots == write_idx[:, None]),
                           rms_db[:, None], state["hist"])
    new_len = torch.where(
        eligible, torch.clamp_max(hist_len + 1, NOISE_FLOOR_HISTORY_FRAMES),
        hist_len).to(torch.int32)
    new_cursor = torch.where(
        eligible & full,
        (state["hist_cursor"] + 1) % NOISE_FLOOR_HISTORY_FRAMES,
        state["hist_cursor"]).to(torch.int32)

    cand, found = _percentile_from_bins(new_bins, new_len, 0.20)
    slewed = state["noise_floor"] + torch.clamp(
        cand - state["noise_floor"], -NOISE_FLOOR_DOWN_SLEW_DB_PER_FRAME,
        NOISE_FLOOR_UP_SLEW_DB_PER_FRAME)
    new_floor = torch.where(eligible & found & (new_len > 0),
                            torch.clamp(slewed, -80.0, -20.0), state["noise_floor"])

    # ---- threshold + raw open decision
    if config.auto_threshold_enabled:
        threshold = torch.clamp(new_floor + margin_db, config.min_threshold_db,
                                config.max_threshold_db)
    else:
        threshold = torch.full_like(new_floor, float(np.clip(
            config.manual_threshold_db, config.min_threshold_db,
            config.max_threshold_db)))
    level_open = rms_db >= threshold
    vad_speech = prob > vad_threshold
    if config.gate_mode == THRESHOLD_ONLY:
        gate_open = level_open
    elif config.gate_mode == VAD_ASSISTED:
        gate_open = level_open | vad_speech
    else:
        gate_open = vad_speech

    # ---- hold + debounce
    debounce_samples = config.debounce_time_ms / 1000.0 * config.sample_rate
    rising = gate_open & ~state["prev_gate_open"]
    debounce_ready = state["closed_counter"] >= debounce_samples
    debounced = gate_open & ~(rising & ~debounce_ready)
    hold_samples = hold_time_ms / 1000.0 * config.sample_rate
    hold_timer = torch.where(debounced, hold_samples, state["hold_timer"])
    timer_running = debounced | state["timer_running"]
    closed_counter = torch.where(debounced, 0.0,
                                 state["closed_counter"] + float(block_samples))
    hold_timer = torch.where(timer_running, hold_timer - float(block_samples),
                             hold_timer)
    expired = timer_running & (hold_timer <= 0.0)
    hold_timer = torch.where(expired, 0.0, hold_timer)
    timer_running = timer_running & ~expired

    new_state = {
        "noise_floor": new_floor,
        "hold_timer": hold_timer,
        "timer_running": timer_running,
        "prev_gate_open": debounced,
        "closed_counter": closed_counter,
        "hist": new_hist,
        "hist_len": new_len,
        "hist_cursor": new_cursor,
        "bins": new_bins,
        "current_probability": prob,
    }
    return new_state, {
        "gate_open": debounced | timer_running,
        "probability": prob,
        "threshold_db": threshold,
        "noise_floor_db": new_floor,
        "reliability": noise_floor_reliability(new_state),
    }


def compute_rms_db(x):
    """Block RMS in dBFS over the last axis."""
    power = torch.mean(x * x, dim=-1)
    return torch.where(power > 0,
                       10.0 * torch.log10(torch.clamp_min(power, 1e-30)), -100.0)
