"""Smart noise gate: downward expander with VAD fusion.

Counterpart of ``audioforge_tpu/ops/gate.py`` (every mode). The gain
smoother feeds back into the state machine, so the recurrence is
sequential: on the card it is the hand-written ``gate_scan`` kernel
(``csrc/gate_scan.cu``: the recurrences serial on a lane per stream, the
level and target-gain math over all samples between them), on the CPU the per-sample
loop :func:`gate_process_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from . import util

__all__ = ["THRESHOLD_ONLY", "VAD_ASSISTED", "VAD_ONLY", "GateConfig",
           "PARAM_KEYS", "FLOAT_KEYS", "INT_KEYS", "gate_init", "gate_reset", "gate_params",
           "gate_process", "gate_process_plain"]

THRESHOLD_ONLY = 0
VAD_ASSISTED = 1
VAD_ONLY = 2

MIN_LEVEL_LINEAR = 1e-10
EXPANDER_RATIO = 4.0
EXPANDER_RANGE_DB = 36.0
DETECTOR_RMS_MS = 8.0
DETECTOR_HYSTERESIS_DB = 4.0
DETECTOR_HOLD_MS = 50.0
CHATTER_WINDOW_MS = 500.0
CHATTER_COOLDOWN_MS = 1000.0
CHATTER_TRANSITION_THRESHOLD = 4
CHATTER_AUTO_RELAX_MS = 700.0
AUTO_RELAX_CLOSE_MARGIN = 0.20
NORMAL_CLOSE_MARGIN = 0.12
VAD_ONSET_VELOCITY = 0.08
UNCERTAIN_LEVEL_SCORE = 0.22
AUTO_RELAX_RANGE_DB = 24.0
FUSED_GATE_OPEN_SCORE = 0.55
FUSED_GATE_CLOSE_SCORE = 0.35
VAD_CONTINUOUS_SMOOTH_MS = 35.0
VAD_CONTINUOUS_CLOSE_MARGIN = 0.20
VAD_ASSISTED_CONTINUOUS_SCALE = 0.30
VAD_ONLY_CONTINUOUS_SCALE = 0.45

_CLOSED, _OPENING, _OPEN, _UNCERTAIN, _RELEASING = range(5)

# kernel rows (csrc/gate_scan.cu GP_*, GF_*, GI_*); booleans travel as int32
PARAM_KEYS = ("threshold_db", "attack_coeff", "release_coeff")
FLOAT_KEYS = ("rms_envelope_sq", "detector_level_db", "current_gain",
              "fused_gate_score", "vad_smoothed_probability",
              "previous_vad_probability", "peak_level")
INT_KEYS = ("hold_remaining", "is_open", "effective_gate_open",
            "has_effective_gate_state", "chatter_window_remaining",
            "chatter_transition_count", "chatter_cooldown",
            "chatter_event_count", "gate_state", "fused_gate_open",
            "auto_relax_remaining")
_BOOL_KEYS = frozenset(("is_open", "effective_gate_open",
                        "has_effective_gate_state", "fused_gate_open"))


@dataclass(frozen=True)
class GateConfig:
    threshold_db: float = -40.0
    attack_ms: float = 5.0
    release_ms: float = 100.0
    sample_rate: float = 48000.0
    mode: int = THRESHOLD_ONLY
    enabled: bool = True

    def _ms(self, ms: float) -> int:
        return int(round(self.sample_rate * ms / 1000.0))

    def _coeff(self, ms: float) -> float:
        return util.time_constant_to_coeff(ms / 1000.0, self.sample_rate)


def gate_init(*, n: int, device) -> dict:
    f = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
    i = lambda v: torch.full((n,), v, dtype=torch.int32, device=device)
    b = lambda v: torch.full((n,), v, dtype=torch.bool, device=device)
    return {
        "rms_envelope_sq": f(0.0), "detector_level_db": f(-120.0),
        "hold_remaining": i(0), "current_gain": f(0.0), "is_open": b(False),
        "effective_gate_open": b(False), "has_effective_gate_state": b(False),
        "chatter_window_remaining": i(0), "chatter_transition_count": i(0),
        "chatter_cooldown": i(0), "chatter_event_count": i(0),
        "gate_state": i(_CLOSED), "fused_gate_score": f(0.0),
        "fused_gate_open": b(False), "vad_smoothed_probability": f(0.0),
        "previous_vad_probability": f(0.0), "auto_relax_remaining": i(0),
        "peak_level": f(-1e30),
    }


def gate_reset(state) -> dict:
    """`gate.rs:762-790`: the full state reset (auto-relax timer included),
    a fresh state of the same streams on the same device."""
    g = state["current_gain"]
    return gate_init(n=g.shape[0], device=g.device)


def gate_params(config: GateConfig, threshold_db=None, attack_ms=None,
                release_ms=None) -> dict:
    """Host control values (stacked per stream by the caller)."""
    return {
        "threshold_db": config.threshold_db if threshold_db is None else threshold_db,
        "attack_coeff": config._coeff(config.attack_ms if attack_ms is None
                                      else attack_ms),
        "release_coeff": config._coeff(config.release_ms if release_ms is None
                                       else release_ms),
    }


def _scan_consts(config: GateConfig) -> tuple:
    """The f32 smoothing pairs and sample counts the recurrence uses, in
    the order of the ``gate_scan`` launcher's arguments."""
    return (*util.f32_pair(config._coeff(DETECTOR_RMS_MS)),
            *util.f32_pair(config._coeff(VAD_CONTINUOUS_SMOOTH_MS)),
            config._ms(DETECTOR_HOLD_MS), config._ms(CHATTER_WINDOW_MS),
            config._ms(CHATTER_COOLDOWN_MS), config._ms(CHATTER_AUTO_RELAX_MS))


def _metrics(s) -> dict:
    return {
        "is_open": s["is_open"],
        "gain": s["current_gain"],
        "chatter_events": s["chatter_event_count"],
        "fused_score": s["fused_gate_score"],
        "gate_state": s["gate_state"],
        "detector_level_db": s["detector_level_db"],
        "auto_relax_active": s["auto_relax_remaining"] > 0,
    }


def gate_process(config: GateConfig, state, x, vad_probability, vad_available,
                 vad_gate_open, vad_threshold, params):
    """Gate ``x: f32 [N, T]``. VAD inputs and ``params`` leaves are per-stream
    ``[N]`` tensors, constant over the block. A CPU tensor runs
    :func:`gate_process_plain`, a CUDA tensor the ``gate_scan`` kernel.
    Returns ``(new_state, y, metrics)``."""
    if not config.enabled:
        return state, x, {
            "is_open": state["is_open"], "gain": state["current_gain"],
            "chatter_events": state["chatter_event_count"],
            "fused_score": state["fused_gate_score"],
            "auto_relax_active": state["auto_relax_remaining"] > 0}
    if x.device.type == "cpu":
        return gate_process_plain(config, state, x, vad_probability,
                                  vad_available, vad_gate_open, vad_threshold,
                                  params)
    if x.device.type != "cuda":
        raise ValueError(f"gate_scan: unsupported device {x.device}")
    s, y = _gate_scan(config, state, x, vad_probability, vad_available,
                      vad_gate_open, vad_threshold, params)
    return s, y, _metrics(s)


def _gate_scan(config, state, x, vad_probability, vad_available,
               vad_gate_open, vad_threshold, params):
    """One ``gate_scan`` launch over ``x``; returns ``(new_state, y)``."""
    n, T = x.shape
    dev = x.device
    p = torch.stack([params[k] for k in PARAM_KEYS])
    fs_in = torch.stack([state[k] for k in FLOAT_KEYS])
    if config.mode == THRESHOLD_ONLY:  # the kernel reads no VAD input
        vad = fs_in[:4]
    else:
        vad = torch.stack([vad_probability.to(torch.float32),
                           vad_available.to(torch.float32),
                           vad_gate_open.to(torch.float32),
                           vad_threshold.to(torch.float32)])
    is_in = torch.stack([state[k].to(torch.int32) for k in INT_KEYS])
    kernels.check_tensor("gate_scan x", x, torch.float32, (n, T), dev)
    kernels.check_tensor("gate_scan params", p, torch.float32,
                         (len(PARAM_KEYS), n), dev)
    kernels.check_tensor("gate_scan vad", vad, torch.float32, (4, n), dev)
    kernels.check_tensor("gate_scan float state", fs_in, torch.float32,
                         (len(FLOAT_KEYS), n), dev)
    kernels.check_tensor("gate_scan int state", is_in, torch.int32,
                         (len(INT_KEYS), n), dev)
    y = torch.empty_like(x)
    fs_out = torch.empty_like(fs_in)
    is_out = torch.empty_like(is_in)
    kernels.launch("gate_scan", x.data_ptr(), p.data_ptr(), vad.data_ptr(),
                   fs_in.data_ptr(), is_in.data_ptr(), y.data_ptr(),
                   fs_out.data_ptr(), is_out.data_ptr(), n, T, int(config.mode),
                   *_scan_consts(config), kernels.stream_of(dev))
    s = dict(zip(FLOAT_KEYS, fs_out.unbind(0)))
    flags = is_out != 0
    for i, k in enumerate(INT_KEYS):
        s[k] = flags[i] if k in _BOOL_KEYS else is_out[i]
    return s, y


def gate_process_plain(config: GateConfig, state, x, vad_probability,
                       vad_available, vad_gate_open, vad_threshold, params):
    """Plain PyTorch twin of the ``gate_scan`` kernel: the per-sample loop
    over ``x: f32 [N, T]`` (one small launch per operation on the card).
    Same arguments and result as :func:`gate_process`."""
    mode = config.mode
    thr = params["threshold_db"]
    atk_c, rel_c = params["attack_coeff"], params["release_coeff"]
    (rms_c, rms_1, sm_c, sm_1, hold_samples, chatter_window, chatter_cooldown,
     auto_relax_samples) = _scan_consts(config)

    vad_in_use = mode != THRESHOLD_ONLY
    if vad_in_use:
        prob = vad_probability.to(torch.float32)
        avail = vad_available.to(torch.bool)
        held = vad_gate_open.to(torch.bool)
        vthr = torch.clamp(vad_threshold.to(torch.float32), 0.05, 0.95)
        prob_delta = prob - state["previous_vad_probability"]
        vad_score = torch.clamp(prob, 0.0, 1.0)
        open_thr = vthr
        c_close = torch.minimum(torch.clamp_min(open_thr - VAD_CONTINUOUS_CLOSE_MARGIN, 0.02),
                                torch.clamp_min(open_thr - 0.02, 0.02))
        span = torch.clamp_min(open_thr - c_close, 1e-3)
        scale = (VAD_ASSISTED_CONTINUOUS_SCALE if mode == VAD_ASSISTED
                 else VAD_ONLY_CONTINUOUS_SCALE)

    s = dict(state)
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        x_t = x[:, t]
        # ---- detector
        rms = rms_c * s["rms_envelope_sq"] + rms_1 * x_t * x_t
        level_db = util.linear_to_db(
            torch.clamp_min(torch.sqrt(rms), MIN_LEVEL_LINEAR), floor_db=-200.0)
        above = level_db >= thr
        hold = torch.where(above, hold_samples,
                      torch.clamp_min(s["hold_remaining"] - 1, 0))
        holding = (~above) & (s["hold_remaining"] > 0)
        below_hyst = level_db <= thr - DETECTOR_HYSTERESIS_DB
        is_open = above | holding | ((~below_hyst) & s["is_open"])
        peak_level = torch.maximum(s["peak_level"], level_db)

        auto_relax = s["auto_relax_remaining"] > 0
        range_db = torch.where(auto_relax, AUTO_RELAX_RANGE_DB, EXPANDER_RANGE_DB)
        closed_db = thr - DETECTOR_HYSTERESIS_DB
        level_score = torch.clamp((level_db - closed_db) / DETECTOR_HYSTERESIS_DB,
                                  0.0, 1.0)
        detector_gr = torch.where(
            is_open, 0.0,
            torch.minimum(torch.clamp_min((thr - level_db)
                                          * (1.0 - 1.0 / EXPANDER_RATIO), 0.0),
                          range_db))
        gain_prev = s["current_gain"]

        if vad_in_use:
            smoothed = torch.clamp(sm_c * s["vad_smoothed_probability"] + sm_1 * prob,
                                   0.0, 1.0)
            recent = torch.where(s["fused_gate_open"] | (gain_prev > 0.35), 1.0, 0.0)
            if mode == VAD_ASSISTED:
                blended = torch.clamp(0.55 * level_score + 0.45 * vad_score
                                      + 0.10 * recent, 0.0, 1.0)
                fused_score = torch.where(
                    avail,
                    torch.maximum(torch.maximum(level_score, vad_score), blended),
                    0.85 * level_score + 0.15 * recent)
            else:
                fused_score = torch.where(
                    avail,
                    torch.where(held, torch.clamp_min(vad_score, FUSED_GATE_OPEN_SCORE),
                           vad_score),
                    torch.where(held, FUSED_GATE_OPEN_SCORE, 0.0))
            fused_open = ((fused_score >= FUSED_GATE_OPEN_SCORE)
                          | ((fused_score > FUSED_GATE_CLOSE_SCORE)
                             & s["fused_gate_open"]))

            close_margin = torch.where(auto_relax, AUTO_RELAX_CLOSE_MARGIN,
                                  NORMAL_CLOSE_MARGIN)
            close_thr = torch.minimum(torch.clamp_min(open_thr - close_margin, 0.02),
                                      open_thr)
            vad_open = avail & ((prob >= open_thr)
                                | ((prob_delta >= VAD_ONSET_VELOCITY)
                                   & (prob >= close_thr)))
            vad_uncertain = avail & (prob >= close_thr)
            level_open = is_open | (level_score >= FUSED_GATE_OPEN_SCORE)
            level_uncertain = ((level_score >= UNCERTAIN_LEVEL_SCORE)
                               | (gain_prev > 0.12))
            cand_ok = (~avail) | vad_uncertain | (gain_prev > 0.20)
            if mode == VAD_ASSISTED:
                strong_open = ((level_open & cand_ok) | (fused_open & cand_ok)
                               | (held & cand_ok) | vad_open)
                sustain = (strong_open | vad_uncertain | level_uncertain
                           | (auto_relax & (level_score > 0.08)))
            else:
                strong_open = held | vad_open
                sustain = (strong_open | vad_uncertain
                           | (auto_relax & (gain_prev > 0.12)))
            releasing_sustain = sustain | ((gain_prev > 0.20)
                                           & (vad_uncertain | auto_relax))
            gs = s["gate_state"]
            from_closed = torch.where(strong_open, _OPENING, _CLOSED)
            fallback = torch.where(sustain, _UNCERTAIN,
                              torch.where(releasing_sustain, _RELEASING, _CLOSED))
            from_opening = torch.where(strong_open, _OPEN,
                                  torch.where(sustain, _UNCERTAIN, _CLOSED))
            from_open = torch.where(strong_open, _OPEN, fallback)
            common = torch.where(strong_open, _OPENING, fallback)
            new_gs = torch.where(gs == _CLOSED, from_closed,
                            torch.where(gs == _OPENING, from_opening,
                                   torch.where(gs == _OPEN, from_open, common))
                            ).to(torch.int32)
            prob_open = new_gs != _CLOSED
            normalized = torch.clamp((smoothed - c_close) / span, 0.0, 1.0)
            closure = 1.0 - normalized * normalized * (3.0 - 2.0 * normalized)
            closure = torch.where(held & (smoothed >= vthr - VAD_CONTINUOUS_CLOSE_MARGIN),
                             torch.clamp_max(closure, 0.80), closure)
            posterior_gr = torch.where(avail, range_db * closure * scale, 0.0)
            target_gr = torch.where(~prob_open, range_db,
                               torch.maximum(detector_gr, posterior_gr))
            effective_open = prob_open
        else:
            smoothed = s["vad_smoothed_probability"]
            fused_score = level_score
            fused_open = s["fused_gate_open"]
            new_gs = s["gate_state"]
            target_gr = detector_gr
            effective_open = is_open

        # ---- chatter tracking
        first = ~s["has_effective_gate_state"]
        transitioned = (~first) & (effective_open != s["effective_gate_open"])
        window_fresh = s["chatter_window_remaining"] == 0
        win = torch.where(transitioned,
                     torch.where(window_fresh, chatter_window,
                            s["chatter_window_remaining"]),
                     s["chatter_window_remaining"])
        cnt = torch.where(transitioned,
                     torch.where(window_fresh, 1, s["chatter_transition_count"] + 1),
                     s["chatter_transition_count"])
        chatter_fire = (transitioned & (cnt >= CHATTER_TRANSITION_THRESHOLD)
                        & (s["chatter_cooldown"] == 0))
        events = s["chatter_event_count"] + chatter_fire.to(torch.int32)
        cooldown = torch.where(chatter_fire, chatter_cooldown, s["chatter_cooldown"])
        relax = s["auto_relax_remaining"]
        if mode != THRESHOLD_ONLY:
            relax = torch.where(chatter_fire, auto_relax_samples, relax)
        win = torch.where(chatter_fire, 0, win)
        cnt = torch.where(chatter_fire, 0, cnt)
        relax = torch.clamp_min(relax - 1, 0)
        win_next = torch.clamp_min(win - 1, 0)
        cnt = torch.where((win > 0) & (win_next == 0), 0, cnt)
        cooldown = torch.clamp_min(cooldown - 1, 0)

        # ---- gain smoothing
        target_gain = torch.pow(10.0, -target_gr / 20.0)
        coeff = torch.where(target_gain > gain_prev, atk_c, rel_c)
        gain = coeff * gain_prev + (1.0 - coeff) * target_gain
        y[:, t] = x_t * gain

        s = {
            "rms_envelope_sq": rms,
            "detector_level_db": level_db,
            "hold_remaining": hold.to(torch.int32),
            "current_gain": gain,
            "is_open": is_open,
            "effective_gate_open": torch.where(first | transitioned, effective_open,
                                          s["effective_gate_open"]),
            "has_effective_gate_state": torch.ones_like(first),
            "chatter_window_remaining": win_next.to(torch.int32),
            "chatter_transition_count": cnt.to(torch.int32),
            "chatter_cooldown": cooldown.to(torch.int32),
            "chatter_event_count": events,
            "gate_state": new_gs,
            "fused_gate_score": fused_score.to(torch.float32),
            "fused_gate_open": fused_open,
            "vad_smoothed_probability": smoothed,
            "previous_vad_probability": s["previous_vad_probability"],
            "auto_relax_remaining": relax.to(torch.int32),
            "peak_level": peak_level,
        }
    if vad_in_use:
        s["previous_vad_probability"] = prob
    return s, y, _metrics(s)
