"""The serving engine's block step, plain: a frozen copy of the pure
functions of ``audioforge_tpu_torch/runtime/serving.py`` (the state
initialisers, the slot reset, the suppressor and VAD steps and
``_serving_step``), over this package's copies of the live chain, the DSP
ops and the three models. It runs on the CPU, where every stage takes its
plain path; nothing here imports the program or launches a kernel."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import dfn3, rnnoise, silero
from ..ops import resample
from . import live_chain as lc

BLOCK = lc.BLOCK_SAMPLES  # 480 == the RNNoise frame

_NONFINITE_EVENTS_FOR_RESET = 3
_NONFINITE_WINDOW_BLOCKS = 200
_RESET_COOLDOWN_BLOCKS = 200
_SUPPRESSOR_MODELS = ("rnnoise", "deepfilter-ll", "deepfilter")

# the VAD is warm after ceil(576 / 160) = 4 blocks of 160 16 kHz samples
_VAD_WARMUP_BLOCKS = silero.VAD_WARMUP_BLOCKS


@dataclass(frozen=True)
class ServingConfig:
    capacity: int = 16
    chain: lc.LiveChainConfig = field(default_factory=lc.LiveChainConfig)
    suppressor_model: str | None = "rnnoise"  # None disables the stage
    vad_enabled: bool = False

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if (self.suppressor_model is not None
                and self.suppressor_model not in _SUPPRESSOR_MODELS):
            raise ValueError(f"unknown suppressor model {self.suppressor_model!r}")


def _model_state_init(config: ServingConfig, device) -> dict:
    n, model = config.capacity, config.suppressor_model
    if model == "rnnoise":
        return rnnoise.rnnoise_state_init(n=n, device=device)
    return dfn3.dfn_state_init(n=n, lookahead=model == "deepfilter", device=device)


def _supp_state_init(config: ServingConfig, device) -> dict:
    n = config.capacity
    i = lambda: torch.zeros(n, dtype=torch.int32, device=device)
    # the dry path is delayed by the model's latency: one frame, three for
    # the standard DeepFilterNet3 (two frames of lookahead)
    delay_blocks = 3 if config.suppressor_model == "deepfilter" else 1
    return {
        "model": _model_state_init(config, device),
        "smoothed_strength": torch.ones(n, dtype=torch.float32, device=device),
        "dry_delay": torch.zeros((n, delay_blocks, BLOCK), dtype=torch.float32,
                                 device=device),
        "backend_failed": torch.zeros(n, dtype=torch.bool, device=device),
        "nonfinite_count": i(),
        "nonfinite_timer": i(),
        "reset_cooldown": i(),
        "soft_resets": i(),
    }


def _vad_state_init(config: ServingConfig, device) -> dict:
    n = config.capacity
    return {
        "window16": torch.zeros((n, silero.MODEL_INPUT_SIZE), dtype=torch.float32,
                                device=device),
        "dec3": resample.decimate3_init(n=n, device=device),
        # stream-major [N, (h, c), 128]
        "lstm": torch.zeros((n, silero._N_LAYERS, silero._STATE_DIM),
                            dtype=torch.float32, device=device),
        "smoothed": torch.zeros(n, dtype=torch.float32, device=device),
        "blocks_seen": torch.zeros(n, dtype=torch.int32, device=device),
    }


def _serving_state_init(config: ServingConfig, device, eq_bands=None) -> dict:
    state = {"chain": lc.live_init(config.chain, eq_bands, n=config.capacity,
                                   device=device)}
    if config.suppressor_model is not None:
        state["supp"] = _supp_state_init(config, device)
    if config.vad_enabled:
        state["vad"] = _vad_state_init(config, device)
    return state


def _masked_reset(state, fresh, reset_mask, shared=frozenset(), path=()):
    """Blend ``fresh`` in where ``reset_mask [N]`` is set. Leaves whose path
    is in ``shared`` have no stream axis and are kept as they are."""
    out = {}
    for k, cur in state.items():
        p = path + (k,)
        if isinstance(cur, dict):
            out[k] = _masked_reset(cur, fresh[k], reset_mask, shared, p)
        elif p in shared:
            out[k] = cur
        else:
            m = reset_mask.reshape((-1,) + (1,) * (cur.ndim - 1))
            out[k] = torch.where(m, fresh[k], cur)
    return out


_SHARED = frozenset(("chain",) + p for p in lc.SHARED_LEAVES)


def _supp_step(config: ServingConfig, sp, state, fresh_model, x):
    """The frame-synchronous batched suppressor with the per-slot failure
    handling, soft reset (to ``fresh_model``) and the latency-aligned dry
    delay. ``sp``: {weights, strength [N], enabled [N], smoothing_coeff} and,
    for DeepFilterNet3, {atten_lim_db, post_filter_beta}. Returns
    (new_state, y, metrics)."""
    model = config.suppressor_model
    if model == "rnnoise":
        scaled = torch.clamp(rnnoise.soft_clip(x) * rnnoise.PCM_SCALE,
                             -rnnoise.PCM_MODEL_LIMIT, rnnoise.PCM_MODEL_LIMIT)
        mstate, wet, aux = rnnoise.rnnoise_frame(sp["weights"], state["model"], scaled)
        wet = wet / rnnoise.PCM_SCALE
        model_vad = aux["vad"]
    else:
        mstate, wet, _ = dfn3.dfn_frame(sp["weights"], state["model"], x,
                                        sp["atten_lim_db"], sp["post_filter_beta"])
        model_vad = torch.zeros_like(x[:, 0])

    finite = torch.isfinite(wet).all(dim=-1)
    wet = torch.where(finite[:, None], torch.nan_to_num(wet), 0.0)
    timer = torch.clamp_min(state["nonfinite_timer"] - 1, 0)
    count = torch.where(timer > 0, state["nonfinite_count"], 0)
    count = torch.where(~finite, count + 1, count)
    timer = torch.where(~finite, _NONFINITE_WINDOW_BLOCKS, timer)
    cooldown = torch.clamp_min(state["reset_cooldown"] - 1, 0)
    do_reset = (count >= _NONFINITE_EVENTS_FOR_RESET) & (cooldown == 0)
    mstate = _masked_reset(mstate, fresh_model, do_reset)
    count = torch.where(do_reset, 0, count)
    cooldown = torch.where(do_reset, _RESET_COOLDOWN_BLOCKS, cooldown)
    failed = state["backend_failed"]
    if model == "deepfilter":  # the standard model latches for good
        failed = failed | ~finite

    sm = (sp["strength"] * sp["smoothing_coeff"]
          + state["smoothed_strength"] * (1.0 - sp["smoothing_coeff"]))
    dry = state["dry_delay"][:, 0]
    dry_q = torch.cat([state["dry_delay"][:, 1:], x[:, None, :]], dim=1)
    mix = wet * sm[:, None] + dry * (1.0 - sm[:, None])
    bypass = failed | ~sp["enabled"] | ~finite
    y = torch.where(bypass[:, None], dry, mix)
    soft_resets = state["soft_resets"] + do_reset.to(torch.int32)
    new_state = {
        "model": mstate, "smoothed_strength": sm, "dry_delay": dry_q,
        "backend_failed": failed, "nonfinite_count": count.to(torch.int32),
        "nonfinite_timer": timer.to(torch.int32),
        "reset_cooldown": cooldown.to(torch.int32), "soft_resets": soft_resets,
    }
    metrics = {
        "suppressor_nonfinite": (~finite).to(torch.int32),
        "suppressor_soft_resets": soft_resets,
        "suppressor_backend_failed": failed,
        "suppressor_vad_probability": model_vad,
    }
    return new_state, y, metrics


def _vad_step(sp, state, x):
    """In-step Silero: decimate the block to 16 kHz, roll it into the
    576-sample window, one batched inference on the window times the
    pre-gain, then the clip, the warm-up, the EMA and the calibration.
    ``sp``: {weights, pre_gain, smoothing}. Returns (new_state,
    probability [N], available [N])."""
    w = sp["weights"]
    hist, window, frames = silero.vad_front(x, state["dec3"]["hist"],
                                            state["window16"], sp["pre_gain"])
    gates = silero.vad_gates(w, frames, state["lstm"][:, 0])
    lstm, smoothed, seen, prob, avail = silero.vad_lstm_head(
        w, gates, state["lstm"], state["smoothed"], state["blocks_seen"],
        sp["smoothing"], _VAD_WARMUP_BLOCKS)
    new_state = {"window16": window, "dec3": {"hist": hist}, "lstm": lstm,
                 "smoothed": smoothed, "blocks_seen": seen}
    return new_state, prob, avail


def _serving_step(config: ServingConfig, params, state, fresh, x, active,
                  reset_mask, ext_vad_prob, ext_vad_avail):
    """One block for every slot, a pure function of its arguments.
    ``reset_mask`` None skips the slot reset (the engine resets its static
    state before the step instead). With ``vad_enabled`` the in-step
    probability replaces the external one."""
    if reset_mask is not None:
        state = _masked_reset(state, fresh, reset_mask, _SHARED)
    x = torch.where(active[:, None], x, 0.0)
    if config.vad_enabled:
        vstate, vad_prob, vad_avail = _vad_step(params["vad"], state["vad"], x)
    else:
        vad_prob, vad_avail = ext_vad_prob, ext_vad_avail

    chain, y, fm = lc.front_block(config.chain, params["chain"], state["chain"],
                                  x, vad_prob, vad_avail)
    sm = {}
    if config.suppressor_model is not None:
        sstate, y, sm = _supp_step(config, params["supp"], state["supp"],
                                   fresh["supp"]["model"], y)
    evidence = {
        "vad_probability": vad_prob,
        "vad_reliability": vad_avail.to(torch.float32),
        "noise_floor_db": fm["noise_floor_db"],
        "live_noise_reliability": fm["noise_floor_reliability"],
    }
    chain, y2, bm = lc.back_block(config.chain, params["chain"], chain, y, evidence)
    new_state = {"chain": chain}
    if config.suppressor_model is not None:
        new_state["supp"] = sstate
    if config.vad_enabled:
        new_state["vad"] = vstate
    metrics = {**fm, **sm, **bm, "vad_probability": vad_prob,
               "vad_available": vad_avail}
    return new_state, y2, metrics



def _stack_tree(tree, n):
    """One stream's host control tree -> ``[n]`` f32 numpy leaves."""
    if isinstance(tree, dict):
        return {k: _stack_tree(v, n) for k, v in tree.items()}
    return np.full(n, tree, dtype=np.float32)



def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.copy(tree), device=device)



def load_weights(config: ServingConfig, archives: dict) -> dict:
    """The step's weight groups from the archives' paths (``archives``:
    "rnnoise", "dfn3", "vad"), by this package's own loaders."""
    weights = {}
    model = config.suppressor_model
    if model == "rnnoise":
        weights["supp"] = rnnoise.load_weights(archives["rnnoise"])
    elif model is not None:
        weights["supp"] = dfn3.load_weights(archives["dfn3"])
    if config.vad_enabled:
        weights["vad"] = silero.load_weights(archives["vad"])
    return weights


def stream_params(config: ServingConfig, weights: dict, n: int) -> dict:
    """The control tree of ``n`` freshly attached streams with the engine's
    defaults (suppressor at full strength, VAD pre-gain 1, smoothing 0.5)."""
    params = {"chain": _stack_tree(lc.live_params(config.chain), n)}
    if config.suppressor_model is not None:
        params["supp"] = {
            "strength": np.ones(n, np.float32), "enabled": np.ones(n, bool),
            "smoothing_coeff": np.float32(1.0 - np.exp(-(BLOCK / 48000.0) / 0.015))}
        if config.suppressor_model != "rnnoise":
            params["supp"].update(atten_lim_db=np.float32(dfn3.DEFAULT_ATTEN_LIM_DB),
                                  post_filter_beta=np.float32(dfn3.DEFAULT_POST_FILTER_BETA))
    if config.vad_enabled:
        params["vad"] = {"pre_gain": np.float32(1.0), "smoothing": np.float32(0.5)}
    params = _to_device(params, "cpu")
    for group, w in weights.items():
        params[group] = dict(params[group], weights=w)
    return params


def run_streams(config: ServingConfig, weights: dict, x: np.ndarray) -> np.ndarray:
    """Streams attached fresh, fed ``x [n, k * 480]`` block by block with
    no external VAD input; returns their output ``[n, k * 480]``."""
    n = x.shape[0]
    params = stream_params(config, weights, n)
    fresh = _serving_state_init(config, "cpu")
    state = _serving_state_init(config, "cpu")
    active = torch.ones(n, dtype=torch.bool)
    no_prob, no_avail = torch.zeros(n), torch.zeros(n, dtype=torch.bool)
    xs = torch.from_numpy(np.ascontiguousarray(x, np.float32)).reshape(n, -1, BLOCK)
    out = torch.empty_like(xs)
    with torch.no_grad():
        for b in range(xs.shape[1]):
            state, y, _ = _serving_step(config, params, state, fresh, xs[:, b].clone(),
                                        active, None, no_prob, no_avail)
            out[:, b] = y
    return out.reshape(n, -1).numpy()
