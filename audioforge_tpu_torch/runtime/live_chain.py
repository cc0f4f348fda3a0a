"""The live chain's two block halves over a batch of streams.

Counterpart of ``audioforge_tpu/runtime/live_chain.py``. Every function takes
and returns tensors with the stream axis first: the JAX package wrote the
halves for one stream and mapped them with ``vmap``; here per-stream control
values are ``[N]`` tensors and the batch axis is explicit.

- :func:`front_block`: sanitize, input meters and true peak, routing (DC
  blocker + 80 Hz high-pass, or gentle/strong hum and rumble cleanup), the
  block-cadence VAD auto-gate, smart gate.
- :func:`back_block`: de-esser -> EQ -> compressor -> lookahead limiter ->
  true-peak limiter -> output clamp, meters and momentary LUFS.
- :func:`front_run` / :func:`back_run`: a burst of ``k`` blocks of one
  stream through a half, for the single-stream engine. Each runs a
  :class:`~audioforge_tpu_torch.runtime.replay.BlockReplay` of its half
  (:func:`front_replay`, :func:`back_replay`): ``k`` replays of the one-block
  graph on the card, the half block by block on the CPU.

Leaves listed in :data:`SHARED_LEAVES` are constants shared by every stream
(no stream axis); slot resets leave them alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..models import vad_gate as vadm
from ..ops import compressor as comp_ops
from ..ops import deesser as des_ops
from ..ops import eq as eq_ops
from ..ops import gate as gate_ops
from ..ops import limiter as lim_ops
from ..ops import loudness as loud_ops
from ..ops import routing as route_ops
from ..ops import true_peak as tp_ops
from ..ops import util
from .chain import effective_limiter_ceiling_db
from .replay import BlockReplay

__all__ = ["BLOCK_SAMPLES", "SHARED_LEAVES", "LiveChainConfig", "live_params",
           "live_init", "front_block", "back_block",
           "effective_limiter_ceiling_db", "front_replay", "back_replay",
           "front_run", "back_run", "chain_latency_samples"]

BLOCK_SAMPLES = 480

# paths (inside the chain state) of the leaves every stream shares
SHARED_LEAVES = frozenset({
    ("meter_coeff",),
    ("out_lufs", "coeffs"),
    ("compressor", "meter", "coeffs"),
})


@dataclass(frozen=True)
class LiveChainConfig:
    """Static topology of the live chain; continuous values live in the
    params (:func:`live_params`). ``cleanup_mode`` is "off", "gentle" or
    "strong" (or the integer code 0/1/2). ``deesser_enabled`` switches the
    de-esser on whatever ``deesser.enabled`` says, as the application path
    of the reference ties them (ROADMAP F3)."""

    sample_rate: float = 48000.0
    cleanup_mode: str | int = "off"
    gate_enabled: bool = True
    gate_mode: int = gate_ops.THRESHOLD_ONLY
    auto_threshold_enabled: bool = True
    deesser_enabled: bool = False
    eq_enabled: bool = True
    compressor_enabled: bool = True
    adaptive_release: bool = False
    auto_makeup_enabled: bool = False
    sidechain_highpass_enabled: bool = True
    limiter_enabled: bool = True
    careful_output_enabled: bool = True
    deesser: des_ops.DeEsserConfig = field(default_factory=des_ops.DeEsserConfig)

    def __post_init__(self):
        self.routing  # validates cleanup_mode

    @property
    def routing(self) -> route_ops.RoutingConfig:
        mode = self.cleanup_mode
        if isinstance(mode, str):
            if mode not in route_ops.CLEANUP_MODES:
                raise ValueError(f"unknown cleanup mode {mode!r}")
            mode = route_ops.CLEANUP_MODES[mode]
        return route_ops.RoutingConfig(sample_rate=self.sample_rate,
                                       cleanup_mode=mode)

    @property
    def deesser_effective(self) -> des_ops.DeEsserConfig:
        return replace(self.deesser, enabled=self.deesser_enabled)

    @property
    def gate(self) -> gate_ops.GateConfig:
        return gate_ops.GateConfig(sample_rate=self.sample_rate,
                                   mode=self.gate_mode, enabled=self.gate_enabled)

    @property
    def vad(self) -> vadm.VadGateConfig:
        return vadm.VadGateConfig(sample_rate=int(self.sample_rate),
                                  gate_mode=self.gate_mode,
                                  auto_threshold_enabled=self.auto_threshold_enabled,
                                  enabled=self.gate_enabled)

    @property
    def compressor(self) -> comp_ops.CompressorConfig:
        return comp_ops.CompressorConfig(
            sample_rate=self.sample_rate, enabled=self.compressor_enabled,
            adaptive_release=self.adaptive_release,
            auto_makeup_enabled=self.auto_makeup_enabled,
            sidechain_highpass_enabled=self.sidechain_highpass_enabled,
            block_samples=BLOCK_SAMPLES)

    @property
    def limiter(self) -> lim_ops.LimiterConfig:
        return lim_ops.LimiterConfig(sample_rate=self.sample_rate,
                                     enabled=self.limiter_enabled)

    @property
    def tp_limiter(self) -> tp_ops.TruePeakLimiterConfig:
        return tp_ops.TruePeakLimiterConfig(sample_rate=self.sample_rate)


def live_params(config: LiveChainConfig, *, gate_threshold_db=-40.0,
                gate_attack_ms=10.0, gate_release_ms=100.0, vad_threshold=0.48,
                vad_hold_time_ms=200.0, gate_margin_db=10.0,
                compressor_threshold_db=-20.0, compressor_ratio=4.0,
                compressor_attack_ms=10.0, compressor_release_ms=200.0,
                compressor_makeup_gain_db=0.0, compressor_target_lufs=-18.0,
                noise_reference_reliability=0.0, limiter_ceiling_db=-1.0,
                limiter_release_ms=50.0) -> dict:
    """One stream's control values as host floats (the engine stacks them
    into ``[N]`` f32 tensors)."""
    ceiling_db = effective_limiter_ceiling_db(limiter_ceiling_db,
                                              config.careful_output_enabled)
    return {
        "gate": gate_ops.gate_params(config.gate, threshold_db=gate_threshold_db,
                                     attack_ms=gate_attack_ms,
                                     release_ms=gate_release_ms),
        "vad_threshold": vad_threshold,
        "vad_gate": {"vad_threshold": vad_threshold, "margin_db": gate_margin_db,
                     "hold_time_ms": vad_hold_time_ms},
        "compressor": comp_ops.compressor_params(
            config.compressor, threshold_db=compressor_threshold_db,
            ratio=compressor_ratio, attack_ms=compressor_attack_ms,
            release_ms=compressor_release_ms,
            makeup_gain_db=compressor_makeup_gain_db,
            target_lufs=compressor_target_lufs,
            noise_reference_reliability=noise_reference_reliability),
        "limiter": lim_ops.limiter_params(config.limiter, ceiling_db=ceiling_db,
                                          release_ms=limiter_release_ms),
        "limiter_ceiling_linear": util.db_to_linear(ceiling_db),
    }


def live_init(config: LiveChainConfig, eq_bands=None, *, n: int, device) -> dict:
    fs = config.sample_rate
    f = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
    kw = dict(n=n, device=device)
    return {
        "routing": route_ops.routing_init(config.routing, **kw),
        "gate": gate_ops.gate_init(**kw),
        "vad": vadm.vad_gate_init(config.vad, **kw),
        "deesser": des_ops.deesser_init(config.deesser_effective, **kw),
        "eq": eq_ops.eq_init(eq_bands, fs, **kw),
        "compressor": comp_ops.compressor_init(config.compressor, **kw),
        "limiter": lim_ops.limiter_init(config.limiter, **kw),
        "tp": tp_ops.tp_limiter_init(**kw),
        "input_tp": tp_ops.detector_init(**kw),
        "out_lufs": loud_ops.meter_init(fs, BLOCK_SAMPLES, **kw),
        "in_rms_acc": f(0.0),
        "out_rms_acc": f(0.0),
        "limiter_feedback_gr_db": f(0.0),
        "meter_coeff": torch.tensor(float(np.exp(-1.0 / (0.3 * fs))),
                                    dtype=torch.float32, device=device),
    }


def front_block(config: LiveChainConfig, params, state, x, vad_probability,
                vad_available):
    """Input half over ``x: f32 [N, T]``; ``vad_*`` are per-stream ``[N]``.
    Returns ``(new_state, y, metrics)``."""
    new_state = dict(state)
    x, clip_count, clip_peak_db = route_ops.sanitize_and_clamp_input(x)
    in_stats, new_state["in_rms_acc"] = route_ops.meter_block_stats(
        x, state["in_rms_acc"], state["meter_coeff"])
    new_state["input_tp"], input_tp = tp_ops.detector_process(state["input_tp"], x)
    new_state["routing"], y, route_metrics = route_ops.routing_process(
        config.routing, state["routing"], x)

    new_state["vad"], vout = vadm.vad_gate_process(
        config.vad, state["vad"], vadm.compute_rms_db(y), vad_probability,
        vad_available, BLOCK_SAMPLES, params=params["vad_gate"])
    gate_params = dict(params["gate"])
    if config.auto_threshold_enabled:
        gate_params["threshold_db"] = vout["threshold_db"]
    new_state["gate"], y, gm = gate_ops.gate_process(
        config.gate, state["gate"], y, vad_probability=vad_probability,
        vad_available=vad_available, vad_gate_open=vout["gate_open"],
        vad_threshold=params["vad_threshold"], params=gate_params)

    metrics = {
        "input_clip_count": clip_count,
        "input_clip_peak_db": clip_peak_db,
        "input_peak_db": in_stats["peak_db"],
        "input_rms_db": in_stats["rms_db"],
        "input_crest_factor_db": in_stats["crest_factor_db"],
        "input_true_peak": input_tp,
        "gate_gain": gm["gain"],
        "gate_is_open": gm["is_open"],
        "gate_chatter_events": gm["chatter_events"],
        "gate_fused_score": gm["fused_score"],
        "gate_auto_relax_active": gm["auto_relax_active"],
        "noise_floor_db": vout["noise_floor_db"],
        "noise_floor_reliability": vout["reliability"],
        "gate_threshold_db": vout["threshold_db"],
        "vad_gate_open": vout["gate_open"],
        **{f"routing_{k}": v for k, v in route_metrics.items()},
    }
    return new_state, y, metrics


def back_block(config: LiveChainConfig, params, state, x, evidence):
    """Downstream half over ``x: f32 [N, T]``. ``evidence``: dict of ``[N]``
    tensors {vad_probability, vad_reliability, noise_floor_db,
    live_noise_reliability} for the auto makeup, or None.
    Returns ``(new_state, y, metrics)``."""
    new_state = dict(state)
    zeros = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    y = x
    if config.deesser_enabled:
        new_state["deesser"], y, dm = des_ops.deesser_process(
            config.deesser_effective, state["deesser"], y)
        metrics = {"deesser_gain_reduction_db": dm["reduction_db"],
                   "deesser_detector_confidence": dm["confidence"]}
    else:
        metrics = {"deesser_gain_reduction_db": zeros,
                   "deesser_detector_confidence": zeros}

    if config.eq_enabled:
        new_state["eq"], y = eq_ops.eq_process(state["eq"], y)

    if config.compressor_enabled:
        new_state["compressor"], y, cm = comp_ops.compressor_process(
            config.compressor, params["compressor"], state["compressor"], y,
            evidence=evidence, limiter_feedback_db=state["limiter_feedback_gr_db"])
        metrics.update(compressor_gain_reduction_db=cm["gain_reduction_db"],
                       compressor_makeup_gain_db=cm["makeup_gain_db"],
                       compressor_lufs=cm["lufs"], compressor_release_ms=zeros)
    else:
        metrics.update(compressor_gain_reduction_db=zeros,
                       compressor_makeup_gain_db=zeros,
                       compressor_lufs=zeros - 100.0, compressor_release_ms=zeros)

    if config.limiter_enabled:
        new_state["limiter"], y, lm = lim_ops.limiter_process(
            config.limiter, state["limiter"], y, params=params["limiter"])
        metrics["limiter_gain_reduction_db"] = lm["peak_gr_db"]
        new_state["limiter_feedback_gr_db"] = lm["peak_gr_db"]
    else:
        metrics["limiter_gain_reduction_db"] = zeros
        new_state["limiter_feedback_gr_db"] = zeros

    y = torch.where(torch.isfinite(y), y, 0.0)
    if config.limiter_enabled:
        new_state["tp"], y, tm = tp_ops.tp_limiter_process(
            config.tp_limiter, state["tp"], y,
            ceiling_linear=params["limiter_ceiling_linear"])
        metrics.update(output_true_peak=tm["output_true_peak"],
                       tp_gain_reduction_db=tm["max_gain_reduction_db"],
                       tp_limited_events=tm["limited_events"])
    else:
        det, tp_peak = tp_ops.detector_process(
            {"history": state["tp"]["in_hist"],
             "last_peak": state["tp"]["last_input_tp"]}, y)
        new_state["tp"] = dict(state["tp"], in_hist=det["history"],
                               last_input_tp=det["last_peak"])
        metrics.update(output_true_peak=tp_peak, tp_gain_reduction_db=zeros,
                       tp_limited_events=torch.zeros_like(zeros, dtype=torch.int32))

    y, out_clip_count, out_clip_peak_db = route_ops.sanitize_and_clamp_output(
        y, params["limiter_ceiling_linear"])
    out_stats, new_state["out_rms_acc"] = route_ops.meter_block_stats(
        y, state["out_rms_acc"], state["meter_coeff"])
    new_state["out_lufs"], out_lufs = loud_ops.meter_process(state["out_lufs"], y)
    metrics.update(
        output_clip_count=out_clip_count,
        output_clip_peak_db=out_clip_peak_db,
        output_peak_db=out_stats["peak_db"],
        output_rms_db=out_stats["rms_db"],
        output_crest_factor_db=out_stats["crest_factor_db"],
        output_lufs=out_lufs,
    )
    return new_state, y, metrics


# ---------------------------------------------------------------------------
# One stream, a burst of blocks at a time (the single-stream engine)
# ---------------------------------------------------------------------------

_EVIDENCE_KEYS = ("vad_probability", "vad_reliability", "noise_floor_db",
                  "live_noise_reliability")


def front_replay(config: LiveChainConfig, params, state, *, k_max: int = 8) -> BlockReplay:
    """The front half of one stream (``state`` and ``params`` with ``n=1``)
    as a :class:`BlockReplay`. A block's input row is the block, the VAD
    probability and its freshness (1.0 or 0.0); its outputs are ``y`` and
    the front half's metrics, one value each."""

    def step(st, block):
        vad = block["vad"]
        st, y, m = front_block(config, params, st, block["x"][None], vad[0:1],
                               vad[1:2] > 0.5)
        return st, {"y": y[0], **{k: v[0] for k, v in m.items()}}

    return BlockReplay(step, state, {"x": (BLOCK_SAMPLES,), "vad": (2,)},
                       device=state["in_rms_acc"].device, k_max=k_max)


def back_replay(config: LiveChainConfig, params, state, *, evidence: bool = True,
                k_max: int = 8) -> BlockReplay:
    """The back half of one stream as a :class:`BlockReplay`. A block's
    input row is the block and the auto makeup's evidence (the four values
    of ``_EVIDENCE_KEYS``; ignored with ``evidence=False``, which runs the
    compressor without evidence)."""

    def step(st, block):
        ev = None
        if evidence:
            e = block["evidence"]
            ev = {k: e[i:i + 1] for i, k in enumerate(_EVIDENCE_KEYS)}
        st, y, m = back_block(config, params, st, block["x"][None], ev)
        return st, {"y": y[0], **{k: v[0] for k, v in m.items()}}

    return BlockReplay(step, state,
                       {"x": (BLOCK_SAMPLES,), "evidence": (len(_EVIDENCE_KEYS),)},
                       device=state["in_rms_acc"].device, k_max=k_max)


def _host_rows(xs) -> np.ndarray:
    if isinstance(xs, torch.Tensor):
        xs = xs.detach().cpu().numpy()
    return np.asarray(xs, np.float32).reshape(-1, BLOCK_SAMPLES)


def _replay_for(replay, state, build):
    if replay is None:
        return build()
    if replay.state is not state:
        raise ValueError("the replay was built over another state tree")
    return replay


def front_run(config: LiveChainConfig, params, state, xs, vad_probability,
              vad_available, *, replay: BlockReplay | None = None):
    """The front half over ``xs [k, 480]`` of one stream, the same VAD
    snapshot for every block. ``state`` is updated in place and returned;
    outputs and metrics come back as host arrays with a leading ``k`` axis:
    ``(state, ys [k, 480], metrics)``. Pass the ``replay`` of
    :func:`front_replay` over this ``state`` to replay its graph; without
    one, a new one is built (on the card that is one capture per call)."""
    xs = _host_rows(xs)
    rows = np.empty((xs.shape[0], BLOCK_SAMPLES + 2), np.float32)
    rows[:, :BLOCK_SAMPLES] = xs
    rows[:, BLOCK_SAMPLES] = float(vad_probability)
    rows[:, BLOCK_SAMPLES + 1] = 1.0 if bool(vad_available) else 0.0
    replay = _replay_for(replay, state, lambda: front_replay(
        config, params, state, k_max=max(1, xs.shape[0])))
    out = replay.run(rows)
    return state, out.pop("y"), out


def back_run(config: LiveChainConfig, params, state, xs, evidence, *,
             replay: BlockReplay | None = None):
    """The back half over ``xs [k, 480]``; ``evidence`` maps the auto
    makeup's inputs to ``[k]`` values, or is None. Returns ``(state, ys,
    metrics)`` as :func:`front_run` does."""
    xs = _host_rows(xs)
    rows = np.zeros((xs.shape[0], BLOCK_SAMPLES + len(_EVIDENCE_KEYS)), np.float32)
    rows[:, :BLOCK_SAMPLES] = xs
    if evidence is not None:
        for i, k in enumerate(_EVIDENCE_KEYS):
            rows[:, BLOCK_SAMPLES + i] = np.asarray(evidence[k], np.float32).reshape(-1)
    replay = _replay_for(replay, state, lambda: back_replay(
        config, params, state, evidence=evidence is not None,
        k_max=max(1, xs.shape[0])))
    out = replay.run(rows)
    return state, out.pop("y"), out


def chain_latency_samples(config: LiveChainConfig, suppressor_latency: int = 0) -> int:
    """The chain's algorithmic latency: the suppressor's frames, the
    limiter's lookahead, the true-peak limiter's lookahead and its polyphase
    interpolator's group delay."""
    total = int(suppressor_latency) + lim_ops.latency_samples(config.limiter)
    if config.limiter_enabled:
        total += tp_ops.LIMITER_LOOKAHEAD_SAMPLES + (tp_ops.TAPS_PER_PHASE - 1) // 2
    return total
