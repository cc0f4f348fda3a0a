"""Offline DSP chain over a batch of streams: de-esser <-> EQ, compressor,
lookahead limiter and true-peak limiter, with per-block stats.

Counterpart of ``audioforge_tpu/runtime/chain.py``. The stage order, the
stats (input/output sample peak, pre-limiter and output true peak, limiter
and true-peak GR, limited events, compressor and de-esser GR) and the final
true-peak limiter's ceiling (the main limiter's) are the reference's.

- Any batch shape is flattened to a stream axis ``[N]`` first; stats come
  back as ``[..., n_blocks]`` and audio as ``[..., n_blocks, T]``.
- Compressor parameters are ``[N]`` tensors (:func:`comp_param_tensors`): a
  candidate sweep is a batch of streams, one parameter set each.
- The EQ is the static compacted cascade (``ops/eq.py``
  :func:`~audioforge_tpu_torch.ops.eq.compact_cascade`): identity sections
  dropped at init, the reference's order kept in one ``(S, 5)`` array with
  f64 state, one ``biquad_cascade`` launch a block, none for a flat EQ.
- ``fused=True`` names the reference's TPU fusion of de-esser, EQ and
  compressor into one scan; here those stages run as three kernels in the
  same order either way.
- :func:`chain_run` runs a take as one CUDA graph replay a block on the card
  (:mod:`.replay`) and the same step eagerly on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cache

import numpy as np
import torch

from .. import kernels
from ..ops import biquad
from ..ops import compressor as comp_ops
from ..ops import deesser as des_ops
from ..ops import eq as eq_ops
from ..ops import limiter as lim_ops
from ..ops import true_peak as tp_ops
from ..ops import util
from .replay import run_take

__all__ = [
    "ChainConfig", "CAREFUL_OUTPUT_CEILING_DB", "STAT_KEYS", "effective_limiter_ceiling_db",
    "comp_param_tensors", "chain_init", "chain_block", "chain_run",
]

CAREFUL_OUTPUT_CEILING_DB = -1.5

STAT_KEYS = (
    "input_sample_peak", "deesser_gain_reduction_db", "compressor_gain_reduction_db",
    "limiter_peak_gain_reduction_db", "true_peak_limiter_input_peak",
    "true_peak_limiter_gain_reduction_db", "true_peak_limited_events",
    "output_sample_peak", "output_true_peak",
)


def effective_limiter_ceiling_db(ceiling_db: float, careful_output_enabled: bool) -> float:
    """The careful-output ceiling caps the limiter at -1.5 dBFS."""
    return min(ceiling_db, CAREFUL_OUTPUT_CEILING_DB) if careful_output_enabled else ceiling_db


@dataclass(frozen=True)
class ChainConfig:
    """Static chain structure; the compressor's numeric parameters are
    per-stream tensors, the EQ's coefficients live in the state."""

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
    # the reference's fused de-esser -> EQ -> compressor scan; the same three
    # kernels in the same order here
    fused: bool = False


def comp_param_tensors(comp_params, n: int, device) -> dict:
    """Compressor parameters (host floats, arrays or tensors, each a scalar or
    one value a stream) -> ``[n]`` f32 tensors on ``device``."""
    if comp_params is None:
        comp_params = comp_ops.compressor_params(comp_ops.CompressorConfig())
    out = {}
    for k, v in comp_params.items():
        t = (v.to(device=device, dtype=torch.float32) if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v, np.float32), device=device))
        out[k] = t.reshape(-1).expand(n).contiguous() if t.numel() == 1 else t.reshape(n)
    return out


def chain_init(config: ChainConfig, comp_params=None, eq_bands=None, batch_shape=(),
               device="cuda") -> dict:
    """Fresh chain state for ``prod(batch_shape)`` streams on ``device`` (a
    CUDA device unless asked otherwise). ``eq_bands``: a list of
    ``EqBandConfig``, or None for the default (flat) layout."""
    dev = kernels.resolve_device(device, "chain_init")
    n = math.prod(batch_shape)
    full = eq_ops.bands_to_sections(
        eq_ops.default_bands() if eq_bands is None else eq_bands, config.sample_rate)
    c_lo, c_hi = eq_ops.compact_cascade(full)
    coeffs = np.concatenate([c_lo, c_hi], axis=0).astype(np.float32)
    comp = comp_ops.compressor_init(config.compressor, n=n, device=dev)
    if comp_params is not None:
        p = comp_param_tensors(comp_params, n, dev)
        comp["current_release_ms"] = p["base_release_ms"].clone()
        comp["smoothed_makeup_gain"] = p["makeup_gain_db"].clone()
    return {
        "deesser": des_ops.deesser_init(config.deesser, n=n, device=dev),
        "eq": {"c": torch.as_tensor(coeffs, device=dev),
               "z": torch.zeros((n, coeffs.shape[0], 2), dtype=torch.float64,
                                device=dev)},
        "compressor": comp,
        "limiter": lim_ops.limiter_init(config.limiter, n=n, device=dev),
        "tp": tp_ops.tp_limiter_init(n=n, device=dev),
        "tp_detector": tp_ops.detector_init(n=n, device=dev),
    }


# device constants are cached without bound: a captured CUDA graph reads them
# by address
@cache
def _limiter_tensors(limiter: lim_ops.LimiterConfig, n: int, device: torch.device):
    f = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
    p = lim_ops.limiter_params(limiter)
    return ({k: f(v) for k, v in p.items()},
            f(util.db_to_linear(limiter.ceiling_db)))


def _chain_tail(config: ChainConfig, new_state, y, stats):
    """Limiter -> true-peak limiter -> output metering."""
    zeros = torch.zeros_like(stats["input_sample_peak"])
    if config.limiter_enabled:
        lim_params, ceiling = _limiter_tensors(config.limiter, y.shape[0], y.device)
        ls, y, lm = lim_ops.limiter_process(config.limiter, new_state["limiter"], y,
                                            lim_params)
        new_state["limiter"] = ls
        stats["limiter_peak_gain_reduction_db"] = lm["peak_gr_db"]
        tp_cfg = tp_ops.TruePeakLimiterConfig(
            ceiling_db=config.limiter.ceiling_db, release_ms=config.tp_release_ms,
            sample_rate=config.sample_rate)
        ts, y, tm = tp_ops.tp_limiter_process(tp_cfg, new_state["tp"], y, ceiling)
        new_state["tp"] = ts
        stats["true_peak_limiter_input_peak"] = tm["input_true_peak"]
        stats["true_peak_limiter_gain_reduction_db"] = tm["max_gain_reduction_db"]
        stats["true_peak_limited_events"] = tm["limited_events"]
    else:
        stats["limiter_peak_gain_reduction_db"] = zeros
        stats["true_peak_limiter_input_peak"] = zeros
        stats["true_peak_limiter_gain_reduction_db"] = zeros
        stats["true_peak_limited_events"] = torch.zeros_like(zeros, dtype=torch.int32)
    stats["output_sample_peak"] = y.abs().amax(dim=-1)
    td, otp = tp_ops.detector_process(new_state["tp_detector"], y)
    new_state["tp_detector"] = td
    stats["output_true_peak"] = otp
    return new_state, y, stats


def chain_block(config: ChainConfig, comp_params, state, x):
    """Process one block ``x: f32 [N, T]``; ``comp_params`` are ``[N]``
    tensors (:func:`comp_param_tensors`). Returns ``(state, y, stats)``."""
    stats = {"input_sample_peak": x.abs().amax(dim=-1)}
    new_state = dict(state)
    zeros = torch.zeros_like(stats["input_sample_peak"])
    stats["deesser_gain_reduction_db"] = zeros

    def run_deesser(y):
        ds, y, dm = des_ops.deesser_process(config.deesser, new_state["deesser"], y)
        new_state["deesser"] = ds
        stats["deesser_gain_reduction_db"] = dm["reduction_db"]
        return y

    def run_eq(y):
        es = new_state["eq"]
        if es["c"].shape[0] == 0:  # a flat EQ: nothing to launch
            return y
        y, z = biquad.apply_fixed(es["c"], es["z"], y)
        new_state["eq"] = {"c": es["c"], "z": z}
        return y

    y = x
    stages = ((config.eq_enabled, run_eq), (config.deesser_enabled, run_deesser))
    for enabled, run in (stages if config.eq_before_deesser else stages[::-1]):
        if enabled:
            y = run(y)
    if config.compressor_enabled:
        cs, y, cm = comp_ops.compressor_process(config.compressor, comp_params,
                                                new_state["compressor"], y)
        new_state["compressor"] = cs
        stats["compressor_gain_reduction_db"] = cm["gain_reduction_db"]
    else:
        stats["compressor_gain_reduction_db"] = zeros
    return _chain_tail(config, new_state, y, stats)


def chain_run(config: ChainConfig, comp_params, state, blocks, return_audio=True):
    """Run a take: ``blocks`` is ``[..., n_blocks, T]`` on the device of
    ``state`` (zero-pad the tail). Returns ``(final_state, output blocks or
    None, stats)`` with each stats entry ``[..., n_blocks]``. With
    ``return_audio=False`` no output audio is kept."""
    blocks = torch.as_tensor(blocks)
    *batch, n_blocks, T = blocks.shape
    n = math.prod(batch)
    x = blocks.reshape(n, n_blocks, T)
    params = comp_param_tensors(comp_params, n, x.device)

    def step(st, block):
        st, y, stats = chain_block(config, params, st, block["x"])
        if return_audio:
            stats["y"] = y
        return st, stats

    final, rows = run_take(step, state, {"x": x.transpose(0, 1)}, n_blocks)
    ys = None
    if return_audio:
        y = rows.pop("y") if rows else x.new_zeros((0, n, T))
        ys = y.transpose(0, 1).reshape(*batch, n_blocks, T)
    if not rows:  # an empty take
        rows = {k: torch.zeros((0, n), device=x.device,
                               dtype=torch.int32 if k == "true_peak_limited_events"
                               else torch.float32) for k in STAT_KEYS}
    stats = {k: v.t().reshape(*batch, n_blocks) for k, v in rows.items()}
    return final, ys, stats
