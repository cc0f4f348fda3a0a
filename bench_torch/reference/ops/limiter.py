"""Lookahead hard limiter (counterpart of ``audioforge_tpu/ops/limiter.py``).

Decision peak over the (W+1)-sample window ``[t-W, t]``, target gain
``ceiling / peak`` above the ceiling, instant attack and one-pole release as
the max-affine recurrence on the gain deficit ``u = 1 - g``, W-sample delay,
hard clamp: everything after the window max is one
:func:`~.scan.limiter_gain_scan` call (one kernel launch on the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import util
from .scan import limiter_gain_scan, sliding_window_max


MAX_LOOKAHEAD_SAMPLES = 1024


@dataclass(frozen=True)
class LimiterConfig:
    ceiling_db: float = -1.0
    release_ms: float = 50.0
    lookahead_ms: float = 2.0
    sample_rate: float = 48000.0
    enabled: bool = True

    @property
    def lookahead_samples(self) -> int:
        w = round(min(max(self.lookahead_ms, 0.1), 10.0) / 1000.0
                  * self.sample_rate)
        return int(min(max(w, 1), MAX_LOOKAHEAD_SAMPLES))


def limiter_init(config: LimiterConfig, *, n: int, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "history": torch.zeros((n, config.lookahead_samples), **f32),
        "gain": torch.ones(n, **f32),
        "peak_gr_db": torch.zeros(n, **f32),
    }


def limiter_reset(state) -> dict:
    """An empty delay line and unity gain, the same shapes on the same
    device."""
    return {
        "history": torch.zeros_like(state["history"]),
        "gain": torch.ones_like(state["gain"]),
        "peak_gr_db": torch.zeros_like(state["peak_gr_db"]),
    }


def limiter_params(config: LimiterConfig, ceiling_db=None, release_ms=None):
    """Host control values (stacked per stream by the caller)."""
    ceiling_db = config.ceiling_db if ceiling_db is None else ceiling_db
    release_ms = config.release_ms if release_ms is None else release_ms
    return {
        "ceiling_linear": util.db_to_linear(ceiling_db),
        "release_coeff": util.time_constant_to_coeff(
            release_ms / 1000.0, config.sample_rate),
    }


def limiter_process(config: LimiterConfig, state, x, params):
    """Limit ``x: f32 [N, T]`` with per-stream ``params`` ``[N]`` tensors.
    Returns ``(new_state, y, {"peak_gr_db": [N]})``."""
    if not config.enabled:
        return state, x, {"peak_gr_db": torch.zeros_like(state["gain"])}
    W = config.lookahead_samples
    ext = torch.cat([state["history"], x], dim=-1)
    peak = sliding_window_max(ext.abs(), W + 1)[:, W:]
    # the delayed input is the history-extended block's first T samples
    y, gain_last, min_gain, _ = limiter_gain_scan(
        peak, ext[:, :x.shape[-1]], params["ceiling_linear"], params["release_coeff"],
        state["gain"], 1.0)
    block_gr_db = torch.where(
        min_gain < 1.0,
        -util.linear_to_db(torch.clamp_min(min_gain, 1e-10)), 0.0)
    new_state = {
        "history": ext[:, -W:].contiguous(),
        "gain": gain_last,
        "peak_gr_db": torch.maximum(state["peak_gr_db"], block_gr_db),
    }
    return new_state, y, {"peak_gr_db": block_gr_db}


def latency_samples(config: LimiterConfig) -> int:
    """The lookahead delay the limiter adds to the chain's latency."""
    return config.lookahead_samples if config.enabled else 0
