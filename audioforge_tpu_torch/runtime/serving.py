"""Multi-stream serving: N live streams advanced together, one block a step.

Counterpart of ``audioforge_tpu/runtime/serving.py``. Each step advances
every slot by one 480-sample block through the live chain's front half, the
frame-synchronous RNNoise suppressor and the back half. Slots are a fixed
capacity; attaching a stream marks its slot for a reset that blends fresh
state in before the block; detached slots process silence and their output
is dropped. Suppressor failures are per-slot state: a non-finite model
output falls back to the latency-aligned dry signal, and three such events
within 2 s soft-reset the model state (2 s cooldown).

The engine runs on the card unless it is given ``device="cpu"``; without a
CUDA device, building one for the card raises.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): in-step Silero VAD, the DeepFilterNet suppressors and stream-axis
sharding. ``step_pipelined``, the free-run loop and ``set_stream_eq`` are
not present.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import rnnoise
from . import live_chain as lc

__all__ = ["BLOCK", "ServingConfig", "ServingEngine"]

BLOCK = lc.BLOCK_SAMPLES  # 480 == the RNNoise frame

_NONFINITE_EVENTS_FOR_RESET = 3
_NONFINITE_WINDOW_BLOCKS = 200
_RESET_COOLDOWN_BLOCKS = 200
_STEP_TIME_HISTORY = 2048
_LATENCY_BUCKETS_MS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
_SUPPRESSOR_MODELS = ("rnnoise", "deepfilter-ll", "deepfilter")


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
        if self.suppressor_model not in (None, "rnnoise"):
            raise NotImplementedError(
                "DeepFilterNet suppressors are not ported yet (ROADMAP queue 1, "
                "DFN3)")
        if self.vad_enabled:
            raise NotImplementedError(
                "in-step Silero VAD is not ported yet (ROADMAP queue 1, in-step "
                "Silero and decimate3)")


def _supp_state_init(config: ServingConfig, device) -> dict:
    n = config.capacity
    i = lambda: torch.zeros(n, dtype=torch.int32, device=device)
    return {
        "model": rnnoise.rnnoise_state_init(n=n, device=device),
        "smoothed_strength": torch.ones(n, dtype=torch.float32, device=device),
        "dry_delay": torch.zeros((n, 1, BLOCK), dtype=torch.float32, device=device),
        "backend_failed": torch.zeros(n, dtype=torch.bool, device=device),
        "nonfinite_count": i(),
        "nonfinite_timer": i(),
        "reset_cooldown": i(),
        "soft_resets": i(),
    }


def _serving_state_init(config: ServingConfig, device, eq_bands=None) -> dict:
    state = {"chain": lc.live_init(config.chain, eq_bands, n=config.capacity,
                                   device=device)}
    if config.suppressor_model is not None:
        state["supp"] = _supp_state_init(config, device)
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


def _supp_step(config: ServingConfig, sp, state, x):
    """Frame-synchronous batched RNNoise with the per-slot failure latch,
    soft reset and one-frame dry delay. ``sp``: {weights, strength [N],
    enabled [N], smoothing_coeff}. Returns (new_state, y, metrics)."""
    scaled = torch.clamp(rnnoise.soft_clip(x) * rnnoise.PCM_SCALE,
                         -rnnoise.PCM_MODEL_LIMIT, rnnoise.PCM_MODEL_LIMIT)
    mstate, wet, aux = rnnoise.rnnoise_frame(sp["weights"], state["model"], scaled)
    wet = wet / rnnoise.PCM_SCALE

    finite = torch.isfinite(wet).all(dim=-1)
    wet = torch.where(finite[:, None], torch.nan_to_num(wet), 0.0)
    timer = torch.clamp_min(state["nonfinite_timer"] - 1, 0)
    count = torch.where(timer > 0, state["nonfinite_count"], 0)
    count = torch.where(~finite, count + 1, count)
    timer = torch.where(~finite, _NONFINITE_WINDOW_BLOCKS, timer)
    cooldown = torch.clamp_min(state["reset_cooldown"] - 1, 0)
    do_reset = (count >= _NONFINITE_EVENTS_FOR_RESET) & (cooldown == 0)
    fresh_model = rnnoise.rnnoise_state_init(n=config.capacity, device=x.device)
    mstate = _masked_reset(mstate, fresh_model, do_reset)
    count = torch.where(do_reset, 0, count)
    cooldown = torch.where(do_reset, _RESET_COOLDOWN_BLOCKS, cooldown)
    failed = state["backend_failed"]  # RNNoise resets, it never latches

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
        "suppressor_vad_probability": aux["vad"],
    }
    return new_state, y, metrics


def _serving_step(config: ServingConfig, params, state, fresh, x, active,
                  reset_mask, ext_vad_prob, ext_vad_avail):
    """One block for every slot. ``reset_mask`` None skips the slot reset
    (no slot was attached since the last step)."""
    if reset_mask is not None:
        state = _masked_reset(state, fresh, reset_mask, _SHARED)
    x = torch.where(active[:, None], x, 0.0)
    vad_prob, vad_avail = ext_vad_prob, ext_vad_avail

    chain, y, fm = lc.front_block(config.chain, params["chain"], state["chain"],
                                  x, vad_prob, vad_avail)
    sm = {}
    if config.suppressor_model is not None:
        sstate, y, sm = _supp_step(config, params["supp"], state["supp"], y)
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
    metrics = {**fm, **sm, **bm, "vad_probability": vad_prob,
               "vad_available": vad_avail}
    return new_state, y2, metrics


def _serving_scan(config: ServingConfig, params, state, fresh, xs, active,
                  reset_mask, ext_vad_prob, ext_vad_avail):
    """``xs: [n_blocks, N, 480]`` block by block; slot resets apply once,
    before the first block. Returns (state, ys, last block's metrics)."""
    if reset_mask is not None:
        state = _masked_reset(state, fresh, reset_mask, _SHARED)
    ys, metrics = [], None
    for xb in xs:
        state, y, metrics = _serving_step(config, params, state, fresh, xb,
                                          active, None, ext_vad_prob, ext_vad_avail)
        ys.append(y)
    return state, torch.stack(ys), metrics


def _stack_tree(tree, n):
    """One stream's host control tree -> ``[n]`` f32 numpy leaves."""
    if isinstance(tree, dict):
        return {k: _stack_tree(v, n) for k, v in tree.items()}
    return np.full(n, tree, dtype=np.float32)


def _write_tree(dst, tree, slot):
    for k, v in tree.items():
        if isinstance(v, dict):
            _write_tree(dst[k], v, slot)
        else:
            dst[k][slot] = np.float32(v)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.copy(tree), device=device)


class _Slot:
    __slots__ = ("active", "generation", "sink", "pending", "underruns", "blocks")

    def __init__(self):
        self.active = False
        self.generation = 0
        self.sink = None
        self.pending = np.zeros(0, np.float32)
        self.underruns = 0
        self.blocks = 0


class ServingEngine:
    """N-stream serving engine around one batched block step.

    Usage::

        eng = ServingEngine(ServingConfig(capacity=16))   # on the card
        slot = eng.attach(sink=lambda block: ...)   # block: float32[480]
        eng.push(slot, samples)                     # 48 kHz mono
        eng.step()                                  # or eng.step_many(k)
        eng.set_stream_params(slot, compressor_threshold_db=-24.0)
        eng.stream_diagnostics(slot)
        eng.detach(slot)
    """

    def __init__(self, config: ServingConfig | None = None, *, device="cuda",
                 eq_bands=None, sharding=None, rnnoise_weights=None):
        if sharding is not None:
            raise NotImplementedError(
                "stream-axis sharding is not ported yet (ROADMAP queue 1, "
                "multi-GPU)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine runs on a CUDA device by default and none is "
                "available: pass device='cpu' to run the plain PyTorch path")
        self.config = config or ServingConfig()
        n = self.config.capacity
        self._lock = threading.Lock()
        self._slots = [_Slot() for _ in range(n)]
        self._reset_pending = np.zeros(n, bool)
        self._fresh = _serving_state_init(self.config, self.device, eq_bands)
        self._state = self._fresh
        self._last_metrics = None
        self._chain_kw = {}
        self._params = {"chain": _stack_tree(lc.live_params(self.config.chain), n)}
        self._weights = {}
        if self.config.suppressor_model is not None:
            if rnnoise_weights is None:
                path = rnnoise.discover_model_path()
                if path is None:
                    raise FileNotFoundError(
                        "no RNNoise weight archive: set RNNOISE_MODEL_PATH or "
                        "provide models/rnnoise.npz")
                rnnoise_weights = rnnoise.load_weights(path, self.device)
            self._weights["supp"] = {k: v.to(self.device)
                                     for k, v in rnnoise_weights.items()}
            self._params["supp"] = {
                "strength": np.ones(n, np.float32),
                "enabled": np.ones(n, bool),
                "smoothing_coeff": np.float32(1.0 - np.exp(-(BLOCK / 48000.0) / 0.015)),
            }
        self._params_dirty = True
        self._params_device = None
        self.steps = 0
        self.last_step_seconds = 0.0
        self._step_times = collections.deque(maxlen=_STEP_TIME_HISTORY)

    # ------------------------------------------------------------- streams
    @property
    def capacity(self) -> int:
        return self.config.capacity

    @property
    def occupancy(self) -> int:
        with self._lock:
            return sum(s.active for s in self._slots)

    def attach(self, sink=None) -> int:
        """Claim a free slot; its state resets before the next block.
        Returns the slot id; raises when full."""
        with self._lock:
            for i, s in enumerate(self._slots):
                if not s.active:
                    s.active = True
                    s.generation += 1
                    s.sink = sink
                    s.pending = np.zeros(0, np.float32)
                    s.underruns = 0
                    s.blocks = 0
                    self._reset_pending[i] = True
                    self._chain_kw[i] = {}
                    _write_tree(self._params["chain"],
                                lc.live_params(self.config.chain), i)
                    if self.config.suppressor_model is not None:
                        self._params["supp"]["strength"][i] = 1.0
                        self._params["supp"]["enabled"][i] = True
                    self._params_dirty = True
                    return i
        raise RuntimeError("serving engine full")

    def detach(self, slot: int) -> None:
        with self._lock:
            s = self._slots[slot]
            s.active = False
            s.sink = None
            s.pending = np.zeros(0, np.float32)

    def push(self, slot: int, samples) -> None:
        """Queue 48 kHz mono samples for a stream."""
        with self._lock:
            s = self._slots[slot]
            if not s.active:
                raise ValueError(f"slot {slot} is not attached")
            s.pending = np.concatenate(
                [s.pending, np.asarray(samples, np.float32).ravel()])

    # ------------------------------------------------------------- control
    def set_stream_params(self, slot: int, **kwargs) -> None:
        """Update a stream's continuous controls (any
        :func:`live_chain.live_params` keyword)."""
        with self._lock:
            kw = self._chain_kw.setdefault(slot, {})
            kw.update(kwargs)
            _write_tree(self._params["chain"],
                        lc.live_params(self.config.chain, **kw), slot)
            self._params_dirty = True

    def set_stream_suppressor(self, slot: int, *, strength=None, enabled=None):
        if self.config.suppressor_model is None:
            raise ValueError("serving config has no suppressor stage")
        with self._lock:
            if strength is not None:
                self._params["supp"]["strength"][slot] = float(
                    np.clip(strength, 0.0, 1.0))
            if enabled is not None:
                self._params["supp"]["enabled"][slot] = bool(enabled)
            self._params_dirty = True

    # ---------------------------------------------------------------- step
    def _device_params(self):
        """Control tensors on the device, refreshed only after a write."""
        if self._params_dirty or self._params_device is None:
            staged = _to_device(self._params, self.device)
            for group, weights in self._weights.items():
                staged[group] = dict(staged[group], weights=weights)
            self._params_device = staged
            self._params_dirty = False
        return self._params_device

    def _gather(self, n_blocks: int):
        n = self.config.capacity
        x = np.zeros((n_blocks, n, BLOCK), np.float32)
        active = np.zeros(n, bool)
        with self._lock:
            reset = self._reset_pending.copy()
            self._reset_pending[:] = False
            for i, s in enumerate(self._slots):
                if not s.active:
                    continue
                active[i] = True
                want = n_blocks * BLOCK
                take = min(want, s.pending.size)
                if take:
                    got = s.pending[:take]
                    s.pending = s.pending[take:]
                    full, rem = divmod(take, BLOCK)
                    for b in range(full):
                        x[b, i] = got[b * BLOCK:(b + 1) * BLOCK]
                    if rem:
                        x[full, i, :rem] = got[full * BLOCK:]
                if take < want:
                    s.underruns += -(-(want - take) // BLOCK)
            params = self._device_params()
        dev = self.device
        reset_t = torch.as_tensor(reset, device=dev) if reset.any() else None
        return (torch.as_tensor(x, device=dev), torch.as_tensor(active, device=dev),
                reset_t, params)

    def _ext_vad(self, prob, avail):
        n = self.config.capacity
        prob = np.zeros(n, np.float32) if prob is None else prob
        avail = np.zeros(n, bool) if avail is None else avail
        return (torch.as_tensor(np.asarray(prob, np.float32), device=self.device),
                torch.as_tensor(np.asarray(avail, bool), device=self.device))

    def step(self, ext_vad_prob=None, ext_vad_avail=None):
        """Advance every stream by one block. Returns per-slot metrics."""
        t0 = time.perf_counter()
        x, active, reset, params = self._gather(1)
        vp, va = self._ext_vad(ext_vad_prob, ext_vad_avail)
        self._state, y, metrics = _serving_step(
            self.config, params, self._state, self._fresh, x[0], active, reset,
            vp, va)
        self._deliver(y.cpu().numpy()[None], 1)
        self._last_metrics = metrics
        self.steps += 1
        self.last_step_seconds = time.perf_counter() - t0
        self._step_times.append(self.last_step_seconds)
        return metrics

    def step_many(self, n_blocks: int, ext_vad_prob=None, ext_vad_avail=None):
        """Advance every stream by ``n_blocks`` blocks, delivering them
        together. Returns the final block's per-slot metrics."""
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        t0 = time.perf_counter()
        x, active, reset, params = self._gather(n_blocks)
        vp, va = self._ext_vad(ext_vad_prob, ext_vad_avail)
        self._state, ys, metrics = _serving_scan(
            self.config, params, self._state, self._fresh, x, active, reset,
            vp, va)
        self._deliver(ys.cpu().numpy(), n_blocks)
        self._last_metrics = metrics
        self.steps += n_blocks
        self.last_step_seconds = time.perf_counter() - t0
        self._step_times.extend([self.last_step_seconds / n_blocks] * n_blocks)
        return metrics

    def _deliver(self, ys, n_blocks: int) -> None:
        """``ys: [n_blocks, N, BLOCK]`` host array -> per-slot sinks."""
        with self._lock:
            targets = [(i, s) for i, s in enumerate(self._slots) if s.active]
            for _, s in targets:
                s.blocks += n_blocks
        for i, s in targets:
            if s.sink is not None:
                for b in range(n_blocks):
                    s.sink(ys[b, i])

    # --------------------------------------------------------- diagnostics
    def stream_diagnostics(self, slot: int) -> dict:
        """Last-step metrics for one stream as host numbers."""
        with self._lock:
            s = self._slots[slot]
            out = {"active": s.active, "generation": s.generation,
                   "blocks_processed": s.blocks, "underrun_count": s.underruns}
        m = self._last_metrics
        if m is not None:
            for key in ("input_peak_db", "input_rms_db", "gate_gain",
                        "gate_is_open", "gate_threshold_db", "noise_floor_db",
                        "noise_floor_reliability", "vad_probability",
                        "vad_available", "compressor_gain_reduction_db",
                        "compressor_makeup_gain_db", "limiter_gain_reduction_db",
                        "tp_gain_reduction_db", "output_peak_db", "output_rms_db",
                        "output_lufs", "output_true_peak"):
                if key in m:
                    out[key] = float(m[key][slot])
            for key in ("suppressor_backend_failed", "suppressor_soft_resets",
                        "suppressor_nonfinite"):
                if key in m:
                    out[key] = int(m[key][slot])
        return out

    def latency_histogram(self) -> dict:
        """Per-block step-time distribution (ms) over recent blocks; fused
        spans contribute their per-block share."""
        times_ms = np.asarray(self._step_times, np.float64) * 1000.0
        edges = list(_LATENCY_BUCKETS_MS)
        counts = [0] * (len(edges) + 1)
        for i in np.searchsorted(edges, times_ms, side="left"):
            counts[int(i)] += 1
        out = {"samples": int(times_ms.size),
               "bucket_upper_bounds_ms": edges + [float("inf")],
               "bucket_counts": counts}
        if times_ms.size:
            out.update(p50_ms=float(np.percentile(times_ms, 50)),
                       p95_ms=float(np.percentile(times_ms, 95)),
                       p99_ms=float(np.percentile(times_ms, 99)),
                       max_ms=float(times_ms.max()))
        return out

    def engine_diagnostics(self) -> dict:
        return {
            "capacity": self.capacity,
            "occupancy": self.occupancy,
            "steps": self.steps,
            "last_step_seconds": self.last_step_seconds,
            "suppressor_model": self.config.suppressor_model,
            "vad_enabled": self.config.vad_enabled,
            "device": str(self.device),
            "step_latency": self.latency_histogram(),
        }
