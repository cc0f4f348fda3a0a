"""Multi-stream serving: N live streams advanced together, one block a step.

Counterpart of ``audioforge_tpu/runtime/serving.py``. Each step advances
every slot by one 480-sample block through the in-step Silero VAD (when
``vad_enabled``), the live chain's front half, the frame-synchronous
suppressor (RNNoise, DeepFilterNet3-LL or the standard DeepFilterNet3) and
the back half. Slots are a fixed capacity; attaching a stream marks its slot
for a reset that blends fresh state in before the block; detached slots
process silence and their output is dropped. Suppressor failures are
per-slot state: a non-finite model output falls back to the latency-aligned
dry signal (one block behind, three for the standard DeepFilterNet3), three
such events within 2 s soft-reset the model state (2 s cooldown), and the
standard DeepFilterNet3 latches the slot to the dry signal for good.

The engine keeps its inputs, controls and state in static buffers. On the
card a block step is one replay of a CUDA graph of :func:`_serving_step`,
captured at the first step (the counterpart of the reference's one jitted
step), which also copies the new state back into the static state; a slot
reset, a staged EQ program and a control write are applied to the static
buffers before the replay. On the CPU the same code calls
:func:`_serving_step` eagerly in place of the replay.

Every call form runs one host path: take the slots' audio at the call's
start, fill a pinned host buffer, launch (the rows to the device, a replay a
block, one copy back), land (wait, unpack) and deliver to the slots the
audio was taken from. ``step`` lands its block at once; ``step_pipelined``
lands block t-1 while block t runs; ``step_many`` runs in chunks of
:data:`CHUNK_BLOCKS` blocks, filling chunk j+1 and delivering chunk j-1
while the card runs chunk j; ``start`` runs the free-run loop.

The engine runs on the card unless it is given ``device="cpu"``; without a
CUDA device, building one for the card raises.

With ``sharding`` (a :class:`~audioforge_tpu_torch.parallel.FleetMesh`) the
slots split into equal contiguous ranges, one a shard, as the JAX engine
shards its stream axis: each shard keeps its own state, controls and graph
on its device (the shared leaves copied to each), every shard's replay is
issued before any is waited on, and the host's slot bookkeeping, staging
buffers and sinks stay one. No collective runs inside a step.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..models import dfn3, rnnoise, silero
from ..ops import eq as eq_ops
from ..ops import resample
from ..parallel.fleet import device_scope, mesh_devices
from . import live_chain as lc
from . import tracing
from .replay import capture_graph
from .replay import clone_tree as _clone_tree
from .replay import copy_into as _copy_into
from .replay import leaf_pairs as _leaf_pairs

__all__ = ["BLOCK", "ServingConfig", "ServingEngine"]

BLOCK = lc.BLOCK_SAMPLES  # 480 == the RNNoise frame

_NONFINITE_EVENTS_FOR_RESET = 3
_NONFINITE_WINDOW_BLOCKS = 200
_RESET_COOLDOWN_BLOCKS = 200
_STEP_TIME_HISTORY = 2048
_LATENCY_BUCKETS_MS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
_SUPPRESSOR_MODELS = ("rnnoise", "deepfilter-ll", "deepfilter")
# step_many's pipeline stage: blocks a chunk (80 ms of audio). The head and
# tail of a call, which nothing overlaps, cost about a chunk's host work
CHUNK_BLOCKS = 8
# the device events of a replay: its start, then the end of each stage
STAGE_MARKS = ("start", "vad", "front", "suppressor", "back", "copy_back")

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
                  reset_mask, ext_vad_prob, ext_vad_avail, mark=None):
    """One block for every slot, a pure function of its arguments.
    ``reset_mask`` None skips the slot reset (the engine resets its static
    state before the step instead). With ``vad_enabled`` the in-step
    probability replaces the external one. ``mark(stage)``, when given, is
    called at the end of the stages "vad", "front", "suppressor" and "back"
    (the engine records a device event there)."""
    if reset_mask is not None:
        state = _masked_reset(state, fresh, reset_mask, _SHARED)
    x = torch.where(active[:, None], x, 0.0)
    if config.vad_enabled:
        vstate, vad_prob, vad_avail = _vad_step(params["vad"], state["vad"], x)
    else:
        vad_prob, vad_avail = ext_vad_prob, ext_vad_avail
    if mark is not None:
        mark("vad")

    chain, y, fm = lc.front_block(config.chain, params["chain"], state["chain"],
                                  x, vad_prob, vad_avail)
    if mark is not None:
        mark("front")
    sm = {}
    if config.suppressor_model is not None:
        sstate, y, sm = _supp_step(config, params["supp"], state["supp"],
                                   fresh["supp"]["model"], y)
    if mark is not None:
        mark("suppressor")
    evidence = {
        "vad_probability": vad_prob,
        "vad_reliability": vad_avail.to(torch.float32),
        "noise_floor_db": fm["noise_floor_db"],
        "live_noise_reliability": fm["noise_floor_reliability"],
    }
    chain, y2, bm = lc.back_block(config.chain, params["chain"], chain, y, evidence)
    if mark is not None:
        mark("back")
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


def _host_rows(tree, lo: int, hi: int):
    """The rows ``[lo, hi)`` of a host control tree; a leaf every stream
    shares (0-d) is kept whole."""
    if isinstance(tree, dict):
        return {k: _host_rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi] if np.ndim(tree) else tree


def _state_rows(tree, lo: int, hi: int, device, path=()):
    """Copies on ``device`` of the rows ``[lo, hi)`` of a state tree: every
    leaf has its stream on axis 0 except those in ``_SHARED``, which are
    copied whole."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _state_rows(v, lo, hi, device, p)
        else:
            out[k] = (v if p in _SHARED else v[lo:hi]).to(device, copy=True)
    return out


def _copy_host_tree(dst, src) -> None:
    """Copy a tree of numpy leaves into the tensors of ``dst``."""
    for k, d in dst.items():
        if isinstance(d, dict):
            _copy_host_tree(d, src[k])
        else:
            d.copy_(torch.from_numpy(np.array(src[k])), non_blocking=True)


def _kept(metrics: dict) -> dict:
    """Copies of a step's metrics, which the next step does not overwrite."""
    out = {k: torch.empty_like(v) for k, v in metrics.items()}
    torch._foreach_copy_(list(out.values()), list(metrics.values()))
    return out


class _Slot:
    __slots__ = ("active", "generation", "sink", "pending", "underruns", "blocks")

    def __init__(self):
        self.active = False
        self.generation = 0
        self.sink = None
        self.pending = np.zeros(0, np.float32)
        self.underruns = 0
        self.blocks = 0


class _Shard:
    """The device side of the engine's slots ``[lo, hi)``: their static state,
    fresh state, control tree and step inputs on ``device``, the staging rows
    of a chunk's input and output, the CUDA graph of their step and the
    device events it records (``STAGE_MARKS``)."""

    __slots__ = ("device", "lo", "hi", "_fresh", "_state", "_params_static", "_params_dev",
                 "_x", "_xs", "_ys", "_active", "_active_host", "_vad_prob", "_vad_avail",
                 "_graph", "_graph_out", "_graph_launches", "_marks", "capture_seconds")

    def __init__(self, device, lo: int, hi: int, fresh: dict, params: dict, weights: dict):
        n = hi - lo
        self.device, self.lo, self.hi = device, lo, hi
        self._fresh = fresh
        self._state = _clone_tree(fresh)  # the static state buffers
        # static inputs of the step: the control tree (written after a
        # control write), the block, the active mask and the external VAD
        self._params_static = _to_device(params, device)
        self._params_dev = {k: dict(v, weights=weights[k]) if k in weights else v
                            for k, v in self._params_static.items()}
        self._x = torch.zeros((n, BLOCK), dtype=torch.float32, device=device)
        # a chunk's input rows [n, blocks, BLOCK] and its output blocks
        # [blocks, n, BLOCK], flat
        self._xs = torch.zeros(n * CHUNK_BLOCKS * BLOCK, dtype=torch.float32, device=device)
        self._ys = torch.zeros_like(self._xs)
        self._active = torch.zeros(n, dtype=torch.bool, device=device)
        self._active_host = np.zeros(n, bool)
        self._vad_prob = torch.zeros(n, dtype=torch.float32, device=device)
        self._vad_avail = torch.zeros(n, dtype=torch.bool, device=device)
        self._graph = None
        self._graph_out = None
        self._graph_launches = {}
        self._marks = None
        self.capture_seconds = None


class ServingEngine:
    """N-stream serving engine around one batched block step.

    Usage::

        eng = ServingEngine(ServingConfig(capacity=16))   # on the card
        slot = eng.attach(sink=lambda block: ...)   # block: float32[480]
        eng.push(slot, samples)                     # 48 kHz mono
        eng.step()                                  # or step_many(k), start()
        eng.set_stream_params(slot, compressor_threshold_db=-24.0)
        eng.stream_diagnostics(slot)
        eng.detach(slot)

    ``sharding``: a :class:`~audioforge_tpu_torch.parallel.FleetMesh` of S
    devices splits the slots into S equal ranges (shard ``k`` owns slots
    ``[k*C/S, (k+1)*C/S)``), each with its own state, controls and graph on
    its device; the host side (slots, staging, sinks) stays one. Every
    shard's replay starts before any is waited on. Metrics come back as
    ``[N]`` tensors on the mesh's first device, which is also the engine's
    ``device``.
    """

    def __init__(self, config: ServingConfig | None = None, *, device=None,
                 eq_bands=None, sharding=None, rnnoise_weights=None,
                 dfn_weights=None, vad_weights=None):
        self.config = config or ServingConfig()
        n = self.config.capacity
        devices = self._shard_devices(device, sharding, n)
        self.device = dev = devices[0]
        self.sharding = sharding
        self._lock = threading.RLock()
        self._slots = [_Slot() for _ in range(n)]
        self._reset_pending = np.zeros(n, bool)
        self._pending_eq = {}
        self._eq_layout = eq_ops.eq_layout(eq_bands)
        self._last_metrics = None
        self._chain_kw = {}
        self._params = {"chain": _stack_tree(lc.live_params(self.config.chain), n)}
        weights = {}
        model = self.config.suppressor_model
        if model is not None:
            if model == "rnnoise":
                if rnnoise_weights is None:
                    path = rnnoise.discover_model_path()
                    if path is None:
                        raise FileNotFoundError(
                            "no RNNoise weight archive: set RNNOISE_MODEL_PATH or "
                            "provide models/rnnoise.npz")
                    rnnoise_weights = rnnoise.load_weights(path, dev)
                supp_weights = rnnoise_weights
            else:
                supp_weights = dfn_weights or dfn3.default_params(model == "deepfilter-ll")
            weights["supp"] = supp_weights
            self._params["supp"] = {
                "strength": np.ones(n, np.float32),
                "enabled": np.ones(n, bool),
                "smoothing_coeff": np.float32(1.0 - np.exp(-(BLOCK / 48000.0) / 0.015)),
            }
            if model != "rnnoise":
                self._params["supp"].update(
                    atten_lim_db=np.float32(dfn3.DEFAULT_ATTEN_LIM_DB),
                    post_filter_beta=np.float32(dfn3.DEFAULT_POST_FILTER_BETA))
        if self.config.vad_enabled:
            weights["vad"] = vad_weights or silero.default_params()
            self._params["vad"] = {"pre_gain": np.float32(1.0),
                                   "smoothing": np.float32(0.5)}
        fresh = _serving_state_init(self.config, dev, eq_bands)
        rows = n // len(devices)
        self._rows_per_shard = rows
        self._shards = []
        for k, d in enumerate(devices):
            lo, hi = k * rows, (k + 1) * rows
            with device_scope(d):
                self._shards.append(_Shard(
                    d, lo, hi, fresh if len(devices) == 1 else _state_rows(fresh, lo, hi, d),
                    _host_rows(self._params, lo, hi),
                    {g: {name: w.to(d) for name, w in ws.items()}
                     for g, ws in weights.items()}))
        self._params_dirty = False
        self._vad_host = (np.zeros(n, np.float32), np.zeros(n, bool))
        self._free_bufs = []
        self._inflight = None
        self._thread = None
        self._running = False
        self.realtime_pacing = False
        self.pipelined_loop = True
        self.steps = 0
        self.last_step_seconds = 0.0
        self._step_times = collections.deque(maxlen=_STEP_TIME_HISTORY)

    @staticmethod
    def _shard_devices(device, sharding, capacity: int) -> tuple:
        """The shards' devices: the one ``device`` (the card by default)
        without ``sharding``, else the mesh's, ``device`` (when given) being
        its first."""
        if sharding is None:
            return (kernels.resolve_device("cuda" if device is None else device,
                                           "ServingEngine"),)
        devices = mesh_devices(sharding, device, "ServingEngine")
        if capacity % len(devices):
            raise ValueError(f"capacity {capacity} does not split into "
                             f"{len(devices)} equal shards")
        return devices

    @property
    def capture_seconds(self):
        """Seconds the shards' graph captures took, summed; None before
        every shard has captured."""
        secs = [sh.capture_seconds for sh in self._shards]
        return None if None in secs else sum(secs)

    def _shard_of(self, slot: int) -> tuple:
        """(shard, the slot's row in it)."""
        k, row = divmod(slot, self._rows_per_shard)
        return self._shards[k], row

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
                    self._pending_eq.pop(i, None)  # stale staged EQ
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
            self._pending_eq.pop(slot, None)

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

    def set_stream_eq(self, slot: int, eq_bands) -> None:
        """Replace one stream's EQ program (``eq_bands``: a list of
        :class:`~audioforge_tpu_torch.ops.eq.EqBandConfig`, None for the
        flat default). Staged like a slot reset: the fresh EQ state is
        recorded under the lock and written into the slot's rows at the next
        block boundary; a slot reset in that step takes it one step later.
        Raises when the bands need another section layout than the engine's
        EQ was built with."""
        layout = eq_ops.eq_layout(eq_bands)
        if layout != self._eq_layout:
            raise ValueError(
                f"EQ bands need the section layout {layout}, the engine's EQ "
                f"has {self._eq_layout}: build the engine with eq_bands of "
                "that layout")
        fresh_eq = eq_ops.eq_init(eq_bands, self.config.chain.sample_rate, n=1,
                                  device="cpu")
        with self._lock:
            self._pending_eq[slot] = fresh_eq

    # ---------------------------------------------------------------- step
    def _begin_step(self) -> np.ndarray:
        """Under the lock, at a step's start: take the pending slot resets,
        and write the staged EQ programs and the control writes into every
        shard's static buffers (eager device work outside the graph, under
        an "engine.reset" span). Returns the reset mask."""
        reset = self._reset_pending.copy()
        self._reset_pending[:] = False
        # a slot reset in this step would wipe its EQ surgery: it takes the
        # staged program one step later
        staged = [s for s in self._pending_eq if not reset[s]]
        if staged or self._params_dirty:
            with tracing.span("engine.reset"):
                self._write_controls(staged)
        return reset

    def _write_masks(self, reset: np.ndarray, active: np.ndarray) -> None:
        """Blend fresh state into the reset slots (under an "engine.reset"
        span) and write the active mask where it changed, on every shard."""
        if reset.any():
            with tracing.span("engine.reset"):
                for sh in self._shards:
                    if reset[sh.lo:sh.hi].any():
                        with device_scope(sh.device):
                            mask = torch.from_numpy(reset[sh.lo:sh.hi]).to(
                                sh.device, non_blocking=True)
                            _copy_into(sh._state,
                                       _masked_reset(sh._state, sh._fresh, mask, _SHARED))
        for sh in self._shards:
            mine = active[sh.lo:sh.hi]
            if not np.array_equal(mine, sh._active_host):
                with device_scope(sh.device):
                    sh._active.copy_(torch.from_numpy(mine), non_blocking=True)
                sh._active_host = mine

    def _take(self, n_blocks: int) -> tuple:
        """The start of every call: apply pending slot resets, staged EQ
        programs and control writes, and take up to ``n_blocks`` blocks of
        every active slot's pending audio (an underrun for each block
        short). Audio pushed later goes to the next call. Returns the taken
        audio by slot (None for an inactive slot) and the call's targets,
        the active slots as ``(slot, _Slot, generation)``."""
        n = self.config.capacity
        active = np.zeros(n, bool)
        taken, targets = [None] * n, []
        want = n_blocks * BLOCK
        with self._lock:
            reset = self._begin_step()
            for i, s in enumerate(self._slots):
                if not s.active:
                    continue
                active[i] = True
                targets.append((i, s, s.generation))
                got, s.pending = s.pending[:want], s.pending[want:]
                taken[i] = got
                if got.size < want:
                    s.underruns += -(-(want - got.size) // BLOCK)
        self._write_masks(reset, active)
        return taken, targets

    def _fill(self, taken: list, b0: int, b1: int) -> torch.Tensor:
        """A host buffer ``[2, S, N/S * CHUNK_BLOCKS * BLOCK]`` from the pool
        (pinned when the engine runs on the card) whose input half ``[0]``
        holds the blocks ``[b0, b1)`` of the audio :meth:`_take` took, each
        shard's rows as ``[N/S, b1 - b0, BLOCK]`` at its start: a slot's
        blocks in one copy, zeros only where a slot lacks audio and in an
        inactive slot's row. The output half ``[1]`` takes the blocks'
        output, each shard's as ``[b1 - b0, N/S, BLOCK]``. A buffer returns
        to the pool only in :meth:`_land_chunk`, after the host has waited
        on the event that follows its last copy and unpacked its output, so
        a buffer whose copies may still be in flight is never refilled."""
        rows = self._rows_per_shard
        buf = self._free_bufs.pop() if self._free_bufs else torch.empty(
            (2, len(self._shards), rows * CHUNK_BLOCKS * BLOCK), dtype=torch.float32,
            pin_memory=self.device.type == "cuda")
        lo, hi = b0 * BLOCK, b1 * BLOCK
        width = hi - lo
        for k, xk in enumerate(buf[0].numpy()[:, :rows * width]):
            xk = xk.reshape(rows, width)
            for r, got in enumerate(taken[k * rows:(k + 1) * rows]):
                seg = () if got is None else got[lo:hi]
                if len(seg) == width:
                    xk[r] = seg
                    continue
                xk[r, :len(seg)] = seg
                xk[r, len(seg):] = 0.0
        return buf

    def _write_controls(self, staged: list) -> None:
        """Under the lock: write the staged EQ programs of the slots
        ``staged`` into their shards' EQ state, and the control tree, when a
        control changed, into every shard's static controls."""
        for slot in staged:
            fresh_eq = self._pending_eq.pop(slot)
            sh, row = self._shard_of(slot)
            with device_scope(sh.device):
                for key, value in fresh_eq.items():
                    sh._state["chain"]["eq"][key][row].copy_(value[0], non_blocking=True)
        if self._params_dirty:
            for sh in self._shards:
                with device_scope(sh.device):
                    _copy_host_tree(sh._params_static, _host_rows(self._params, sh.lo, sh.hi))
            self._params_dirty = False

    def _stage_vad(self, prob, avail) -> None:
        """Write the external VAD inputs into the shards' static tensors when
        they changed."""
        n = self.config.capacity
        prob = np.broadcast_to(np.zeros(n, np.float32) if prob is None
                               else np.asarray(prob, np.float32), (n,))
        avail = np.broadcast_to(np.zeros(n, bool) if avail is None
                                else np.asarray(avail, bool), (n,))
        for sh in self._shards:
            lo, hi = sh.lo, sh.hi
            with device_scope(sh.device):
                if not np.array_equal(prob[lo:hi], self._vad_host[0][lo:hi]):
                    sh._vad_prob.copy_(torch.from_numpy(prob[lo:hi].copy()),
                                       non_blocking=True)
                if not np.array_equal(avail[lo:hi], self._vad_host[1][lo:hi]):
                    sh._vad_avail.copy_(torch.from_numpy(avail[lo:hi].copy()),
                                        non_blocking=True)
        self._vad_host = (prob.copy(), avail.copy())

    def _open(self, n_blocks: int, ext_vad_prob, ext_vad_avail) -> tuple:
        """The head of every call: under "engine.gather", take the call's
        audio and fill its first chunk's buffer; under "engine.stage_vad",
        the external VAD inputs. Returns ``(taken, targets, buffer)``."""
        with tracing.span("engine.gather"):
            taken, targets = self._take(n_blocks)
            buf = self._fill(taken, 0, min(n_blocks, CHUNK_BLOCKS))
        with tracing.span("engine.stage_vad"):
            self._stage_vad(ext_vad_prob, ext_vad_avail)
        return taken, targets, buf

    def _step_in_place(self, shard: _Shard, state, mark=None):
        """:func:`_serving_step` on a shard's static inputs, its new state
        copied into ``state``; ``mark(stage)`` as ``_serving_step`` takes it,
        also called with "start" first and "copy_back" last. Returns the
        block's ``(y, metrics)``."""
        if mark is not None:
            mark("start")
        new_state, y, metrics = _serving_step(
            self.config, shard._params_dev, state, shard._fresh, shard._x,
            shard._active, None, shard._vad_prob, shard._vad_avail, mark)
        _copy_into(state, new_state)
        if mark is not None:
            mark("copy_back")
        return y, metrics

    def _capture(self, shard: _Shard) -> None:
        """Capture :meth:`_step_in_place` on a shard's static state as a
        CUDA graph (``replay.capture_graph``: one eager warm-up step on a
        copy of the state first creates what the step sets up lazily, the
        cached device constants, the cuFFT plan, the cuBLAS workspace, the
        kernels' attributes). The kernel launches the capture recorded are
        added to ``kernels.launch_counts`` on every replay; the warm-up's
        and the capture's own are not counted. The graph records a timing
        event at each of ``STAGE_MARKS`` (six event nodes a replay), which
        :meth:`_sample_stages` reads. A failed capture raises."""
        with self._lock:
            marks = {m: torch.cuda.Event(enable_timing=True, external=True)
                     for m in STAGE_MARKS}
            graph, out, launches, seconds = capture_graph(
                shard.device,
                lambda state: self._step_in_place(shard, state, lambda m: marks[m].record()),
                shard._state)
            shard._graph, shard._graph_out, shard._marks = graph, out, marks
            shard._graph_launches, shard.capture_seconds = launches, seconds

    def _run(self, shard: _Shard):
        """Advance a shard's static state by the block in its static inputs.
        Returns the block's ``(y, metrics)``, valid until the next run."""
        if shard.device.type != "cuda":
            return self._step_in_place(shard, shard._state)
        if shard._graph is None:
            with tracing.span("engine.capture"):
                self._capture(shard)
        shard._graph.replay()
        kernels.add_launches(shard._graph_launches)
        tracing.count("replay.replays")
        return shard._graph_out

    def _enqueue(self, buf: torch.Tensor, b0: int, b1: int, keep: bool) -> tuple:
        """Run the blocks ``[b0, b1)`` of a call, filled into ``buf`` by
        :meth:`_fill`, on every shard and queue their output's copy into
        ``buf[1]``: per shard, the rows to the device's staging rows in one
        copy, then for each block its copy into the step's input, a run and
        its output into the staging blocks ``[b1 - b0, N/S, BLOCK]``, then one
        copy back. Every shard's
        work is started before any is waited on. Returns the in-flight
        record ``(buf, the events that follow the shards' copies, b0, b1,
        metrics)``: with ``keep`` the last block's metrics (copies that later
        blocks do not overwrite), else None."""
        nb = b1 - b0
        size = self._rows_per_shard * nb * BLOCK
        done, metrics = [], []
        for k, sh in enumerate(self._shards):
            with device_scope(sh.device):
                xs, ys = sh._xs[:size], sh._ys[:size]
                xs.copy_(buf[0, k, :size], non_blocking=True)
                for xb, yb in zip(xs.view(-1, nb, BLOCK).unbind(1), ys.view(nb, -1, BLOCK)):
                    sh._x.copy_(xb)
                    y, m = self._run(sh)
                    yb.copy_(y)
                buf[1, k, :size].copy_(ys, non_blocking=True)
                if keep:
                    metrics.append(_kept(m))
                if sh.device.type == "cuda":
                    done.append(torch.cuda.Event())
                    done[-1].record()
        if not keep:
            metrics = None
        elif len(metrics) == 1:
            metrics = metrics[0]
        else:
            with device_scope(self.device):
                metrics = {key: torch.cat([m[key].to(self.device) for m in metrics])
                           for key in metrics[0]}
        return buf, done, b0, b1, metrics

    def _land_chunk(self, out, inflight: tuple, targets: list, stages: bool,
                    cause=None, overlapped: bool = False):
        """Land the blocks ``[b0, b1)`` of the in-flight record
        :meth:`_enqueue` returned: wait for the events that follow their
        copies, write them into ``out[b0:b1]`` (``out`` None: a new array;
        sinks may keep views), return the buffer to the pool and deliver the
        blocks to ``targets``. With ``stages`` (the landed block is the last
        one launched) and spans on, also samples the last replay's device
        time by stage (:meth:`_sample_stages`); with ``overlapped`` (a chunk
        of :meth:`step_many`), counts the chunk in
        ``engine.span_chunks_hidden`` when a shard still runs it at the
        wait. ``cause``: the call that launched the blocks, when another
        call lands them. Returns the record's metrics, which become the
        engine's last when it kept any."""
        buf, done, b0, b1, metrics = inflight
        nb = b1 - b0
        if overlapped and not all(event.query() for event in done):
            tracing.count("engine.span_chunks_hidden")
        with tracing.span("engine.wait"):
            for event in done:
                event.synchronize()
        if stages and tracing.enabled():
            self._sample_stages()
        with tracing.span("engine.unpack"):
            ys = (np.empty((nb, self.config.capacity, BLOCK), np.float32) if out is None
                  else out[b0:b1])
            S, rows = len(self._shards), self._rows_per_shard
            y = buf[1, :, :rows * nb * BLOCK].numpy().reshape(S, nb, rows, BLOCK)
            ys.reshape(nb, S, rows, BLOCK)[...] = y.transpose(1, 0, 2, 3)  # one copy
        self._free_bufs.append(buf)
        self._deliver(ys, nb, targets, cause)
        if metrics is not None:
            self._last_metrics = metrics
        return metrics

    def _sample_stages(self) -> None:
        """Each shard's last replay, by stage: the device milliseconds between
        the events its graph recorded, as the samples
        ``replay.stage_ms.<stage>`` (stages "vad", "front", "suppressor",
        "back" and "copy_back"). Called after the replay's wait."""
        for sh in self._shards:
            if sh._marks is not None:
                ev = [sh._marks[m] for m in STAGE_MARKS]
                for name, a, b in zip(STAGE_MARKS[1:], ev, ev[1:]):
                    tracing.sample(f"replay.stage_ms.{name}", a.elapsed_time(b))

    def _record_time(self, t0: float, n_blocks: int) -> None:
        self.steps += n_blocks
        self.last_step_seconds = time.perf_counter() - t0
        self._step_times.extend([self.last_step_seconds / n_blocks] * n_blocks)

    def step(self, ext_vad_prob=None, ext_vad_avail=None):
        """Advance every stream by one block. Returns per-slot metrics."""
        t0 = time.perf_counter()
        with tracing.span("engine.step", n_blocks=1, shards=len(self._shards)):
            _, targets, buf = self._open(1, ext_vad_prob, ext_vad_avail)
            with tracing.span("engine.launch"):
                inflight = self._enqueue(buf, 0, 1, True)
            metrics = self._land_chunk(None, inflight, targets, True)
        self._record_time(t0, 1)
        return metrics

    def step_pipelined(self, ext_vad_prob=None, ext_vad_avail=None):
        """Advance every stream by one block with one block of pipeline
        delay: block t is launched and its copy to the host queued, then
        block t-1 is delivered once its copy has landed, while block t runs.
        Sinks receive each block one call later than :meth:`step`, with the
        same audio; a stream detached in between gets none of its last
        block, and a stream attached in its slot none of it either. Call
        :meth:`flush_pipeline` (or :meth:`stop`) to deliver the last block.
        A :meth:`step` or :meth:`step_many` in between leaves the block in
        flight. Returns the delivered block's metrics, or None on the first
        call. The delivery's span ("engine.deliver") names the call that
        launched its block as its ``cause``."""
        t0 = time.perf_counter()
        with tracing.span("engine.step_pipelined", n_blocks=1, shards=len(self._shards)):
            _, targets, buf = self._open(1, ext_vad_prob, ext_vad_avail)
            with tracing.span("engine.launch"):
                inflight = self._enqueue(buf, 0, 1, True)
            held, self._inflight = self._inflight, (inflight, targets, tracing.current_call())
            delivered = None
            if held is not None:
                inflight, targets, cause = held
                delivered = self._land_chunk(None, inflight, targets, False, cause)
        self._record_time(t0, 1)
        return delivered

    def flush_pipeline(self):
        """Deliver the block :meth:`step_pipelined` left in flight."""
        if self._inflight is None:
            return None
        (inflight, targets, cause), self._inflight = self._inflight, None
        with tracing.span("engine.flush_pipeline", n_blocks=1, shards=len(self._shards)):
            return self._land_chunk(None, inflight, targets, False, cause)

    def step_many(self, n_blocks: int, ext_vad_prob=None, ext_vad_avail=None):
        """Advance every stream by ``n_blocks`` blocks. The call's input is
        taken from the slots at its start (audio pushed during the call, by
        a sink too, goes to the next step); then the call runs as a pipeline
        over chunks of :data:`CHUNK_BLOCKS` blocks: chunk j's input goes to
        the device and its blocks run, and while they run the host fills
        chunk j+1's buffer, then waits for chunk j-1's output and delivers
        it. Every block lands in one new host array ``[n_blocks, N, BLOCK]``,
        of which the sinks get views, in block order for each slot. Counts
        each chunk (``engine.span_chunks``) and each chunk still running when
        the host came to wait for it (``engine.span_chunks_hidden``). Returns
        the final block's per-slot metrics."""
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        t0 = time.perf_counter()
        chunks = [(b0, min(b0 + CHUNK_BLOCKS, n_blocks))
                  for b0 in range(0, n_blocks, CHUNK_BLOCKS)]
        with tracing.span("engine.step_many", n_blocks=n_blocks, shards=len(self._shards)):
            taken, targets, buf = self._open(n_blocks, ext_vad_prob, ext_vad_avail)
            out = np.empty((n_blocks, self.config.capacity, BLOCK), np.float32)
            inflight = None
            for j, (b0, b1) in enumerate(chunks):
                last = j == len(chunks) - 1
                with tracing.span("engine.launch"):
                    launched = self._enqueue(buf, b0, b1, last)
                tracing.count("engine.span_chunks")
                if not last:
                    with tracing.span("engine.gather"):
                        buf = self._fill(taken, *chunks[j + 1])
                if inflight is not None:
                    self._land_chunk(out, inflight, targets, False, overlapped=True)
                inflight = launched
            metrics = self._land_chunk(out, inflight, targets, True, overlapped=True)
        self._record_time(t0, n_blocks)
        return metrics

    def _deliver(self, ys, n_blocks: int, targets: list, cause=None) -> None:
        """``ys: [n_blocks, N, BLOCK]`` host array -> per-slot sinks.
        ``targets``: the ``(slot, _Slot, generation)`` whose audio the blocks
        are, of which those still attached, and not attached again since,
        get them. ``cause``: the call id of the step that launched the
        blocks, when another call delivers them."""
        with tracing.span("engine.deliver", cause=cause):
            with self._lock:
                live = [(i, s) for i, s, gen in targets
                        if s.active and s.generation == gen]
                for _, s in live:
                    s.blocks += n_blocks
            for i, s in live:
                if s.sink is not None:
                    for b in range(n_blocks):
                        s.sink(ys[b, i])

    def run_blocks(self, n_blocks: int) -> None:
        for _ in range(n_blocks):
            self.step()

    # ------------------------------------------------------------ free-run
    def start(self) -> None:
        """Run the free-run loop on a thread of its own until :meth:`stop`."""
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.flush_pipeline()

    def _loop(self):
        """Free-run loop: :meth:`step_pipelined` by default (the host
        delivers block t-1 while the card runs block t), :meth:`step` when
        ``pipelined_loop`` is False; with ``realtime_pacing`` one block per
        10 ms of audio."""
        period = BLOCK / self.config.chain.sample_rate
        advance = self.step_pipelined if self.pipelined_loop else self.step
        next_t = time.perf_counter()
        while self._running:
            advance()
            if self.realtime_pacing:
                next_t += period
                delay = next_t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_t = time.perf_counter()

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

    def shard_diagnostics(self) -> dict:
        """The shards' devices, each shard's graph capture seconds and kernel
        launches a replay, and both summed over the shards (a block is one
        replay of each). ``engine_diagnostics`` keeps the reference's keys."""
        launches = collections.Counter()
        for sh in self._shards:
            launches.update(sh._graph_launches)
        return {
            "shards": len(self._shards),
            "devices": [str(sh.device) for sh in self._shards],
            "capture_seconds": self.capture_seconds,
            "shard_capture_seconds": [sh.capture_seconds for sh in self._shards],
            "launches_per_block": dict(launches),
            "shard_launches_per_block": [dict(sh._graph_launches) for sh in self._shards],
        }

    def engine_diagnostics(self) -> dict:
        return {
            "capacity": self.capacity,
            "occupancy": self.occupancy,
            "steps": self.steps,
            "last_step_seconds": self.last_step_seconds,
            "suppressor_model": self.config.suppressor_model,
            "vad_enabled": self.config.vad_enabled,
            "realtime_pacing": self.realtime_pacing,
            "pipelined_loop": self.pipelined_loop,
            "step_latency": self.latency_histogram(),
        }
