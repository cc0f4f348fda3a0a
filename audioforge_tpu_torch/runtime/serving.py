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
:func:`_serving_step` eagerly in place of the replay. ``step_many`` replays
the graph once per block of the span; ``step_pipelined`` delivers block
t-1 while block t runs; ``start`` runs the free-run loop.

The engine runs on the card unless it is given ``device="cpu"``; without a
CUDA device, building one for the card raises.

Not ported yet (raises ``NotImplementedError`` naming its ROADMAP item):
stream-axis sharding.
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
from . import live_chain as lc
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
    """

    def __init__(self, config: ServingConfig | None = None, *, device="cuda",
                 eq_bands=None, sharding=None, rnnoise_weights=None,
                 dfn_weights=None, vad_weights=None):
        if sharding is not None:
            raise NotImplementedError(
                "stream-axis sharding is not ported yet (ROADMAP queue 1, "
                "multi-GPU)")
        self.device = kernels.resolve_device(device, "ServingEngine")
        self.config = config or ServingConfig()
        n = self.config.capacity
        dev = self.device
        self._lock = threading.RLock()
        self._slots = [_Slot() for _ in range(n)]
        self._reset_pending = np.zeros(n, bool)
        self._pending_eq = {}
        self._eq_layout = eq_ops.eq_layout(eq_bands)
        self._fresh = _serving_state_init(self.config, dev, eq_bands)
        self._state = _clone_tree(self._fresh)  # the static state buffers
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
            weights["supp"] = {k: v.to(dev) for k, v in supp_weights.items()}
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
            weights["vad"] = {k: v.to(dev) for k, v in
                              (vad_weights or silero.default_params()).items()}
            self._params["vad"] = {"pre_gain": np.float32(1.0),
                                   "smoothing": np.float32(0.5)}
        # static inputs of the step: the control tree (written after a
        # control write), the block, the active mask and the external VAD
        self._params_static = _to_device(self._params, dev)
        self._params_dev = {k: dict(v, weights=weights[k]) if k in weights else v
                            for k, v in self._params_static.items()}
        self._params_dirty = False
        self._x = torch.zeros((n, BLOCK), dtype=torch.float32, device=dev)
        self._active = torch.zeros(n, dtype=torch.bool, device=dev)
        self._active_host = np.zeros(n, bool)
        self._vad_prob = torch.zeros(n, dtype=torch.float32, device=dev)
        self._vad_avail = torch.zeros(n, dtype=torch.bool, device=dev)
        self._vad_host = (np.zeros(n, np.float32), np.zeros(n, bool))
        self._host_bufs = {}
        self._calls = 0
        self._graph = None
        self._graph_out = None
        self._graph_launches = {}
        self.capture_seconds = None
        self._inflight = None
        self._thread = None
        self._running = False
        self.realtime_pacing = False
        self.pipelined_loop = True
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
    def _host(self, name: str, shape: tuple) -> torch.Tensor:
        """A host staging buffer, pinned when the engine runs on the card,
        kept for later steps of the same shape."""
        key = (name, shape)
        buf = self._host_bufs.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            self._host_bufs[key] = buf
        return buf

    def _gather(self, n_blocks: int) -> torch.Tensor:
        """Stage the next ``n_blocks`` blocks: apply pending slot resets,
        staged EQ programs and control writes to the static buffers, and
        fill a host buffer ``[n_blocks, N, BLOCK]`` with the slots' input
        (two buffers in turn, so that a copy still in flight from the
        previous call is never overwritten)."""
        n = self.config.capacity
        self._calls += 1
        xh = self._host(f"x{self._calls % 2}", (n_blocks, n, BLOCK))
        x = xh.numpy()
        x.fill(0.0)
        active = np.zeros(n, bool)
        with self._lock:
            reset = self._reset_pending.copy()
            self._reset_pending[:] = False
            # a slot reset in this step would wipe its EQ surgery: it takes
            # the staged program one step later
            for slot in [s for s in self._pending_eq if not reset[s]]:
                fresh_eq = self._pending_eq.pop(slot)
                for key, row in fresh_eq.items():
                    self._state["chain"]["eq"][key][slot].copy_(row[0], non_blocking=True)
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
            if self._params_dirty:
                _copy_host_tree(self._params_static, self._params)
                self._params_dirty = False
        if reset.any():
            mask = torch.from_numpy(reset).to(self.device, non_blocking=True)
            _copy_into(self._state,
                       _masked_reset(self._state, self._fresh, mask, _SHARED))
        if not np.array_equal(active, self._active_host):
            self._active.copy_(torch.from_numpy(active), non_blocking=True)
            self._active_host = active
        return xh

    def _stage_vad(self, prob, avail) -> None:
        """Write the external VAD inputs into their static tensors when they
        changed."""
        n = self.config.capacity
        prob = np.broadcast_to(np.zeros(n, np.float32) if prob is None
                               else np.asarray(prob, np.float32), (n,))
        avail = np.broadcast_to(np.zeros(n, bool) if avail is None
                                else np.asarray(avail, bool), (n,))
        if not np.array_equal(prob, self._vad_host[0]):
            self._vad_prob.copy_(torch.from_numpy(prob.copy()), non_blocking=True)
        if not np.array_equal(avail, self._vad_host[1]):
            self._vad_avail.copy_(torch.from_numpy(avail.copy()), non_blocking=True)
        self._vad_host = (prob.copy(), avail.copy())

    def _step_in_place(self, state):
        """:func:`_serving_step` on the static inputs, its new state copied
        into ``state``. Returns the block's ``(y, metrics)``."""
        new_state, y, metrics = _serving_step(
            self.config, self._params_dev, state, self._fresh, self._x,
            self._active, None, self._vad_prob, self._vad_avail)
        _copy_into(state, new_state)
        return y, metrics

    def _capture(self) -> None:
        """Capture :meth:`_step_in_place` on the static state as a CUDA
        graph (``replay.capture_graph``: one eager warm-up step on a copy of
        the state first creates what the step sets up lazily, the cached
        device constants, the cuFFT plan, the cuBLAS workspace, the kernels'
        attributes). The kernel launches the capture recorded are added to
        ``kernels.launch_counts`` on every replay; the warm-up's and the
        capture's own are not counted. A failed capture raises."""
        with self._lock:
            graph, out, self._graph_launches, self.capture_seconds = capture_graph(
                self.device, self._step_in_place, self._state)
            self._graph, self._graph_out = graph, out

    def _run(self):
        """Advance the static state by the block in the static inputs.
        Returns the block's ``(y, metrics)``, valid until the next run."""
        if self.device.type != "cuda":
            return self._step_in_place(self._state)
        if self._graph is None:
            self._capture()
        self._graph.replay()
        kernels.add_launches(self._graph_launches)
        return self._graph_out

    def _advance(self, n_blocks: int, ext_vad_prob, ext_vad_avail):
        """Run ``n_blocks`` blocks. Returns their output ``[n_blocks, N,
        BLOCK]`` on the device and the last block's metrics."""
        xh = self._gather(n_blocks)
        self._stage_vad(ext_vad_prob, ext_vad_avail)
        if n_blocks == 1:
            self._x.copy_(xh[0], non_blocking=True)
            y, metrics = self._run()
            return y[None], _kept(metrics)
        xs = xh.to(self.device, non_blocking=True)
        ys = torch.empty_like(xs)
        for b in range(n_blocks):
            self._x.copy_(xs[b])
            y, metrics = self._run()
            ys[b].copy_(y)
        return ys, _kept(metrics)

    def _fetch(self, ys):
        """Start copying ``ys`` to a host buffer (two in turn). Returns what
        :meth:`_landed` waits on."""
        buf = self._host(f"y{self._calls % 2}", tuple(ys.shape))
        buf.copy_(ys, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return buf, done

    @staticmethod
    def _landed(fetch) -> np.ndarray:
        """The fetched blocks as a new host array (sinks may keep views)."""
        buf, done = fetch
        if done is not None:
            done.synchronize()
        return buf.numpy().copy()

    def _record_time(self, t0: float, n_blocks: int) -> None:
        self.steps += n_blocks
        self.last_step_seconds = time.perf_counter() - t0
        self._step_times.extend([self.last_step_seconds / n_blocks] * n_blocks)

    def step(self, ext_vad_prob=None, ext_vad_avail=None):
        """Advance every stream by one block. Returns per-slot metrics."""
        t0 = time.perf_counter()
        ys, metrics = self._advance(1, ext_vad_prob, ext_vad_avail)
        self._deliver(self._landed(self._fetch(ys)), 1)
        self._last_metrics = metrics
        self._record_time(t0, 1)
        return metrics

    def step_pipelined(self, ext_vad_prob=None, ext_vad_avail=None):
        """Advance every stream by one block with one block of pipeline
        delay: block t is launched and its copy to the host queued, then
        block t-1 is delivered once its copy has landed, while block t runs.
        Sinks receive each block one call later than :meth:`step`, with the
        same audio. Call :meth:`flush_pipeline` (or :meth:`stop`) to deliver
        the last block. Returns the delivered block's metrics, or None on
        the first call."""
        t0 = time.perf_counter()
        ys, metrics = self._advance(1, ext_vad_prob, ext_vad_avail)
        launched = (self._fetch(ys), metrics)
        delivered = None
        if self._inflight is not None:
            delivered = self._land(self._inflight)
        self._inflight = launched
        self._record_time(t0, 1)
        return delivered

    def _land(self, inflight):
        fetch, metrics = inflight
        self._deliver(self._landed(fetch), 1)
        self._last_metrics = metrics
        return metrics

    def flush_pipeline(self):
        """Deliver the block :meth:`step_pipelined` left in flight."""
        if self._inflight is None:
            return None
        inflight, self._inflight = self._inflight, None
        return self._land(inflight)

    def step_many(self, n_blocks: int, ext_vad_prob=None, ext_vad_avail=None):
        """Advance every stream by ``n_blocks`` blocks: the span's input is
        staged on the device once, the step runs once per block, and the
        output comes back in one copy and is delivered together. Returns
        the final block's per-slot metrics."""
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        t0 = time.perf_counter()
        ys, metrics = self._advance(n_blocks, ext_vad_prob, ext_vad_avail)
        self._deliver(self._landed(self._fetch(ys)), n_blocks)
        self._last_metrics = metrics
        self._record_time(t0, n_blocks)
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
