"""Live audio engine: the single-stream ``AudioProcessor`` runtime.

Counterpart of ``audioforge_tpu/runtime/processor.py`` (the reference engine
god-object, `rust-core/src/audio/processor.rs` + `processor/dsp_loop.rs` +
`processor/python_api.rs:827-2042`), with the same public surface plus the
``device`` keyword. Architecture:

- **Three host threads around three graphs.** An input thread feeds the
  native SPSC ring at the 10 ms block cadence, the DSP thread drains it,
  runs :mod:`.live_chain` ``front_run`` → suppressor engine → ``back_run``
  and stages output, and an output thread drains the output ring to the
  sink (mirrors the CPAL callback / DSP-thread split, SURVEY §3.2). On the
  card each of the front half, the suppressor's frame and the back half is
  a :class:`~.replay.BlockReplay` captured once per topology: a block in the
  steady state is three replays and no capture, a burst of k blocks is k
  replays of the same graphs (each with one copy of its rows to the card and
  one back). On the CPU the same steps run eagerly.
- **Controls are written into the graphs' static tensors.** Setters write
  plain Python values under a mutex; the DSP thread snapshots them between
  bursts and, when dirty, copies the new values into the static parameter
  tensors the graphs read (one flat copy); it never rebinds a captured
  tensor. State slot replacements (a path change, a de-esser re-init, an EQ
  band edit) are copied into the static state. Topology changes (stage
  enables, modes, cleanup mode, de-esser design) select graphs from a cache
  keyed by the config (``GRAPH_CACHE_SIZE`` entries, least recently used
  evicted), as the reference's jit cache selects compiled variants
  (`dsp_loop.rs:1052-1114` path reselection); an EQ relayout (new section
  shapes) empties the cache.
- **Devices are pluggable callables.** Inputs/outputs are virtual endpoints
  (silence, tone, noise, user-registered callables / collectors),
  enumerated through the same ``DeviceInfo`` surface as the reference
  (`audio/device.rs:29-50`).
- **VAD worker thread** consumes a tee ring at the Silero window cadence
  and publishes (probability, timestamp) on a CUDA stream of its own; the
  DSP thread treats the posterior as stale after 500 ms
  (`processor/vad_worker.rs`, `dsp_loop.rs:1381-1396`).
- **Failures stop the engine.** A capture or replay failure (or any other
  error) in the DSP thread or the VAD worker ends that thread with the error
  in ``get_runtime_diagnostics()`` (``rt_error_code`` 4,
  ``last_stream_error``) and a recovery request; a failure of the suppressor
  stage also shows in ``noise_backend_failed()`` / ``noise_backend_error()``.

``AudioProcessor()`` runs on the card unless given ``device="cpu"``; without
a CUDA device it raises.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..models import silero
from ..models import suppressor as supp
from ..ops import gate as gate_ops
from ..ops import mixdown as mixdown_ops
from ..ops import eq as eq_ops
from . import live_chain as lc
from .output_writer import OUTPUT_PRIME_MS, OutputWriteController
from .replay import copy_into
from .ringbuffer import AudioRing

__all__ = [
    "AudioProcessor",
    "DeviceInfo",
    "list_input_devices",
    "list_output_devices",
    "register_virtual_input",
    "register_virtual_output",
]

BLOCK = lc.BLOCK_SAMPLES
SAMPLE_RATE = 48000
VAD_STALE_MS = 500.0  # `processor.rs:95-96`
INPUT_BACKLOG_DROP_MS = 250.0  # `dsp_loop.rs:792-793`
INPUT_BACKLOG_KEEP_MS = 100.0
IDLE_SLEEP_MIN_US = 100.0  # `processor.rs:54-56`
IDLE_SLEEP_MAX_US = 1600.0
GR_HISTORY_BLOCKS = 100  # 1 s of 10 ms blocks for GR history telemetry
# suppressor in-band failure policy (`dsp_loop.rs:570-577,1554-1641`)
SUPPRESSOR_NONFINITE_EVENTS_FOR_RESET = 3
SUPPRESSOR_NONFINITE_WINDOW_S = 2.0
SUPPRESSOR_STARVATION_S = 0.4
SUPPRESSOR_RESET_COOLDOWN_S = 2.0

DSP_TIME_HISTORY = 4096  # per-block DSP times kept for percentiles
GRAPH_CACHE_SIZE = 8  # topologies whose front/back graphs stay captured

_INPUT_CHANNEL_MODES = ("average", "left", "right", "max_rms", "phase_safe_mono")
_CLEANUP_MODES = ("off", "gentle", "strong")


# --------------------------------------------------------------------------
# Virtual device registry (`audio/device.rs`)
# --------------------------------------------------------------------------


@dataclass
class DeviceInfo:
    """Audio endpoint descriptor (`audio/device.rs:29-50`)."""

    name: str
    is_default: bool = False
    endpoint_id: str | None = None
    host_api: str = "virtual"
    direction: str = "input"
    sample_rate: int | None = SAMPLE_RATE
    channels: int | None = 1
    name_ordinal: int = 0


def _silence_source(n: int) -> np.ndarray:
    return np.zeros(n, np.float32)


class _ToneSource:
    def __init__(self, freq_hz: float = 440.0, amp_db: float = -20.0):
        self._freq = freq_hz
        self._amp = 10.0 ** (amp_db / 20.0)
        self._phase = 0.0

    def __call__(self, n: int) -> np.ndarray:
        t = self._phase + np.arange(n)
        self._phase = float(self._phase + n)
        return (self._amp * np.sin(2.0 * np.pi * self._freq * t / SAMPLE_RATE)).astype(
            np.float32
        )


class _NoiseSource:
    def __init__(self, amp_db: float = -50.0, seed: int = 0xA5):
        self._amp = 10.0 ** (amp_db / 20.0)
        self._rng = np.random.default_rng(seed)

    def __call__(self, n: int) -> np.ndarray:
        return (self._amp * self._rng.standard_normal(n)).astype(np.float32)


_REGISTRY_LOCK = threading.Lock()
_INPUT_DEVICES: dict[str, object] = {}
_OUTPUT_DEVICES: dict[str, object] = {}


def _builtin_devices():
    return (
        {
            "Null Input": _silence_source,
            "Test Tone Input": lambda: _ToneSource(),
            "Noise Input": lambda: _NoiseSource(),
        },
        {"Null Output": lambda block: None},
    )


def register_virtual_input(name: str, source_factory,
                           sample_rate: int = SAMPLE_RATE) -> None:
    """Register an input endpoint. ``source_factory`` is either a callable
    ``(n) -> float32[n]`` used directly, or a zero-arg factory returning
    one (fresh state per stream). ``sample_rate`` declares the device's
    native rate; the engine resamples to 48 kHz on ingest
    (`dsp_loop.rs:960-1025`)."""
    with _REGISTRY_LOCK:
        _INPUT_DEVICES[str(name)] = (source_factory, int(sample_rate))


def register_virtual_output(name: str, sink_factory) -> None:
    """Register an output endpoint: a callable ``(block) -> None`` or a
    zero-arg factory returning one."""
    with _REGISTRY_LOCK:
        _OUTPUT_DEVICES[str(name)] = sink_factory


def _registry_table(direction: str) -> dict:
    """name -> (factory, sample_rate)."""
    builtin_in, builtin_out = _builtin_devices()
    with _REGISTRY_LOCK:
        if direction == "input":
            table = {k: (v, SAMPLE_RATE) for k, v in builtin_in.items()}
            table.update(_INPUT_DEVICES)
        else:
            table = {k: (v, SAMPLE_RATE) for k, v in builtin_out.items()}
            table.update(
                {k: (v if isinstance(v, tuple) else (v, SAMPLE_RATE))
                 for k, v in _OUTPUT_DEVICES.items()}
            )
    return table


def _enumerate(direction: str) -> list[DeviceInfo]:
    table = _registry_table(direction)
    default = "Null Input" if direction == "input" else "Null Output"
    return [
        DeviceInfo(
            name=name,
            is_default=(name == default),
            endpoint_id=f"virtual:{direction}:{name}",
            direction=direction,
            sample_rate=rate,
        )
        for name, (_, rate) in table.items()
    ]


def list_input_devices() -> list[DeviceInfo]:
    return _enumerate("input")


def list_output_devices() -> list[DeviceInfo]:
    return _enumerate("output")


def _resolve(direction: str, name: str | None):
    table = _registry_table(direction)
    if name is None:
        name = "Null Input" if direction == "input" else "Null Output"
    if name not in table:
        raise RuntimeError(
            f"Failed to resolve audio {direction}: no device named {name!r}"
        )
    factory, rate = table[name]
    try:
        endpoint = factory()  # zero-arg factory
    except TypeError:
        endpoint = factory  # direct callable
    return name, endpoint, rate


# --------------------------------------------------------------------------
# Control snapshot
# --------------------------------------------------------------------------

_PARAM_DEFAULTS = dict(
    gate_threshold_db=-40.0,
    gate_attack_ms=10.0,
    gate_release_ms=100.0,
    vad_threshold=0.48,
    vad_hold_time_ms=200.0,
    vad_pre_gain=1.0,
    gate_margin_db=10.0,
    compressor_threshold_db=-20.0,
    compressor_ratio=4.0,
    compressor_attack_ms=10.0,
    compressor_release_ms=200.0,
    compressor_makeup_gain_db=0.0,
    compressor_base_release_ms=50.0,
    compressor_target_lufs=-18.0,
    noise_reference_reliability=0.0,
    limiter_ceiling_db=-0.5,
    limiter_release_ms=50.0,
    suppressor_strength=1.0,
)

_TOPOLOGY_DEFAULTS = dict(
    gate_enabled=True,
    gate_mode=gate_ops.THRESHOLD_ONLY,
    auto_threshold_enabled=True,
    deesser_enabled=False,
    eq_enabled=True,
    compressor_enabled=True,
    adaptive_release=False,
    auto_makeup_enabled=False,
    sidechain_highpass_enabled=True,
    limiter_enabled=True,
    careful_output_enabled=True,
    cleanup_mode="off",
    suppressor_enabled=True,
    noise_model="rnnoise",
)

_DEESSER_DEFAULTS = dict(
    auto_enabled=True,
    auto_amount=0.5,
    low_cut_hz=4000.0,
    high_cut_hz=11000.0,
    threshold_db=-28.0,
    ratio=4.0,
    attack_ms=2.0,
    release_ms=80.0,
    max_reduction_db=6.0,
)


def _param_layout(tree, path=(), out=None):
    """Leaf paths of a control tree, in order."""
    out = [] if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            _param_layout(v, path + (k,), out)
        else:
            out.append(path + (k,))
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _eq_shapes(state) -> tuple:
    """The EQ's leaf shapes: a relayout changes them."""
    return tuple((k, tuple(v.shape)) for k, v in sorted(state["eq"].items()))


class AudioProcessor:
    """The live engine (`processor/python_api.rs:827-2042`) on ``device``
    (a CUDA device unless asked otherwise)."""

    def __init__(self, *, device="cuda"):
        self._device = kernels.resolve_device(device, "AudioProcessor")
        self._lock = threading.RLock()
        self._running = False
        self._threads: list[threading.Thread] = []
        self._stop_event = threading.Event()

        self._params = dict(_PARAM_DEFAULTS)
        self._topology = dict(_TOPOLOGY_DEFAULTS)
        self._deesser = dict(_DEESSER_DEFAULTS)
        self._eq_bands = list(eq_ops.default_bands())
        self._pending_eq: list[tuple[int, object]] = []
        self._params_dirty = True
        self._topology_dirty = False

        self._bypass = False
        self._raw_monitor = False
        self._output_muted = False
        self._input_channel_mode = "average"
        self._recovery_suppressed = False
        self._latency_compensation_ms = 0.0

        self._active_input: str | None = None
        self._active_output: str | None = None

        # realtime pacing: off = as-fast-as-possible (tests/benchmarks)
        self.realtime_pacing = True

        # backlog drain cap (blocks per burst: one replay of each graph a
        # block, one copy each way a burst); 8 blocks = 80 ms, far under the
        # 250 ms hard-drop threshold
        self._max_drain_blocks = max(1, int(os.environ.get(
            "AUDIOFORGE_MAX_DRAIN_BLOCKS", "8")))
        # Host block multiple H: the engine steps H blocks at a time (one
        # burst per H*10 ms) for hosts whose per-burst overhead cannot hold
        # 10 ms blocks at realtime. Latency grows by (H-1)*10 ms plus the
        # scaled output priming, which engine_latency_ms reports; the
        # default keeps H=1. Cap 64.
        self._host_block_multiple = max(1, min(64, int(os.environ.get(
            "AUDIOFORGE_HOST_BLOCK_MULTIPLE", "1"))))
        if self._host_block_multiple > 1:
            self._max_drain_blocks = max(
                self._max_drain_blocks, self._host_block_multiple)
        # per-block limiter/true-peak values of the last full-path burst,
        # so the UI histories keep one entry per block even when several
        # blocks go through one burst
        self._last_burst_gr: list[float] = []
        self._last_burst_tp: list[float] = []

        self._metrics = self._fresh_metrics()
        self._counters = self._fresh_counters()
        self._recovery = {
            "requested": False,
            "recovering": False,
            "restart_count": 0,
            "last_error": None,
            "last_reason": None,
            "next_attempt_at": 0.0,
            "attempt_index": 0,
        }

        self._recording = None  # dict when active
        self._probe = None  # dict when queued

        self._vad_state = {
            "probability": 0.0,
            "timestamp": 0.0,
            "available": False,
        }

        # the graphs' static tensors: one stream's chain state (built at
        # start), the controls in one flat buffer, and the topology's graphs
        self._state = None
        self._params_flat = None
        self._params_dev = None
        self._param_paths = None
        self._graphs = collections.OrderedDict()
        self._eq_shape = None
        self._dsp_times = collections.deque(maxlen=DSP_TIME_HISTORY)
        self._suppressor_error = None
        self._vad_stream = None
        self._engine = None
        self._suppressor_guard = {
            "nonfinite_events": [], "last_output_at": 0.0, "last_reset_at": 0.0
        }

    @property
    def device(self) -> torch.device:
        return self._device

    # ---- internal state factories ------------------------------------

    @staticmethod
    def _fresh_metrics() -> dict:
        return {
            "input_peak_db": -100.0,
            "input_rms_db": -100.0,
            "input_crest_factor_db": 0.0,
            "input_true_peak": 0.0,
            "output_peak_db": -100.0,
            "output_rms_db": -100.0,
            "output_crest_factor_db": 0.0,
            "output_true_peak": 0.0,
            "output_lufs": -100.0,
            "gate_gain": 1.0,
            "gate_is_open": False,
            "gate_fused_score": 0.0,
            "gate_chatter_events": 0,
            "gate_auto_relax_active": False,
            "noise_floor_db": -60.0,
            "noise_floor_reliability": 0.0,
            "gate_threshold_db": -40.0,
            "compressor_gain_reduction_db": 0.0,
            "compressor_makeup_gain_db": 0.0,
            "compressor_lufs": -100.0,
            "compressor_release_ms": 200.0,
            "deesser_gain_reduction_db": 0.0,
            "deesser_detector_confidence": 0.0,
            "limiter_gain_reduction_db": 0.0,
            "limiter_peak_gain_reduction_db": 0.0,
            "limiter_gr_history_db": [0.0] * GR_HISTORY_BLOCKS,
            "tp_gain_reduction_db": 0.0,
            "tp_gr_history_db": [0.0] * GR_HISTORY_BLOCKS,
            "output_true_peak_events": 0,
            "hum_detected": False,
            "rumble_detected": False,
            "selected_hp_hz": 80.0,
            "input_stereo_correlation": 1.0,
            "input_phase_rescue_strategy": "none",
            "input_phase_estimated_delay_samples": 0.0,
            "input_phase_polarity_flipped": False,
            "dsp_time_ms": 0.0,
            "dsp_time_smoothed_ms": 0.0,
            "dsp_drain_span_blocks": 1,
        }

    @staticmethod
    def _fresh_counters() -> dict:
        return {
            "dropped_samples": 0,
            "input_backlog_recovery_count": 0,
            "input_backlog_dropped_samples": 0,
            "lock_contention_count": 0,
            "output_underrun_streak": 0,
            "output_underrun_total": 0,
            "jitter_dropped_samples": 0,
            "output_retime_adjustment_count": 0,
            "output_recovery_event_count": 0,
            "output_recovery_count": 0,
            "output_short_write_dropped_samples": 0,
            "suppressor_non_finite_count": 0,
            "rt_error_code": 0,
            "input_phase_warning_count": 0,
            "input_callback_error_count": 0,
            "output_callback_error_count": 0,
            "rt_buffer_overflow_count": 0,
            "clip_event_count": 0,
            "clip_peak_db": -100.0,
            "output_clip_event_count": 0,
            "output_clip_peak_db": -100.0,
            "dsp_idle_wakeup_count": 0,
            "dsp_idle_sleep_us": IDLE_SLEEP_MIN_US,
            "input_callback_at": 0.0,
            "output_callback_at": 0.0,
            "blocks_processed": 0,
        }

    # ---- lifecycle ------------------------------------------------------

    def start(self, input_device=None, output_device=None,
              input_device_name_ordinal=0, output_device_name_ordinal=0):
        """Bring the engine up (`dsp_loop.rs` start, §3.1). Returns
        ``"Started: <in> -> <out>"``."""
        with self._lock:
            if self._running:
                raise RuntimeError("Already running")
            in_name, source, in_rate = _resolve("input", input_device)
            out_name, sink, _out_rate = _resolve("output", output_device)
            self._input_device_rate = in_rate

            # 1 s of staging matches the reference rings at H=1; a host
            # step of H blocks legitimately swings the queues by multiple
            # steps (input lands and is consumed in H-block chunks, the
            # backlog-drop line sits 2 steps up), so capacity scales with
            # the step to keep ring-full drops impossible below the
            # documented drop threshold
            step_cap = 4 * self._host_block_multiple * BLOCK
            cap = max(SAMPLE_RATE, step_cap)
            self._in_ring = AudioRing(cap)
            self._out_ring = AudioRing(cap)
            self._vad_ring = AudioRing(max(SAMPLE_RATE, step_cap))

            self._stop_event = threading.Event()
            self._active_input = in_name
            self._active_output = out_name
            self._counters = self._fresh_counters()
            self._metrics = self._fresh_metrics()
            self._params_dirty = True
            self._topology_dirty = False
            self._suppressor_error = None
            self._dsp_times.clear()
            self._dsp_ready = threading.Event()
            self._vad_ready = threading.Event()

            threads = [
                threading.Thread(
                    target=self._dsp_loop, name="afx-dsp", daemon=True
                ),
                threading.Thread(
                    target=self._supervisor_loop, name="afx-supervisor",
                    daemon=True,
                ),
                threading.Thread(
                    target=self._input_loop, args=(source, in_rate),
                    name="afx-input", daemon=True,
                ),
                threading.Thread(
                    target=self._output_loop, args=(sink,),
                    name="afx-output", daemon=True,
                ),
                threading.Thread(
                    target=self._vad_loop, name="afx-vad", daemon=True
                ),
            ]
            self._threads = threads
            self._running = True
        for t in threads:
            t.start()
        # wait for the first block's graphs so callers see a warm engine
        self._dsp_ready.wait(timeout=300.0)
        return f"Started: {in_name} -> {out_name}"

    def stop(self):
        """`dsp_loop.rs:1798-1883`: tear down streams and reset state."""
        with self._lock:
            if not self._running:
                return
            self._running = False
            self._stop_event.set()
            threads = self._threads
            self._threads = []
        for t in threads:
            # generous join: the DSP thread may be inside a graph capture
            # (topology change) that must finish before teardown
            t.join(timeout=120.0)
        with self._lock:
            self._active_input = None
            self._active_output = None
            self._vad_state = {
                "probability": 0.0, "timestamp": 0.0, "available": False
            }

    def is_running(self) -> bool:
        return self._running

    def get_active_input_device(self):
        return self._active_input

    def get_active_output_device(self):
        return self._active_output

    def sample_rate(self) -> int:
        return SAMPLE_RATE

    def output_sample_rate(self) -> int:
        return SAMPLE_RATE

    @staticmethod
    def _fixed_buffer_frames(env_name: str) -> int:
        """Env-overridable callback buffer size, preflight-clamped to
        16..8192 (`input.rs:281-347`)."""
        import os

        raw = os.environ.get(env_name, "")
        try:
            frames = int(raw)
        except ValueError:
            return BLOCK
        return min(max(frames, 16), 8192)

    def input_fixed_buffer_frames(self) -> int:
        return self._fixed_buffer_frames("AUDIOFORGE_FIXED_INPUT_BUFFER_FRAMES")

    def output_fixed_buffer_frames(self) -> int:
        return self._fixed_buffer_frames("AUDIOFORGE_FIXED_OUTPUT_BUFFER_FRAMES")

    # ---- engine threads -------------------------------------------------

    def _input_loop(self, source, device_rate: int = SAMPLE_RATE):
        """Paced producer standing in for the input stream callback.

        Stereo sources (shape ``[n, 2]`` or ``[2, n]``) go through the
        channel mixdown (`input.rs:136-177`, including phase-safe mono);
        non-48k devices are resampled on ingest (`dsp_loop.rs:960-1025`)."""
        from ..ops.resample import StreamingResampler
        from .ingest import NativeIngest, native_ingest_available

        # hold until the DSP graphs AND the VAD worker's graph are captured —
        # otherwise the warm-up floods the ring with drops that look like
        # runtime faults
        self._dsp_ready.wait(timeout=300.0)
        self._vad_ready.wait(timeout=300.0)

        # Native fast path: mixdown + resample + ring write in one C call
        # per callback (phase-safe mono keeps the Python kernel — its
        # delay-scan state is block-adaptive). Falls back transparently.
        native = None
        native_channels = None
        if (native_ingest_available()
                and self._input_channel_mode != "phase_safe_mono"
                and hasattr(self._in_ring, "_handle")):
            native = {"mode": self._input_channel_mode}

        # pull device-rate-sized chunks covering one host step (H engine
        # blocks; H=1 is the reference's 10 ms callback cadence)
        pull = max(1, int(round(
            BLOCK * self._host_block_multiple * device_rate / SAMPLE_RATE)))
        resampler = (
            StreamingResampler(device_rate, SAMPLE_RATE)
            if device_rate != SAMPLE_RATE else None
        )
        period = pull / device_rate
        next_at = time.perf_counter()
        phase_state = mixdown_ops.PhaseSafeMonoState()
        while not self._stop_event.is_set():
            try:
                raw = np.asarray(source(pull), np.float32)
                if native is not None:
                    channels = raw.shape[1] if raw.ndim == 2 else 1
                    if (native.get("pipe") is None
                            or native_channels != channels):
                        native["pipe"] = NativeIngest(
                            self._in_ring, channels, native["mode"],
                            device_rate,
                        )
                        native_channels = channels
                    frames = raw if raw.ndim == 2 else raw[:pull]
                    native["pipe"].push(frames[:pull])
                    with self._lock:
                        self._counters["input_callback_at"] = (
                            time.perf_counter()
                        )
                    if self.realtime_pacing:
                        next_at += period
                        delay = next_at - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                        else:
                            next_at = time.perf_counter()
                    continue
                if raw.ndim == 2:
                    if raw.shape[0] == 2 and raw.shape[1] != 2:
                        left, right = raw[0], raw[1]
                    else:
                        left, right = raw[:, 0], raw[:, 1]
                    block, corr, diag = mixdown_ops.mix_to_mono(
                        left[:pull], right[:pull],
                        self._input_channel_mode, phase_state,
                    )
                    with self._lock:
                        self._metrics["input_stereo_correlation"] = (
                            1.0 if corr is None else float(corr)
                        )
                        self._metrics["input_phase_rescue_strategy"] = (
                            diag["strategy"]
                        )
                        self._metrics["input_phase_estimated_delay_samples"] = (
                            float(diag["estimated_delay_samples"])
                        )
                        self._metrics["input_phase_polarity_flipped"] = (
                            bool(diag["polarity_flipped"])
                        )
                        if (corr is not None and corr
                                < mixdown_ops.INPUT_PHASE_WARNING_CORRELATION):
                            self._counters["input_phase_warning_count"] += 1
                else:
                    block = raw.ravel()[:pull]
                if block.size < pull:
                    block = np.pad(block, (0, pull - block.size))
                if resampler is not None:
                    block = resampler.process(block)
            except Exception:
                with self._lock:
                    self._counters["input_callback_error_count"] += 1
                    first_error = (
                        self._counters["input_callback_error_count"] == 1)
                if first_error:
                    import traceback
                    traceback.print_exc()
                block = np.zeros(BLOCK, np.float32)
            self._in_ring.write(block)
            with self._lock:
                self._counters["input_callback_at"] = time.perf_counter()
            if self.realtime_pacing:
                next_at += period
                delay = next_at - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_at = time.perf_counter()

    def _output_loop(self, sink):
        """Paced consumer standing in for the output stream callback.

        Underruns repeat the last sample (`output.rs:343-473`)."""
        period = BLOCK / SAMPLE_RATE
        next_at = time.perf_counter()
        last_sample = 0.0
        # prime: wait for the DSP to produce before draining
        self._dsp_ready.wait(timeout=300.0)
        # fill-based priming: with a host step of H blocks the DSP lands
        # audio in H-block bursts, so draining must not start until a
        # step-plus-cushion of audio is queued — starting on the ready
        # event alone leaves the consumer a full step ahead of the first
        # burst and every cycle underruns by the burst's compute lag
        # (reference primes 30 ms for its H=1 stream, `dsp_loop.rs:259`)
        prime_samples = max(
            int(OUTPUT_PRIME_MS / 1e3 * SAMPLE_RATE),
            (self._host_block_multiple + 2) * BLOCK,
        )
        prime_deadline = time.perf_counter() + 300.0
        while (not self._stop_event.is_set()
               and self._out_ring.available() < prime_samples
               and time.perf_counter() < prime_deadline):
            time.sleep(0.002)
        next_at = time.perf_counter()
        while not self._stop_event.is_set():
            block = self._out_ring.read(BLOCK)
            with self._lock:
                if block.size < BLOCK:
                    self._counters["output_underrun_total"] += 1
                    self._counters["output_underrun_streak"] += 1
                    fill = np.full(BLOCK - block.size, last_sample, np.float32)
                    block = np.concatenate([block, fill])
                else:
                    self._counters["output_underrun_streak"] = 0
                self._counters["output_callback_at"] = time.perf_counter()
                muted = self._output_muted
            last_sample = float(block[-1]) if block.size else last_sample
            if muted:
                block = np.zeros_like(block)
            # calibration probes render post-mute, like the reference's
            # output-callback probe path (`output.rs:322-346`)
            block = self._mix_probe(np.asarray(block, np.float32))
            try:
                sink(block)
            except Exception:
                with self._lock:
                    self._counters["output_callback_error_count"] += 1
            if self.realtime_pacing:
                next_at += period
                delay = next_at - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_at = time.perf_counter()

    def _supervisor_loop(self):
        """Watchdog standing in for the reference supervisor + UI poller
        (`supervisor.rs`, `ui/stream_recovery.py`): watches callback ages
        through the stall heuristics and flags recovery; the next
        ``service_recovery()`` call performs the restart."""
        from .stream_recovery import StreamRecoveryManager

        manager = StreamRecoveryManager()
        manager.mark_processing_started()
        while not self._stop_event.is_set():
            time.sleep(0.5)
            if self._stop_event.is_set():
                break
            should = manager.maybe_recover_callback_stall(
                input_cb_age_ms=self.get_input_callback_age_ms(),
                output_cb_age_ms=self.get_output_callback_age_ms(),
                calibration_dialog_open=self._recording is not None,
            )
            if should and not self._recovery_suppressed:
                self.request_recovery("output callback stall")
            # input half of the dual heartbeat watch (`supervisor.rs:22-98`):
            # a source that blocks or dies without raising surfaces here
            should_in = manager.maybe_recover_input_stall(
                input_cb_age_ms=self.get_input_callback_age_ms(),
                calibration_dialog_open=self._recording is not None,
            )
            if should_in and not self._recovery_suppressed:
                self.request_recovery("input callback stall")

    def _vad_loop(self):
        """Silero worker at window cadence (`processor/vad_worker.rs`), on a
        CUDA stream of its own when the engine runs on the card. An error
        ends the worker with the error recorded (``rt_error_code`` 4,
        ``last_stream_error``) and a recovery request."""
        try:
            if self._device.type == "cuda":
                with torch.cuda.device(self._device):
                    self._vad_stream = torch.cuda.Stream(self._device)
                    with torch.cuda.stream(self._vad_stream):
                        self._vad_loop_inner()
            else:
                self._vad_loop_inner()
        except Exception as exc:  # noqa: BLE001 — recorded, the worker ends
            self._record_failure(f"vad worker error: {exc!r}")
            self._vad_ready.set()

    def _vad_loop_inner(self):
        state = silero.vad_stream_init(SAMPLE_RATE, device=self._device)
        win = state["config"]["window_in"]
        # capture the window's graph BEFORE audio flows: a capture at the
        # first live window would stall the worker (the input pump holds
        # until _vad_ready alongside _dsp_ready)
        state = silero.vad_stream_prepare(state)
        self._vad_ready.set()
        while not self._stop_event.is_set():
            if self._vad_ring.available() < win:
                time.sleep(0.005)  # 5 ms idle (`vad_worker.rs`)
                continue
            samples = self._vad_ring.read(win)
            with self._lock:
                pre_gain = self._params["vad_pre_gain"]
            state, prob = silero.vad_stream_process(
                state, samples * np.float32(pre_gain)
            )
            with self._lock:
                self._vad_state = {
                    "probability": float(prob),
                    "timestamp": time.perf_counter(),
                    "available": True,
                }

    def _record_failure(self, message: str) -> None:
        with self._lock:
            self._counters["rt_error_code"] = 4  # processor_unavailable
            self._recovery["last_error"] = message
        self.request_recovery(message)

    @staticmethod
    def _build_config(topo, par, dee):
        """Pure LiveChainConfig construction (no control-state mutation)."""
        from ..ops import deesser as des_ops

        # attack/release are fixed inside the de-esser envelope scan
        # (the reference exposes setters, but its detector constants pin
        # the usable range; stored here for settings round-trips)
        dee_fields = {
            k: v for k, v in dee.items() if k not in ("attack_ms", "release_ms")
        }
        dee_cfg = des_ops.DeEsserConfig(
            sample_rate=float(SAMPLE_RATE),
            enabled=topo["deesser_enabled"],
            **dee_fields,
        )
        config = lc.LiveChainConfig(
            sample_rate=float(SAMPLE_RATE),
            cleanup_mode=topo["cleanup_mode"],
            gate_enabled=topo["gate_enabled"],
            gate_mode=topo["gate_mode"],
            auto_threshold_enabled=topo["auto_threshold_enabled"],
            deesser_enabled=topo["deesser_enabled"],
            eq_enabled=topo["eq_enabled"],
            compressor_enabled=topo["compressor_enabled"],
            adaptive_release=topo["adaptive_release"],
            auto_makeup_enabled=topo["auto_makeup_enabled"],
            sidechain_highpass_enabled=topo["sidechain_highpass_enabled"],
            limiter_enabled=topo["limiter_enabled"],
            careful_output_enabled=topo["careful_output_enabled"],
            deesser=dee_cfg,
        )
        return config

    def _write_params(self, tree) -> dict:
        """Copy a control tree (host floats) into the static parameter
        tensors, one copy of the flat buffer; the tensors are built at the
        first call and never rebound. Returns the static tree."""
        if self._params_dev is None:
            paths = _param_layout(tree)
            flat = torch.zeros(len(paths), dtype=torch.float32, device=self._device)
            static = {}
            for i, path in enumerate(paths):
                node = static
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = flat[i:i + 1]
            self._param_paths, self._params_flat, self._params_dev = paths, flat, static
        host = np.array([_leaf(tree, path) for path in self._param_paths], np.float32)
        self._params_flat.copy_(torch.from_numpy(host))
        return self._params_dev

    def _snapshot_control(self):
        """Consume dirty control state: build (config, params, topo, par,
        pending EQ edits), the new control values written into the static
        parameter tensors (``params``). DSP-thread only, between bursts —
        clears dirty flags."""
        with self._lock:
            topo = dict(self._topology)
            par = dict(self._params)
            dee = dict(self._deesser)
            pending_eq = self._pending_eq
            self._pending_eq = []
            self._params_dirty = False
            self._topology_dirty = False
        config = self._build_config(topo, par, dee)
        params = self._write_params(lc.live_params(
            config,
            gate_threshold_db=par["gate_threshold_db"],
            gate_attack_ms=par["gate_attack_ms"],
            gate_release_ms=par["gate_release_ms"],
            vad_threshold=par["vad_threshold"],
            vad_hold_time_ms=par["vad_hold_time_ms"],
            gate_margin_db=par["gate_margin_db"],
            compressor_threshold_db=par["compressor_threshold_db"],
            compressor_ratio=par["compressor_ratio"],
            compressor_attack_ms=par["compressor_attack_ms"],
            compressor_release_ms=par["compressor_release_ms"],
            compressor_makeup_gain_db=par["compressor_makeup_gain_db"],
            compressor_target_lufs=par["compressor_target_lufs"],
            noise_reference_reliability=par["noise_reference_reliability"],
            limiter_ceiling_db=par["limiter_ceiling_db"],
            limiter_release_ms=par["limiter_release_ms"],
        ))
        return config, params, topo, par, pending_eq

    def _dsp_loop(self):
        try:
            if self._device.type == "cuda":
                with torch.cuda.device(self._device):
                    self._dsp_loop_inner()
            else:
                self._dsp_loop_inner()
        except Exception as exc:  # noqa: BLE001 — RT thread must not die silently
            self._record_failure(f"dsp thread error: {exc!r}")
            self._dsp_ready.set()

    def _fresh_state(self, config, eq_bands):
        """The static chain state, reset to ``live_init``: built at the first
        start (or when the EQ's section layout changed), else the fresh
        values copied into it, so that the cached graphs stay valid."""
        fresh = lc.live_init(config, eq_bands, n=1, device=self._device)
        if self._state is None or _eq_shapes(fresh) != _eq_shapes(self._state):
            self._state = fresh
            self._graphs.clear()
        else:
            copy_into(self._state, fresh)
        return self._state

    def _graphs_for(self, config, params, state) -> dict:
        """The front and back graphs of ``config`` over ``params`` and
        ``state`` from the cache (built on a miss; on the card each is
        captured at its first run), least recently used evicted."""
        key = (config, id(params), id(state), _eq_shapes(state))
        graphs = self._graphs.get(key)
        if graphs is None:
            k_max = max(self._max_drain_blocks, self._host_block_multiple)
            graphs = {"front": lc.front_replay(config, params, state, k_max=k_max),
                      "back": lc.back_replay(config, params, state, k_max=k_max)}
            self._graphs[key] = graphs
            while len(self._graphs) > GRAPH_CACHE_SIZE:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        return graphs

    def _warm(self, config, params, state, engine, topo):
        """Capture the topology's graphs (front, back, the suppressor's
        frame) before audio flows; on the CPU only build them."""
        for replay in self._graphs_for(config, params, state).values():
            replay.prepare()
        if topo["suppressor_enabled"]:
            engine = self._suppressor_call(supp.engine_prepare, engine)
        return engine

    def _suppressor_call(self, fn, *args):
        """A suppressor engine call; its failure is recorded as the noise
        backend's error before it propagates."""
        try:
            return fn(*args)
        except Exception as exc:
            self._suppressor_error = f"{type(exc).__name__}: {exc}"
            raise

    def _dsp_loop_inner(self):
        config, params, topo, par, _ = self._snapshot_control()
        writer = OutputWriteController(
            float(SAMPLE_RATE), block_multiple=self._host_block_multiple)
        with self._lock:
            eq_bands = list(self._eq_bands)
        eq_layout = eq_ops.eq_layout(eq_bands)
        state = self._fresh_state(config, eq_bands)
        engine = supp.engine_init(
            topo["noise_model"], par["suppressor_strength"], device=self._device
        )
        self._engine = engine
        supp_delay = np.zeros(engine["latency_samples"], np.float32)
        self._suppressor_guard = {
            "nonfinite_events": [], "last_output_at": 0.0, "last_reset_at": 0.0
        }
        gr_hist = [0.0] * GR_HISTORY_BLOCKS
        tp_hist = [0.0] * GR_HISTORY_BLOCKS
        idle_us = IDLE_SLEEP_MIN_US
        smoothed_dsp_ms = 0.0
        first = True
        # Hard backlog protection (`dsp_loop.rs:792-793`). With a host step
        # of H blocks the queue legitimately swings by a full step between
        # bursts (input lands in H-block chunks, the engine consumes in
        # H-block steps), so the drop/keep lines shift up by two steps —
        # the same latency protection measured at the step granularity.
        step_samples = self._host_block_multiple * BLOCK
        backlog_drop = (int(INPUT_BACKLOG_DROP_MS / 1000.0 * SAMPLE_RATE)
                        + 2 * (step_samples - BLOCK))
        backlog_keep = (int(INPUT_BACKLOG_KEEP_MS / 1000.0 * SAMPLE_RATE)
                        + (step_samples - BLOCK))

        host_blocks = self._host_block_multiple
        while not self._stop_event.is_set():
            avail = self._in_ring.available()
            if avail < host_blocks * BLOCK:
                if first:
                    # capture the graphs before audio flows
                    engine = self._warm(config, params, state, engine, topo)
                    self._engine = engine
                    self._dsp_ready.set()
                    first = False
                    continue
                with self._lock:
                    self._counters["dsp_idle_wakeup_count"] += 1
                    self._counters["dsp_idle_sleep_us"] = idle_us
                time.sleep(idle_us / 1e6)
                idle_us = min(idle_us * 2.0, IDLE_SLEEP_MAX_US)
                continue
            idle_us = IDLE_SLEEP_MIN_US

            # backlog drop (`dsp_loop.rs:917-950`)
            if avail > backlog_drop:
                to_drop = avail - backlog_keep
                dropped = self._in_ring.discard(to_drop)
                with self._lock:
                    self._counters["input_backlog_recovery_count"] += 1
                    self._counters["input_backlog_dropped_samples"] += dropped
                writer.mark_discontinuity()
                avail = self._in_ring.available()

            # Control snapshot between bursts: new values go into the static
            # parameter tensors before the burst's first replay, never
            # between two replays of one burst.
            with self._lock:
                dirty = self._params_dirty or self._topology_dirty
                bypass = self._bypass
                raw_monitor = self._raw_monitor
            if dirty:
                new_config, params, topo, par, pending_eq = (
                    self._snapshot_control()
                )
                if new_config != config:
                    fresh = None
                    if (
                        new_config.gate_mode != config.gate_mode
                        or new_config.cleanup_mode != config.cleanup_mode
                    ):
                        # path change resets stage state
                        # (`dsp_loop.rs:1052-1114`)
                        fresh = lc.live_init(new_config, eq_bands=self._eq_bands,
                                             n=1, device=self._device)
                        for key in ("routing", "gate", "vad"):
                            copy_into(state[key], fresh[key])
                    if new_config.deesser != config.deesser:
                        fresh = fresh or lc.live_init(
                            new_config, eq_bands=self._eq_bands, n=1,
                            device=self._device)
                        copy_into(state["deesser"], fresh["deesser"])
                    config = new_config
                for band_index, band_cfg in pending_eq:
                    eq_bands[band_index] = band_cfg
                    try:
                        copy_into(state["eq"], eq_ops.eq_set_band(
                            state["eq"], band_index, band_cfg,
                            float(SAMPLE_RATE), layout=eq_layout,
                        ))
                    except ValueError:
                        # band outgrew its compact slot (non-pass -> pass
                        # type change): rebuild the cascade with the new
                        # layout — new section shapes, so every cached graph
                        # goes (`dsp_loop.rs:1052-1114` path reselect)
                        eq_layout = eq_ops.eq_layout(eq_bands)
                        state["eq"] = eq_ops.eq_init(
                            eq_bands, float(SAMPLE_RATE), layout=eq_layout,
                            n=1, device=self._device,
                        )
                        self._graphs.clear()
                if topo["noise_model"] != engine["model"]:
                    engine = supp.engine_init(
                        topo["noise_model"], par["suppressor_strength"],
                        device=self._device,
                    )
                    supp_delay = np.zeros(
                        engine["latency_samples"], np.float32
                    )
                engine = supp.engine_set_strength(
                    engine, par["suppressor_strength"]
                )
                self._engine = engine

            # Backlog drain: when a full burst is waiting the engine catches
            # up with a burst of k blocks (k replays of the same graphs, one
            # copy each way) — audio is only *discarded* past the 250 ms
            # hard threshold above. Two spans exist: the host step and the
            # cap (default 8 blocks = 80 ms).
            span = host_blocks
            if (avail >= self._max_drain_blocks * BLOCK
                    and self._max_drain_blocks > host_blocks):
                span = self._max_drain_blocks

            x = self._in_ring.read(span * BLOCK)
            if x.size < span * BLOCK:
                x = np.pad(x, (0, span * BLOCK - x.size))

            # recording tap + VAD tee run on every path — calibration
            # records raw input while bypassed (`dsp_loop.rs:1255-1283`,
            # `1359-1369`)
            self._tap_recording(x)
            self._vad_ring.write(x)

            started = time.perf_counter()
            if raw_monitor:
                y = x
            elif bypass:
                y = np.clip(np.nan_to_num(x), -1.0, 1.0)
            else:
                state, y, engine, supp_delay = self._process_block(
                    config, params, state,
                    x.reshape(span, BLOCK), engine, supp_delay, topo,
                )
                self._engine = engine
            dsp_ms = (time.perf_counter() - started) * 1e3 / span
            smoothed_dsp_ms = 0.9 * smoothed_dsp_ms + 0.1 * dsp_ms
            self._dsp_times.extend([dsp_ms] * span)

            with self._lock:
                if not raw_monitor and not bypass:
                    burst_gr = self._last_burst_gr or (
                        [self._metrics["limiter_gain_reduction_db"]] * span
                    )
                    burst_tp = self._last_burst_tp or (
                        [self._metrics["tp_gain_reduction_db"]] * span
                    )
                else:
                    burst_gr = (
                        [self._metrics["limiter_gain_reduction_db"]] * span
                    )
                    burst_tp = [self._metrics["tp_gain_reduction_db"]] * span
                # one history entry per block, even across bursts
                for gr_v, tp_v in zip(burst_gr, burst_tp):
                    gr_hist.pop(0)
                    tp_hist.pop(0)
                    gr_hist.append(gr_v)
                    tp_hist.append(tp_v)
                self._metrics["limiter_gr_history_db"] = list(gr_hist)
                self._metrics["tp_gr_history_db"] = list(tp_hist)
                self._metrics["dsp_time_ms"] = dsp_ms
                self._metrics["dsp_time_smoothed_ms"] = smoothed_dsp_ms
                self._metrics["dsp_drain_span_blocks"] = span
                self._counters["blocks_processed"] += span

            # output-writer conditioning: drift retime toward the queue
            # target, discontinuity fade after drops
            conditioned = writer.condition(
                np.asarray(y, np.float32), self._out_ring.available(),
                blocks=span,
            )
            self._out_ring.write(conditioned)
            with self._lock:
                self._counters["output_retime_adjustment_count"] = (
                    writer.retime_adjustment_count
                )
                self._counters["jitter_dropped_samples"] = (
                    writer.jitter_dropped_samples
                )
            if first:
                engine = self._warm(config, params, state, engine, topo)
                self._engine = engine
                self._dsp_ready.set()
                first = False

    def _process_block(self, config, params, state, x, engine, supp_delay,
                       topo):
        """One full-chain burst: front → suppressor → back, metric
        publication. ``x: [k, BLOCK]`` — a drain burst of ``k`` blocks (k is
        1 in the steady state; see the drain logic in ``_dsp_loop_inner``):
        on the card k replays of the front graph, the suppressor engine's
        frame graph and the back graph, each half with one copy of its rows
        each way (the metrics ride in the halves' output rows). ``state`` is
        the static state, updated in place and returned."""
        k = x.shape[0]
        total = k * BLOCK
        with self._lock:
            vad = dict(self._vad_state)
        age_ms = (time.perf_counter() - vad["timestamp"]) * 1e3
        vad_fresh = vad["available"] and age_ms <= VAD_STALE_MS

        graphs = self._graphs_for(config, params, state)
        new_state, y, fm = lc.front_run(
            config, params, state, x, vad["probability"], vad_fresh,
            replay=graphs["front"],
        )

        y_np = np.asarray(y).ravel()

        if topo["suppressor_enabled"]:
            engine, _ = self._suppressor_call(supp.engine_push, engine, y_np)
            engine, _ = self._suppressor_call(supp.engine_process, engine)
            engine, out = supp.engine_pop(engine, total)
            now = time.perf_counter()
            guard = self._suppressor_guard
            if out.size < total:
                # starvation: a staged engine that stops producing for
                # 400 ms gets a soft reset, 2 s cooldown
                # (`dsp_loop.rs:1554-1589`)
                if guard["last_output_at"] == 0.0:
                    guard["last_output_at"] = now
                if (now - guard["last_output_at"] > SUPPRESSOR_STARVATION_S
                        and now - guard["last_reset_at"]
                        > SUPPRESSOR_RESET_COOLDOWN_S):
                    engine = supp.engine_soft_reset(engine)
                    guard["last_reset_at"] = now
                    guard["last_output_at"] = now
                    with self._lock:
                        self._counters["output_recovery_event_count"] += 1
                out = np.concatenate(
                    [np.zeros(total - out.size, np.float32), out]
                )
            else:
                guard["last_output_at"] = now
            bad = ~np.isfinite(out)
            if bad.any():
                # non-finite scrub + windowed rebuild: 3 events in 2 s
                # trigger a soft reset (`dsp_loop.rs:570-577,1601-1641`)
                out = np.where(bad, 0.0, out)
                guard["nonfinite_events"].append(now)
                guard["nonfinite_events"] = [
                    t for t in guard["nonfinite_events"]
                    if now - t <= SUPPRESSOR_NONFINITE_WINDOW_S
                ]
                with self._lock:
                    self._counters["suppressor_non_finite_count"] += int(
                        bad.sum()
                    )
                    self._counters["rt_error_code"] = 3  # non_finite
                if (len(guard["nonfinite_events"])
                        >= SUPPRESSOR_NONFINITE_EVENTS_FOR_RESET
                        and now - guard["last_reset_at"]
                        > SUPPRESSOR_RESET_COOLDOWN_S):
                    engine = supp.engine_soft_reset(engine)
                    guard["last_reset_at"] = now
                    guard["nonfinite_events"] = []
                    with self._lock:
                        self._counters["output_recovery_count"] += 1
            y_np = out
        else:
            # keep chain latency constant when the suppressor is off
            joined = np.concatenate([supp_delay, y_np])
            y_np = joined[:total]
            supp_delay = joined[total:]

        # per-block auto-makeup evidence: the noise-floor values carry the
        # burst axis from front_run; the VAD posterior is the same worker
        # snapshot for every block in the burst (10 ms cadence, 500 ms
        # staleness budget — an 80 ms burst stays well inside it)
        evidence = {
            "vad_probability": np.full(k, vad["probability"], np.float32),
            "vad_reliability": np.full(k, 1.0 if vad_fresh else 0.0, np.float32),
            "noise_floor_db": fm["noise_floor_db"],
            "live_noise_reliability": fm["noise_floor_reliability"],
        }
        new_state, y2, bm = lc.back_run(
            config, params, new_state, np.asarray(y_np).reshape(k, BLOCK),
            evidence, replay=graphs["back"],
        )
        out = np.asarray(y2).ravel()

        # publish metrics (host floats from the halves' output rows, one
        # fetch each per burst) — gauges report the burst's last block,
        # counts sum over it
        m = {}
        m["input_peak_db"] = float(fm["input_peak_db"][-1])
        m["input_rms_db"] = float(fm["input_rms_db"][-1])
        m["input_crest_factor_db"] = float(fm["input_crest_factor_db"][-1])
        m["input_true_peak"] = float(fm["input_true_peak"].max())
        m["gate_gain"] = float(fm["gate_gain"][-1])
        m["gate_is_open"] = bool(fm["gate_is_open"][-1])
        m["gate_fused_score"] = float(fm["gate_fused_score"][-1])
        m["gate_chatter_events"] = int(fm["gate_chatter_events"][-1])
        m["gate_auto_relax_active"] = bool(fm["gate_auto_relax_active"][-1])
        m["noise_floor_db"] = float(fm["noise_floor_db"][-1])
        m["noise_floor_reliability"] = float(
            fm["noise_floor_reliability"][-1]
        )
        m["gate_threshold_db"] = float(fm["gate_threshold_db"][-1])
        m["hum_detected"] = bool(fm["routing_hum_detected"][-1])
        m["rumble_detected"] = bool(fm["routing_rumble_detected"][-1])
        m["selected_hp_hz"] = float(fm["routing_selected_hp_hz"][-1])
        m["compressor_gain_reduction_db"] = float(
            bm["compressor_gain_reduction_db"][-1]
        )
        m["compressor_makeup_gain_db"] = float(
            bm["compressor_makeup_gain_db"][-1]
        )
        m["compressor_lufs"] = float(bm["compressor_lufs"][-1])
        m["compressor_release_ms"] = float(bm["compressor_release_ms"][-1])
        m["deesser_gain_reduction_db"] = float(
            bm["deesser_gain_reduction_db"][-1]
        )
        m["deesser_detector_confidence"] = float(
            bm["deesser_detector_confidence"][-1]
        )
        m["limiter_gain_reduction_db"] = float(
            bm["limiter_gain_reduction_db"].max()
        )
        m["tp_gain_reduction_db"] = float(bm["tp_gain_reduction_db"].max())
        m["output_peak_db"] = float(bm["output_peak_db"][-1])
        m["output_rms_db"] = float(bm["output_rms_db"][-1])
        m["output_crest_factor_db"] = float(bm["output_crest_factor_db"][-1])
        m["output_true_peak"] = float(bm["output_true_peak"].max())
        m["output_lufs"] = float(bm["output_lufs"][-1])
        in_clips = int(fm["input_clip_count"].sum())
        out_clips = int(bm["output_clip_count"].sum())
        tp_events = int(bm["tp_limited_events"].sum())
        with self._lock:
            # per-block values so burst spans keep one history entry per
            # block (the UI timeline must not compress 8 blocks into 1)
            self._last_burst_gr = [
                float(v) for v in
                np.asarray(bm["limiter_gain_reduction_db"]).ravel()
            ]
            self._last_burst_tp = [
                float(v) for v in
                np.asarray(bm["tp_gain_reduction_db"]).ravel()
            ]
            self._metrics.update(m)
            self._metrics["limiter_peak_gain_reduction_db"] = max(
                self._metrics["limiter_peak_gain_reduction_db"],
                m["limiter_gain_reduction_db"],
            )
            if in_clips:
                self._counters["clip_event_count"] += in_clips
                self._counters["clip_peak_db"] = max(
                    self._counters["clip_peak_db"],
                    float(fm["input_clip_peak_db"].max()),
                )
            if out_clips:
                self._counters["output_clip_event_count"] += out_clips
                self._counters["output_clip_peak_db"] = max(
                    self._counters["output_clip_peak_db"],
                    float(bm["output_clip_peak_db"].max()),
                )
            self._metrics["output_true_peak_events"] += tp_events
        return new_state, out, engine, supp_delay

    # ---- recording tap / output probe ---------------------------------

    def _tap_recording(self, block: np.ndarray) -> None:
        with self._lock:
            rec = self._recording
            if rec is None or rec["complete"]:
                return
            rec["buffer"].append(block.copy())
            rec["captured"] += block.size
            rms = float(np.sqrt(np.mean(block.astype(np.float64) ** 2)))
            rec["level_db"] = 20.0 * math.log10(max(rms, 1e-10))
            if rec["captured"] >= rec["total"]:
                rec["complete"] = True

    def _mix_probe(self, block: np.ndarray) -> np.ndarray:
        with self._lock:
            probe = self._probe
            if probe is None or probe["cancelled"]:
                if probe is not None:
                    self._probe = None
                return block
            pos = probe["pos"]
            remaining = probe["samples"].size - pos
            n = min(block.size, remaining)
            chunk = probe["samples"][pos : pos + n]
            probe["pos"] += n
            mix_through = probe["mix_through"]
            if probe["pos"] >= probe["samples"].size:
                probe["complete"] = True
                self._probe = None
        out = block if mix_through else np.zeros_like(block)
        out = out.copy()
        out[: chunk.size] += chunk
        return out

    # ==================================================================
    # Control surface (`python_api.rs:886-1423`) — names/semantics parity
    # ==================================================================

    def _set_param(self, key, value, low=None, high=None):
        value = float(value)
        if not math.isfinite(value):
            return
        if low is not None:
            value = min(max(value, low), high)
        with self._lock:
            if self._params[key] != value:
                self._params[key] = value
                self._params_dirty = True

    def _set_topo(self, key, value):
        with self._lock:
            if self._topology[key] != value:
                self._topology[key] = value
                self._topology_dirty = True

    def _set_deesser(self, key, value, low, high):
        value = float(value)
        if not math.isfinite(value):
            return
        value = min(max(value, low), high)
        with self._lock:
            if self._deesser[key] != value:
                self._deesser[key] = value
                self._topology_dirty = True  # de-esser numerics are static

    # --- bypass / monitor / input conditioning

    def set_bypass(self, bypass: bool):
        self._bypass = bool(bypass)

    def is_bypass(self) -> bool:
        return self._bypass

    def set_raw_monitor_enabled(self, enabled: bool):
        self._raw_monitor = bool(enabled)

    def is_raw_monitor_enabled(self) -> bool:
        return self._raw_monitor

    def set_input_channel_mode(self, mode: str):
        if mode not in _INPUT_CHANNEL_MODES:
            raise ValueError(f"invalid input channel mode: {mode}")
        self._input_channel_mode = mode

    def get_input_channel_mode(self) -> str:
        return self._input_channel_mode

    def set_input_cleanup_mode(self, mode: str):
        if mode not in _CLEANUP_MODES:
            raise ValueError(f"invalid input cleanup mode: {mode}")
        self._set_topo("cleanup_mode", mode)

    def get_input_cleanup_mode(self) -> str:
        return self._topology["cleanup_mode"]

    # --- gate

    def set_gate_enabled(self, enabled: bool):
        self._set_topo("gate_enabled", bool(enabled))

    def is_gate_enabled(self) -> bool:
        return self._topology["gate_enabled"]

    def get_gate_chatter_event_count(self) -> int:
        return int(self._metrics["gate_chatter_events"])

    def set_gate_threshold(self, threshold_db: float):
        self._set_param("gate_threshold_db", threshold_db, -80.0, -10.0)

    def set_gate_attack(self, attack_ms: float):
        self._set_param("gate_attack_ms", attack_ms, 0.1, 100.0)

    def set_gate_release(self, release_ms: float):
        self._set_param("gate_release_ms", release_ms, 10.0, 1000.0)

    def set_gate_mode(self, mode: int):
        if int(mode) not in (0, 1, 2):
            raise ValueError("gate mode must be 0 (threshold), 1 (VAD-assisted), or 2 (VAD-only)")
        self._set_topo("gate_mode", int(mode))

    def get_vad_probability(self) -> float:
        return float(self._vad_state["probability"])

    def get_gate_fused_score(self) -> float:
        return float(self._metrics["gate_fused_score"])

    def is_vad_available(self) -> bool:
        v = self._vad_state
        if not v["available"]:
            return False
        return (time.perf_counter() - v["timestamp"]) * 1e3 <= VAD_STALE_MS

    def set_vad_threshold(self, threshold: float):
        self._set_param("vad_threshold", threshold, 0.05, 0.95)

    def set_vad_hold_time(self, hold_ms: float):
        self._set_param("vad_hold_time_ms", hold_ms, 0.0, 500.0)

    def set_vad_pre_gain(self, gain: float):
        self._set_param("vad_pre_gain", gain, 1.0, 10.0)

    def vad_pre_gain(self) -> float:
        return float(self._params["vad_pre_gain"])

    def set_auto_threshold(self, enabled: bool):
        self._set_topo("auto_threshold_enabled", bool(enabled))

    def auto_threshold_enabled(self) -> bool:
        return self._topology["auto_threshold_enabled"]

    def set_gate_margin(self, margin_db: float):
        self._set_param("gate_margin_db", margin_db, 0.0, 20.0)

    def gate_margin(self) -> float:
        return float(self._params["gate_margin_db"])

    def get_noise_floor(self) -> float:
        return float(self._metrics["noise_floor_db"])

    # --- suppressor

    def set_rnnoise_enabled(self, enabled: bool):
        self._set_topo("suppressor_enabled", bool(enabled))

    def is_rnnoise_enabled(self) -> bool:
        return self._topology["suppressor_enabled"]

    def set_rnnoise_strength(self, strength: float):
        self._set_param("suppressor_strength", strength, 0.0, 1.0)

    def get_rnnoise_strength(self) -> float:
        return float(self._params["suppressor_strength"])

    def set_noise_model(self, model: str) -> bool:
        if model not in supp.NOISE_MODELS:
            return False
        if model.startswith("deepfilter") and not supp.deepfilter_enabled():
            return False
        self._set_topo("noise_model", model)
        return True

    def get_noise_model(self) -> str:
        return self._topology["noise_model"]

    def get_noise_model_display_name(self) -> str:
        names = dict(self.list_noise_models())
        model = self._topology["noise_model"]
        # a model selected while its env gate was on stays displayable
        # even if the gate flips off afterwards
        fallback = {"deepfilter-ll": "DeepFilterNet3 (low latency)",
                    "deepfilter": "DeepFilterNet3"}
        return names.get(model, fallback.get(model, model))

    def list_noise_models(self):
        """`python_api.rs:1081`: (id, display name) pairs."""
        out = [("rnnoise", "RNNoise")]
        if supp.deepfilter_enabled():
            out.append(("deepfilter-ll", "DeepFilterNet3 (low latency)"))
            out.append(("deepfilter", "DeepFilterNet3"))
        return out

    def is_noise_backend_available(self) -> bool:
        model = self._topology["noise_model"]
        return not model.startswith("deepfilter") or supp.deepfilter_enabled()

    def noise_backend_failed(self) -> bool:
        """True once the suppressor stage failed: an error of its engine
        call (a capture or replay on the card) or a backend that latched on
        a non-finite model output."""
        engine = self._engine
        latched = bool(engine is not None
                       and engine["proc"].get("backend_failed", False))
        return self._suppressor_error is not None or latched

    def noise_backend_error(self):
        if self._suppressor_error is not None:
            return self._suppressor_error
        if self.noise_backend_failed():
            return "noise model produced a non-finite frame; backend latched to passthrough"
        return None

    # --- EQ

    def set_eq_enabled(self, enabled: bool):
        self._set_topo("eq_enabled", bool(enabled))

    def is_eq_enabled(self) -> bool:
        return self._topology["eq_enabled"]

    def _update_eq_band(self, band: int, **changes):
        if not 0 <= band < eq_ops.NUM_BANDS:
            raise ValueError(f"EQ band index out of range: {band}")
        with self._lock:
            cfg = self._eq_bands[band]
            new_cfg = eq_ops.EqBandConfig(
                filter_type=changes.get("filter_type", cfg.filter_type),
                frequency_hz=changes.get("frequency_hz", cfg.frequency_hz),
                gain_db=changes.get("gain_db", cfg.gain_db),
                q=changes.get("q", cfg.q),
                slope_db_per_octave=changes.get(
                    "slope_db_per_octave", cfg.slope_db_per_octave
                ),
                enabled=changes.get("enabled", cfg.enabled),
            )
            eq_ops.validate_band(new_cfg, float(SAMPLE_RATE))
            self._eq_bands[band] = new_cfg
            self._pending_eq.append((band, new_cfg))
            self._params_dirty = True

    def set_eq_band_gain(self, band: int, gain_db: float):
        self._update_eq_band(band, gain_db=float(gain_db))

    def set_eq_band_frequency(self, band: int, frequency: float):
        self._update_eq_band(band, frequency_hz=float(frequency))

    def set_eq_band_q(self, band: int, q: float):
        self._update_eq_band(band, q=float(q))

    def set_eq_band_filter_type(self, band: int, filter_type: str):
        self._update_eq_band(
            band, filter_type=eq_ops.EqBandConfig.type_id(filter_type)
        )

    def set_eq_band_slope(self, band: int, slope_db_per_octave: int):
        self._update_eq_band(
            band, slope_db_per_octave=int(slope_db_per_octave)
        )

    def set_eq_band_enabled(self, band: int, enabled: bool):
        self._update_eq_band(band, enabled=bool(enabled))

    def get_eq_band_params(self, band: int):
        if not 0 <= band < eq_ops.NUM_BANDS:
            return None
        cfg = self._eq_bands[band]
        return (float(cfg.frequency_hz), float(cfg.gain_db), float(cfg.q))

    def get_eq_band_config(self, band: int):
        if not 0 <= band < eq_ops.NUM_BANDS:
            return None
        cfg = self._eq_bands[band]
        return (
            eq_ops.FILTER_TYPE_NAMES[int(cfg.filter_type)],
            float(cfg.frequency_hz),
            float(cfg.gain_db),
            float(cfg.q),
            int(cfg.slope_db_per_octave),
            bool(cfg.enabled),
        )

    def apply_eq_settings(self, bands):
        """Legacy (freq, gain, q) triples onto default band types
        (`python_api.rs:1160`)."""
        if len(bands) != eq_ops.NUM_BANDS:
            raise ValueError(
                f"expected {eq_ops.NUM_BANDS} EQ bands, got {len(bands)}"
            )
        for i, (freq, gain, q) in enumerate(bands):
            self._update_eq_band(
                i, frequency_hz=float(freq), gain_db=float(gain), q=float(q)
            )

    def apply_eq_settings_v2(self, bands):
        """Schema-v2 (type, freq, gain, q, slope, enabled) tuples
        (`python_api.rs:1168`)."""
        if len(bands) != eq_ops.NUM_BANDS:
            raise ValueError(
                f"expected {eq_ops.NUM_BANDS} EQ bands, got {len(bands)}"
            )
        for i, (ftype, freq, gain, q, slope, enabled) in enumerate(bands):
            self._update_eq_band(
                i,
                filter_type=eq_ops.EqBandConfig.type_id(ftype),
                frequency_hz=float(freq),
                gain_db=float(gain),
                q=float(q),
                slope_db_per_octave=int(slope),
                enabled=bool(enabled),
            )

    # --- de-esser

    def set_deesser_enabled(self, enabled: bool):
        self._set_topo("deesser_enabled", bool(enabled))

    def is_deesser_enabled(self) -> bool:
        return self._topology["deesser_enabled"]

    def set_deesser_auto_enabled(self, enabled: bool):
        with self._lock:
            if self._deesser["auto_enabled"] != bool(enabled):
                self._deesser["auto_enabled"] = bool(enabled)
                self._topology_dirty = True

    def is_deesser_auto_enabled(self) -> bool:
        return self._deesser["auto_enabled"]

    def set_deesser_auto_amount(self, amount: float):
        self._set_deesser("auto_amount", amount, 0.0, 1.0)

    def get_deesser_auto_amount(self) -> float:
        return float(self._deesser["auto_amount"])

    def set_deesser_low_cut_hz(self, hz: float):
        self._set_deesser("low_cut_hz", hz, 2000.0, 12000.0)

    def get_deesser_low_cut_hz(self) -> float:
        return float(self._deesser["low_cut_hz"])

    def set_deesser_high_cut_hz(self, hz: float):
        self._set_deesser("high_cut_hz", hz, 2200.0, 16000.0)

    def get_deesser_high_cut_hz(self) -> float:
        return float(self._deesser["high_cut_hz"])

    def set_deesser_threshold_db(self, threshold_db: float):
        self._set_deesser("threshold_db", threshold_db, -60.0, -6.0)

    def get_deesser_threshold_db(self) -> float:
        return float(self._deesser["threshold_db"])

    def set_deesser_ratio(self, ratio: float):
        self._set_deesser("ratio", ratio, 1.0, 20.0)

    def get_deesser_ratio(self) -> float:
        return float(self._deesser["ratio"])

    def set_deesser_attack_ms(self, attack_ms: float):
        self._set_deesser("attack_ms", attack_ms, 0.1, 50.0)

    def set_deesser_release_ms(self, release_ms: float):
        self._set_deesser("release_ms", release_ms, 5.0, 500.0)

    def set_deesser_max_reduction_db(self, max_reduction_db: float):
        self._set_deesser("max_reduction_db", max_reduction_db, 0.0, 24.0)

    def get_deesser_max_reduction_db(self) -> float:
        return float(self._deesser["max_reduction_db"])

    def get_deesser_gain_reduction_db(self) -> float:
        return float(self._metrics["deesser_gain_reduction_db"])

    def get_deesser_detector_confidence(self) -> float:
        return float(self._metrics["deesser_detector_confidence"])

    # --- compressor

    def set_compressor_enabled(self, enabled: bool):
        self._set_topo("compressor_enabled", bool(enabled))

    def is_compressor_enabled(self) -> bool:
        return self._topology["compressor_enabled"]

    def set_compressor_threshold(self, threshold_db: float):
        self._set_param("compressor_threshold_db", threshold_db, -60.0, 0.0)

    def set_compressor_ratio(self, ratio: float):
        self._set_param("compressor_ratio", ratio, 1.0, 20.0)

    def set_compressor_attack(self, attack_ms: float):
        self._set_param("compressor_attack_ms", attack_ms, 0.1, 100.0)

    def set_compressor_release(self, release_ms: float):
        self._set_param("compressor_release_ms", release_ms, 10.0, 1000.0)

    def get_compressor_release(self) -> float:
        return float(self._params["compressor_release_ms"])

    def set_compressor_makeup_gain(self, makeup_gain_db: float):
        self._set_param("compressor_makeup_gain_db", makeup_gain_db, 0.0, 24.0)

    def set_compressor_adaptive_release(self, enabled: bool):
        self._set_topo("adaptive_release", bool(enabled))

    def get_compressor_adaptive_release(self) -> bool:
        return self._topology["adaptive_release"]

    def set_compressor_base_release(self, release_ms: float):
        self._set_param("compressor_base_release_ms", release_ms, 20.0, 200.0)

    def get_compressor_base_release(self) -> float:
        return float(self._params["compressor_base_release_ms"])

    def set_compressor_sidechain_highpass_enabled(self, enabled: bool):
        self._set_topo("sidechain_highpass_enabled", bool(enabled))

    def get_compressor_sidechain_highpass_enabled(self) -> bool:
        return self._topology["sidechain_highpass_enabled"]

    def get_compressor_current_release(self) -> float:
        return float(self._metrics["compressor_release_ms"])

    def set_compressor_auto_makeup_enabled(self, enabled: bool):
        self._set_topo("auto_makeup_enabled", bool(enabled))

    def get_compressor_auto_makeup_enabled(self) -> bool:
        return self._topology["auto_makeup_enabled"]

    def set_compressor_target_lufs(self, target_lufs: float):
        self._set_param("compressor_target_lufs", target_lufs, -24.0, -12.0)

    def get_compressor_target_lufs(self) -> float:
        return float(self._params["compressor_target_lufs"])

    def set_compressor_noise_reference_reliability(self, reliability: float):
        self._set_param("noise_reference_reliability", reliability, 0.0, 1.0)

    def get_compressor_current_lufs(self) -> float:
        return float(self._metrics["compressor_lufs"])

    def get_compressor_current_makeup_gain(self) -> float:
        return float(self._metrics["compressor_makeup_gain_db"])

    def get_compressor_gain_reduction_db(self) -> float:
        return float(self._metrics["compressor_gain_reduction_db"])

    # --- limiter

    def set_limiter_enabled(self, enabled: bool):
        self._set_topo("limiter_enabled", bool(enabled))

    def is_limiter_enabled(self) -> bool:
        return self._topology["limiter_enabled"]

    def set_limiter_ceiling(self, ceiling_db: float):
        self._set_param("limiter_ceiling_db", ceiling_db, -12.0, 0.0)

    def set_limiter_release(self, release_ms: float):
        self._set_param("limiter_release_ms", release_ms, 10.0, 500.0)

    def set_limiter_careful_output_enabled(self, enabled: bool):
        self._set_topo("careful_output_enabled", bool(enabled))

    def is_limiter_careful_output_enabled(self) -> bool:
        return self._topology["careful_output_enabled"]

    def get_limiter_effective_ceiling_db(self) -> float:
        return lc.effective_limiter_ceiling_db(
            self._params["limiter_ceiling_db"],
            self._topology["careful_output_enabled"],
        )

    # --- metering getters (`python_api.rs:1425-1620`)

    def get_input_peak_db(self) -> float:
        return float(self._metrics["input_peak_db"])

    def get_input_rms_db(self) -> float:
        return float(self._metrics["input_rms_db"])

    def get_input_crest_factor_db(self) -> float:
        return float(self._metrics["input_crest_factor_db"])

    def get_output_peak_db(self) -> float:
        return float(self._metrics["output_peak_db"])

    def get_output_rms_db(self) -> float:
        return float(self._metrics["output_rms_db"])

    def get_output_crest_factor_db(self) -> float:
        return float(self._metrics["output_crest_factor_db"])

    def get_output_short_term_lufs(self) -> float:
        return float(self._metrics["output_lufs"])

    def get_input_stereo_correlation(self) -> float:
        return float(self._metrics["input_stereo_correlation"])

    def get_input_phase_warning_count(self) -> int:
        return int(self._counters["input_phase_warning_count"])

    def get_latency_ms(self) -> float:
        return self.get_engine_latency_ms() + self._latency_compensation_ms

    def get_engine_latency_ms(self) -> float:
        with self._lock:
            topo = dict(self._topology)
            par = dict(self._params)
            dee = dict(self._deesser)
        config = self._build_config(topo, par, dee)
        supp_lat = int(
            supp.model_latency_ms(topo["noise_model"]) / 1e3 * SAMPLE_RATE
        )
        samples = lc.chain_latency_samples(config, supp_lat)
        # in/out ring targets scale with the host step: a step of H blocks
        # holds up to H blocks on each side (H=1 = reference accounting)
        buffered = 2 * BLOCK * self._host_block_multiple
        return (samples + buffered) / SAMPLE_RATE * 1e3

    def set_latency_compensation_ms(self, compensation_ms: float):
        value = float(compensation_ms)
        if math.isfinite(value):
            self._latency_compensation_ms = min(max(value, 0.0), 1000.0)

    def get_latency_compensation_ms(self) -> float:
        return self._latency_compensation_ms

    def get_dsp_time_ms(self) -> float:
        return float(self._metrics["dsp_time_ms"])

    def get_dsp_time_smoothed_ms(self) -> float:
        return float(self._metrics["dsp_time_smoothed_ms"])

    def get_input_buffer_samples(self) -> int:
        ring = getattr(self, "_in_ring", None)
        return int(ring.available()) if ring is not None else 0

    def get_input_buffer_smoothed_samples(self) -> int:
        return self.get_input_buffer_samples()

    def get_buffer_smoothed_samples(self) -> int:
        return self.get_input_buffer_samples()

    def get_output_buffer_samples(self) -> int:
        ring = getattr(self, "_out_ring", None)
        return int(ring.available()) if ring is not None else 0

    def get_rnnoise_buffer_samples(self) -> int:
        return 0

    def get_dropped_samples(self) -> int:
        ring = getattr(self, "_in_ring", None)
        base = int(ring.dropped()) if ring is not None else 0
        return base + int(self._counters["dropped_samples"])

    def reset_dropped_samples(self):
        ring = getattr(self, "_in_ring", None)
        if ring is not None:
            ring.reset_dropped()
        with self._lock:
            self._counters["dropped_samples"] = 0

    def get_lock_contention_count(self) -> int:
        return int(self._counters["lock_contention_count"])

    def reset_lock_contention_count(self):
        with self._lock:
            self._counters["lock_contention_count"] = 0

    def get_input_callback_age_ms(self) -> int:
        at = self._counters["input_callback_at"]
        return int((time.perf_counter() - at) * 1e3) if at else 0

    def get_output_callback_age_ms(self) -> int:
        at = self._counters["output_callback_at"]
        return int((time.perf_counter() - at) * 1e3) if at else 0

    def get_output_underrun_streak(self) -> int:
        return int(self._counters["output_underrun_streak"])

    def get_output_underrun_total(self) -> int:
        return int(self._counters["output_underrun_total"])

    def get_jitter_dropped_samples(self) -> int:
        return int(self._counters["jitter_dropped_samples"])

    def get_output_retime_adjustment_count(self) -> int:
        return int(self._counters["output_retime_adjustment_count"])

    def get_output_recovery_event_count(self) -> int:
        return int(self._counters["output_recovery_event_count"])

    def get_output_recovery_count(self) -> int:
        return int(self._counters["output_recovery_count"])

    def get_suppressor_non_finite_count(self) -> int:
        return int(self._counters["suppressor_non_finite_count"])

    def get_rt_error_code(self) -> int:
        return int(self._counters["rt_error_code"])

    _RT_ERROR_NAMES = {
        0: "none",
        1: "input_queue_full",
        2: "output_queue_full",
        3: "non_finite",
        4: "processor_unavailable",
    }

    def get_rt_error_name(self) -> str:
        """Single-word RT error channel names (`rt.rs:11-50`)."""
        return self._RT_ERROR_NAMES.get(
            int(self._counters["rt_error_code"]), "processor_unavailable"
        )

    def get_input_callback_error_count(self) -> int:
        return int(self._counters["input_callback_error_count"])

    def get_output_callback_error_count(self) -> int:
        return int(self._counters["output_callback_error_count"])

    def get_rt_buffer_overflow_count(self) -> int:
        ring = getattr(self, "_in_ring", None)
        return int(ring.overflow_events()) if ring is not None else 0

    def set_recovery_suppressed(self, suppressed: bool):
        self._recovery_suppressed = bool(suppressed)

    def is_recovery_suppressed(self) -> bool:
        return self._recovery_suppressed

    # --- recovery (`processor/recovery.rs:8-123`)

    _RECOVERY_BACKOFF_S = (0.0, 2.0, 5.0, 10.0)

    def request_recovery(self, reason: str):
        """Flag a stream failure; ``service_recovery`` performs the
        restart with 0/2/5/10 s backoff."""
        with self._lock:
            if not self._recovery["requested"]:
                self._recovery["requested"] = True
                self._recovery["last_reason"] = str(reason)
                idx = min(
                    self._recovery["attempt_index"],
                    len(self._RECOVERY_BACKOFF_S) - 1,
                )
                self._recovery["next_attempt_at"] = (
                    time.perf_counter() + self._RECOVERY_BACKOFF_S[idx]
                )

    def is_recovery_requested(self) -> bool:
        return bool(self._recovery["requested"])

    def is_recovering(self) -> bool:
        return bool(self._recovery["recovering"])

    def get_stream_restart_count(self) -> int:
        return int(self._recovery["restart_count"])

    def get_last_stream_error(self):
        return self._recovery["last_error"]

    def get_last_restart_reason(self):
        return self._recovery["last_reason"]

    def service_recovery(self):
        """Attempt a pending restart. Returns None when nothing was due,
        else True/False for success (`recovery.rs:8-123`)."""
        with self._lock:
            due = (
                self._recovery["requested"]
                and not self._recovery_suppressed
                and time.perf_counter() >= self._recovery["next_attempt_at"]
            )
            if not due:
                return None
            self._recovery["recovering"] = True
            in_dev, out_dev = self._active_input, self._active_output
        try:
            self.stop()
            self.start(in_dev, out_dev)
            ok = True
            error = None
        except Exception as exc:  # noqa: BLE001 — recovery reports, never raises
            ok = False
            error = str(exc)
        with self._lock:
            self._recovery["recovering"] = False
            self._recovery["last_error"] = error
            if ok:
                self._recovery["requested"] = False
                self._recovery["attempt_index"] = 0
                self._recovery["restart_count"] += 1
            else:
                self._recovery["attempt_index"] += 1
                idx = min(
                    self._recovery["attempt_index"],
                    len(self._RECOVERY_BACKOFF_S) - 1,
                )
                self._recovery["next_attempt_at"] = (
                    time.perf_counter() + self._RECOVERY_BACKOFF_S[idx]
                )
        return ok

    # --- raw recording (`python_api.rs:1980-2014`)

    def start_raw_recording(self, duration_secs: float):
        duration = float(duration_secs)
        if not math.isfinite(duration) or not 0.1 <= duration <= 600.0:
            raise ValueError(
                "recording duration must be between 0.1 and 600 seconds"
            )
        if not self._running:
            raise RuntimeError("processor is not running")
        with self._lock:
            self._recording = {
                "total": int(duration * SAMPLE_RATE),
                "captured": 0,
                "buffer": [],
                "complete": False,
                "level_db": -100.0,
            }

    def stop_raw_recording(self):
        with self._lock:
            rec = self._recording
            self._recording = None
        if rec is None:
            return []
        audio = (
            np.concatenate(rec["buffer"]) if rec["buffer"]
            else np.zeros(0, np.float32)
        )
        return audio[: rec["total"]].tolist()

    def is_recording_complete(self) -> bool:
        rec = self._recording
        return bool(rec and rec["complete"])

    def recording_progress(self) -> float:
        rec = self._recording
        if not rec or rec["total"] == 0:
            return 0.0
        return min(1.0, rec["captured"] / rec["total"])

    def recording_level_db(self) -> float:
        rec = self._recording
        return float(rec["level_db"]) if rec else -100.0

    # --- output probe (`python_api.rs:2016-2042`)

    def set_output_mute(self, muted: bool):
        self._output_muted = bool(muted)

    def queue_output_probe(self, samples, mix_through: bool = False):
        buf = np.asarray(samples, np.float32).ravel()
        if buf.size == 0 or not np.all(np.isfinite(buf)):
            raise ValueError("probe samples must be non-empty and finite")
        with self._lock:
            self._probe = {
                "samples": np.clip(buf, -1.0, 1.0),
                "pos": 0,
                "complete": False,
                "cancelled": False,
                "mix_through": bool(mix_through),
            }
            self._probe_complete_flag = False

    def is_output_probe_complete(self) -> bool:
        with self._lock:
            if self._probe is None:
                return True
            return bool(self._probe["complete"])

    def cancel_output_probe(self):
        with self._lock:
            if self._probe is not None:
                self._probe["cancelled"] = True

    # --- runtime diagnostics dict (`python_api.rs:1620-1952`)

    def get_runtime_diagnostics(self) -> dict:
        with self._lock:
            m = dict(self._metrics)
            c = dict(self._counters)
            topo = dict(self._topology)
        ceiling = self.get_limiter_effective_ceiling_db()
        out_tp = m["output_true_peak"]
        out_tp_db = 20.0 * math.log10(max(out_tp, 1e-10))
        return {
            "noise_model": topo["noise_model"],
            "noise_attenuation_limit_db": 30.0,
            "noise_post_filter_beta": 0.0,
            "noise_backend_available": self.is_noise_backend_available(),
            "noise_backend_failed": self.noise_backend_failed(),
            "noise_backend_error": self.noise_backend_error(),
            "input_dropped_samples": self.get_dropped_samples(),
            "input_backlog_recovery_count": c["input_backlog_recovery_count"],
            "input_backlog_dropped_samples": c["input_backlog_dropped_samples"],
            "lock_contention_count": c["lock_contention_count"],
            "output_underrun_total": c["output_underrun_total"],
            "output_underrun_streak": c["output_underrun_streak"],
            "jitter_dropped_samples": c["jitter_dropped_samples"],
            "output_retime_adjustment_count": c["output_retime_adjustment_count"],
            "output_recovery_event_count": c["output_recovery_event_count"],
            "output_recovery_count": c["output_recovery_count"],
            "dsp_idle_wakeup_count": c["dsp_idle_wakeup_count"],
            "dsp_idle_sleep_us": c["dsp_idle_sleep_us"],
            "output_short_write_dropped_samples": c[
                "output_short_write_dropped_samples"
            ],
            "input_channel_mode": self._input_channel_mode,
            "input_cleanup_mode": topo["cleanup_mode"],
            "input_cleanup_hum_detected": m["hum_detected"],
            "input_cleanup_rumble_detected": m["rumble_detected"],
            "input_cleanup_high_pass_hz": m["selected_hp_hz"],
            "input_crest_factor_db": m["input_crest_factor_db"],
            "output_crest_factor_db": m["output_crest_factor_db"],
            "output_short_term_lufs": m["output_lufs"],
            "input_stereo_correlation": self.get_input_stereo_correlation(),
            "input_phase_warning_count": c["input_phase_warning_count"],
            "input_phase_rescue_strategy": m["input_phase_rescue_strategy"],
            "input_phase_estimated_delay_samples": m[
                "input_phase_estimated_delay_samples"
            ],
            "input_phase_polarity_flipped": m["input_phase_polarity_flipped"],
            "stream_restart_count": self.get_stream_restart_count(),
            "last_restart_reason": self.get_last_restart_reason(),
            "last_stream_error": self.get_last_stream_error(),
            "suppressor_non_finite_count": c["suppressor_non_finite_count"],
            "rt_error_code": c["rt_error_code"],
            "rt_error_name": self.get_rt_error_name(),
            "input_callback_error_count": c["input_callback_error_count"],
            "output_callback_error_count": c["output_callback_error_count"],
            "rt_buffer_overflow_count": self.get_rt_buffer_overflow_count(),
            "clip_event_count": c["clip_event_count"],
            "clip_peak_db": c["clip_peak_db"],
            "output_clip_event_count": c["output_clip_event_count"],
            "output_clip_peak_db": c["output_clip_peak_db"],
            "output_true_peak_event_count": m["output_true_peak_events"],
            "output_true_peak_db": out_tp_db,
            "output_true_peak_input_db": 20.0
            * math.log10(max(m["input_true_peak"], 1e-10)),
            "output_true_peak_gain_reduction_db": m["tp_gain_reduction_db"],
            "output_true_peak_gain_reduction_history_db": m["tp_gr_history_db"],
            "output_true_peak_headroom_db": ceiling - out_tp_db,
            "limiter_gain_reduction_db": m["limiter_gain_reduction_db"],
            "limiter_peak_gain_reduction_db": m[
                "limiter_peak_gain_reduction_db"
            ],
            "limiter_gain_reduction_history_db": m["limiter_gr_history_db"],
            "limiter_careful_output_enabled": topo["careful_output_enabled"],
            "limiter_effective_ceiling_db": ceiling,
            "gate_chatter_event_count": m["gate_chatter_events"],
            "gate_auto_relax_active": m["gate_auto_relax_active"],
            "deesser_detector_confidence": m["deesser_detector_confidence"],
            "host_block_multiple": self._host_block_multiple,
            "dsp_drain_span_blocks": m["dsp_drain_span_blocks"],
            "input_resampler_active": (
                getattr(self, "_input_device_rate", SAMPLE_RATE)
                != SAMPLE_RATE
            ),
            # virtual outputs are pinned to the 48 kHz engine rate; no
            # output-side resampler exists in this deviceless environment
            "output_resampler_active": False,
            "output_sample_rate": SAMPLE_RATE,
            "output_fixed_buffer_frames": BLOCK,
            "input_fixed_buffer_frames": BLOCK,
            "engine_latency_ms": self.get_engine_latency_ms(),
            "total_latency_ms": self.get_latency_ms(),
            "recovery_suppressed": self._recovery_suppressed,
            "raw_monitor_enabled": self._raw_monitor,
            "gate_fused_score": m["gate_fused_score"],
        }
