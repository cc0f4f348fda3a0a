"""Silero voice activity detection, batched over a leading stream axis.

Counterpart of ``audioforge_tpu/models/silero.py`` (the published Silero
v5/v6 16 kHz graph, the reference's ``vad.rs`` contract): a 576-sample
window at 16 kHz (64 samples of context and the 512-sample window), right
reflect pad by 64, four 256-sample frames at hop 128 projected on the
hann-windowed Fourier basis ``stft_basis [258, 1, 256]``, the magnitude over
129 bins, four Conv1d(k=3, pad 1) + ReLU blocks 129 -> 128 -> 64 -> 64 -> 128
with strides 1, 2, 2, 1 (time 4 -> 1), one LSTMCell(128, 128) whose (h, c)
is the ``[2, B, 128]`` state, ReLU, a 128 -> 1 head and a sigmoid. The
weight layout is the reference's (torch layouts, ``ONNX_NAME_MAP`` keys).

The serving step runs the model through two kernels with the GEMMs and
convolutions between them: :func:`vad_front` (decimation of the block to
16 kHz, the window's roll, the pre-gain and the four frames) and
:func:`vad_lstm_head` (the LSTM cell after its GEMMs, the head, and the
serving step's smoothing and calibration). Each launches its CUDA kernel for
a CUDA tensor and runs its plain twin for a CPU tensor.
:func:`silero_infer` is the model as the reference's API has it, in plain
torch.

:func:`vad_stream_init` / :func:`vad_stream_process` are the reference's
single-stream worker: one 1,536-sample window at 48 kHz a call (512 at 16
kHz), decimated by :func:`~..ops.resample.decimate3` to 512 samples behind
the 64 of context, then the STFT GEMM, the encoder, the LSTM's GEMMs and the
``vad_lstm_head`` kernel with the stream's ``smoothing`` and the
calibration, as one :class:`~..runtime.replay.BlockReplay` a window.
``vad_front`` is not used there: it has the serving layout (a 480-sample
block rolled into the window by 160), which does not fit a whole window.

:func:`analyze_vad_probabilities` is the offline pass over a take: the
windows' contexts are known up front, so the STFT projection, the encoder and
the LSTM's input GEMM run once over every window, and only the recurrence
chains, one graph replay a window on the card (a GEMM and one
``vad_lstm_head`` launch, which also applies the 0.5 EMA and the
calibration).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..ops import resample
from ..runtime.replay import BlockReplay, run_take

__all__ = [
    "SAMPLE_RATE", "WINDOW_SIZE", "CONTEXT_SIZE", "MODEL_INPUT_SIZE",
    "CALIBRATION_A", "CALIBRATION_B", "VAD_IN_PER_BLOCK", "VAD_WARMUP_BLOCKS",
    "ONNX_NAME_MAP", "stft_basis_analytic", "calibrate_probability", "init_params",
    "weights_from_numpy", "load_weights", "discover_model_path",
    "default_params", "weights_source", "stft_frames", "silero_infer",
    "vad_front", "vad_front_plain", "vad_gates", "vad_lstm_head",
    "vad_lstm_head_plain", "analyze_vad_probabilities", "vad_stream_init",
    "vad_stream_prepare", "vad_stream_process",
]

SAMPLE_RATE = 16000
WINDOW_SIZE = 512
CONTEXT_SIZE = 64
MODEL_INPUT_SIZE = CONTEXT_SIZE + WINDOW_SIZE  # 576
CALIBRATION_A = 0.6922877
CALIBRATION_B = 0.08612386

_STFT_N = 256
_STFT_HOP = 128
_STFT_PAD = 64  # right reflect pad: (576 + 64 - 256) // 128 + 1 = 4 frames
_N_BINS = _STFT_N // 2 + 1  # 129
_N_FRAMES = (MODEL_INPUT_SIZE + _STFT_PAD - _STFT_N) // _STFT_HOP + 1  # 4
_LSTM_HIDDEN = 128
# encoder blocks: (in_ch, out_ch, stride); kernel 3, symmetric zero pad 1
_ENC_SPEC = ((_N_BINS, 128, 1), (128, 64, 2), (64, 64, 2), (64, 128, 1))
_N_LAYERS = 2  # state planes: h and c of the single LSTMCell
_STATE_DIM = _LSTM_HIDDEN

# the conversion contract: weight key -> tensor name in the official Silero
# checkpoint (its jit/ONNX export's state dict)
ONNX_NAME_MAP = {
    "stft_basis": "_model.stft.forward_basis_buffer",
    **{f"enc{i}_{p}": f"_model.encoder.{i}.reparam_conv.{name}"
       for i in range(len(_ENC_SPEC)) for p, name in (("w", "weight"), ("b", "bias"))},
    "lstm_wi": "_model.decoder.rnn.weight_ih",
    "lstm_wh": "_model.decoder.rnn.weight_hh",
    "lstm_bi": "_model.decoder.rnn.bias_ih",
    "lstm_bh": "_model.decoder.rnn.bias_hh",
    "head_w": "_model.decoder.decoder.2.weight",
    "head_b": "_model.decoder.decoder.2.bias",
}

# serving cadence: 160 fresh 16 kHz samples a 480-sample block into the
# 576-sample window, warm after ceil(576 / 160) = 4 blocks
VAD_IN_PER_BLOCK = 480 // 3
VAD_WARMUP_BLOCKS = -(-MODEL_INPUT_SIZE // VAD_IN_PER_BLOCK)


def stft_basis_analytic() -> np.ndarray:
    """The hann-windowed 256-point Fourier basis, 129 real rows then 129
    imaginary rows, ``[258, 1, 256]`` f32 (the official buffer's value)."""
    n = _STFT_N
    basis = np.fft.fft(np.eye(n))[:_N_BINS]
    window = np.hanning(n + 1)[:n]  # periodic hann
    full = np.concatenate([basis.real, basis.imag], axis=0) * window
    return full[:, None, :].astype(np.float32)


def calibrate_probability(probability):
    """Platt calibration ``sigmoid(A logit(p) + B)`` (`vad.rs:468-477`);
    a non-finite input gives 0."""
    p = torch.as_tensor(probability, dtype=torch.float32)
    eps = 1e-6
    bounded = torch.clamp(p, eps, 1.0 - eps)
    logit = torch.log(bounded / (1.0 - bounded))
    transformed = torch.clamp(CALIBRATION_A * logit + CALIBRATION_B, -30.0, 30.0)
    out = torch.clamp(1.0 / (1.0 + torch.exp(-transformed)), 0.0, 1.0)
    return torch.where(torch.isfinite(p), out, 0.0)


def init_params(seed: int = 0x51E0) -> dict:
    """The reference's seeded weights, drawn from the same numpy generator in
    the same order (numpy f32 arrays), with the exact analytic STFT basis."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        scale = 1.0 / np.sqrt(np.prod(shape[1:]))
        return rng.normal(0.0, scale, shape).astype(np.float32)

    params = {"stft_basis": stft_basis_analytic()}
    for i, (cin, cout, _stride) in enumerate(_ENC_SPEC):
        params[f"enc{i}_w"] = w(cout, cin, 3)  # torch Conv1d layout
        params[f"enc{i}_b"] = np.zeros((cout,), np.float32)
    params["lstm_wi"] = w(4 * _LSTM_HIDDEN, _LSTM_HIDDEN)
    params["lstm_wh"] = w(4 * _LSTM_HIDDEN, _LSTM_HIDDEN)
    params["lstm_bi"] = np.zeros((4 * _LSTM_HIDDEN,), np.float32)
    params["lstm_bh"] = np.zeros((4 * _LSTM_HIDDEN,), np.float32)
    params["head_w"] = w(1, _LSTM_HIDDEN, 1)  # Conv1d(128 -> 1, k=1)
    params["head_b"] = np.zeros((1,), np.float32)
    return params


def _validate_loaded(params: dict, reference: dict) -> dict:
    missing, extra = set(reference) - set(params), set(params) - set(reference)
    if missing or extra:
        raise ValueError(f"weight archive key mismatch: missing={sorted(missing)} "
                         f"extra={sorted(extra)}")
    for key, ref in reference.items():
        if params[key].shape != ref.shape:
            raise ValueError(f"weight {key!r} shape {params[key].shape} != expected "
                             f"{ref.shape}")
    return params


def weights_from_numpy(arrays: dict, device="cpu") -> dict:
    """Validate a ``{name: array}`` weight dict against the graph's key/shape
    contract and move it to ``device``. Keys starting with ``__`` are
    provenance metadata and are dropped."""
    params = {k: np.asarray(v, np.float32) for k, v in arrays.items()
              if not k.startswith("__")}
    _validate_loaded(params, init_params())
    return {k: torch.as_tensor(v, device=device) for k, v in params.items()}


def load_weights(path, device="cpu") -> dict:
    with np.load(path) as data:
        return weights_from_numpy({k: data[k] for k in data.files}, device)


def discover_model_path():
    """``VAD_MODEL_PATH`` first, then ``models/silero_vad.npz`` at the root of
    the checkout. Returns None when neither exists."""
    env = os.environ.get("VAD_MODEL_PATH")
    if env and Path(env).is_file():
        return Path(env)
    candidate = Path(__file__).resolve().parents[2] / "models" / "silero_vad.npz"
    return candidate if candidate.is_file() else None


_DEFAULT_PARAMS_CACHE: dict = {}


def default_params() -> dict:
    """The default weights (CPU tensors), resolved once per process: a
    discovered archive (:func:`discover_model_path`) wins, else the seeded
    weights; :func:`weights_source` says which."""
    if "params" not in _DEFAULT_PARAMS_CACHE:
        path = discover_model_path()
        if path is not None:
            with np.load(path) as data:
                arrays = {k: data[k] for k in data.files}
            source = (str(np.asarray(arrays["__provenance__"]).item())
                      if "__provenance__" in arrays else "converted")
            _DEFAULT_PARAMS_CACHE["params"] = weights_from_numpy(arrays)
        else:
            _DEFAULT_PARAMS_CACHE["params"] = weights_from_numpy(init_params())
            source = "seeded"
        _DEFAULT_PARAMS_CACHE["source"] = source
    return _DEFAULT_PARAMS_CACHE["params"]


def weights_source() -> str:
    """``"trained"`` or ``"converted"`` for an archive, ``"seeded"`` for the
    structural weights."""
    default_params()
    return _DEFAULT_PARAMS_CACHE["source"]


# ---------------------------------------------------------------------------
# Model pieces
# ---------------------------------------------------------------------------


def stft_frames(audio: torch.Tensor) -> torch.Tensor:
    """``audio [B, 576]`` -> the four frames of its right-reflect-padded
    form (``x[:, -2:-2-64:-1]``: the edge sample is not repeated) as rows of
    ``[B * 4, 256]``."""
    pad = audio[:, MODEL_INPUT_SIZE - 1 - _STFT_PAD:MODEL_INPUT_SIZE - 1].flip(-1)
    xp = torch.cat([audio, pad], dim=-1)
    return xp.unfold(-1, _STFT_N, _STFT_HOP).reshape(-1, _STFT_N)


def _stft_mag(params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Frames ``[B * 4, 256]`` -> magnitudes ``[B, 129, 4]`` (channel-major,
    as Conv1d takes them)."""
    proj = torch.matmul(frames, params["stft_basis"][:, 0, :].T)  # [B * 4, 258]
    re, im = proj[:, :_N_BINS], proj[:, _N_BINS:]
    mag = torch.sqrt(re * re + im * im + 1e-12)
    return mag.reshape(-1, _N_FRAMES, _N_BINS).transpose(1, 2)


def _encoder(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The four Conv1d + ReLU blocks; ``[B, 129, 4]`` -> ``[B, 128]``."""
    for i, (_cin, _cout, stride) in enumerate(_ENC_SPEC):
        h = torch.relu(F.conv1d(h, params[f"enc{i}_w"], params[f"enc{i}_b"],
                                stride=stride, padding=1))
    return h[:, :, 0]


def vad_gates(params: dict, frames: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Frames ``[B * 4, 256]`` and the LSTM's ``h0 [B, 128]`` -> the gate
    pre-activations ``x W_i^T + h0 W_h^T`` ``[B, 512]`` (ifgo, biases not
    added): the STFT projection, the encoder and the cell's two GEMMs."""
    x_t = _encoder(params, _stft_mag(params, frames))
    return torch.addmm(torch.matmul(x_t, params["lstm_wi"].T), h0, params["lstm_wh"].T)


def _lstm_cell_head(params: dict, gates: torch.Tensor, c0: torch.Tensor):
    """The LSTM cell from its pre-activations (biases added here), ReLU, the
    head and the sigmoid. Returns ``(prob [B], h1, c1)``."""
    g = gates + params["lstm_bi"] + params["lstm_bh"]
    i_g, f_g, g_g, o_g = torch.split(g, _LSTM_HIDDEN, dim=-1)
    c1 = torch.sigmoid(f_g) * c0 + torch.sigmoid(i_g) * torch.tanh(g_g)
    h1 = torch.sigmoid(o_g) * torch.tanh(c1)
    logits = torch.matmul(torch.relu(h1), params["head_w"][0, :, 0]) + params["head_b"][0]
    return torch.sigmoid(logits), h1, c1


def silero_infer(params: dict, audio_576: torch.Tensor, state: torch.Tensor):
    """One batched inference: ``audio_576 [B, 576]`` (pre-gain applied),
    ``state [2, B, 128]`` (h, c). Returns ``(prob [B], new_state)`` with the
    raw posterior."""
    gates = vad_gates(params, stft_frames(audio_576), state[0])
    prob, h1, c1 = _lstm_cell_head(params, gates, state[1])
    return prob, torch.stack([h1, c1], dim=0)


# ---------------------------------------------------------------------------
# Kernels of the serving step
# ---------------------------------------------------------------------------


def vad_front_plain(x, hist, window, pre_gain):
    """``x [N, 480]``, decimator history ``[N, 30]``, 16 kHz window ``[N,
    576]``, ``pre_gain`` (a scalar). Returns ``(hist, window, frames)``: the
    new history and window (unscaled) and the frames of ``window *
    pre_gain`` as ``[N * 4, 256]``."""
    dec, y16 = resample.decimate3({"hist": hist}, x)
    win = torch.cat([window[:, VAD_IN_PER_BLOCK:], y16], dim=-1)
    return dec["hist"], win, stft_frames(win * pre_gain)


def vad_front(x, hist, window, pre_gain):
    """:func:`vad_front_plain` on a CPU tensor; the ``vad_front`` CUDA kernel
    on a CUDA tensor (f32, contiguous; ``pre_gain`` a 0-d tensor there)."""
    if x.device.type == "cpu":
        return vad_front_plain(x, hist, window, pre_gain)
    if x.device.type != "cuda":
        raise ValueError(f"vad_front: unsupported device {x.device}")
    return _vad_front_launch(x, hist, window, pre_gain)


def _vad_front_launch(x, hist, window, pre_gain):
    n, dev = x.shape[0], x.device
    pre_gain = kernels.scalar(pre_gain, dev)
    kernels.check_tensor("vad_front x", x, torch.float32, (n, 3 * VAD_IN_PER_BLOCK), dev)
    kernels.check_tensor("vad_front hist", hist, torch.float32,
                         (n, resample.VAD_DECIMATE_TAPS - 1), dev)
    kernels.check_tensor("vad_front window", window, torch.float32,
                         (n, MODEL_INPUT_SIZE), dev)
    kernels.check_tensor("vad_front pre_gain", pre_gain, torch.float32, (), dev)
    kernels.check_aligned("vad_front x", x, 16)
    kernels.check_aligned("vad_front hist", hist, 8)
    kernels.check_aligned("vad_front window", window, 16)
    hist_out = torch.empty_like(hist)
    window_out = torch.empty_like(window)
    frames = torch.empty((n * _N_FRAMES, _STFT_N), dtype=torch.float32, device=dev)
    kernels.launch("vad_front", x.data_ptr(), hist.data_ptr(), window.data_ptr(),
                   pre_gain.data_ptr(), hist_out.data_ptr(), window_out.data_ptr(),
                   frames.data_ptr(), n, kernels.stream_of(dev))
    return hist_out, window_out, frames


def vad_lstm_head_plain(params, gates, lstm, smoothed, blocks_seen, smoothing,
                        warmup_blocks=VAD_WARMUP_BLOCKS):
    """The LSTM cell from the gate pre-activations ``[N, 512]`` and the state
    ``lstm [N, 2, 128]`` (h, c), the head, then the serving step's clip,
    warm-up, EMA (``smoothing``, from the first warm block on) and
    calibration. Returns ``(lstm, smoothed, blocks_seen, probability,
    available)``."""
    prob, h1, c1 = _lstm_cell_head(params, gates, lstm[:, 1])
    prob = torch.clamp(prob, 0.0, 1.0)
    warm = blocks_seen >= warmup_blocks - 1
    first = blocks_seen == warmup_blocks - 1
    sm = torch.where(first, prob, smoothing * prob + (1.0 - smoothing) * smoothed)
    sm = torch.where(warm, sm, 0.0)
    return (torch.stack([h1, c1], dim=1), sm, blocks_seen + 1,
            calibrate_probability(sm), warm)


def vad_lstm_head(params, gates, lstm, smoothed, blocks_seen, smoothing,
                  warmup_blocks=VAD_WARMUP_BLOCKS):
    """:func:`vad_lstm_head_plain` on a CPU tensor; the ``vad_lstm_head``
    CUDA kernel on a CUDA tensor (f32 and int32 ``blocks_seen``, contiguous;
    ``smoothing`` a 0-d tensor there)."""
    if gates.device.type == "cpu":
        return vad_lstm_head_plain(params, gates, lstm, smoothed, blocks_seen,
                                   smoothing, warmup_blocks)
    if gates.device.type != "cuda":
        raise ValueError(f"vad_lstm_head: unsupported device {gates.device}")
    return _vad_lstm_head_launch(params, gates, lstm, smoothed, blocks_seen, smoothing,
                                 warmup_blocks)


def _vad_lstm_head_launch(params, gates, lstm, smoothed, blocks_seen, smoothing,
                          warmup_blocks):
    n, dev, h = gates.shape[0], gates.device, _LSTM_HIDDEN
    smoothing = kernels.scalar(smoothing, dev)
    head_w = params["head_w"].reshape(-1)
    args = (("gates", gates, torch.float32, (n, 4 * h)),
            ("lstm", lstm, torch.float32, (n, _N_LAYERS, h)),
            ("lstm_bi", params["lstm_bi"], torch.float32, (4 * h,)),
            ("lstm_bh", params["lstm_bh"], torch.float32, (4 * h,)),
            ("head_w", head_w, torch.float32, (h,)),
            ("head_b", params["head_b"], torch.float32, (1,)),
            ("smoothed", smoothed, torch.float32, (n,)),
            ("blocks_seen", blocks_seen, torch.int32, (n,)),
            ("smoothing", smoothing, torch.float32, ()))
    for name, t, dtype, shape in args:
        kernels.check_tensor(f"vad_lstm_head {name}", t, dtype, shape, dev)
    lstm_out = torch.empty_like(lstm)
    smoothed_out = torch.empty_like(smoothed)
    seen_out = torch.empty_like(blocks_seen)
    prob = torch.empty_like(smoothed)
    avail = torch.empty((n,), dtype=torch.bool, device=dev)
    kernels.launch("vad_lstm_head", *(t.data_ptr() for _, t, _, _ in args),
                   lstm_out.data_ptr(), smoothed_out.data_ptr(), seen_out.data_ptr(),
                   prob.data_ptr(), avail.data_ptr(), n, warmup_blocks,
                   kernels.stream_of(dev))
    return lstm_out, smoothed_out, seen_out, prob, avail


# ---------------------------------------------------------------------------
# Streaming worker (one stream, a window a call)
# ---------------------------------------------------------------------------


def vad_stream_init(sample_rate: int = 48000, threshold: float = 0.5,
                    smoothing: float = 0.5, pre_gain: float = 1.0, params=None, *,
                    device="cuda") -> dict:
    """One stream's streaming state; the model runs on ``device`` (a CUDA
    device unless asked otherwise). The window's graph is built at the first
    inference and kept in the state (``"replay"``)."""
    if sample_rate not in (16000, 48000):
        raise ValueError("sample_rate must be 16000 or 48000")
    dev = kernels.resolve_device(device, "vad_stream_init")
    params = default_params() if params is None else params
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "params": {k: v.to(dev) for k, v in params.items()},
        "config": {
            "sample_rate": sample_rate,
            "threshold": float(threshold),
            "smoothing": float(smoothing),
            "pre_gain": float(max(pre_gain, 0.1)),
            "window_in": WINDOW_SIZE * (sample_rate // SAMPLE_RATE),
        },
        "buffer": np.zeros(0, np.float32),
        "model": {
            "context": torch.zeros((1, CONTEXT_SIZE), **f32),
            "lstm": torch.zeros((1, _N_LAYERS, _STATE_DIM), **f32),
            "dec3": resample.decimate3_init(n=1, device=dev),
            "smoothed": torch.zeros(1, **f32),
            "seen": torch.zeros(1, dtype=torch.int32, device=dev),
        },
        "smoothed_prob": 0.0,
        "has_inference": False,
        "replay": None,
    }


def _window_replay(state) -> BlockReplay:
    cfg, params = state["config"], state["params"]
    dev = params["lstm_wi"].device
    pre_gain = kernels.scalar(cfg["pre_gain"], dev)
    smoothing = kernels.scalar(cfg["smoothing"], dev)
    decimate = cfg["sample_rate"] == 48000

    def step(st, block):
        x = block["x"][None]
        dec3 = st["dec3"]
        if decimate:
            dec3, x = resample.decimate3(dec3, x)
        model_in = torch.cat([st["context"], x], dim=-1) * pre_gain
        gates = vad_gates(params, stft_frames(model_in), st["lstm"][:, 0])
        lstm, smoothed, seen, prob, _ = vad_lstm_head(
            params, gates, st["lstm"], st["smoothed"], st["seen"], smoothing,
            warmup_blocks=1)
        new = {"context": x[:, WINDOW_SIZE - CONTEXT_SIZE:], "lstm": lstm,
               "dec3": dec3, "smoothed": smoothed, "seen": seen}
        return new, {"probability": prob[0], "smoothed": smoothed[0]}

    return BlockReplay(step, state["model"], {"x": (cfg["window_in"],)}, device=dev,
                       k_max=1)


def vad_stream_prepare(state):
    """Build the window's graph now and, on the card, capture it, so that
    the first window pays no capture; no window is inferred."""
    state = dict(state)
    if state["replay"] is None:
        state["replay"] = _window_replay(state)
    state["replay"].prepare()
    return state


def vad_stream_process(state, samples):
    """Feed samples (1-D, at the configured rate); at most one window is
    inferred a call, as the reference does. Returns ``(state, calibrated
    probability)``; ``state["model"]`` is the window graph's static state,
    updated in place."""
    cfg = state["config"]
    buf = np.concatenate([state["buffer"], np.asarray(samples, np.float32).ravel()])
    win = cfg["window_in"]
    if len(buf) < win:
        return dict(state, buffer=buf), float(
            calibrate_probability(np.float32(state["smoothed_prob"])))
    state = dict(state, buffer=buf[win:])
    if state["replay"] is None:
        state["replay"] = _window_replay(state)
    out = state["replay"].run(buf[None, :win])
    state["smoothed_prob"] = float(out["smoothed"][0])
    state["has_inference"] = True
    return state, float(out["probability"][0])


# ---------------------------------------------------------------------------
# Offline pass over a take
# ---------------------------------------------------------------------------


def analyze_vad_probabilities(audio, sample_rate, threshold=0.48, params=None, *,
                              device="cuda"):
    """Calibrated posteriors of a take, one a model window (512 samples at
    16 kHz; 48 kHz input is decimated by 3 first); the last window is
    zero-padded. Runs on ``device`` (a CUDA device unless asked otherwise).
    ``threshold`` is accepted for the reference's signature."""
    del threshold
    if sample_rate not in (16000, 48000):
        raise ValueError("sample_rate must be 16000 or 48000")
    dev = kernels.resolve_device(device, "analyze_vad_probabilities")
    x = np.asarray(audio, np.float32)
    params = {k: v.to(dev) for k, v in (default_params() if params is None
                                        else params).items()}
    win_in = WINDOW_SIZE * (sample_rate // SAMPLE_RATE)
    n_windows = -(-len(x) // win_in) if len(x) else 0
    if n_windows == 0:
        return []
    padded = np.zeros((1, n_windows * win_in), np.float32)
    padded[0, :len(x)] = x
    x16 = torch.as_tensor(padded, device=dev)
    if sample_rate == 48000:
        _, x16 = resample.decimate3(resample.decimate3_init(n=1, device=dev), x16)
    windows = x16.reshape(n_windows, WINDOW_SIZE)
    contexts = torch.cat([windows.new_zeros((1, CONTEXT_SIZE)),
                          windows[:-1, WINDOW_SIZE - CONTEXT_SIZE:]])
    probs = _offline_windows(params, torch.cat([contexts, windows], dim=1))
    return [float(v) for v in probs.cpu()]


def _offline_windows(params, model_ins):
    """``model_ins [W, 576]`` -> calibrated probabilities ``[W]``: the input
    side of every window at once, then the LSTM chain window by window."""
    x_t = _encoder(params, _stft_mag(params, stft_frames(model_ins)))
    xw = torch.matmul(x_t, params["lstm_wi"].T)  # [W, 512]
    dev = model_ins.device
    smoothing = kernels.scalar(0.5, dev)
    wh_t = params["lstm_wh"].T
    state = {"lstm": torch.zeros((1, _N_LAYERS, _LSTM_HIDDEN), device=dev),
             "smoothed": torch.zeros(1, device=dev),
             "seen": torch.zeros(1, dtype=torch.int32, device=dev)}

    def step(st, block):
        gates = torch.addmm(block["xw"], st["lstm"][:, 0], wh_t)
        lstm, smoothed, seen, prob, _ = vad_lstm_head(
            params, gates, st["lstm"], st["smoothed"], st["seen"], smoothing,
            warmup_blocks=1)
        return {"lstm": lstm, "smoothed": smoothed, "seen": seen}, {"prob": prob}

    _, rows = run_take(step, state, {"xw": xw[:, None, :]}, xw.shape[0])
    return rows["prob"][:, 0]
