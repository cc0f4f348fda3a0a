"""RNNoise noise suppression, batched over a leading stream axis.

Counterpart of ``audioforge_tpu/models/rnnoise.py``: the published RNNoise
processing graph (input high-pass, Vorbis-windowed 960-point FFT at 480 hop,
22 ``eband5ms`` band energies, the Opus/CELT pitch tracker, the 42-dim
feature vector, dense -> 3 GRUs -> sigmoid heads, pitch comb filter, gain
interpolation and the silence bypass), with the same weight layout
(``{name}_wi [din, 3h]``, ``{name}_wh [h, 3h]``, ``{name}_b [3h]``, gate
order ``[z | r | h~]``).

Where the JAX package used one-hot matmuls or a barrel shifter to suit the
TPU, this port gathers; the input high-pass is one ``biquad_cascade`` launch
with f64 state; the GEMMs are ``torch.matmul``.

:func:`rnnoise_frames` runs a take frame by frame (one CUDA graph replay a
frame on the card, :mod:`..runtime.replay`); the ``processor_*`` functions are
the reference's frame-staging processor (numpy staging, soft-clipped PCM
scaling, one frame of dry delay, 15 ms strength smoothing) around one
stream's frame step, a :class:`~..runtime.replay.BlockReplay` that the
processor's state keeps from its first call on (on the card: captured once,
then one replay a frame).
"""

from __future__ import annotations

import os
from functools import cache
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..ops import biquad
from ..ops.dft import irdft, rdft
from ..runtime.replay import BlockReplay, copy_into, run_take

__all__ = [
    "FRAME_SIZE", "WINDOW_SIZE", "FREQ_SIZE", "NB_BANDS", "NB_FEATURES",
    "PCM_SCALE", "PCM_MODEL_LIMIT", "LATENCY_SAMPLES", "init_params", "load_weights",
    "archive_provenance",
    "discover_model_path", "default_params", "weights_source", "rnnoise_state_init",
    "frame_features", "rnnoise_pitch", "rnnoise_pitch_plain", "rnnoise_features",
    "rnnoise_features_plain", "rnnoise_frame", "rnnoise_frames", "soft_clip",
    "frame_replay", "processor_init", "processor_push", "processor_prepare",
    "processor_process",
    "processor_pop",
    "processor_soft_reset",
]

FRAME_SIZE = 480
WINDOW_SIZE = 960
FREQ_SIZE = WINDOW_SIZE // 2 + 1  # 481
NB_BANDS = 22
NB_DELTA_CEPS = 6
NB_FEATURES = NB_BANDS + 3 * NB_DELTA_CEPS + 2  # 42
CEPS_MEM = 8
LATENCY_SAMPLES = FRAME_SIZE

PITCH_MIN_PERIOD = 60
PITCH_MAX_PERIOD = 768
PITCH_FRAME_SIZE = 960
PITCH_BUF_SIZE = PITCH_MAX_PERIOD + PITCH_FRAME_SIZE  # 1728

PCM_SCALE = 32768.0
PCM_MODEL_LIMIT = 32760.0
SOFT_CLIP_THRESHOLD = 0.98

_SILENCE_ENERGY = 0.04
_GAIN_HANGOVER = 0.6

# input high-pass biquad (rnnoise denoise.c: b_hp / a_hp), stored as f32
_HP_COEFFS = np.array([[1.0, -2.0, 1.0, -1.99599, 0.99600]], dtype=np.float32)

_BAND_EDGES = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28,
                        34, 40, 48, 60, 78, 100]) * 4

# remove_doubling's sub-period cross-check table (celt/pitch.c)
_SECOND_CHECK = np.array([0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2])

_GRU_DIMS = {
    "vad_gru": (24, 24),
    "noise_gru": (24 + 24 + NB_FEATURES, 48),
    "denoise_gru": (24 + 48 + NB_FEATURES, 96),
}
_GRU_ACT = {"vad_gru": torch.tanh, "noise_gru": torch.relu,
            "denoise_gru": torch.relu}


def _vorbis_window() -> np.ndarray:
    n = np.arange(WINDOW_SIZE)
    s = np.sin(np.pi * (n + 0.5) / WINDOW_SIZE)
    return np.sin(0.5 * np.pi * s * s).astype(np.float32)


def _band_matrix() -> np.ndarray:
    """``(NB_BANDS, FREQ_SIZE)`` triangular band-energy weights."""
    m = np.zeros((NB_BANDS, FREQ_SIZE), np.float64)
    for b in range(NB_BANDS - 1):
        lo, hi = _BAND_EDGES[b], _BAND_EDGES[b + 1]
        for j in range(hi - lo):
            frac = j / (hi - lo)
            m[b, lo + j] += 1.0 - frac
            m[b + 1, lo + j] += frac
    m[0] *= 2.0
    m[NB_BANDS - 1] *= 2.0
    return m


def _interp_matrix() -> np.ndarray:
    """``(FREQ_SIZE, NB_BANDS)`` per-bin gain interpolation."""
    m = np.zeros((FREQ_SIZE, NB_BANDS), np.float64)
    for b in range(NB_BANDS - 1):
        lo, hi = _BAND_EDGES[b], _BAND_EDGES[b + 1]
        for j in range(hi - lo):
            frac = j / (hi - lo)
            m[lo + j, b] = 1.0 - frac
            m[lo + j, b + 1] = frac
    return m


def _band_weights() -> np.ndarray:
    """``(2, 400)``: a bin's weight in :func:`_band_matrix` for the band at
    the start of its segment (row 0) and at its end (row 1), as the
    ``rnnoise_features`` kernel reads them."""
    m = _band_matrix()
    seg = np.searchsorted(_BAND_EDGES, np.arange(_BAND_EDGES[-1]), side="right") - 1
    bins = np.arange(_BAND_EDGES[-1])
    return np.stack([m[seg, bins], m[seg + 1, bins]])


def _dct_matrix() -> np.ndarray:
    j = np.arange(NB_BANDS)
    k = np.arange(NB_BANDS)[:, None]
    m = np.cos(np.pi / NB_BANDS * (j[None, :] + 0.5) * k) * np.sqrt(2.0 / NB_BANDS)
    m[0] *= np.sqrt(0.5)
    return m


# cached without bound: the serving engine's captured CUDA graph reads these
# tensors by address, so an entry dropped from the cache would be freed under it
@cache
def _consts(device: torch.device) -> dict:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {
        "window": f32(_vorbis_window()),
        "bands_t": f32(_band_matrix().T.copy()),     # (481, 22)
        "interp_t": f32(_interp_matrix().T.copy()),  # (22, 481)
        "dct_t": f32(_dct_matrix().T.copy()),        # (22, 22)
        "lagw": f32([1.0] + [1.0 - (0.008 * i) ** 2 for i in range(1, 5)]),
        "decay": f32([0.9 ** (i + 1) for i in range(4)]),
        "second_check": torch.as_tensor(_SECOND_CHECK[2:16], dtype=torch.int32,
                                        device=device),
        "pc_offset": f32([1.3, 0.9, 0, 0, 0, 0]),
        "ceps_offset": f32([12.0, 4.0] + [0.0] * (NB_BANDS - 2)),
        "band_w": f32(_band_weights()),
        "band_edges": torch.as_tensor(_BAND_EDGES, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def weight_shapes() -> dict:
    """The key/shape contract of a weight archive."""
    shapes = {
        "input_w": (NB_FEATURES, 24), "input_b": (24,),
        "vad_out_w": (24, 1), "vad_out_b": (1,),
        "denoise_out_w": (96, NB_BANDS), "denoise_out_b": (NB_BANDS,),
    }
    for name, (din, dh) in _GRU_DIMS.items():
        shapes.update({f"{name}_wi": (din, 3 * dh), f"{name}_wh": (dh, 3 * dh),
                       f"{name}_b": (3 * dh,)})
    return shapes


def weights_from_numpy(arrays: dict, device) -> dict:
    """Validate a ``{name: array}`` weight dict and move it to ``device``.
    Keys starting with ``__`` are provenance metadata and are dropped."""
    params = {k: np.asarray(v, np.float32) for k, v in arrays.items()
              if not k.startswith("__")}
    expected = weight_shapes()
    missing, extra = set(expected) - set(params), set(params) - set(expected)
    if missing or extra:
        raise ValueError(f"weight archive key mismatch: missing={sorted(missing)} "
                         f"extra={sorted(extra)}")
    for key, shape in expected.items():
        if params[key].shape != shape:
            raise ValueError(f"weight {key!r} shape {params[key].shape} != "
                             f"expected {shape}")
    return {k: torch.as_tensor(v, device=device) for k, v in params.items()}


def init_params(seed: int = 0x4242) -> dict:
    """The reference's seeded structural weights (numpy f32), drawn from the
    same generator in the same order."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape).astype(np.float32)

    p = {"input_w": w(NB_FEATURES, 24), "input_b": np.zeros(24, np.float32),
         "vad_out_w": w(24, 1), "vad_out_b": np.zeros(1, np.float32),
         "denoise_out_w": w(96, NB_BANDS), "denoise_out_b": np.zeros(NB_BANDS, np.float32)}
    for name, (din, dh) in _GRU_DIMS.items():
        p[f"{name}_wi"] = w(din, 3 * dh)
        p[f"{name}_wh"] = w(dh, 3 * dh)
        p[f"{name}_b"] = np.zeros(3 * dh, np.float32)
    return p


def load_weights(path, device="cpu") -> dict:
    with np.load(path) as data:
        return weights_from_numpy({k: data[k] for k in data.files}, device)


def _provenance(arrays) -> str:
    return (str(np.asarray(arrays["__provenance__"]).item())
            if "__provenance__" in arrays else "converted")


def archive_provenance(path) -> str:
    """The ``__provenance__`` string of a weight archive (``"trained"`` for
    the in-repo training runs), else ``"converted"``."""
    with np.load(path) as data:
        return _provenance(data)


def discover_model_path():
    """``RNNOISE_MODEL_PATH`` first, then ``models/rnnoise.npz`` at the root
    of the checkout. Returns None when neither exists."""
    env = os.environ.get("RNNOISE_MODEL_PATH")
    if env and Path(env).is_file():
        return Path(env)
    candidate = Path(__file__).resolve().parents[2] / "models" / "rnnoise.npz"
    return candidate if candidate.is_file() else None


@cache
def _default_weights():
    path = discover_model_path()
    if path is None:
        return weights_from_numpy(init_params(), "cpu"), "seeded"
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return weights_from_numpy(arrays, "cpu"), _provenance(arrays)


def default_params(device="cpu") -> dict:
    """The default weights on ``device``: a discovered archive
    (:func:`discover_model_path`) wins, else the seeded structural weights;
    :func:`weights_source` says which."""
    return {k: v.to(device) for k, v in _default_weights()[0].items()}


def weights_source() -> str:
    """``"trained"`` or ``"converted"`` for an archive, ``"seeded"`` for the
    structural weights."""
    return _default_weights()[1]


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def rnnoise_state_init(*, n: int, device) -> dict:
    z = lambda *s: torch.zeros((n,) + s, dtype=torch.float32, device=device)
    return {
        "analysis_mem": z(FRAME_SIZE),
        "synthesis_mem": z(FRAME_SIZE),
        "cepstral_mem": z(CEPS_MEM, NB_BANDS),  # index 0 = newest frame
        "vad_gru": z(24),
        "noise_gru": z(48),
        "denoise_gru": z(96),
        "pitch_buf": z(PITCH_BUF_SIZE),
        "last_period": torch.zeros(n, dtype=torch.int32, device=device),
        "last_gain": z(),
        "lastg": z(NB_BANDS),
        "hp_mem": torch.zeros((n, 2), dtype=torch.float64, device=device),
    }


# ---------------------------------------------------------------------------
# DSP pieces
# ---------------------------------------------------------------------------


def _fwd(x):
    """Opus forward transform: FFT with 1/N scaling."""
    return rdft(x, WINDOW_SIZE) * (1.0 / WINDOW_SIZE)


def _inv(X):
    """Opus inverse transform (unscaled IFFT)."""
    return irdft(X, WINDOW_SIZE).to(torch.float32) * WINDOW_SIZE


def _band_energy(X, c):
    return (X.real * X.real + X.imag * X.imag) @ c["bands_t"]


def _sliding_inner(y, frame, n_lags):
    """``out[n, i] = sum_j frame[n, j] * y[n, j + i]`` for ``i < n_lags``:
    a grouped 1-D cross-correlation, one group per stream."""
    n = y.shape[0]
    out = torch.nn.functional.conv1d(y[None], frame[:, None, :], groups=n)[0]
    return out[:, :n_lags]


def _find_best_pitch(xcorr, y, length):
    """Top-2 lags of ``xcorr^2 / Syy`` over positive correlations."""
    n_lags = xcorr.shape[-1]
    csum = torch.cumsum(y * y, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=-1)
    i = torch.arange(n_lags, device=y.device)
    syy = torch.clamp_min(1.0 + csum[:, i + length] - csum[:, i], 1.0)
    valid = xcorr > 0
    score = torch.where(valid, xcorr * xcorr / syy, -1.0)
    best0 = score.argmax(dim=-1)
    best1 = torch.where(i == best0[:, None], -2.0, score).argmax(dim=-1)
    any_valid = valid.any(dim=-1)
    return (torch.where(any_valid, best0, 0).to(torch.int32),
            torch.where(any_valid, best1, 1).to(torch.int32))


def _lpc4(ac):
    """Order-4 Levinson-Durbin with the early exit as a freeze mask."""
    lpc = [torch.zeros_like(ac[:, 0]) for _ in range(4)]
    error = ac[:, 0]
    alive = ac[:, 0] != 0.0
    for i in range(4):
        rr = ac[:, i + 1]
        for j in range(i):
            rr = rr + lpc[j] * ac[:, i - j]
        r = -rr / torch.where(error == 0.0, 1.0, error)
        upd = list(lpc)
        upd[i] = r
        for j in range((i + 1) // 2):
            t1, t2 = lpc[j], lpc[i - 1 - j]
            upd[j] = t1 + r * t2
            upd[i - 1 - j] = t2 + r * t1
        new_error = error - r * r * error
        lpc = [torch.where(alive, u, o) for u, o in zip(upd, lpc)]
        error = torch.where(alive, new_error, error)
        alive = alive & (error >= 0.001 * ac[:, 0])
    return torch.stack(lpc, dim=-1)


def _pitch_downsample(x, c):
    """celt ``pitch_downsample``: 2x decimation with [.25 .5 .25], then a
    5-tap pre-whitening FIR from lag-windowed order-4 LPC."""
    half = PITCH_BUF_SIZE // 2  # 864
    left = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:-1:2]], dim=-1)
    x_lp = 0.25 * left + 0.5 * x[:, 0::2] + 0.25 * x[:, 1::2]
    ac = torch.stack([torch.sum(x_lp[:, : half - k] * x_lp[:, k:], dim=-1)
                      for k in range(5)], dim=-1)
    ac = torch.cat([ac[:, :1] * 1.0001, ac[:, 1:]], dim=-1) * c["lagw"]
    lpc = _lpc4(ac) * c["decay"]
    l0, l1, l2, l3 = lpc.unbind(-1)
    k8 = 0.8
    taps = torch.stack([l0 + k8, l1 + k8 * l0, l2 + k8 * l1, l3 + k8 * l2,
                        k8 * l3], dim=-1)
    acc = x_lp
    for k in range(5):
        shifted = torch.cat([torch.zeros_like(x_lp[:, : k + 1]),
                             x_lp[:, : half - k - 1]], dim=-1)
        acc = acc + taps[:, k: k + 1] * shifted
    return acc  # 24 kHz, length 864


def _take(a, idx):
    return torch.gather(a, -1, idx.to(torch.int64))


def _pitch_search(x_lp, y24):
    """celt ``pitch_search``: coarse 12 kHz scan, refinement near the two
    coarse candidates, pseudo-interpolation. Returns the lag in 48 kHz units
    and the extended 24 kHz correlation row."""
    max_pitch = PITCH_MAX_PERIOD - 3 * (PITCH_MIN_PERIOD // 2)  # 678
    n12, n24 = max_pitch // 4, max_pitch // 2  # 169, 339
    x4 = x_lp[:, 0::2][:, : PITCH_FRAME_SIZE // 4]
    y4 = y24[:, 0::2]
    c0, c1 = _find_best_pitch(_sliding_inner(y4, x4, n12), y4,
                              PITCH_FRAME_SIZE // 4)
    xc24_ext = _sliding_inner(y24, x_lp, PITCH_MAX_PERIOD // 2 + 1)
    lags = torch.arange(n24, device=x_lp.device)
    near = (((lags - 2 * c0[:, None]).abs() <= 2)
            | ((lags - 2 * c1[:, None]).abs() <= 2))
    xc24 = torch.where(near, torch.clamp_min(xc24_ext[:, :n24], -1.0), 0.0)
    b0, _ = _find_best_pitch(xc24, y24, PITCH_FRAME_SIZE // 2)
    interior = (b0 > 0) & (b0 < n24 - 1)
    idx = torch.clamp(b0, 1, n24 - 2)
    abc = _take(xc24, torch.stack([idx - 1, idx, idx + 1], dim=-1))
    a, b, cc = abc.unbind(-1)
    offset = torch.where((cc - a) > 0.7 * (b - a), 1,
                         torch.where((a - cc) > 0.7 * (b - cc), -1, 0))
    offset = torch.where(interior, offset, 0)
    return (2 * b0 - offset).to(torch.int32), xc24_ext


def _pitch_gain(xy, xx, yy):
    return xy / torch.sqrt(1.0 + xx * yy)


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _remove_doubling(x24, T0_48, prev_period_48, prev_gain, corr_full):
    """celt ``remove_doubling`` at 2x decimation: probe each sub-period
    T0/k (k = 2..15), keep the last that passes the continuity thresholds,
    then pseudo-interpolate. Returns ``(T0_48_new, gain)``."""
    maxp, minp, N = PITCH_MAX_PERIOD // 2, PITCH_MIN_PERIOD // 2, PITCH_FRAME_SIZE // 2
    dev = x24.device
    T0 = torch.clamp_max(_floor_div(T0_48, 2), maxp - 1)
    prev_period = _floor_div(prev_period_48, 2)

    xw = x24[:, maxp: maxp + N]
    xx = torch.sum(xw * xw, dim=-1)
    back = x24[:, :maxp].flip(-1)        # x[-1] .. x[-maxp]
    fwd = x24[:, N: maxp + N].flip(-1)   # x[N-1] .. x[N-maxp]
    yy_lookup = torch.cat(
        [xx[:, None], xx[:, None] + torch.cumsum(back * back - fwd * fwd, dim=-1)],
        dim=-1)
    yy_lookup = torch.clamp_min(yy_lookup, 0.0)

    ks = torch.arange(2, 16, device=dev, dtype=torch.int32)
    sec = _consts(dev)["second_check"]
    T1s = _floor_div(2 * T0[:, None] + ks, 2 * ks)
    T1bs = _floor_div(2 * sec * T0[:, None] + ks, 2 * ks)
    t1b2 = torch.where(T1s[:, 0] + T0 > maxp, T0, T0 + T1s[:, 0])
    T1bs = torch.cat([t1b2[:, None], T1bs[:, 1:]], dim=-1)
    probes = torch.cat([T0[:, None], torch.clamp(T1s, 0, maxp),
                        torch.clamp(T1bs, 0, maxp)], dim=-1)  # [N, 29]
    xy_all = _take(corr_full, maxp - probes)
    yy_all = _take(yy_lookup, probes)

    g0 = _pitch_gain(xy_all[:, 0], xx, yy_all[:, 0])
    best_xy, best_yy, T, g = xy_all[:, 0], yy_all[:, 0], T0, g0
    for i, k in enumerate(range(2, 16)):
        T1 = T1s[:, i]
        xy = 0.5 * (xy_all[:, 1 + i] + xy_all[:, 15 + i])
        yy = 0.5 * (yy_all[:, 1 + i] + yy_all[:, 15 + i])
        g1 = _pitch_gain(xy, xx, yy)
        dist = (T1 - prev_period).abs()
        cont = torch.where(dist <= 1, prev_gain,
                           torch.where((dist <= 2) & (5 * k * k < T0),
                                       0.5 * prev_gain, 0.0))
        thresh = torch.clamp_min(0.7 * g0 - cont, 0.3)
        thresh = torch.where(
            T1 < 2 * minp, torch.clamp_min(0.9 * g0 - cont, 0.5),
            torch.where(T1 < 3 * minp, torch.clamp_min(0.85 * g0 - cont, 0.4),
                        thresh))
        take = (T1 >= minp) & (g1 > thresh)
        best_xy = torch.where(take, xy, best_xy)
        best_yy = torch.where(take, yy, best_yy)
        T = torch.where(take, T1, T)
        g = torch.where(take, g1, g)

    best_xy = torch.clamp_min(best_xy, 0.0)
    pg = torch.where(best_yy <= best_xy, 1.0, best_xy / (best_yy + best_xy))
    Ts = torch.clamp(T, 1, maxp - 1)
    xc = _take(corr_full, maxp - torch.stack([Ts - 1, Ts, Ts + 1], dim=-1))
    offset = torch.where(
        (xc[:, 2] - xc[:, 0]) > 0.7 * (xc[:, 1] - xc[:, 0]), 1,
        torch.where((xc[:, 0] - xc[:, 2]) > 0.7 * (xc[:, 1] - xc[:, 2]), -1, 0))
    pg = torch.minimum(pg, g)
    T0_new = torch.clamp_min(2 * T + offset, PITCH_MIN_PERIOD)
    return T0_new.to(torch.int32), pg


def _gru(p, name, h, x):
    """RNNoise GRU: gate order [z|r|h~], reset applied to the state before
    the recurrent matmul, ``h' = z*h + (1-z)*h~``."""
    dh = h.shape[-1]
    wi, wh, b = p[f"{name}_wi"], p[f"{name}_wh"], p[f"{name}_b"]
    z = torch.sigmoid(x @ wi[:, :dh] + h @ wh[:, :dh] + b[:dh])
    r = torch.sigmoid(x @ wi[:, dh: 2 * dh] + h @ wh[:, dh: 2 * dh] + b[dh: 2 * dh])
    h_tilde = _GRU_ACT[name](x @ wi[:, 2 * dh:] + (r * h) @ wh[:, 2 * dh:]
                             + b[2 * dh:])
    return z * h + (1.0 - z) * h_tilde


def _spectral_floor(logE):
    """Per-band log energy with the -1.5 dB/band ``follow`` and
    ``logMax - 7`` floors (22 sequential steps)."""
    log_max = torch.full_like(logE[:, 0], -2.0)
    follow = torch.full_like(logE[:, 0], -2.0)
    out = []
    for i in range(NB_BANDS):
        ly = torch.maximum(log_max - 7.0, torch.maximum(follow - 1.5, logE[:, i]))
        out.append(ly)
        log_max = torch.maximum(log_max, ly)
        follow = torch.maximum(follow - 1.5, ly)
    return torch.stack(out, dim=-1)


def rnnoise_pitch_plain(pitch_buf, x_frame, last_period, last_gain):
    """The pitch tracker of ``compute_frame_features``: the new pitch buffer
    (``pitch_buf [N, 1728]`` shifted by the frame ``x_frame [N, 480]``),
    ``_pitch_downsample``, ``_pitch_search`` and ``_remove_doubling`` from
    the previous period and gain. Returns ``(pitch_buf, pitch_index [N]
    int32, gain [N], p_frame [N, 960])``: ``p_frame`` is the pitch-delayed
    window of the buffer, windowed, whose FFT is P."""
    c = _consts(x_frame.device)
    pitch_buf = torch.cat([pitch_buf[:, FRAME_SIZE:], x_frame], dim=-1)
    x24 = _pitch_downsample(pitch_buf, c)
    x_lp = x24[:, PITCH_MAX_PERIOD // 2:]
    raw_idx, corr_row = _pitch_search(x_lp, x24)
    pitch_index, gain = _remove_doubling(
        x24, PITCH_MAX_PERIOD - raw_idx, last_period, last_gain, corr_row)
    start = PITCH_BUF_SIZE - WINDOW_SIZE - pitch_index
    rows = start[:, None] + torch.arange(WINDOW_SIZE, device=x_frame.device)
    return pitch_buf, pitch_index, gain, _take(pitch_buf, rows) * c["window"]


def rnnoise_features_plain(X, P, cepstral_mem, pitch_index):
    """The feature tail of ``compute_frame_features`` from the spectra ``X``
    and ``P`` (complex ``[N, 481]``), the cepstral memory ``[N, 8, 22]`` and
    the pitch period. Returns ``(features [N, 42], cepstral_mem, Ex, Ep,
    Exp, silence)``; the memory is shifted whether or not the frame is
    silent."""
    c = _consts(X.device)
    Ex = _band_energy(X, c)
    Ep = _band_energy(P, c)
    Exp = ((X.real * P.real + X.imag * P.imag) @ c["bands_t"]) / torch.sqrt(
        0.001 + Ex * Ep)

    pc = (Exp @ c["dct_t"])[:, :NB_DELTA_CEPS]
    pc = pc - c["pc_offset"]
    silence = torch.sum(Ex, dim=-1) < _SILENCE_ENERGY
    ceps = _spectral_floor(torch.log10(1e-2 + Ex)) @ c["dct_t"]
    ceps = ceps - c["ceps_offset"]

    mem = cepstral_mem
    c0, c1, c2 = ceps, mem[:, 0], mem[:, 1]
    bfcc = torch.cat([(c0 + c1 + c2)[:, :NB_DELTA_CEPS], c0[:, NB_DELTA_CEPS:]],
                     dim=-1)
    new_mem = torch.cat([c0[:, None], mem[:, :-1]], dim=1)
    diff = new_mem[:, :, None, :] - new_mem[:, None, :, :]
    dist = torch.sum(diff * diff, dim=-1)
    eye = torch.eye(CEPS_MEM, dtype=torch.bool, device=dist.device)
    dist = torch.where(eye, torch.inf, dist)
    variability = dist.amin(dim=-1).sum(dim=-1) / CEPS_MEM - 2.1

    features = torch.cat([
        bfcc,
        (c0 - c2)[:, :NB_DELTA_CEPS],
        (c0 - 2.0 * c1 + c2)[:, :NB_DELTA_CEPS],
        pc,
        (0.01 * (pitch_index - 300))[:, None],
        variability[:, None],
    ], dim=-1).to(torch.float32)
    return features, new_mem, Ex, Ep, Exp, silence


def rnnoise_pitch(pitch_buf, x_frame, last_period, last_gain):
    """:func:`rnnoise_pitch_plain` on CPU tensors; the ``rnnoise_pitch``
    CUDA kernel on CUDA tensors (f32 and int32, contiguous)."""
    if x_frame.device.type == "cpu":
        return rnnoise_pitch_plain(pitch_buf, x_frame, last_period, last_gain)
    if x_frame.device.type != "cuda":
        raise ValueError(f"rnnoise_pitch: unsupported device {x_frame.device}")
    n, dev = x_frame.shape[0], x_frame.device
    x_frame = x_frame.contiguous()
    for name, t, dtype, shape in (
            ("pitch_buf", pitch_buf, torch.float32, (n, PITCH_BUF_SIZE)),
            ("x_frame", x_frame, torch.float32, (n, FRAME_SIZE)),
            ("last_period", last_period, torch.int32, (n,)),
            ("last_gain", last_gain, torch.float32, (n,))):
        kernels.check_tensor(f"rnnoise_pitch {name}", t, dtype, shape, dev)
    kernels.check_aligned("rnnoise_pitch pitch_buf", pitch_buf, 16)
    kernels.check_aligned("rnnoise_pitch x_frame", x_frame, 16)
    c = _consts(dev)
    buf = torch.empty_like(pitch_buf)
    pitch_index = torch.empty(n, dtype=torch.int32, device=dev)
    gain = torch.empty(n, dtype=torch.float32, device=dev)
    p_frame = torch.empty((n, WINDOW_SIZE), dtype=torch.float32, device=dev)
    kernels.launch("rnnoise_pitch", pitch_buf.data_ptr(), x_frame.data_ptr(),
                   last_period.data_ptr(), last_gain.data_ptr(), c["lagw"].data_ptr(),
                   c["decay"].data_ptr(), c["second_check"].data_ptr(), c["window"].data_ptr(),
                   buf.data_ptr(),
                   pitch_index.data_ptr(), gain.data_ptr(), p_frame.data_ptr(), n,
                   kernels.stream_of(dev))
    return buf, pitch_index, gain, p_frame


def rnnoise_features(X, P, cepstral_mem, pitch_index):
    """:func:`rnnoise_features_plain` on CPU tensors; the
    ``rnnoise_features`` CUDA kernel on CUDA tensors (complex64 spectra,
    contiguous)."""
    if X.device.type == "cpu":
        return rnnoise_features_plain(X, P, cepstral_mem, pitch_index)
    if X.device.type != "cuda":
        raise ValueError(f"rnnoise_features: unsupported device {X.device}")
    n, dev = X.shape[0], X.device
    spectra = []
    for name, t in (("X", X), ("P", P)):
        kernels.check_tensor(f"rnnoise_features {name}", t, torch.complex64, (n, FREQ_SIZE),
                             dev)
        spectra.append(torch.view_as_real(t))
    kernels.check_tensor("rnnoise_features cepstral_mem", cepstral_mem, torch.float32,
                         (n, CEPS_MEM, NB_BANDS), dev)
    kernels.check_tensor("rnnoise_features pitch_index", pitch_index, torch.int32, (n,), dev)
    c = _consts(dev)
    features = torch.empty((n, NB_FEATURES), dtype=torch.float32, device=dev)
    new_mem = torch.empty_like(cepstral_mem)
    Ex, Ep, Exp = (torch.empty((n, NB_BANDS), dtype=torch.float32, device=dev)
                   for _ in range(3))
    silence = torch.empty(n, dtype=torch.bool, device=dev)
    kernels.launch("rnnoise_features", spectra[0].data_ptr(), spectra[1].data_ptr(),
                   cepstral_mem.data_ptr(), pitch_index.data_ptr(), c["band_w"].data_ptr(),
                   c["band_edges"].data_ptr(), c["dct_t"].data_ptr(),
                   c["ceps_offset"].data_ptr(), c["pc_offset"].data_ptr(),
                   features.data_ptr(), new_mem.data_ptr(),
                   Ex.data_ptr(), Ep.data_ptr(), Exp.data_ptr(), silence.data_ptr(), n,
                   kernels.stream_of(dev))
    return features, new_mem, Ex, Ep, Exp, silence


def frame_features(state, x_frame):
    """``compute_frame_features``: returns ``(features, X, P, Ex, Ep, Exp,
    silence, updates)``. On the card the pitch tracker and the feature tail
    are one kernel each (:func:`rnnoise_pitch`, :func:`rnnoise_features`)
    around the two FFTs."""
    c = _consts(x_frame.device)
    X = _fwd(torch.cat([state["analysis_mem"], x_frame], dim=-1) * c["window"])
    pitch_buf, pitch_index, gain, p_frame = rnnoise_pitch(
        state["pitch_buf"], x_frame, state["last_period"], state["last_gain"])
    P = _fwd(p_frame)
    features, new_mem, Ex, Ep, Exp, silence = rnnoise_features(
        X, P, state["cepstral_mem"], pitch_index)
    updates = {"pitch_buf": pitch_buf, "last_period": pitch_index,
               "last_gain": gain, "cepstral_mem": new_mem}
    return features, X, P, Ex, Ep, Exp, silence, updates


def _pitch_filter(X, P, Ex, Ep, Exp, g, c):
    """Per-band comb mix of the pitch-delayed spectrum, then band-energy
    renormalisation."""
    r = torch.where(Exp > g, 1.0,
                    (Exp * Exp) * (1.0 - g * g) / (0.001 + g * g * (1.0 - Exp * Exp)))
    r = torch.sqrt(torch.clamp(r, 0.0, 1.0)) * torch.sqrt(Ex / (1e-8 + Ep))
    Xc = X + (r @ c["interp_t"]) * P
    norm = torch.sqrt(Ex / (1e-8 + _band_energy(Xc, c)))
    return Xc * (norm @ c["interp_t"])


def rnnoise_frame(params, state, x_frame):
    """One 480-sample frame (PCM-scaled, ``[N, 480]``). Returns
    ``(new_state, y_frame, {"gains", "vad"})``."""
    c = _consts(x_frame.device)
    y_hp, hp_mem = biquad.apply_fixed(_HP_COEFFS, state["hp_mem"][:, None, :],
                                      x_frame)
    x = y_hp
    feats, X, P, Ex, Ep, Exp, silence, upd = frame_features(state, x)

    dense = torch.tanh(feats @ params["input_w"] + params["input_b"])
    vad_h = _gru(params, "vad_gru", state["vad_gru"], dense)
    vad = torch.sigmoid(vad_h @ params["vad_out_w"] + params["vad_out_b"])[:, 0]
    noise_h = _gru(params, "noise_gru", state["noise_gru"],
                   torch.cat([dense, vad_h, feats], dim=-1))
    den_h = _gru(params, "denoise_gru", state["denoise_gru"],
                 torch.cat([vad_h, noise_h, feats], dim=-1))
    g = torch.sigmoid(den_h @ params["denoise_out_w"] + params["denoise_out_b"])

    g = torch.maximum(g, _GAIN_HANGOVER * state["lastg"])
    Y_active = _pitch_filter(X, P, Ex, Ep, Exp, g, c) * (g @ c["interp_t"])
    Y = torch.where(silence[:, None], X, Y_active)
    y = _inv(Y) * c["window"]
    out = state["synthesis_mem"] + y[:, :FRAME_SIZE]

    def keep(new, old):
        return torch.where(silence.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)

    new_state = {
        "analysis_mem": x,
        "synthesis_mem": y[:, FRAME_SIZE:],
        "cepstral_mem": keep(upd["cepstral_mem"], state["cepstral_mem"]),
        "vad_gru": keep(vad_h, state["vad_gru"]),
        "noise_gru": keep(noise_h, state["noise_gru"]),
        "denoise_gru": keep(den_h, state["denoise_gru"]),
        "pitch_buf": upd["pitch_buf"],
        "last_period": upd["last_period"],
        "last_gain": upd["last_gain"],
        "lastg": keep(g, state["lastg"]),
        "hp_mem": hp_mem[:, 0],
    }
    return new_state, out, {"gains": g, "vad": torch.where(silence, 0.0, vad)}


def soft_clip(x):
    """Finite scrub plus a soft knee above 0.98 of full scale."""
    x = torch.where(torch.isfinite(x), x, 0.0)
    limit_unit = PCM_MODEL_LIMIT / PCM_SCALE
    mag = x.abs()
    over = mag - SOFT_CLIP_THRESHOLD
    softened = SOFT_CLIP_THRESHOLD + (limit_unit - SOFT_CLIP_THRESHOLD) * (
        over / (over + (1.0 - SOFT_CLIP_THRESHOLD)))
    return torch.where(mag <= SOFT_CLIP_THRESHOLD, x,
                       torch.sign(x) * torch.clamp_max(softened, limit_unit))


def rnnoise_frames(params, state, frames):
    """Denoise ``frames: [..., n_frames, 480]`` (PCM-scaled) on their device,
    frame by frame; ``state`` holds ``prod(...)`` streams. Returns
    ``(state, y [..., n_frames, 480], vad [..., n_frames])``."""
    frames = torch.as_tensor(frames)
    *lead, n_frames, _ = frames.shape
    n = int(np.prod(lead))
    x = frames.reshape(n, n_frames, FRAME_SIZE).transpose(0, 1)

    def step(st, block):
        st, y, aux = rnnoise_frame(params, st, block["x"])
        return st, {"y": y, "vad": aux["vad"]}

    state, rows = run_take(step, state, {"x": x}, n_frames)
    if not rows:
        rows = {"y": frames.new_zeros((0, n, FRAME_SIZE)), "vad": frames.new_zeros((0, n))}
    return (state, rows["y"].transpose(0, 1).reshape(*lead, n_frames, FRAME_SIZE),
            rows["vad"].t().reshape(*lead, n_frames))


# ---------------------------------------------------------------------------
# Frame-staging processor
# ---------------------------------------------------------------------------


def processor_init(params=None, strength: float = 1.0, sample_rate: float = 48000.0, *,
                   device="cuda") -> dict:
    """One stream's staging processor; the model runs on ``device`` (a CUDA
    device unless asked otherwise)."""
    dev = kernels.resolve_device(device, "rnnoise.processor_init")
    params = default_params(dev) if params is None else {
        k: v.to(dev) for k, v in params.items()}
    frame_dt = FRAME_SIZE / sample_rate
    return {
        "params": params,
        "model": rnnoise_state_init(n=1, device=dev),
        "in_buf": np.zeros(0, np.float32),
        "out_buf": np.zeros(0, np.float32),
        "strength": float(np.clip(strength, 0.0, 1.0)),
        "smoothed_strength": 1.0,
        "smoothing_coeff": float(1.0 - np.exp(-(frame_dt / 0.015))),  # 15 ms EMA
        "enabled": True,
        "replay": None,  # the frame step, built at the first processed frame
    }


def processor_push(state, samples):
    state = dict(state)
    state["in_buf"] = np.concatenate([state["in_buf"], np.asarray(samples, np.float32)])
    return state, len(np.asarray(samples))


def frame_replay(params, model_state, *, k_max: int = 8) -> BlockReplay:
    """One stream's frame step over ``model_state`` (``n=1``): the soft clip
    and PCM scaling of the frame, the model, and the wet frame back at unit
    scale (``wet``)."""

    def step(st, block):
        x = torch.clamp(soft_clip(block["x"][None]) * PCM_SCALE,
                        -PCM_MODEL_LIMIT, PCM_MODEL_LIMIT)
        st, y, _ = rnnoise_frame(params, st, x)
        return st, {"wet": y[0] / PCM_SCALE}

    return BlockReplay(step, model_state, {"x": (FRAME_SIZE,)},
                       device=model_state["pitch_buf"].device, k_max=k_max)


def processor_prepare(state):
    """Build the state's frame step now and, on the card, capture it, so
    that the first frame pays no capture; no frame is processed."""
    state = dict(state)
    if state.get("replay") is None:
        state["replay"] = frame_replay(state["params"], state["model"])
    state["replay"].prepare()
    return state


def processor_process(state, *, take: bool = False):
    """Process every complete staged frame: PCM scaling with the soft clip,
    the model, the wet/dry mix at the smoothed strength (the dry path one
    frame behind, at the model's latency). ``state["model"]`` is the model's
    static state, updated in place. A live caller runs the model through the
    state's frame replay (built at the first frame, then replayed for every
    burst); ``take=True`` runs the staged frames as one take through
    :func:`rnnoise_frames` (one graph for the take), as an offline caller
    that stages a whole signal does. Returns ``(state, n_frames)``."""
    state = dict(state)
    n_frames = len(state["in_buf"]) // FRAME_SIZE
    if n_frames == 0:
        return state, 0
    frames_np = state["in_buf"][: n_frames * FRAME_SIZE]
    state["in_buf"] = state["in_buf"][n_frames * FRAME_SIZE:]
    if not state["enabled"]:
        state["out_buf"] = np.concatenate([state["out_buf"], frames_np])
        return state, n_frames

    frames = frames_np.reshape(n_frames, FRAME_SIZE)
    if take:
        dev = state["model"]["pitch_buf"].device
        x = torch.as_tensor(frames[None], device=dev)
        scaled = torch.clamp(soft_clip(x) * PCM_SCALE, -PCM_MODEL_LIMIT, PCM_MODEL_LIMIT)
        model, wet, _ = rnnoise_frames(state["params"], state["model"], scaled)
        copy_into(state["model"], model)
        wet = (wet[0] / PCM_SCALE).cpu().numpy()
    else:
        if state.get("replay") is None:
            # a burst of the live engine is at most k_max frames
            state["replay"] = frame_replay(state["params"], state["model"])
        wet = state["replay"].run(frames)["wet"]

    dry_delay = state.get("dry_delay", np.zeros(FRAME_SIZE, np.float32))
    dry_frames = np.concatenate([dry_delay[None, :], frames])
    sm = state["smoothed_strength"]
    target = state["strength"]
    mixed = []
    for i in range(n_frames):
        sm = target * state["smoothing_coeff"] + sm * (1.0 - state["smoothing_coeff"])
        mixed.append(wet[i] * sm + dry_frames[i] * (1.0 - sm))
    state["smoothed_strength"] = sm
    state["dry_delay"] = dry_frames[-1]
    state["out_buf"] = np.concatenate([state["out_buf"]] + mixed)
    return state, n_frames


def processor_pop(state, count):
    state = dict(state)
    n = min(count, len(state["out_buf"]))
    out = state["out_buf"][:n]
    state["out_buf"] = state["out_buf"][n:]
    return state, out


def processor_soft_reset(state):
    """Clear the staging; the model's learned state stays."""
    state = dict(state)
    state["in_buf"] = np.zeros(0, np.float32)
    state["out_buf"] = np.zeros(0, np.float32)
    state["dry_delay"] = np.zeros(FRAME_SIZE, np.float32)
    return state
