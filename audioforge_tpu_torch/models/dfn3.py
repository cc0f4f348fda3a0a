"""DeepFilterNet3 noise suppression, LL and standard, batched over streams.

Counterpart of ``audioforge_tpu/models/dfn3.py`` (the published DFN3
topology with the reference's flat weight keys and layouts): a 960-point
STFT at 480 hop with the vorbis window; 32 rectangular ERB bands of log
power with an exponential mean norm and the unit-normed complex spectrum of
the 96 low bins as features; a separable-conv ERB encoder with skips, a
grouped-linear GRU bottleneck, an ERB-gain decoder (the transposed convs with
the converted kernels) and a deep-filtering decoder emitting order-5 complex
FIR taps for the low bins.
The low-latency variant applies a frame's gains to that frame; the standard
variant (a state with ``spec_queue``) applies them to the spectrum of frame
t-2.

Per frame the model runs two kernels with the FFTs, conv units and GEMMs
between them: :func:`dfn_features` (power, ERB means, the norms and both
feature sets after the rfft) and :func:`dfn_spec_synth` (post filter, ERB
spread, the deep filter on the low bins and the attenuation limit before the
irfft). Each launches its CUDA kernel for a CUDA tensor and runs its plain
twin for a CPU tensor. No convolution op runs: every conv unit is a dense
GEMM (its grouped and pointwise convs and BatchNorm composed into one weight
and bias, made once per weight tensor) or a sum of three taps over strided
views, on channels-last activations ``[N, F, C]``.

:func:`dfn_frames` runs a take frame by frame (one CUDA graph replay a frame
on the card). The ``processor_*`` functions are the reference's frame-staging
processor for one stream: numpy staging, the dry path through the model's
alignment delay, the per-frame strength EMA, and the reference's
``backend_failed`` passthrough, which latches when the model gives a
non-finite frame (product semantics of the reference, not a fallback from
the card). Its model step is a :class:`~..runtime.replay.BlockReplay` kept
in the processor's state from its first frame on.
"""

from __future__ import annotations

import math
import os
from functools import cache
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from .. import kernels
from ..runtime.replay import BlockReplay, run_take

__all__ = [
    "FRAME_SIZE", "WINDOW_SIZE", "FREQ_SIZE", "NB_ERB", "NB_DF", "DF_ORDER",
    "DF_BINS", "DF_LOOKAHEAD", "CONV_CH", "CONV_KERNEL_INP", "CONV_KERNEL",
    "EMB_HIDDEN", "DF_HIDDEN", "EMB_GRU_LAYERS", "ERB_DEC_GRU_LAYERS",
    "DF_GRU_LAYERS", "LIN_GROUPS", "ENC_LIN_GROUPS",
    "DF_PATHWAY_KT", "DEFAULT_ATTEN_LIM_DB", "DEFAULT_POST_FILTER_BETA",
    "validate_runtime_config", "erb_widths", "init_params", "TORCH_NAME_MAP",
    "convert_torch_state_dict", "weights_from_numpy",
    "load_weights", "configure_deepfilter_runtime_paths",
    "configured_deepfilter_runtime_paths", "external_paths_allowed",
    "resolve_weight_path", "default_params", "weights_source", "dfn_state_init",
    "dfn_frame", "dfn_features", "dfn_features_plain", "dfn_spec_synth",
    "dfn_spec_synth_plain", "dfn_frames", "latency_samples", "frame_replay",
    "processor_init", "processor_push", "processor_prepare", "processor_process",
    "processor_pop", "processor_soft_reset",
]

SAMPLE_RATE = 48000
FRAME_SIZE = 480            # hop
WINDOW_SIZE = 960           # fft size
FREQ_SIZE = WINDOW_SIZE // 2 + 1  # 481
NB_ERB = 32
NB_DF = 96                  # deep-filtering bins (<= 4.8 kHz)
DF_BINS = NB_DF             # the reference's name of the same
DF_ORDER = 5
DF_LOOKAHEAD = 2            # standard variant; the LL variant uses 0
CONV_CH = 64
CONV_KERNEL_INP = (3, 3)    # (time, freq) of the two input convs
CONV_KERNEL = (1, 3)
EMB_HIDDEN = 256
DF_HIDDEN = 256
EMB_GRU_LAYERS = 1          # encoder bottleneck GRU
ERB_DEC_GRU_LAYERS = 1      # = emb_num_layers - 1
DF_GRU_LAYERS = 2
LIN_GROUPS = 8
ENC_LIN_GROUPS = 16
DF_PATHWAY_KT = 5
LSNR_MIN = -15.0
LSNR_MAX = 35.0
NORM_TAU_S = 1.0
_BN_EPS = 1e-5

EMB_DIM = CONV_CH * NB_ERB // 4          # 512
_DF_CEMB_DIM = CONV_CH * NB_DF // 2      # 3072
_DF_OUT_DIM = NB_DF * DF_ORDER * 2       # 960

DEFAULT_ATTEN_LIM_DB = 30.0
DEFAULT_POST_FILTER_BETA = 0.0

# exponential norm smoothing of the features (tau 1 s at the 10 ms hop)
_NORM_ALPHA = float(np.exp(-(FRAME_SIZE / SAMPLE_RATE) / NORM_TAU_S))


def validate_runtime_config(atten_lim_db=DEFAULT_ATTEN_LIM_DB,
                            post_filter_beta=DEFAULT_POST_FILTER_BETA):
    """Attenuation limit 0.01-100 dB, post-filter beta 0-0.05
    (`deepfilter_ffi.rs:44-79`)."""
    if not np.isfinite(atten_lim_db) or not (0.01 <= atten_lim_db <= 100.0):
        raise ValueError("attenuation limit must be between 0.01 and 100 dB")
    if not np.isfinite(post_filter_beta) or not (0.0 <= post_filter_beta <= 0.05):
        raise ValueError("post-filter beta must be between 0 and 0.05")
    return float(atten_lim_db), float(post_filter_beta)


def _vorbis_window() -> np.ndarray:
    n = np.arange(WINDOW_SIZE)
    s = np.sin(np.pi * (n + 0.5) / WINDOW_SIZE)
    return np.sin(0.5 * np.pi * s * s).astype(np.float32)


def erb_widths(sr: int = SAMPLE_RATE, fft_size: int = WINDOW_SIZE,
               nb_bands: int = NB_ERB, min_nb_freqs: int = 2) -> np.ndarray:
    """Rectangular ERB band widths in FFT bins (libDF's layout: uniform steps
    on the ERB scale rounded to bins with a minimum width, the rounding
    overshoot carried forward, the Nyquist bin in the last band). They sum
    to ``fft_size // 2 + 1``."""
    erb_l, erb_q = 24.7, 9.265

    def freq2erb(f):
        return erb_q * np.log(1.0 + f / (erb_l * erb_q))

    def erb2freq(e):
        return (np.exp(e / erb_q) - 1.0) * erb_l * erb_q

    freq_width = sr / fft_size
    step = freq2erb(sr / 2) / nb_bands
    widths = np.zeros(nb_bands, np.int64)
    prev_freq = 0   # the ideal band boundary in bins
    over = 0
    for i in range(1, nb_bands + 1):
        fb = int(round(erb2freq(step * i) / freq_width))
        nb_freqs = fb - prev_freq - over
        if nb_freqs < min_nb_freqs:
            over = min_nb_freqs - nb_freqs
            nb_freqs = min_nb_freqs
        else:
            over = 0
        widths[i - 1] = nb_freqs
        prev_freq = fb
    widths[-1] += 1  # the Nyquist bin
    if int(widths.sum()) != fft_size // 2 + 1:
        raise ValueError("ERB widths do not cover the spectrum")
    return widths


def _erb_matrices():
    """(analysis ``[NB_ERB, 481]`` width-normalised sums, synthesis ``[481,
    NB_ERB]`` rectangular spread), f32."""
    fb = np.zeros((NB_ERB, FREQ_SIZE), np.float32)
    spread = np.zeros((FREQ_SIZE, NB_ERB), np.float32)
    start = 0
    for b, w in enumerate(erb_widths()):
        fb[b, start:start + w] = 1.0 / float(w)
        spread[start:start + w, b] = 1.0
        start += w
    return fb, spread


# mean-norm state init -60 -> -90 dB across bands; unit-norm init 0.001 ->
# 0.0001 across the low bins (libDF's defaults)
_ERB_NORM_INIT = np.linspace(-60.0, -90.0, NB_ERB).astype(np.float32)
_UNIT_NORM_INIT = np.linspace(0.001, 0.0001, NB_DF).astype(np.float32)


# cached without bound: a captured CUDA graph reads these tensors by address
@cache
def _consts(device: torch.device) -> dict:
    fb, spread = _erb_matrices()
    widths = erb_widths()
    offsets = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    return {
        "window": torch.as_tensor(_vorbis_window(), device=device),
        "fb_t": torch.as_tensor(fb.T.copy(), device=device),          # [481, 32]
        "spread_t": torch.as_tensor(spread.T.copy(), device=device),  # [32, 481]
        "erb_offsets": torch.as_tensor(offsets, device=device),       # [33]
        "bin_band": torch.as_tensor(np.repeat(np.arange(NB_ERB), widths).astype(np.int32),
                                    device=device),                   # [481]
    }


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _conv_unit(rng, out_ch, in_ch, kt, kf, groups, separable):
    fan_in = (in_ch // groups) * kt * kf
    unit = {
        "w": rng.normal(0, 1.0 / np.sqrt(fan_in),
                        (out_ch, in_ch // groups, kt, kf)).astype(np.float32),
        "bn.g": np.ones(out_ch, np.float32),
        "bn.b": np.zeros(out_ch, np.float32),
        "bn.m": np.zeros(out_ch, np.float32),
        "bn.v": np.ones(out_ch, np.float32),
    }
    if separable:
        unit["pw"] = rng.normal(
            0, 1.0 / np.sqrt(out_ch), (out_ch, out_ch, 1, 1)).astype(np.float32)
    return unit


def _glinear(rng, in_dim, out_dim, groups):
    return rng.normal(0, 1.0 / np.sqrt(in_dim // groups),
                      (groups, in_dim // groups, out_dim // groups)).astype(np.float32)


def _gru_layer(rng, in_dim, hidden):
    s = 1.0 / np.sqrt(hidden)
    return {
        "wi": rng.uniform(-s, s, (3 * hidden, in_dim)).astype(np.float32),
        "wh": rng.uniform(-s, s, (3 * hidden, hidden)).astype(np.float32),
        "bi": np.zeros(3 * hidden, np.float32),
        "bh": np.zeros(3 * hidden, np.float32),
    }


def _flatten_into(params, prefix, tree):
    for key, value in tree.items():
        params[f"{prefix}.{key}"] = value


def init_params(seed: int = 0xDF3) -> dict:
    """The reference's seeded weights (numpy f32), drawn from the same
    generator in the same order; the key set is the weight contract."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}
    conv = lambda key, *spec: _flatten_into(p, key, _conv_unit(rng, *spec))
    conv("enc.erb_conv0", CONV_CH, 1, 3, 3, 1, False)
    conv("enc.erb_conv1", CONV_CH, CONV_CH, 1, 3, CONV_CH, True)
    conv("enc.erb_conv2", CONV_CH, CONV_CH, 1, 3, CONV_CH, True)
    conv("enc.erb_conv3", CONV_CH, CONV_CH, 1, 3, CONV_CH, True)
    conv("enc.df_conv0", CONV_CH, 2, 3, 3, 2, True)
    conv("enc.df_conv1", CONV_CH, CONV_CH, 1, 3, CONV_CH, True)
    p["enc.df_fc_emb.w"] = _glinear(rng, _DF_CEMB_DIM, EMB_DIM, ENC_LIN_GROUPS)
    p["enc.emb_gru.lin_in.w"] = _glinear(rng, EMB_DIM, EMB_HIDDEN, LIN_GROUPS)
    _flatten_into(p, "enc.emb_gru.gru_l0", _gru_layer(rng, EMB_HIDDEN, EMB_HIDDEN))
    p["enc.emb_gru.lin_out.w"] = _glinear(rng, EMB_HIDDEN, EMB_DIM, LIN_GROUPS)
    p["enc.lsnr.w"] = rng.normal(0, 1.0 / np.sqrt(EMB_DIM), (1, EMB_DIM)).astype(np.float32)
    p["enc.lsnr.b"] = np.zeros(1, np.float32)

    p["erb_dec.emb_gru.lin_in.w"] = _glinear(rng, EMB_DIM, EMB_HIDDEN, LIN_GROUPS)
    _flatten_into(p, "erb_dec.emb_gru.gru_l0", _gru_layer(rng, EMB_HIDDEN, EMB_HIDDEN))
    p["erb_dec.emb_gru.lin_out.w"] = _glinear(rng, EMB_HIDDEN, EMB_DIM, LIN_GROUPS)
    conv("erb_dec.conv3p", CONV_CH, CONV_CH, 1, 1, 1, False)
    conv("erb_dec.convt3", CONV_CH, CONV_CH, 1, 3, CONV_CH, True)
    conv("erb_dec.conv2p", CONV_CH, CONV_CH, 1, 1, 1, False)
    conv("erb_dec.convt2", CONV_CH, CONV_CH, 1, 3, CONV_CH, True)
    conv("erb_dec.conv1p", CONV_CH, CONV_CH, 1, 1, 1, False)
    conv("erb_dec.convt1", CONV_CH, CONV_CH, 1, 3, CONV_CH, True)
    conv("erb_dec.conv0p", CONV_CH, CONV_CH, 1, 1, 1, False)
    conv("erb_dec.conv0_out", 1, CONV_CH, 1, 3, 1, False)

    conv("df_dec.df_convp", DF_ORDER * 2, CONV_CH, DF_PATHWAY_KT, 1, 2, True)
    p["df_dec.df_gru.lin_in.w"] = _glinear(rng, EMB_DIM, DF_HIDDEN, LIN_GROUPS)
    for layer in range(DF_GRU_LAYERS):
        _flatten_into(p, f"df_dec.df_gru.gru_l{layer}", _gru_layer(rng, DF_HIDDEN, DF_HIDDEN))
    p["df_dec.df_out.w"] = _glinear(rng, DF_HIDDEN, _DF_OUT_DIM, LIN_GROUPS)
    return p


@cache
def _weight_shapes() -> dict:
    return {k: v.shape for k, v in init_params().items()}


def _torch_name_map() -> dict[str, str]:
    """Official DFN3 torch state-dict name -> the weight key here, the
    reference's conversion contract (``models/dfn3.py`` there). Every
    Conv2dNormAct of the official ``deepfilternet3.DfNet`` is an
    nn.Sequential whose indices depend on the causal time-pad layer (time
    kernel > 1) and on the separable pointwise conv."""
    m: dict[str, str] = {}

    def conv(off: str, key: str, padded: bool, separable: bool):
        i = 1 if padded else 0
        m[f"{off}.{i}.weight"] = f"{key}.w"
        if separable:
            i += 1
            m[f"{off}.{i}.weight"] = f"{key}.pw"
        i += 1
        for name, leaf in (("weight", "g"), ("bias", "b"), ("running_mean", "m"),
                           ("running_var", "v")):
            m[f"{off}.{i}.{name}"] = f"{key}.bn.{leaf}"

    def gru(off: str, key: str, layers: int):
        for layer in range(layers):
            for name, leaf in (("weight_ih", "wi"), ("weight_hh", "wh"), ("bias_ih", "bi"),
                               ("bias_hh", "bh")):
                m[f"{off}.{name}_l{layer}"] = f"{key}.gru_l{layer}.{leaf}"

    conv("enc.erb_conv0", "enc.erb_conv0", True, False)
    for name in ("erb_conv1", "erb_conv2", "erb_conv3"):
        conv(f"enc.{name}", f"enc.{name}", False, True)
    conv("enc.df_conv0", "enc.df_conv0", True, True)
    conv("enc.df_conv1", "enc.df_conv1", False, True)
    m["enc.df_fc_emb.0.weight"] = "enc.df_fc_emb.w"
    m["enc.emb_gru.linear_in.0.weight"] = "enc.emb_gru.lin_in.w"
    gru("enc.emb_gru.gru", "enc.emb_gru", EMB_GRU_LAYERS)
    m["enc.emb_gru.linear_out.0.weight"] = "enc.emb_gru.lin_out.w"
    m["enc.lsnr_fc.0.weight"] = "enc.lsnr.w"
    m["enc.lsnr_fc.0.bias"] = "enc.lsnr.b"

    m["erb_dec.emb_gru.linear_in.0.weight"] = "erb_dec.emb_gru.lin_in.w"
    gru("erb_dec.emb_gru.gru", "erb_dec.emb_gru", ERB_DEC_GRU_LAYERS)
    m["erb_dec.emb_gru.linear_out.0.weight"] = "erb_dec.emb_gru.lin_out.w"
    for level in (3, 2, 1):
        conv(f"erb_dec.conv{level}p", f"erb_dec.conv{level}p", False, False)
        conv(f"erb_dec.convt{level}", f"erb_dec.convt{level}", False, True)
    conv("erb_dec.conv0p", "erb_dec.conv0p", False, False)
    conv("erb_dec.conv0_out", "erb_dec.conv0_out", False, False)

    conv("df_dec.df_convp", "df_dec.df_convp", True, True)
    m["df_dec.df_gru.linear_in.0.weight"] = "df_dec.df_gru.lin_in.w"
    gru("df_dec.df_gru.gru", "df_dec.df_gru", DF_GRU_LAYERS)
    m["df_dec.df_out.0.weight"] = "df_dec.df_out.w"
    return m


TORCH_NAME_MAP = _torch_name_map()

# torch ConvTranspose2d stores its weight as [in, out/g, kt, kf]; the weights
# here store every conv as [out, in/g, kt, kf] in forward-correlation
# orientation, so a transposed conv's weight is regrouped, transposed within
# each group and flipped along frequency. Key -> groups (both depthwise).
_TRANSPOSED_KEYS = {
    "erb_dec.convt2.w": CONV_CH,
    "erb_dec.convt1.w": CONV_CH,
}


def _convert_transposed(arr: np.ndarray, groups: int) -> np.ndarray:
    """[in, out/g, kt, kf] (torch ConvTranspose2d) -> [out, in/g, kt, kf] in
    forward-correlation orientation."""
    i_total, og, kh, kw = arr.shape
    arr = arr.reshape(groups, i_total // groups, og, kh, kw).transpose(0, 2, 1, 3, 4)
    return arr.reshape(groups * og, i_total // groups, kh, kw)[..., ::-1].copy()


def convert_torch_state_dict(state_dict: dict) -> dict:
    """An official DFN3 torch state dict (tensor name -> array) as the
    weight archive here (numpy f32), validating keys and shapes; raises
    ``ValueError`` on a missing or unknown key or a wrong shape."""
    shapes = _weight_shapes()
    out: dict[str, np.ndarray] = {}
    unknown = []
    for name, value in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        key = TORCH_NAME_MAP.get(name)
        if key is None:
            unknown.append(name)
            continue
        arr = np.asarray(value, np.float32)
        if key in _TRANSPOSED_KEYS:
            arr = _convert_transposed(arr, _TRANSPOSED_KEYS[key])
        out[key] = arr
    missing = set(shapes) - set(out)
    if missing or unknown:
        raise ValueError(f"torch state dict does not match the DFN3 graph: "
                         f"missing={sorted(missing)} unknown={sorted(unknown)}")
    for key, shape in shapes.items():
        if out[key].shape != shape:
            raise ValueError(f"weight {key!r} shape {out[key].shape} != expected {shape}")
    return out


def weights_from_numpy(arrays: dict, device="cpu") -> dict:
    """Validate a ``{name: array}`` weight dict against the graph's key/shape
    contract and move it to ``device``. Keys starting with ``__`` are
    provenance metadata and are dropped."""
    params = {k: np.asarray(v, np.float32) for k, v in arrays.items()
              if not k.startswith("__")}
    shapes = _weight_shapes()
    missing, extra = set(shapes) - set(params), set(params) - set(shapes)
    if missing or extra:
        raise ValueError(f"weight archive key mismatch: missing={sorted(missing)} "
                         f"extra={sorted(extra)}")
    for key, shape in shapes.items():
        if params[key].shape != shape:
            raise ValueError(f"weight {key!r} shape {params[key].shape} != expected "
                             f"{shape}")
    return {k: torch.as_tensor(v, device=device) for k, v in params.items()}


def load_weights(path, device="cpu") -> dict:
    with np.load(path) as data:
        return weights_from_numpy({k: data[k] for k in data.files}, device)


# App-owned asset paths (`dsp/deepfilter_ffi.rs:119-160`), apart from the
# ambient DEEPFILTER_* environment overrides, which are ignored unless
# AUDIOFORGE_ALLOW_EXTERNAL_DF=1.
_APP_OWNED_PATHS: dict = {"library": None, "model": None}


def _canonical_app_owned_path(path, kind: str):
    if path is None:
        return None
    try:
        return Path(path).resolve(strict=True)
    except OSError as exc:
        raise ValueError(f"Invalid app-owned DeepFilter {kind} path: {exc}") from exc


def configure_deepfilter_runtime_paths(library_path=None, model_path=None):
    """Register bundled DeepFilter assets; both paths must exist, either may
    be None to clear it."""
    configured = {
        "library": _canonical_app_owned_path(library_path, "library"),
        "model": _canonical_app_owned_path(model_path, "model"),
    }
    _APP_OWNED_PATHS.update(configured)


def configured_deepfilter_runtime_paths() -> dict:
    return dict(_APP_OWNED_PATHS)


def external_paths_allowed() -> bool:
    """Ambient ``DEEPFILTER_*`` paths count only with
    ``AUDIOFORGE_ALLOW_EXTERNAL_DF=1``."""
    return os.environ.get("AUDIOFORGE_ALLOW_EXTERNAL_DF", "").strip() == "1"


def resolve_weight_path(low_latency: bool = True):
    """The weight archive under the trust model: an app-owned (registered)
    path first; ``DEEPFILTER_MODEL_PATH`` only with the external opt-in;
    then the bundled archive of the variant (``dfn3_ll.npz`` LL,
    ``dfn3.npz`` standard: the two variants are different models). None when
    nothing trusted is there."""
    owned = _APP_OWNED_PATHS.get("model")
    if owned is not None:
        return owned
    env = os.environ.get("DEEPFILTER_MODEL_PATH")
    if env and external_paths_allowed():
        candidate = Path(env)
        if candidate.is_file():
            return candidate.resolve()
    name = "dfn3_ll.npz" if low_latency else "dfn3.npz"
    bundled = Path(__file__).resolve().parents[2] / "models" / name
    return bundled if bundled.is_file() else None


_DEFAULT_PARAMS_CACHE: dict = {}


def default_params(low_latency: bool = True) -> dict:
    """The default weights of a variant (CPU tensors), resolved once per
    process: a trusted archive (:func:`resolve_weight_path`) wins, else the
    seeded weights. An archive tagged for the other variant is refused."""
    key = "ll" if low_latency else "std"
    if key not in _DEFAULT_PARAMS_CACHE:
        path = resolve_weight_path(low_latency)
        if path is not None:
            with np.load(path) as data:
                arrays = {k: data[k] for k in data.files}
            source = (str(np.asarray(arrays["__provenance__"]).item())
                      if "__provenance__" in arrays else "converted")
            variant = (str(np.asarray(arrays["__variant__"]).item())
                       if "__variant__" in arrays else None)
            expected = "ll" if low_latency else "standard"
            if variant is not None and variant != expected:
                raise ValueError(
                    f"DeepFilter archive {path} is the {variant!r} variant but the "
                    f"{expected!r} variant was requested: the two latency variants "
                    "use different weights")
            _DEFAULT_PARAMS_CACHE[key] = (weights_from_numpy(arrays), source)
        else:
            _DEFAULT_PARAMS_CACHE[key] = (weights_from_numpy(init_params()), "seeded")
    return _DEFAULT_PARAMS_CACHE[key][0]


def weights_source(low_latency: bool = True) -> str:
    """``"converted"``, ``"trained"`` or ``"seeded"``."""
    default_params(low_latency)
    return _DEFAULT_PARAMS_CACHE["ll" if low_latency else "std"][1]


# ---------------------------------------------------------------------------
# Layers. Activations are channels-last, ``[N, F, C]``; the state's windows
# keep the reference's ``[N, time, C, F]``. No convolution op runs: each conv
# unit is a dense GEMM over the window's or the activation's own layout, and
# a depthwise conv is a sum of three taps over strided views.
# ---------------------------------------------------------------------------

# a unit's weight tensor -> (its other tensors, its GEMM form); made at the
# unit's first eager call (a graph capture's warm-up), then read by address by
# every replay, as _consts is
_UNITS = WeakIdKeyDictionary()
_UNIT_LEAVES = ("pw", "bn.g", "bn.b", "bn.m", "bn.v")


def _bn_fold(p, key):
    """Inference BatchNorm of unit ``key`` as a per-channel ``(scale,
    shift)``, in f64."""
    g, b, m, v = (p[f"{key}.bn.{leaf}"].double() for leaf in "gbmv")
    scale = g * torch.rsqrt(v + _BN_EPS)
    return scale, b - m * scale


def _fold(w, pw, scale, shift, groups):
    """A conv unit's GEMM form, composed in f64 and stored in f32, with the
    BatchNorm's scale folded into the output channels and its shift made the
    bias. A depthwise ``(1, kf)`` conv followed by a pointwise one gives
    ``(taps [kf, C], pointwise [C, O], bias [O])``; any other unit ``(weight
    [kt * I * kf, O], bias [O])``, its grouped conv and pointwise conv
    composed into one dense map whose rows run over (time, input channel,
    freq tap)."""
    o, ig, kt, kf = w.shape
    f32 = lambda *ts: tuple(t.float().contiguous() for t in ts)
    if pw is not None and groups == o and ig == 1 and kt == 1:
        return f32(w[:, 0, 0].T, (pw[:, :, 0, 0].double() * scale[:, None]).T, shift)
    og = o // groups
    dense = w.new_zeros((o, ig * groups, kt, kf), dtype=torch.float64)
    for j in range(groups):
        dense[j * og:(j + 1) * og, j * ig:(j + 1) * ig] = w[j * og:(j + 1) * og]
    if pw is not None:
        dense = torch.einsum("op,pitk->oitk", pw[:, :, 0, 0].double(), dense)
    return f32((dense * scale[:, None, None, None]).permute(2, 1, 3, 0).reshape(-1, o), shift)


def _unit(p, key, groups=1):
    """The GEMM form (:func:`_fold`) of conv unit ``key`` of the weights
    ``p``, made once for the unit's tensors: a tensor replaced in ``p`` makes
    it anew."""
    w = p[f"{key}.w"]
    rest = tuple(p.get(f"{key}.{leaf}") for leaf in _UNIT_LEAVES)
    hit = _UNITS.get(w)
    if hit is None or any(a is not b for a, b in zip(hit[0], rest)):
        hit = _UNITS[w] = (rest, _fold(w, rest[0], *_bn_fold(p, key), groups))
    return hit[1]


def _activate(y, act):
    if act == "relu":
        return y.relu_()
    if act == "sigmoid":
        return y.sigmoid_()
    return y


def _cols(x, axis):
    """The rows of a 'same' (.., 3) conv over the freq axis ``axis`` of ``x
    [N, ...]``: ``[N * F, K]``, one row an output bin's three-bin
    neighbourhood over x's other axes in their order, the freq tap last."""
    pad = [0, 0] * (x.ndim - 1 - axis) + [1, 1]
    u = F.pad(x, pad).unfold(axis, 3, 1)
    return u.movedim(axis, 1).reshape(x.shape[0] * x.shape[axis], -1)


def _gemm(unit, rows, act="relu"):
    """``act(rows @ weight + bias)`` of a unit's dense form."""
    weight, bias = unit
    return _activate(torch.addmm(bias, rows, weight), act)


def _conv_window(unit, win, act="relu"):
    """Conv2dNormAct producing one frame from the causal window ``win [N, T,
    C, F]`` (oldest first), 'same' over freq: ``[N, F, O]``. A kf-3 unit
    runs one GEMM over the unfolded window, a kf-1 unit one GEMM a stream
    over the window's own layout."""
    weight, bias = unit
    n, t, c, f = win.shape
    if weight.shape[0] == t * c:
        y = torch.baddbmm(bias, win.reshape(n, t * c, f).mT, weight.expand(n, -1, -1))
        return _activate(y, act)
    return _gemm(unit, _cols(win, 3), act).view(n, f, -1)


def _pointwise(weight, bias, x):
    """A 1x1 conv with its BatchNorm and ReLU over ``x [N, F, C]``: one
    GEMM."""
    n, f, c = x.shape
    return _gemm((weight, bias), x.reshape(n * f, c)).view(n, f, -1)


def _depthwise(x, taps, stride):
    """Depthwise (1, 3) conv over the freq axis of ``x [N, F, C]``, 'same'
    padding, ``taps [3, C]``: the three taps' products summed over strided
    views. ``[N, (F - 1) // stride + 1, C]``."""
    fo = (x.shape[1] - 1) // stride + 1
    y = x[:, ::stride] * taps[1]
    right = x[:, 1::stride]
    y[:, :right.shape[1]].addcmul_(right, taps[2])
    y[:, 1:].addcmul_(x[:, stride - 1::stride][:, :fo - 1], taps[0])
    return y


def _separable(unit, x, stride=1):
    """A depthwise (1, 3) unit with its pointwise conv, BatchNorm and ReLU
    over ``x [N, F, C]``."""
    taps, weight, bias = unit
    return _pointwise(weight, bias, _depthwise(x, taps, stride))


def _convt(unit, x):
    """ConvTranspose2dNormAct, freq stride 2, kernel (1, 3), depthwise +
    pointwise + BN + ReLU, ``[N, F, C]`` -> ``[N, 2F, C]``. The converted
    kernel's correlation over the input with zeros inserted, without the
    zeros: output ``2m`` is the middle tap of ``x[m]``, output ``2m + 1``
    the outer taps of ``x[m]`` and ``x[m + 1]`` (0 past the end)."""
    taps, weight, bias = unit
    n, f, c = x.shape
    y = x.new_empty(n, f, 2, c)
    torch.mul(x, taps[1], out=y[:, :, 0])
    torch.mul(x, taps[0], out=y[:, :, 1])
    y[:, :-1, 1].addcmul_(x[:, 1:], taps[2])
    return _pointwise(weight, bias, y.view(n, 2 * f, c))


def _glinear_apply(w, x):
    """GroupedLinearEinsum: ``x [..., I]`` with ``w [g, I/g, O/g]`` ->
    ``[..., O]``."""
    g, ig, og = w.shape
    y = torch.einsum("...gi,gio->...go", x.reshape(*x.shape[:-1], g, ig), w)
    return y.reshape(*x.shape[:-1], g * og)


def _gru_step(p, key, x, h):
    """One torch GRU cell step (gate order r, z, n; ``r`` multiplies
    ``h W_hn^T + b_hn``)."""
    gi = torch.addmm(p[f"{key}.bi"], x, p[f"{key}.wi"].T)
    gh = torch.addmm(p[f"{key}.bh"], h, p[f"{key}.wh"].T)
    hs = h.shape[-1]
    r = torch.sigmoid(gi[:, :hs] + gh[:, :hs])
    z = torch.sigmoid(gi[:, hs:2 * hs] + gh[:, hs:2 * hs])
    n = torch.tanh(gi[:, 2 * hs:] + r * gh[:, 2 * hs:])
    return (1.0 - z) * n + z * h


def _flatten_fc(x):
    """``[N, F, C]`` -> ``[N, F * C]`` (freq-major, channel-minor): a view."""
    return x.reshape(x.shape[0], -1)


def _unflatten_cf(x, f):
    """``[N, F * C]`` -> ``[N, F, C]``, the inverse of :func:`_flatten_fc`."""
    return x.view(x.shape[0], f, -1)


def _post_filter(gains, beta):
    """libDF's post filter: ``g (1 + beta) / (1 + beta (g / sin(pi g /
    2))^2)``."""
    ratio = gains / torch.clamp_min(torch.sin(0.5 * math.pi * gains), 1e-6)
    return gains * (1.0 + beta) / (1.0 + beta * torch.square(ratio))


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def dfn_state_init(*, n: int, lookahead: bool = False, device) -> dict:
    """The streaming state of ``n`` streams. ``lookahead=True`` is the
    standard variant: the spectra of frames t-2 and t-1 wait in
    ``spec_queue`` for their gains."""
    z = lambda *s: torch.zeros((n,) + s, dtype=torch.float32, device=device)
    rows = lambda init: torch.as_tensor(init, device=device).repeat(n, 1)
    state = {
        "analysis_mem": z(FRAME_SIZE),
        "synthesis_mem": z(FRAME_SIZE),
        "erb_norm": rows(_ERB_NORM_INIT),
        "unit_norm": rows(_UNIT_NORM_INIT),
        "erb_feat_hist": z(2, 1, NB_ERB),
        "spec_feat_hist": z(2, 2, NB_DF),
        "c0_hist": z(DF_PATHWAY_KT - 1, CONV_CH, NB_DF),
        "enc_gru": z(EMB_HIDDEN),
        "erb_dec_gru": z(EMB_HIDDEN),
        "df_gru": z(DF_GRU_LAYERS, DF_HIDDEN),
        "spec_hist": z(DF_ORDER, NB_DF, 2),
    }
    if lookahead:
        state["spec_queue"] = z(2, FREQ_SIZE, 2)
    return state


# ---------------------------------------------------------------------------
# Kernels of the frame
# ---------------------------------------------------------------------------


def dfn_features_plain(spec, erb_norm, unit_norm):
    """``spec [N, 481, 2]`` (real, imaginary), the norm states ``[N, 32]``
    and ``[N, 96]``. Returns ``(feat_erb [N, 32], feat_spec [N, 2, 96],
    erb_norm, unit_norm)``."""
    c = _consts(spec.device)
    re, im = spec[..., 0], spec[..., 1]
    power = re * re + im * im
    erb_db = 10.0 * torch.log10(torch.matmul(power, c["fb_t"]) + 1e-10)
    erb_mean = erb_db * (1.0 - _NORM_ALPHA) + erb_norm * _NORM_ALPHA
    unit = torch.sqrt(power[:, :NB_DF]) * (1.0 - _NORM_ALPHA) + unit_norm * _NORM_ALPHA
    scale = torch.rsqrt(torch.clamp_min(unit, 1e-10))
    feat_spec = torch.stack([re[:, :NB_DF] * scale, im[:, :NB_DF] * scale], dim=1)
    return (erb_db - erb_mean) / 40.0, feat_spec, erb_mean, unit


def dfn_features(spec, erb_norm, unit_norm):
    """:func:`dfn_features_plain` on a CPU tensor; the ``dfn_features`` CUDA
    kernel on a CUDA tensor (f32, contiguous)."""
    if spec.device.type == "cpu":
        return dfn_features_plain(spec, erb_norm, unit_norm)
    if spec.device.type != "cuda":
        raise ValueError(f"dfn_features: unsupported device {spec.device}")
    return _dfn_features_launch(spec, erb_norm, unit_norm)


def _dfn_features_launch(spec, erb_norm, unit_norm):
    n, dev = spec.shape[0], spec.device
    kernels.check_tensor("dfn_features spec", spec, torch.float32, (n, FREQ_SIZE, 2), dev)
    kernels.check_tensor("dfn_features erb_norm", erb_norm, torch.float32, (n, NB_ERB), dev)
    kernels.check_tensor("dfn_features unit_norm", unit_norm, torch.float32, (n, NB_DF), dev)
    kernels.check_aligned("dfn_features spec", spec, 8)
    feat_erb, erb_out = torch.empty_like(erb_norm), torch.empty_like(erb_norm)
    unit_out = torch.empty_like(unit_norm)
    feat_spec = torch.empty((n, 2, NB_DF), dtype=torch.float32, device=dev)
    kernels.launch("dfn_features", spec.data_ptr(), erb_norm.data_ptr(),
                   unit_norm.data_ptr(), _consts(dev)["erb_offsets"].data_ptr(),
                   feat_erb.data_ptr(), feat_spec.data_ptr(), erb_out.data_ptr(),
                   unit_out.data_ptr(), n, _NORM_ALPHA, 1.0 - _NORM_ALPHA,
                   kernels.stream_of(dev))
    return feat_erb, feat_spec, erb_out, unit_out


def dfn_spec_synth_plain(x_tgt, erb_gains, df_coefs, spec_hist, atten_lim_db,
                         post_filter_beta):
    """The enhanced spectrum ``[N, 481, 2]`` of the target spectrum ``x_tgt
    [N, 481, 2]``: the ERB gains ``[N, 32]`` (post-filtered where beta > 0)
    spread to the bins, the order-5 deep filter of ``df_coefs [N, 5, 96, 2]``
    over ``spec_hist [N, 5, 96, 2]`` in place of the 96 low bins, then the
    attenuation limit's mix with the target."""
    c = _consts(x_tgt.device)
    atten_lim_db = kernels.scalar(atten_lim_db, x_tgt.device)
    post_filter_beta = kernels.scalar(post_filter_beta, x_tgt.device)
    gains = torch.where(post_filter_beta > 0, _post_filter(erb_gains, post_filter_beta),
                        erb_gains)
    bin_gains = torch.matmul(gains, c["spread_t"])
    xr, xi = x_tgt[..., 0], x_tgt[..., 1]
    cr, ci = df_coefs[..., 0], df_coefs[..., 1]
    hr, hi = spec_hist[..., 0], spec_hist[..., 1]
    yr = torch.cat([(cr * hr - ci * hi).sum(1), (xr * bin_gains)[:, NB_DF:]], dim=-1)
    yi = torch.cat([(cr * hi + ci * hr).sum(1), (xi * bin_gains)[:, NB_DF:]], dim=-1)
    floor = torch.pow(10.0, -atten_lim_db / 20.0)
    return torch.stack([floor * xr + (1.0 - floor) * yr,
                        floor * xi + (1.0 - floor) * yi], dim=-1)


def dfn_spec_synth(x_tgt, erb_gains, df_coefs, spec_hist, atten_lim_db,
                   post_filter_beta):
    """:func:`dfn_spec_synth_plain` on a CPU tensor; the ``dfn_spec_synth``
    CUDA kernel on a CUDA tensor (f32, contiguous; the two controls 0-d
    tensors there)."""
    if x_tgt.device.type == "cpu":
        return dfn_spec_synth_plain(x_tgt, erb_gains, df_coefs, spec_hist, atten_lim_db,
                                    post_filter_beta)
    if x_tgt.device.type != "cuda":
        raise ValueError(f"dfn_spec_synth: unsupported device {x_tgt.device}")
    return _dfn_spec_synth_launch(x_tgt, erb_gains, df_coefs, spec_hist, atten_lim_db,
                                  post_filter_beta)


def _dfn_spec_synth_launch(x_tgt, erb_gains, df_coefs, spec_hist, atten_lim_db,
                           post_filter_beta):
    n, dev = x_tgt.shape[0], x_tgt.device
    atten_lim_db = kernels.scalar(atten_lim_db, dev)
    post_filter_beta = kernels.scalar(post_filter_beta, dev)
    for name, t, shape in (("x_tgt", x_tgt, (n, FREQ_SIZE, 2)),
                           ("erb_gains", erb_gains, (n, NB_ERB)),
                           ("df_coefs", df_coefs, (n, DF_ORDER, NB_DF, 2)),
                           ("spec_hist", spec_hist, (n, DF_ORDER, NB_DF, 2)),
                           ("atten_lim_db", atten_lim_db, ()),
                           ("post_filter_beta", post_filter_beta, ())):
        kernels.check_tensor(f"dfn_spec_synth {name}", t, torch.float32, shape, dev)
    kernels.check_aligned("dfn_spec_synth x_tgt", x_tgt, 8)
    y = torch.empty_like(x_tgt)
    kernels.launch("dfn_spec_synth", x_tgt.data_ptr(), erb_gains.data_ptr(),
                   df_coefs.data_ptr(), spec_hist.data_ptr(),
                   _consts(dev)["bin_band"].data_ptr(), atten_lim_db.data_ptr(),
                   post_filter_beta.data_ptr(), y.data_ptr(), n, kernels.stream_of(dev))
    return y


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _dfn_analyze(p, state, x_frame):
    """Window and transform the frame, the features, the encoder and both
    decoders. Returns ``(spec [N, 481, 2], new_partial, erb_gains [N, 32],
    df_coefs [N, 5, 96, 2], lsnr [N, 1])``; ``new_partial["spec_hist"]``
    holds the low-bin history the deep filter runs over."""
    c = _consts(x_frame.device)
    windowed = torch.cat([state["analysis_mem"], x_frame], dim=-1) * c["window"]
    spec = torch.view_as_real(torch.fft.rfft(windowed, dim=-1))  # [N, 481, 2]
    feat_erb, feat_spec, erb_norm, unit_norm = dfn_features(
        spec, state["erb_norm"], state["unit_norm"])

    # --- encoder (windows [N, time, C, F], oldest first; out [N, F, C]) ---
    erb_win = torch.cat([state["erb_feat_hist"], feat_erb[:, None, None, :]], dim=1)
    spec_win = torch.cat([state["spec_feat_hist"], feat_spec[:, None]], dim=1)
    sep = lambda key, x, stride=1: _separable(_unit(p, key, CONV_CH), x, stride)
    e0 = _conv_window(_unit(p, "enc.erb_conv0"), erb_win)                  # [N, 32, C]
    e1 = sep("enc.erb_conv1", e0, 2)                                        # [N, 16, C]
    e2 = sep("enc.erb_conv2", e1, 2)                                        # [N, 8, C]
    e3 = sep("enc.erb_conv3", e2)                                           # [N, 8, C]
    c0 = _conv_window(_unit(p, "enc.df_conv0", 2), spec_win)                # [N, 96, C]
    c1 = sep("enc.df_conv1", c0, 2)                                         # [N, 48, C]

    cemb = torch.relu(_glinear_apply(p["enc.df_fc_emb.w"], _flatten_fc(c1)))
    emb = _flatten_fc(e3) + cemb                                            # [N, 512]
    g_in = torch.relu(_glinear_apply(p["enc.emb_gru.lin_in.w"], emb))
    enc_h = _gru_step(p, "enc.emb_gru.gru_l0", g_in, state["enc_gru"])
    emb = torch.relu(_glinear_apply(p["enc.emb_gru.lin_out.w"], enc_h))
    lsnr = (torch.sigmoid(torch.addmm(p["enc.lsnr.b"], emb, p["enc.lsnr.w"].T))
            * (LSNR_MAX - LSNR_MIN) + LSNR_MIN)

    # --- ERB-gain decoder (the skip pathways' mirror) ---
    d_in = torch.relu(_glinear_apply(p["erb_dec.emb_gru.lin_in.w"], emb))
    dec_h = _gru_step(p, "erb_dec.emb_gru.gru_l0", d_in, state["erb_dec_gru"])
    demb = torch.relu(_glinear_apply(p["erb_dec.emb_gru.lin_out.w"], dec_h))
    skip = lambda key, e, x: _pointwise(*_unit(p, key), e).add_(x)
    x3 = sep("erb_dec.convt3", skip("erb_dec.conv3p", e3, _unflatten_cf(demb, 8)))  # [N, 8, C]
    convt = lambda key, x: _convt(_unit(p, key, CONV_CH), x)
    x2 = convt("erb_dec.convt2", skip("erb_dec.conv2p", e2, x3))           # [N, 16, C]
    x1 = convt("erb_dec.convt1", skip("erb_dec.conv1p", e1, x2))           # [N, 32, C]
    erb_gains = _gemm(_unit(p, "erb_dec.conv0_out"),
                      _cols(skip("erb_dec.conv0p", e0, x1), 1),
                      "sigmoid").view(-1, NB_ERB)                           # [N, 32]

    # --- deep-filtering decoder ---
    h = torch.relu(_glinear_apply(p["df_dec.df_gru.lin_in.w"], emb))
    df_h = []
    for layer in range(DF_GRU_LAYERS):
        h = _gru_step(p, f"df_dec.df_gru.gru_l{layer}", h, state["df_gru"][:, layer])
        df_h.append(h)
    coefs = torch.tanh(_glinear_apply(p["df_dec.df_out.w"], h))
    c0_win = torch.cat([state["c0_hist"], c0.mT[:, None]], dim=1)          # [N, 5, C, 96]
    cp = _conv_window(_unit(p, "df_dec.df_convp", 2), c0_win)              # [N, 96, 10]
    coefs = cp.add_(coefs.view(-1, NB_DF, DF_ORDER * 2))
    df_coefs = coefs.view(-1, NB_DF, DF_ORDER, 2).transpose(1, 2).contiguous()

    new_partial = {
        "analysis_mem": x_frame,
        "erb_norm": erb_norm,
        "unit_norm": unit_norm,
        "erb_feat_hist": erb_win[:, 1:],
        "spec_feat_hist": spec_win[:, 1:],
        "c0_hist": c0_win[:, 1:],
        "enc_gru": enc_h,
        "erb_dec_gru": dec_h,
        "df_gru": torch.stack(df_h, dim=1),
        # the deep filter's tap i reads history frame i (oldest first)
        "spec_hist": torch.cat([state["spec_hist"][:, 1:], spec[:, None, :NB_DF]], dim=1),
    }
    return spec, new_partial, erb_gains, df_coefs, lsnr


def dfn_frame(params, state, x_frame, atten_lim_db=DEFAULT_ATTEN_LIM_DB,
              post_filter_beta=DEFAULT_POST_FILTER_BETA):
    """Enhance one 480-sample frame of every stream, ``x_frame [N, 480]``.
    Returns ``(new_state, y [N, 480], aux)`` with ``aux`` ``{erb_gains,
    lsnr}``. The state's structure picks the variant: without
    ``spec_queue`` (LL) the gains apply to this frame; with it (standard)
    to the queued spectrum of frame t-2, with the deep filter's history
    centred on it."""
    dev = x_frame.device
    atten_lim_db = kernels.scalar(atten_lim_db, dev)
    post_filter_beta = kernels.scalar(post_filter_beta, dev)
    spec, new_state, erb_gains, df_coefs, lsnr = _dfn_analyze(params, state, x_frame)
    if "spec_queue" in state:
        queue = state["spec_queue"]
        x_tgt = queue[:, 0].contiguous()
        new_state["spec_queue"] = torch.cat([queue[:, 1:], spec[:, None]], dim=1)
    else:
        x_tgt = spec
    y_spec = dfn_spec_synth(x_tgt, erb_gains, df_coefs, new_state["spec_hist"],
                            atten_lim_db, post_filter_beta)
    y = (torch.fft.irfft(torch.view_as_complex(y_spec), n=WINDOW_SIZE, dim=-1)
         * _consts(dev)["window"])
    new_state["synthesis_mem"] = y[:, FRAME_SIZE:]
    out = state["synthesis_mem"] + y[:, :FRAME_SIZE]
    return new_state, out, {"erb_gains": erb_gains, "lsnr": lsnr}


def dfn_frames(params, state, frames, atten_lim_db=DEFAULT_ATTEN_LIM_DB,
               post_filter_beta=DEFAULT_POST_FILTER_BETA):
    """Enhance ``frames [..., n, 480]`` frame by frame on their device;
    ``state`` holds ``prod(...)`` streams. Returns ``(state, y [..., n,
    480])``."""
    frames = torch.as_tensor(frames)
    *lead, n_frames, _ = frames.shape
    n = int(np.prod(lead))
    x = frames.reshape(n, n_frames, FRAME_SIZE).transpose(0, 1)
    atten = kernels.scalar(atten_lim_db, frames.device)
    beta = kernels.scalar(post_filter_beta, frames.device)

    def step(st, block):
        st, y, _ = dfn_frame(params, st, block["x"], atten, beta)
        return st, {"y": y}

    state, rows = run_take(step, state, {"x": x}, n_frames)
    if not rows:
        return state, frames.new_zeros(frames.shape)
    return state, rows["y"].transpose(0, 1).reshape(*lead, n_frames, FRAME_SIZE)


# ---------------------------------------------------------------------------
# Frame-staging processor with failure semantics
# ---------------------------------------------------------------------------


def latency_samples(low_latency: bool) -> int:
    """LL: one frame; standard: three frames (two of lookahead)."""
    return FRAME_SIZE if low_latency else 3 * FRAME_SIZE


def processor_init(params=None, strength: float = 1.0, low_latency: bool = True,
                   atten_lim_db: float = DEFAULT_ATTEN_LIM_DB,
                   post_filter_beta: float = DEFAULT_POST_FILTER_BETA, *,
                   device="cuda") -> dict:
    """One stream's staging processor; the model runs on ``device`` (a CUDA
    device unless asked otherwise)."""
    atten, beta = validate_runtime_config(atten_lim_db, post_filter_beta)
    dev = kernels.resolve_device(device, "dfn3.processor_init")
    params = default_params(low_latency) if params is None else params
    return {
        "params": {k: v.to(dev) for k, v in params.items()},
        "model": dfn_state_init(n=1, lookahead=not low_latency, device=dev),
        "in_buf": np.zeros(0, np.float32),
        "out_buf": np.zeros(0, np.float32),
        # the dry path waits for the model's latency
        "dry_delay": np.zeros(latency_samples(low_latency), np.float32),
        "strength": float(np.clip(strength, 0.0, 1.0)),
        "smoothed_strength": 1.0,
        "smoothing_coeff": float(1.0 - np.exp(-(FRAME_SIZE / 48000.0) / 0.015)),
        "low_latency": bool(low_latency),
        "atten_lim_db": atten,
        "post_filter_beta": beta,
        "backend_failed": False,
        "enabled": True,
        "replay": None,  # the frame step, built at the first processed frame
    }


def processor_push(state, samples):
    state = dict(state)
    state["in_buf"] = np.concatenate([state["in_buf"], np.asarray(samples, np.float32)])
    return state, len(np.asarray(samples))


def frame_replay(params, model_state, atten_lim_db=DEFAULT_ATTEN_LIM_DB,
                 post_filter_beta=DEFAULT_POST_FILTER_BETA, *,
                 k_max: int = 8) -> BlockReplay:
    """One stream's frame step over ``model_state`` (``n=1``): the model's
    output frame (``wet``)."""
    dev = model_state["analysis_mem"].device
    atten = kernels.scalar(atten_lim_db, dev)
    beta = kernels.scalar(post_filter_beta, dev)

    def step(st, block):
        st, y, _ = dfn_frame(params, st, block["x"][None], atten, beta)
        return st, {"wet": y[0]}

    return BlockReplay(step, model_state, {"x": (FRAME_SIZE,)}, device=dev,
                       k_max=k_max)


def processor_prepare(state):
    """Build the state's frame step now and, on the card, capture it, so
    that the first frame pays no capture; no frame is processed."""
    state = dict(state)
    if state.get("replay") is None:
        state["replay"] = frame_replay(state["params"], state["model"],
                                       state["atten_lim_db"], state["post_filter_beta"])
    state["replay"].prepare()
    return state


def processor_process(state):
    """Process every staged frame. A non-finite model frame marks the
    backend failed for good; the processor then passes the latency-aligned
    dry signal through (the model state it had advanced is not used again).
    Returns ``(state, n_frames)``."""
    state = dict(state)
    n_frames = len(state["in_buf"]) // FRAME_SIZE
    if n_frames == 0:
        return state, 0
    take = state["in_buf"][: n_frames * FRAME_SIZE]
    state["in_buf"] = state["in_buf"][n_frames * FRAME_SIZE:]

    dry_stream = np.concatenate([state["dry_delay"], take])
    dry_aligned = dry_stream[: n_frames * FRAME_SIZE]
    state["dry_delay"] = dry_stream[n_frames * FRAME_SIZE:]

    if state["backend_failed"] or not state["enabled"]:
        state["out_buf"] = np.concatenate([state["out_buf"], dry_aligned])
        return state, n_frames

    if state.get("replay") is None:
        state["replay"] = frame_replay(state["params"], state["model"],
                                       state["atten_lim_db"], state["post_filter_beta"],
                                       k_max=max(8, min(n_frames, 256)))
    wet = state["replay"].run(take.reshape(n_frames, FRAME_SIZE))["wet"].reshape(-1)
    if not np.all(np.isfinite(wet)):
        state["backend_failed"] = True
        state["out_buf"] = np.concatenate([state["out_buf"], dry_aligned])
        return state, n_frames

    sm = state["smoothed_strength"]
    target = state["strength"]
    mixed = []
    for i in range(n_frames):
        sm = target * state["smoothing_coeff"] + sm * (1.0 - state["smoothing_coeff"])
        lo, hi = i * FRAME_SIZE, (i + 1) * FRAME_SIZE
        mixed.append(wet[lo:hi] * sm + dry_aligned[lo:hi] * (1.0 - sm))
    state["smoothed_strength"] = sm
    state["out_buf"] = np.concatenate([state["out_buf"]] + mixed)
    return state, n_frames


def processor_pop(state, count):
    state = dict(state)
    n = min(count, len(state["out_buf"]))
    out = state["out_buf"][:n]
    state["out_buf"] = state["out_buf"][n:]
    return state, out


def processor_soft_reset(state):
    """Clear the staging; the model's state and the failed flag stay."""
    state = dict(state)
    state["in_buf"] = np.zeros(0, np.float32)
    state["out_buf"] = np.zeros(0, np.float32)
    state["dry_delay"] = np.zeros(latency_samples(state["low_latency"]), np.float32)
    return state
