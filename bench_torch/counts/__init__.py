"""Operations and bytes of one serving block, per stage, from the
configuration's shapes: the published widths in the weight archives and the
chain's block geometry. Nothing here traces the program, so a stage counts
the same work whatever implements it.

The DSP stages' formulas are those of the port's kernel table (each input
read once and each output written once; the operations per sample of the
kernel's recurrence or feed-forward math). The model stages count the
multiply-adds of their layers from the archives' tensor shapes, the signal
processing around them as stated operations, and read their weights once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

BLOCK = 480
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense f32 and f64 FLOP/s
# outside the tensor cores (the port keeps TF32 off)
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12, "f64_flops_per_s": 34e12}


@dataclass(frozen=True)
class Stage:
    name: str
    launches: int
    bytes: float      # per launch
    f32_ops: float    # per launch
    f64_ops: float = 0.0

    def bound_s(self) -> float:
        """The least time of all its launches (:func:`bound`)."""
        return self.launches * bound(self.bytes, self.f32_ops, self.f64_ops)[0] / 1e3


def bound(bytes_moved: float, f32_ops: float = 0.0, f64_ops: float = 0.0):
    """``(bound_ms, bound_by)``: the larger of the bytes' time at the HBM rate
    and the operations' time at their type's peak."""
    t_bytes = bytes_moved / PEAKS["hbm_bytes_per_s"]
    t_ops = max(f32_ops / PEAKS["f32_flops_per_s"], f64_ops / PEAKS["f64_flops_per_s"])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _archive(path) -> dict:
    with np.load(path) as data:
        return {k: data[k].shape for k in data.files if not k.startswith("__")}


def _numel(shapes: dict, keys) -> int:
    return sum(math.prod(shapes[k]) for k in keys)


def _rfft_ops(n: int) -> float:
    """Stated operations of a real FFT of ``n`` points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


# --- model stages: multiply-adds per stream and frame --------------------

def rnnoise_macs(shapes: dict) -> dict:
    """RNNoise (Valin 2018): the input dense layer, the VAD, noise and
    denoise GRUs (three gates each over input and state) and both output
    layers, from the archive's ``*_w``/``*_wi``/``*_wh`` shapes; then, as
    stated operations of the frame's signal processing, the 22 Opus bands'
    energies of the spectrum, the pitch-filtered spectrum and their product
    (4 products of 481 bins x 22 bands), the band DCT of the features (2 of
    22 x 22), the gains spread back to the bins (3 of 22 x 481), and the
    pitch search's correlations: 193 lags of 240 samples at 12 kHz and 385
    lags of 480 at 24 kHz."""
    layers = _numel(shapes, [k for k in shapes if k.endswith(("_w", "_wi", "_wh"))])
    bands, bins = shapes["denoise_out_w"][1], 481
    dsp = 4 * bins * bands + 2 * bands * bands + 3 * bands * bins
    pitch = 193 * 240 + 385 * 480
    return {"layers": layers, "dsp": dsp, "pitch": pitch}


def silero_macs(shapes: dict) -> dict:
    """Silero VAD: the STFT basis over 4 frames of 256 samples, the four
    Conv1d layers of kernel 3 over 4, 2, 1 and 1 frames (strides 1, 2, 2, 1),
    and the LSTM cell's input and state products; once per block on the
    576-sample window."""
    basis = shapes["stft_basis"][0] * shapes["stft_basis"][2] * 4
    positions = {"enc0_w": 4, "enc1_w": 2, "enc2_w": 1, "enc3_w": 1}
    convs = sum(math.prod(shapes[k]) * p for k, p in positions.items())
    lstm = _numel(shapes, ["lstm_wi", "lstm_wh"])
    return {"layers": basis + convs + lstm}


# output positions (frequency bins) per frame of each DeepFilterNet3 weight
# that is applied as a convolution: 32 ERB bands, halved by the strided
# encoder convs and doubled again by the decoder's transposed convs; 96 deep
# filter bins, halved once; every other weight is applied once a frame
_DFN_POSITIONS = {
    "enc.erb_conv0.w": 32, "enc.erb_conv1.w": 16, "enc.erb_conv1.pw": 16,
    "enc.erb_conv2.w": 8, "enc.erb_conv2.pw": 8, "enc.erb_conv3.w": 8, "enc.erb_conv3.pw": 8,
    "enc.df_conv0.w": 96, "enc.df_conv0.pw": 96, "enc.df_conv1.w": 48, "enc.df_conv1.pw": 48,
    "erb_dec.conv3p.w": 8, "erb_dec.convt3.w": 8, "erb_dec.convt3.pw": 8,
    "erb_dec.conv2p.w": 8, "erb_dec.convt2.w": 16, "erb_dec.convt2.pw": 16,
    "erb_dec.conv1p.w": 16, "erb_dec.convt1.w": 32, "erb_dec.convt1.pw": 32,
    "erb_dec.conv0p.w": 32, "erb_dec.conv0_out.w": 32,
    "df_dec.df_convp.w": 96, "df_dec.df_convp.pw": 96,
}


def dfn3_macs(shapes: dict) -> dict:
    """DeepFilterNet3 (Schroeter et al. 2023): every weight tensor of the
    encoder, the ERB decoder and the deep-filter decoder (convs, grouped
    linears, GRU input and state products, the LSNR head) times the
    positions it is applied at in a frame; then the frame's two FFTs of 960
    points as stated operations."""
    weights = [k for k in shapes if k.endswith((".w", ".pw", ".wi", ".wh"))]
    layers = sum(math.prod(shapes[k]) * _DFN_POSITIONS.get(k, 1) for k in weights)
    return {"layers": layers}


# --- the step ---------------------------------------------------------------

def _biquad(n: int, sections: int) -> Stage:
    # per section and sample 9 f64 operations; coefficients and f64 state
    return Stage(f"biquad_cascade x {sections}", 1, 8 * n * BLOCK + n * sections * (40 + 64 + 8),
                 0.0, BLOCK * 9 * n * sections)


def step_stages(config: dict, n: int, root: Path) -> list:
    """The stages of one block of ``n`` streams under ``config`` (a
    configuration file's dict), each with its launches, bytes and
    operations."""
    serving, chain = config["serving"], config.get("chain", {})
    model = serving.get("suppressor_model", "rnnoise")
    vad = serving.get("vad_enabled", False)
    strong = chain.get("cleanup_mode", "off") != "off"
    nT = n * BLOCK
    stages = [
        # EQ (10 sections), the routing high-pass, the loudness meter's and
        # the compressor meter's K-weighting (2 each), RNNoise's input high-pass
        *[_biquad(n, s) for s in ((10, 1, 2, 2, 1) if model == "rnnoise" else (10, 1, 2, 2))],
        Stage("limiter_gain_scan", 2, 12 * nT + n * 4 * 6, 16 * nT),
        Stage("compressor_scan", 1, 8 * nT + n * 4 * 2 * 20, 70 * nT),
        Stage("gate_scan", 1, 8 * nT + n * 4 * 2 * 18,
              (80 if chain.get("gate_mode", "THRESHOLD_ONLY") != "THRESHOLD_ONLY" else 35) * nT),
        Stage("limiter window max", 1, 4 * n * (96 + BLOCK) + 4 * nT, 3 * nT),
        Stage("true-peak 4x32 FIR", 3, 4 * n * (31 + BLOCK) + 4 * nT, nT * (2 * 4 * 32 + 9)),
        Stage("block reductions", 4, 1.5 * 4 * nT + n * 16, 3 * nT),
    ]
    if strong:
        stages += [
            Stage("cleanup_scan", 1, 8 * nT + n * (4 * (8 + 20 + 10) + 8 * 8 * 2), 20 * nT,
                  BLOCK * 27 * n),
            Stage("hum oscillator bank", 1, 4 * nT + 4 * n * 26 + 4 * n + 4 * n * (4 * 26 + 2),
                  10 * n * 26 * BLOCK),
        ]
    if chain.get("deesser_enabled", False):
        stages.append(Stage("deesser_scan", 1, 8 * nT + n * 4 * 2 * 33, 270 * nT))
    arch = {k: root / v for k, v in config["archives"].items()}
    if vad:
        shapes = _archive(arch["vad"])
        w = 4 * _numel(shapes, shapes)
        stages += [
            Stage("vad_front", 1, 4 * n * (BLOCK + 30 + 416 + 30 + 576 + 1024),
                  n * (2 * 160 * 31 + 1024)),
            Stage("Silero STFT, encoder and LSTM", 1,
                  w + 4 * n * (1024 + 2 * 258 * 4 + 128 * 4 + 2 * 512),
                  2 * n * silero_macs(shapes)["layers"]),
            Stage("vad_lstm_head", 1, 4 * n * (512 + 128 + 256 + 6), n * 128 * 114),
        ]
    if model == "rnnoise":
        shapes = _archive(arch["rnnoise"])
        m = rnnoise_macs(shapes)
        stages.append(Stage(
            "RNNoise frame", 1,
            4 * _numel(shapes, shapes) + 4 * n * (2 * (1728 + 96 + 48 + 24 + 960) + 2 * BLOCK),
            n * (2 * (m["layers"] + m["dsp"] + m["pitch"]) + 2 * _rfft_ops(960))))
    elif model is not None:
        shapes = _archive(arch["dfn3"])
        stages += [
            Stage("dfn_features", 1, 4 * n * (962 + 32 + 96 + 32 + 192 + 32 + 96),
                  n * (3 * 481 + 32 * 26 + 96 * 16)),
            Stage("DeepFilterNet3 network", 1,
                  4 * _numel(shapes, shapes) + 4 * n * 2 * (3 * 256 + 2 * 256 + 5 * 96 * 2),
                  n * (2 * dfn3_macs(shapes)["layers"] + 2 * _rfft_ops(960))),
            Stage("dfn_spec_synth", 1, 4 * n * (962 + 32 + 960 + 960 + 962),
                  n * (8 * 481 + 40 * 96 + 30 * 32)),
        ]
    return stages


def step_totals(config: dict, n: int, root: Path) -> dict:
    """One block of ``n`` streams: its f32 and f64 operations, their time at
    the peaks, and the sum of its stages' bounds, in seconds."""
    stages = step_stages(config, n, root)
    f32 = sum(s.launches * s.f32_ops for s in stages)
    f64 = sum(s.launches * s.f64_ops for s in stages)
    return {"f32_ops": f32, "f64_ops": f64,
            "peak_s": f32 / PEAKS["f32_flops_per_s"] + f64 / PEAKS["f64_flops_per_s"],
            "bound_s": sum(s.bound_s() for s in stages)}


# --- the offline chain --------------------------------------------------------

# the true-peak interpolator: 4 phases of 32 taps, multiply-adds a sample
TP_MACS = 4 * 32


def chain_stages(config: dict, n: int) -> list:
    """The stages of one 20 ms analysis block of ``n`` candidate streams of
    the offline chain under ``config`` (a configuration file's dict with the
    flat ``settings`` of ``simulate_auto_eq_chain`` and its ``bands``), each
    with its launches, bytes and operations: the de-esser, the EQ's active
    sections (a band at 0 dB is dropped), the compressor with its loudness
    meter's K-weighting (2 sections), the lookahead limiter's window maximum
    and gain scan, the true-peak limiter's gain scan and its input and output
    interpolators, the output detector's, and the block's four reductions
    (input and output sample peaks, the compressor's and the meter's block
    power)."""
    s, fs = config["settings"], float(config["sample_rate"])
    T = round(fs * 0.020)
    nT = n * T

    def cascade(sections: int) -> Stage:
        # per section and sample 9 f64 operations; coefficients and f64 state
        return Stage(f"biquad_cascade x {sections}", 1, 8 * nT + n * sections * (40 + 64 + 8),
                     0.0, T * 9 * n * sections)

    stages = [Stage("block reductions", 4, 4 * nT + 4 * n, 2 * nT),
              Stage("true-peak 4x32 FIR", 1, 4 * n * (31 + T) + 4 * nT,
                    nT * (2 * TP_MACS + 9))]
    if s.get("deesser_enabled", False):
        stages.append(Stage("deesser_scan", 1, 8 * nT + n * 4 * 2 * 33, 270 * nT))
    sections = sum(g != 0 for _, g, _ in config["bands"])
    if sections:
        stages.append(cascade(sections))
    if s.get("compressor_enabled", True):
        stages += [cascade(2), Stage("compressor_scan", 1, 8 * nT + n * 4 * 2 * 20, 70 * nT)]
    if s.get("limiter_enabled", True):
        w = round(s.get("limiter_lookahead_ms", 2.0) * fs / 1000.0)
        stages += [Stage("limiter window max", 1, 4 * n * (w + T) + 4 * nT, 3 * nT),
                   Stage("limiter_gain_scan", 2, 12 * nT + n * 4 * 6, 16 * nT),
                   Stage("true-peak 4x32 FIR", 2, 4 * n * (31 + T) + 4 * nT,
                         nT * (2 * TP_MACS + 9))]
    return stages


def chain_totals(config: dict, n: int) -> dict:
    """One analysis block of ``n`` streams of the offline chain: as
    :func:`step_totals`."""
    stages = chain_stages(config, n)
    f32 = sum(s.launches * s.f32_ops for s in stages)
    f64 = sum(s.launches * s.f64_ops for s in stages)
    return {"f32_ops": f32, "f64_ops": f64,
            "peak_s": f32 / PEAKS["f32_flops_per_s"] + f64 / PEAKS["f64_flops_per_s"],
            "bound_s": sum(s.bound_s() for s in stages)}
