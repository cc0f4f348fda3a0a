"""Windowed-sinc resampling: the offline product resampler and the 3:1
decimator (48 kHz -> 16 kHz) that feeds the VAD.

Counterpart of ``audioforge_tpu/ops/resample.py``: the unit-DC-gain
windowed-sinc design (:func:`windowed_sinc`, numpy, f64); :func:`resample`,
the product resampler (sinc_len 128, Blackman, cubic interpolation between
256x-oversampled filter phases, the cutoff searched from the window's
stopband floor); :func:`simulate_product_resampler` with the reference's
contract; and :func:`decimate3`, a 31-tap low-pass at a third of the band
applied at stride 3 over the 30-sample history plus the block; and
:class:`StreamingResampler`, the live ingest path's chunked resampler (host
numpy, a copy of the reference's, behaviour unchanged).

:func:`resample` gathers each output's ``sinc_len`` input window and
reduces it against its Catmull-Rom-interpolated filter row, as the
reference does, over chunks of output positions: a 60 s take at 48 kHz with
sinc_len 256 would otherwise hold 2.9 GB of windows. Chunking changes the
memory, not the result.

On the serving path the decimation runs inside the ``vad_front`` kernel
(:func:`audioforge_tpu_torch.models.silero.vad_front`); :func:`decimate3` is
its plain form and the reference of its twin.
"""

from __future__ import annotations

import time
from functools import cache, lru_cache

import numpy as np
import torch



VAD_DECIMATE_TAPS = 31
PRODUCT_SINC_LEN = 128
PRODUCT_WINDOW_NAME = "blackman"
RESAMPLER_CHUNK_SIZE = 1024
OVERSAMPLING = 256
# output positions :func:`resample` gathers at a time
RESAMPLE_CHUNK_OUTPUTS = 16384

WINDOWS = ("blackman", "blackman_squared", "blackman_harris",
           "blackman_harris_squared", "hann", "hann_squared")


def _window(name: str, n: np.ndarray, length: int) -> np.ndarray:
    x = 2.0 * np.pi * n / length
    base = name.removesuffix("_squared")
    if base == "blackman":
        w = 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)
    elif base == "blackman_harris":
        w = (0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x)
             - 0.01168 * np.cos(3 * x))
    elif base == "hann":
        w = 0.5 - 0.5 * np.cos(x)
    else:
        raise ValueError(f"unsupported resampler window {name!r}")
    if name not in WINDOWS:
        raise ValueError(f"unsupported resampler window {name!r}")
    return w * w if name.endswith("_squared") else w


def windowed_sinc(taps: int, cutoff: float, window: str = "blackman") -> np.ndarray:
    """Unit-DC-gain windowed-sinc low-pass; ``cutoff`` is relative to
    Nyquist."""
    n = np.arange(taps, dtype=np.float64)
    off = n - (taps - 1) / 2.0
    fc = cutoff / 2.0  # cycles per sample
    sinc = np.where(
        np.abs(off) < 1e-12,
        2.0 * fc,
        np.sin(2.0 * np.pi * fc * off) / (np.pi * np.where(off == 0, 1.0, off)),
    )
    taps_arr = sinc * _window(window, n, taps)
    return taps_arr / taps_arr.sum()


@lru_cache(maxsize=8)
def _auto_cutoff(sinc_len: int, window: str) -> float:
    """Largest cutoff whose worst response over the folded band [Nyquist,
    2 fs] of the continuous (oversampled) prototype stays under the
    window's far-stopband sidelobe floor (bisection, 30 steps)."""
    O = 32  # prototype oversampling for the response probes
    n_fft = sinc_len * O * 8

    def dense_response(cutoff):
        dense = windowed_sinc(sinc_len * O, cutoff / O, window) * O
        return np.abs(np.fft.rfft(dense, n_fft)) / O

    def band_max_db(H, lo_cyc, hi_cyc):
        lo = int(np.ceil(lo_cyc / O * n_fft))
        hi = int(np.floor(hi_cyc / O * n_fft))
        return 20.0 * np.log10(max(float(H[lo:hi].max()), 1e-15))

    floor_db = band_max_db(dense_response(0.25), 0.125 + 6.0 / sinc_len, 2.0)
    target_db = min(floor_db, -60.0)
    lo, hi = 0.2, 1.0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        if band_max_db(dense_response(mid), 0.5, 2.0) <= target_db:
            lo = mid
        else:
            hi = mid
    return lo


@lru_cache(maxsize=16)
def _phase_table(sinc_len: int, window: str, cutoff: float | None = None):
    """``(OVERSAMPLING + 3, sinc_len)`` f32 filter phases ``p = -1 .. O + 1``
    (row ``p + 1``) of the dense prototype, and the cutoff used."""
    L, O = sinc_len, OVERSAMPLING
    c = _auto_cutoff(L, window) if cutoff is None else cutoff
    dense = windowed_sinc(L * O, c / O, window) * O
    densep = np.concatenate([[0.0, 0.0], dense, [0.0, 0.0]])
    k = np.arange(L)
    table = np.stack([densep[(L - 1 - k) * O + p + 2] for p in range(-1, O + 2)])
    return table.astype(np.float32), c


def product_resampler_configuration():
    """``(sinc_len, window, interpolation, oversampling, chunk)``."""
    return (PRODUCT_SINC_LEN, PRODUCT_WINDOW_NAME, "cubic", OVERSAMPLING,
            RESAMPLER_CHUNK_SIZE)


def decimate3_taps() -> np.ndarray:
    """The decimator's 31 taps, flipped (tap ``t`` multiplies history sample
    ``3 o + t`` for output ``o``), f32."""
    return np.flip(windowed_sinc(VAD_DECIMATE_TAPS, 1.0 / 3.0, "blackman")).astype(
        np.float32)


# cached without bound: a captured CUDA graph reads the tensor by address
@cache
def _taps(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(decimate3_taps().copy(), device=device)


def decimate3_init(*, n: int, device) -> dict:
    return {"hist": torch.zeros((n, VAD_DECIMATE_TAPS - 1), dtype=torch.float32,
                                device=device)}


def decimate3(state: dict, x: torch.Tensor):
    """Decimate ``x [N, T]`` (T a multiple of 3) by 3. Returns
    ``(new_state, y [N, T // 3])``."""
    ext = torch.cat([state["hist"], x], dim=-1)
    windows = ext.unfold(-1, VAD_DECIMATE_TAPS, 3)  # [N, T // 3, 31]
    y = torch.matmul(windows, _taps(x.device))
    return {"hist": ext[..., -(VAD_DECIMATE_TAPS - 1):]}, y


class StreamingResampler:
    """Chunked arbitrary-rate resampler for the live ingest path.

    Host-side numpy counterpart of the reference's streaming input
    resampler (`processor/resampling.rs:125-168`, rubato): the same
    windowed-sinc phase table and cubic phase interpolation as
    :func:`resample`, with carried input history so chunks concatenate to
    the exact offline result (measured 8e-8 RMS, chunk-size invariant).
    The stream is zero-offset time-aligned; ``delay_frames``
    (= sinc_len/2 * ratio) is the wall-clock latency before an output
    frame's full window has arrived, and the first ``delay_frames`` outputs
    lean on the pre-charged zero history — the same startup contract the
    product resampler reports (`resampling.rs:170-260`).
    """

    def __init__(self, in_rate: float, out_rate: float,
                 sinc_len: int = PRODUCT_SINC_LEN,
                 window: str = PRODUCT_WINDOW_NAME):
        if in_rate <= 0 or out_rate <= 0:
            raise ValueError("sample rates must be positive")
        ratio = out_rate / in_rate
        base_cutoff = _auto_cutoff(sinc_len, window)
        eff_cutoff = round(base_cutoff * min(1.0, ratio), 9)
        table, _ = _phase_table(sinc_len, window, eff_cutoff)
        self._table = np.asarray(table, np.float32)
        self._sinc_len = int(sinc_len)
        self._half = sinc_len // 2
        self._step = in_rate / out_rate
        self.delay_frames = int(round(self._half * ratio))
        # buffer holds input samples from absolute index _buf_start onward;
        # pre-charged with the left half-window of zeros
        self._buf = np.zeros(self._half, np.float32)
        self._buf_start = -self._half
        self._next_pos = 0.0

    def process(self, samples) -> np.ndarray:
        """Feed input samples; returns every output frame whose window is
        complete."""
        chunk = np.asarray(samples, np.float32).ravel()
        if chunk.size:
            self._buf = np.concatenate([self._buf, chunk])
        end = self._buf_start + self._buf.size  # one past last input index
        # output at pos needs inputs base-half+1 .. base+half (base=floor(pos))
        limit = end - self._half  # require base < limit
        n_out = int(np.floor((limit - 1 - self._next_pos) / self._step)) + 1
        if n_out <= 0:
            return np.zeros(0, np.float32)

        pos = self._next_pos + np.arange(n_out, dtype=np.float64) * self._step
        base = np.floor(pos).astype(np.int64)
        frac = (pos - base).astype(np.float32)
        rel = base - self._buf_start  # index of base within the buffer
        win_idx = rel[:, None] + np.arange(-self._half + 1, self._half + 1)
        windows = self._buf[win_idx]  # [n_out, sinc_len] oldest-first

        p = frac * OVERSAMPLING
        # f32 rounding of frac can land exactly on 1.0 -> clamp the phase
        p0 = np.minimum(np.floor(p).astype(np.int64), OVERSAMPLING - 1)
        t = (p - p0).astype(np.float32)[:, None]
        f_m1 = self._table[p0]
        f_0 = self._table[p0 + 1]
        f_1 = self._table[p0 + 2]
        f_2 = self._table[p0 + 3]
        a = -0.5 * f_m1 + 1.5 * f_0 - 1.5 * f_1 + 0.5 * f_2
        b = f_m1 - 2.5 * f_0 + 2.0 * f_1 - 0.5 * f_2
        c = 0.5 * (f_1 - f_m1)
        filt = ((a * t + b) * t + c) * t + f_0
        # table rows index taps newest-first relative to the window layout
        # used by resample(); windows here are oldest-first covering
        # base-half+1..base+half, same as xp[base+1+k] there
        y = np.einsum("ot,ot->o", windows, filt).astype(np.float32)

        self._next_pos = float(pos[-1] + self._step)
        keep_from = int(np.floor(self._next_pos)) - self._half + 1 - self._buf_start
        if keep_from > 0:
            self._buf = self._buf[keep_from:]
            self._buf_start += keep_from
        return y
