"""The streaming 3:1 decimator (48 kHz -> 16 kHz) that feeds the VAD.

Counterpart of the VAD part of ``audioforge_tpu/ops/resample.py``: the
unit-DC-gain windowed-sinc design (:func:`windowed_sinc`, numpy, f64) and
:func:`decimate3`, a 31-tap low-pass at a third of the band applied at stride
3 over the 30-sample history plus the block. The arbitrary-rate resamplers
of that module are not ported yet (ROADMAP queue 1, offline chain and the
single-stream engine).

On the serving path the decimation runs inside the ``vad_front`` kernel
(:func:`audioforge_tpu_torch.models.silero.vad_front`); :func:`decimate3` is
its plain form and the reference of its twin.
"""

from __future__ import annotations

from functools import cache

import numpy as np
import torch

__all__ = ["VAD_DECIMATE_TAPS", "windowed_sinc", "decimate3_taps",
           "decimate3_init", "decimate3"]

VAD_DECIMATE_TAPS = 31


def _window(name: str, n: np.ndarray, length: int) -> np.ndarray:
    x = 2.0 * np.pi * n / length
    if name == "blackman":
        return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)
    if name == "hann":
        return 0.5 - 0.5 * np.cos(x)
    raise ValueError(f"unknown window {name!r}")


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
