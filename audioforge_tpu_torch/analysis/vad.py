"""Offline VAD posteriors for the calibration tools.

Counterpart of ``audioforge_tpu/analysis/vad.py``: Silero posteriors of a
take, or an explicit ``"energy_fallback"`` label so that a diagnostic never
claims a neural posterior that was not computed. The thresholds are the
reference's (0.48 / 0.40 / 0.65 / 0.35).

The label stands for what the take or the weights cause: an empty take, a
rate other than 16 or 48 kHz, a ``ValueError``/``TypeError`` from validating
the weights, a result with no finite posterior. A failure to build or launch
a kernel, or any other device error, propagates: on the card it is a fault,
not an input the model cannot take.
"""

from __future__ import annotations

import numpy as np

from .. import kernels
from ..models import silero

__all__ = [
    "CALIBRATED_VAD_DEFAULT_THRESHOLD", "VAD_NOISE_CONTAMINATION_THRESHOLD",
    "VAD_SPEECH_EVIDENCE_THRESHOLD", "VAD_STRONG_SPEECH_THRESHOLD",
    "analyze_offline_vad",
]

CALIBRATED_VAD_DEFAULT_THRESHOLD = 0.48
VAD_SPEECH_EVIDENCE_THRESHOLD = 0.40
VAD_STRONG_SPEECH_THRESHOLD = 0.65
VAD_NOISE_CONTAMINATION_THRESHOLD = 0.35


def analyze_offline_vad(audio, sample_rate, *, threshold=CALIBRATED_VAD_DEFAULT_THRESHOLD,
                        device="cuda"):
    """Return ``(posteriors or None, backend_label)``; the model runs on
    ``device`` (a CUDA device unless asked otherwise)."""
    samples = np.ascontiguousarray(np.asarray(audio, np.float32).reshape(-1))
    if samples.size == 0 or sample_rate <= 0:
        return None, "energy_fallback"
    if int(sample_rate) not in (16000, 48000):
        return None, "energy_fallback"
    dev = kernels.resolve_device(device, "analyze_offline_vad")
    try:
        params = silero.default_params()
        threshold = float(threshold)
    except (ValueError, TypeError):
        return None, "energy_fallback"
    raw = silero.analyze_vad_probabilities(samples, int(sample_rate), threshold, params,
                                           device=dev)
    probs = np.asarray(raw, float).reshape(-1)
    if probs.size == 0 or not np.isfinite(probs).all():
        return None, "energy_fallback"
    return np.clip(probs, 0.0, 1.0), "silero"
