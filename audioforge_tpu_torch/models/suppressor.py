"""The noise suppressor behind one interface, and its runtime-swappable engine.

Counterpart of ``audioforge_tpu/models/suppressor.py`` (the reference's
``noise_suppressor.rs``):

- one interface over RNNoise and DeepFilterNet3 (LL and standard): push,
  process, pop, strength, soft reset, pending samples, latency;
- model ids ``rnnoise`` / ``deepfilter-ll`` / ``deepfilter`` with 10 / 10 /
  30 ms latency labels;
- DeepFilterNet3 only with the ``AUDIOFORGE_ENABLE_DEEPFILTER=1`` opt-in, and
  only with trained or converted weights: without either the engine reports
  ``backend_available=False`` and passes the audio through at the model's
  latency.

An engine is a dict plus these functions, so swapping a model is building a
new engine off the hot path and exchanging it between blocks. The engine
runs its model on ``device`` (a CUDA device unless asked otherwise); each
model's processor keeps its frame graph in its state.
"""

from __future__ import annotations

import os

import numpy as np

from .. import kernels
from . import dfn3, rnnoise

__all__ = [
    "NOISE_MODELS",
    "model_latency_ms",
    "deepfilter_enabled",
    "engine_init",
    "engine_push",
    "engine_process",
    "engine_prepare",
    "engine_pop",
    "engine_soft_reset",
    "engine_set_strength",
    "engine_diagnostics",
]

NOISE_MODELS = ("rnnoise", "deepfilter-ll", "deepfilter")
_LATENCY_MS = {"rnnoise": 10.0, "deepfilter-ll": 10.0, "deepfilter": 30.0}


def model_latency_ms(model: str) -> float:
    if model not in NOISE_MODELS:
        raise ValueError(f"unknown noise model {model!r}")
    return _LATENCY_MS[model]


def deepfilter_enabled() -> bool:
    """The DeepFilterNet3 opt-in (``AUDIOFORGE_ENABLE_DEEPFILTER=1``)."""
    return os.environ.get("AUDIOFORGE_ENABLE_DEEPFILTER", "") == "1"


def engine_init(model: str = "rnnoise", strength: float = 1.0,
                rnnoise_params=None, dfn_params=None, *, device="cuda"):
    """An engine for ``model``. DeepFilterNet3 needs the opt-in and trained
    or converted weights (seeded structural weights are refused unless
    ``dfn_params`` are given); without them the engine passes the audio
    through at the model's latency and reports why in ``error``."""
    if model not in NOISE_MODELS:
        raise ValueError(f"unknown noise model {model!r}")
    dev = kernels.resolve_device(device, "engine_init")
    available = True
    error = None
    if model.startswith("deepfilter") and not deepfilter_enabled():
        available = False
        error = "DeepFilter runtime not enabled (set AUDIOFORGE_ENABLE_DEEPFILTER=1)"
    elif model.startswith("deepfilter") and dfn_params is None and \
            dfn3.weights_source(model == "deepfilter-ll") == "seeded":
        available = False
        error = (f"no trained or converted weights for {model!r} "
                 "(seeded structural weights refused; supply "
                 "models/dfn3_ll.npz / dfn3.npz or DEEPFILTER_MODEL_PATH)")
    if model == "rnnoise":
        proc = rnnoise.processor_init(rnnoise_params, strength, device=dev)
        latency = rnnoise.LATENCY_SAMPLES
    else:
        low_latency = model == "deepfilter-ll"
        proc = dfn3.processor_init(dfn_params, strength, low_latency=low_latency,
                                   device=dev)
        latency = dfn3.latency_samples(low_latency)
    return {
        "model": model,
        "proc": proc,
        "latency_samples": latency,
        "backend_available": available,
        "error": error,
        # the passthrough's delay line while the backend is unavailable
        "pt_delay": np.zeros(latency, np.float32),
        "pt_buf": np.zeros(0, np.float32),
    }


def _passthrough_push(engine, samples):
    stream = np.concatenate([engine["pt_delay"], np.asarray(samples, np.float32)])
    lat = engine["latency_samples"]
    out, engine["pt_delay"] = stream[:-lat] if lat else stream, stream[-lat:]
    engine["pt_buf"] = np.concatenate([engine["pt_buf"], out])


def _module(engine):
    return rnnoise if engine["model"] == "rnnoise" else dfn3


def engine_push(engine, samples):
    engine = dict(engine)
    if not engine["backend_available"]:
        _passthrough_push(engine, samples)
        return engine, len(np.asarray(samples))
    engine["proc"], n = _module(engine).processor_push(engine["proc"], samples)
    return engine, n


def engine_prepare(engine):
    """Build the model's frame step now and, on the card, capture it (see
    the processors' ``processor_prepare``); no frame is processed."""
    engine = dict(engine)
    if engine["backend_available"]:
        engine["proc"] = _module(engine).processor_prepare(engine["proc"])
    return engine


def engine_process(engine):
    engine = dict(engine)
    if not engine["backend_available"]:
        return engine, 0
    engine["proc"], n = _module(engine).processor_process(engine["proc"])
    return engine, n


def engine_pop(engine, count):
    engine = dict(engine)
    if not engine["backend_available"]:
        n = min(count, len(engine["pt_buf"]))
        out = engine["pt_buf"][:n]
        engine["pt_buf"] = engine["pt_buf"][n:]
        return engine, out
    engine["proc"], out = _module(engine).processor_pop(engine["proc"], count)
    return engine, out


def engine_soft_reset(engine):
    engine = dict(engine)
    engine["proc"] = _module(engine).processor_soft_reset(engine["proc"])
    engine["pt_delay"] = np.zeros(engine["latency_samples"], np.float32)
    engine["pt_buf"] = np.zeros(0, np.float32)
    return engine


def engine_set_strength(engine, value: float):
    engine = dict(engine)
    proc = dict(engine["proc"])
    proc["strength"] = float(np.clip(value, 0.0, 1.0))
    engine["proc"] = proc
    return engine


def engine_diagnostics(engine):
    """The backend's availability, failure, error, latency, pending samples
    and ``weights_source`` (converted / trained / seeded)."""
    failed = bool(engine["proc"].get("backend_failed", False))
    source = (rnnoise.weights_source() if engine["model"] == "rnnoise"
              else dfn3.weights_source(engine["model"] == "deepfilter-ll"))
    return {
        "model": engine["model"],
        "backend_available": engine["backend_available"],
        "backend_failed": failed,
        "error": engine["error"],
        "latency_samples": engine["latency_samples"],
        "latency_ms": model_latency_ms(engine["model"]),
        "pending_samples": int(len(engine["proc"].get("in_buf", []))),
        "weights_source": source,
    }
