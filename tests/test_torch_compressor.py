"""Port parity: the compressor (per-sample scan + block-cadence auto makeup)
against the JAX reference, for the serving default flags and for adaptive
release + auto makeup with speech evidence.

On CPU the port runs ``compressor_scan_plain``, the plain twin of the
``compressor_scan`` CUDA kernel. Tolerances: audio RMS <= 1e-4 and max abs
<= 1e-3, dB metrics <= 1e-2 dB.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioforge_tpu.ops import compressor as jcomp
from audioforge_tpu_torch.ops import compressor as tcomp

N, T, FS = 3, 480, 48000.0
N_BLOCKS = 6

FLAG_SETS = {
    "default": dict(sidechain_highpass_enabled=True),
    "adaptive_automakeup_evidence": dict(
        sidechain_highpass_enabled=True, adaptive_release=True,
        auto_makeup_enabled=True),
}


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _speech_like(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N_BLOCKS * T) / FS
    env = (np.sin(2 * np.pi * 4.0 * t) > -0.2).astype(np.float64)
    voiced = sum(np.sin(2 * np.pi * 140.0 * h * t) / h for h in range(1, 6))
    x = (0.3 * env * voiced)[None] * rng.uniform(0.3, 1.5, (N, 1))
    x = x + 0.01 * rng.standard_normal((N, t.size))
    x[:, 2 * T: 2 * T + 60] += 0.6  # a plosive-like low thump
    return x.astype(np.float32)


@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
def test_compressor_matches_reference(flags):
    kw = FLAG_SETS[flags]
    cfg_j = jcomp.CompressorConfig(**kw)
    cfg_t = tcomp.CompressorConfig(**kw)
    pkw = dict(threshold_db=-30.0, ratio=4.0, makeup_gain_db=2.0)
    pj = jcomp.compressor_params(cfg_j, **pkw)
    pt = {k: torch.full((N,), float(np.float32(v)))
          for k, v in tcomp.compressor_params(cfg_t, **pkw).items()}
    sj = jcomp.compressor_init(cfg_j, batch_shape=(N,))
    st = tcomp.compressor_init(cfg_t, n=N, device="cpu")
    rng = np.random.default_rng(7)
    x = _speech_like(8)
    for b in range(N_BLOCKS):
        xb = x[:, b * T:(b + 1) * T]
        fb = rng.uniform(0.0, 3.0, N).astype(np.float32)
        if flags == "default":
            ev_j = ev_t = None
        else:
            ev = {"vad_probability": rng.random(N), "vad_reliability": np.full(N, 0.8),
                  "noise_floor_db": np.full(N, -60.0),
                  "live_noise_reliability": rng.random(N)}
            ev = {k: v.astype(np.float32) for k, v in ev.items()}
            ev_j = {k: jnp.asarray(v) for k, v in ev.items()}
            ev_t = {k: torch.as_tensor(v) for k, v in ev.items()}
        sj, yj, mj = jcomp.compressor_process(cfg_j, pj, sj, jnp.asarray(xb),
                                              evidence=ev_j,
                                              limiter_feedback_db=jnp.asarray(fb))
        st, yt, mt = tcomp.compressor_process(cfg_t, pt, st, torch.as_tensor(xb),
                                              evidence=ev_t,
                                              limiter_feedback_db=torch.as_tensor(fb))
        _assert_audio(yt.numpy(), yj)
        for k in ("gain_reduction_db", "makeup_gain_db", "lufs"):
            np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), atol=1e-2)
        np.testing.assert_allclose(mt["activity"].numpy(), np.asarray(mj["activity"]),
                                   atol=1e-4)
    assert float(np.max(np.asarray(mj["gain_reduction_db"]))) > 0.5
    for k in tcomp.SCAN_STATE_KEYS:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(st["meter"]["filled"].numpy(),
                                  np.asarray(sj["meter"]["filled"]))
