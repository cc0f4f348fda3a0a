"""Port parity: the de-esser (auto and manual gain computers) against the JAX
reference.

On CPU the port runs ``deesser_scan_plain``, the plain twin of the
``deesser_scan`` CUDA kernel: the detector biquads, the envelope step and
the dynamic peaking bands sample by sample in f32, where the reference runs
the biquads as f32 associative scans. The input carries sibilant bursts
(0.25 amplitude at 6.8 kHz) over a 0.05 voice body so the detector engages.
Tolerances: audio RMS <= 1e-4 and max abs <= 1e-3, dB metrics <= 1e-2 dB,
other state 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioforge_tpu.ops import deesser as jdes
from audioforge_tpu_torch.ops import deesser as tdes

N, T, FS = 3, 480, 48000.0
N_BLOCKS = 4


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _sibilant(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N_BLOCKS * T) / FS
    body = 0.05 * np.sin(2 * np.pi * rng.uniform(120.0, 220.0, (N, 1)) * t)
    gate = np.sin(2 * np.pi * rng.uniform(3.0, 6.0, (N, 1)) * t) > 0.3
    sib = 0.25 * np.sin(2 * np.pi * 6800.0 * t) * gate
    x = body + sib + 0.002 * rng.standard_normal((N, t.size))
    x[2] = body[2]  # one stream without sibilance
    return x.astype(np.float32)


@pytest.mark.parametrize("auto", [True, False], ids=["auto", "manual"])
def test_deesser_matches_reference(auto):
    kw = dict(enabled=True, auto_enabled=auto, threshold_db=-40.0)
    cfg_j = jdes.DeEsserConfig(**kw)
    cfg_t = tdes.DeEsserConfig(**kw)
    sj = jdes.deesser_init(cfg_j, (N,))
    st = tdes.deesser_init(cfg_t, n=N, device="cpu")
    x = _sibilant(70 + auto)
    for b in range(N_BLOCKS):
        xb = x[:, b * T:(b + 1) * T]
        sj, yj, mj = jdes.deesser_process(cfg_j, sj, jnp.asarray(xb))
        st, yt, mt = tdes.deesser_process(cfg_t, st, torch.as_tensor(xb))
        _assert_audio(yt.numpy(), yj)
        for k in ("reduction_db", "band_reduction_db"):
            np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), atol=1e-2,
                                       err_msg=k)
        np.testing.assert_allclose(mt["confidence"].numpy(),
                                   np.asarray(mj["confidence"]), atol=1e-3)
    for k, r in sj.items():
        np.testing.assert_allclose(st[k].numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    red = np.asarray(mj["reduction_db"])
    assert red[:2].min() > 1.0 and red[2] < red[:2].min()  # sibilance engaged it


def test_disabled_deesser_passes_audio_through():
    cfg = tdes.DeEsserConfig()
    st = tdes.deesser_init(cfg, n=N, device="cpu")
    x = torch.as_tensor(_sibilant(72)[:, :T])
    new, y, m = tdes.deesser_process(cfg, st, x)
    assert y is x and not m["reduction_db"].any()
