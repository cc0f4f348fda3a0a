"""Port parity: the RNNoise frame (features, pitch tracker, GRUs, comb
filter, silence bypass) against the JAX reference, with the weights in
``models/rnnoise.npz`` loaded into both packages through ``convert``.

The input has an unambiguous pitch (a 150 Hz harmonic tone plus -40 dB
noise) so the pitch search cannot flip on a last-bit tie; stream 1's second
frame is silent to exercise the bypass that freezes the recurrent state.
Tolerances: gains, VAD and GRU states <= 1e-3 abs (the conversion
contract, rnnoise.py:41-44), output audio RMS <= 1e-4 / max <= 1e-3 of full
scale, pitch period exact.
"""

import numpy as np
import torch

import jax.numpy as jnp

from audioforge_tpu.models import rnnoise as jrn
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.models import rnnoise as trn

N, F = 2, 480


def _frames(n_frames=3):
    rng = np.random.default_rng(50)
    t = np.arange(n_frames * F) / 48000.0
    tone = sum(np.sin(2 * np.pi * 150.0 * h * t + h) / h for h in range(1, 8))
    x = 0.3 * tone[None] * np.array([[1.0], [0.6]])
    x = x + 0.01 * 0.3 * rng.standard_normal((N, t.size))
    x[1, :F] = 0.0  # stream 1 starts with a silent frame
    return (x * jrn.PCM_SCALE).astype(np.float32)


def test_rnnoise_frames_match_reference():
    path = jrn.discover_model_path()
    assert path is not None, "models/rnnoise.npz is part of the repository"
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    pj = jrn.load_weights(path)
    pt = convert.rnnoise_weights(arrays)
    sj = jrn.rnnoise_state_init((N,))
    st = trn.rnnoise_state_init(n=N, device="cpu")
    x = _frames()
    for f in range(3):
        xf = x[:, f * F:(f + 1) * F]
        sj, yj, aj = jrn.rnnoise_frame(pj, sj, jnp.asarray(xf))
        st, yt, at = trn.rnnoise_frame(pt, st, torch.as_tensor(xf))
        np.testing.assert_array_equal(st["last_period"].numpy(),
                                      np.asarray(sj["last_period"]))
        err = (yt.numpy().astype(np.float64) - np.asarray(yj)) / jrn.PCM_SCALE
        assert np.sqrt(np.mean(err ** 2)) <= 1e-4
        assert np.abs(err).max() <= 1e-3
        np.testing.assert_allclose(at["gains"].numpy(), np.asarray(aj["gains"]), atol=1e-3)
        np.testing.assert_allclose(at["vad"].numpy(), np.asarray(aj["vad"]), atol=1e-3)
        for k in ("vad_gru", "noise_gru", "denoise_gru", "lastg"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), atol=1e-3,
                                       err_msg=k)
        np.testing.assert_allclose(st["last_gain"].numpy(), np.asarray(sj["last_gain"]),
                                   atol=1e-3)
        if f == 0:  # stream 1's silent frame: bypassed, state frozen
            assert float(at["vad"][1]) == 0.0
            assert not st["vad_gru"][1].any()
    assert 0 < int(st["last_period"][0]) < trn.PITCH_MAX_PERIOD


def test_silent_frame_bypasses_the_network():
    path = jrn.discover_model_path()
    pt = trn.load_weights(path)
    st = trn.rnnoise_state_init(n=N, device="cpu")
    st["vad_gru"] = torch.full((N, 24), 0.25)
    new, _, aux = trn.rnnoise_frame(pt, st, torch.zeros((N, F)))
    np.testing.assert_array_equal(new["vad_gru"].numpy(), st["vad_gru"].numpy())
    np.testing.assert_array_equal(aux["vad"].numpy(), np.zeros(N, np.float32))
