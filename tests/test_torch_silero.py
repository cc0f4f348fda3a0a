"""Port parity: the in-step Silero VAD against the JAX reference.

``decimate3`` (48 kHz -> 16 kHz, 31 taps at stride 3 over the carried
history), ``silero_infer`` with the trained archive ``models/silero_vad.npz``
over chained calls, ``calibrate_probability`` and the serving step's
``_vad_step`` (the ``vad_front`` and ``vad_lstm_head`` kernels' plain twins
with the GEMMs between them) over blocks of a harmonic tone with pauses and
of noise at two levels, the same seeded inputs through both packages. Tolerances: the decimated signal
1e-6 (f32 FIR of unit gain); probabilities and the LSTM state 1e-3 (the
conversion contract of the model ports); ``available`` exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioforge_tpu.models import silero as jsil
from audioforge_tpu.ops import resample as jres
from audioforge_tpu.runtime import serving as jsv
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.models import silero as tsil
from audioforge_tpu_torch.ops import resample as tres
from audioforge_tpu_torch.runtime import serving as tsv

N, T = 3, 480


def _voice(n_blocks: int, seed: int, rate: float = 48000.0) -> np.ndarray:
    """``[N, n_blocks * 480]`` at ``rate``: stream 0 bursts of a harmonic
    tone (harmonics 3-6 of 200 Hz) over noise, stream 1 noise at -30 dBFS,
    stream 2 noise at -50 dBFS (the archive's posterior is near 1 on the
    first two and near 0 on the third)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / rate
    tone = sum(np.sin(2 * np.pi * 200.0 * h * t + h) for h in range(3, 7))
    x = np.stack([0.2 * tone * (np.sin(2 * np.pi * 2.5 * t) > -0.2),
                  0.03 * rng.standard_normal(t.size),
                  0.003 * rng.standard_normal(t.size)])
    x[0] += 0.003 * rng.standard_normal(t.size)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    path = jsil.discover_model_path()
    assert path is not None, "models/silero_vad.npz is part of the repository"
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return jsil.load_weights(path), convert.silero_weights(arrays)


def test_decimate3_matches_reference():
    x = _voice(6, seed=1)
    sj = jres.decimate3_init((N,))
    st = tres.decimate3_init(n=N, device="cpu")
    for b in range(6):
        xb = x[:, b * T:(b + 1) * T]
        sj, yj = jres.decimate3(sj, jnp.asarray(xb))
        st, yt = tres.decimate3(st, torch.as_tensor(xb))
        assert yt.shape == (N, T // 3)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)
        np.testing.assert_allclose(st["hist"].numpy(), np.asarray(sj["hist"]), atol=1e-6)


def test_silero_infer_matches_reference_over_chained_calls(weights):
    pj, pt = weights
    rng = np.random.default_rng(2)
    audio = _voice(8, seed=3, rate=16000.0)  # 8 windows of 320 new samples
    state_j = jnp.zeros((2, N, 128), jnp.float32)
    state_t = torch.zeros((2, N, 128))
    probs = []
    for k in range(8):
        win = audio[:, k * 320: k * 320 + tsil.MODEL_INPUT_SIZE]
        win = np.pad(win, ((0, 0), (0, tsil.MODEL_INPUT_SIZE - win.shape[1])))
        win = win + 1e-4 * rng.standard_normal(win.shape).astype(np.float32)
        prob_j, state_j = jsil.silero_infer(pj, jnp.asarray(win), state_j)
        prob_t, state_t = tsil.silero_infer(pt, torch.as_tensor(win), state_t)
        np.testing.assert_allclose(prob_t.numpy(), np.asarray(prob_j), atol=1e-3)
        np.testing.assert_allclose(state_t.numpy(), np.asarray(state_j), atol=1e-3)
        probs.append(np.asarray(prob_j))
    probs = np.stack(probs)
    assert probs[2:, 0].min() > 0.5 > probs[2:, 2].max()  # voice and noise apart


def test_calibrate_probability_matches_reference():
    p = np.array([0.0, 1.0, np.nan, 0.5, 0.02, 0.37, 0.93, 1e-7, np.inf],
                 np.float32)
    got = tsil.calibrate_probability(torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsil.calibrate_probability(p)),
                               atol=1e-6)
    assert got[2] == 0.0 and got[8] == 0.0


def test_vad_step_matches_reference(weights):
    pj, pt = weights
    spj = {"weights": pj, "pre_gain": np.float32(1.0), "smoothing": np.float32(0.5)}
    spt = {"weights": pt, "pre_gain": torch.tensor(1.0), "smoothing": torch.tensor(0.5)}
    cfg = jsv.ServingConfig(capacity=N, vad_enabled=True)
    sj = jsv._vad_state_init(cfg)
    st = tsv._vad_state_init(tsv.ServingConfig(capacity=N, vad_enabled=True), "cpu")
    x = _voice(10, seed=4)
    seen = []
    for b in range(10):
        xb = x[:, b * T:(b + 1) * T]
        sj, pj_b, aj = jsv._vad_step(spj, sj, jnp.asarray(xb))
        st, pt_b, at = tsv._vad_step(spt, st, torch.as_tensor(xb))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        assert bool(at.all()) == (b >= tsv._VAD_WARMUP_BLOCKS - 1)
        np.testing.assert_allclose(pt_b.numpy(), np.asarray(pj_b), atol=1e-3)
        ref = convert._tree_to_numpy(st)
        for k in ("window16", "lstm", "smoothed"):
            np.testing.assert_allclose(ref[k], np.asarray(sj[k]), atol=1e-3, err_msg=k)
        np.testing.assert_allclose(ref["dec3"]["hist"], np.asarray(sj["dec3"]["hist"]),
                                   atol=1e-6)
        np.testing.assert_array_equal(ref["blocks_seen"], np.asarray(sj["blocks_seen"]))
        seen.append(pt_b.numpy())
    warm = np.stack(seen[tsv._VAD_WARMUP_BLOCKS:])
    assert warm[:, :2].min() > 0.5 > warm[:, 2].max()  # voice and noise apart


def test_init_params_equal_reference_seeded_weights():
    ref = jsil.init_params()
    got = tsil.init_params()
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_weights_contract_is_enforced():
    arrays = tsil.init_params()
    arrays["head_w"] = arrays["head_w"][:, :64]
    with pytest.raises(ValueError, match="shape"):
        tsil.weights_from_numpy(arrays)
    with pytest.raises(ValueError, match="missing"):
        tsil.weights_from_numpy({"stft_basis": tsil.stft_basis_analytic()})
    assert tsil.weights_source() == "trained"
