"""Port parity for the offline model passes on the CPU: RNNoise over a take
(``rnnoise_frames``) and its frame-staging processor, Silero's offline
posteriors (``analyze_vad_probabilities``) at 16 and 48 kHz, and
``analysis.vad.analyze_offline_vad``.

Tolerances: audio RMS <= 1e-4 and max <= 1e-3 (at unit scale), VAD and
posteriors <= 1e-3, the model's audio buffers (PCM scale) at the audio max
tolerance, its other state 1e-3 (of a leaf's scale where it is above 1, as
the serving parity holds it), the pitch period exact; the input
high-pass's own state ``hp_mem`` is not compared, since the reference's f32
state is what F4 is about (it differs from the port's f64 state by ~1 % of
its scale within 5 frames, while the filtered audio it feeds stays within
1e-3 of its scale). The reference's RNNoise input
high-pass runs in f32 where the port's keeps f64 (ROADMAP F4), so the two
drift apart within a few frames once voice starts: ``rnnoise_frames`` is
compared over 40 frames in spans of 5, each later span starting from the
reference's state (the handover the serving parity uses).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioforge_tpu.analysis import vad as javad
from audioforge_tpu.models import rnnoise as jrn
from audioforge_tpu.models import silero as jsil
from audioforge_tpu_torch.analysis import vad as tavad
from audioforge_tpu_torch.models import rnnoise as trn
from audioforge_tpu_torch.models import silero as tsil
from audioforge_tpu_torch.ops import resample as tres
from audioforge_tpu_torch.runtime import chain as tchain

def _speech_like(fs, seconds, seed=0):
    """Harmonics 3-6 of a 200 Hz voice in 0.3 s bursts over low noise (the
    trained Silero archive calls the bursts voice and the gaps not)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    voiced = sum(np.sin(2 * np.pi * 200.0 * h * t + h) for h in range(3, 7))
    x = 0.08 * voiced * ((t % 0.5) < 0.3) + 0.002 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


PCM_BUFFERS = ("analysis_mem", "synthesis_mem", "pitch_buf")


def _assert_state(port, ref):
    for k, r in ref.items():
        if k == "hp_mem":  # the reference's f32 high-pass state itself (F4)
            continue
        if k in PCM_BUFFERS:  # audio at PCM scale: the audio tolerance
            np.testing.assert_allclose(port[k].numpy(), np.asarray(r), rtol=0,
                                       atol=1e-3 * trn.PCM_SCALE, err_msg=k)
            continue
        r = np.asarray(r)
        p = port[k].numpy()
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(p, r, err_msg=k)
        else:  # 1e-3, of the leaf's scale where it is above 1 (PCM-scale buffers)
            np.testing.assert_allclose(p, r, rtol=1e-3,
                                       atol=1e-3 * max(1.0, float(np.abs(r).max())),
                                       err_msg=k)


SPAN = 5  # frames a reference run covers before its state is handed over


@pytest.fixture(scope="module")
def rnnoise_take():
    """Two streams of 40 frames (PCM scale) of a 150 Hz harmonic tone in
    bursts over -40 dB noise (an unambiguous pitch, so the pitch search
    cannot flip on a last-bit tie), run by the reference in spans of SPAN
    frames: each span's start state, output, VAD and end state."""
    rng = np.random.default_rng(1)
    t = np.arange(40 * 480) / 48000.0
    tone = sum(np.sin(2 * np.pi * 150.0 * h * t + h) / h for h in range(1, 8))
    x = 0.3 * tone * ((t % 0.2) < 0.12) * np.array([[1.0], [0.6]])
    x = x + 0.003 * rng.standard_normal((2, t.size))
    frames = (x.reshape(2, 40, 480) * trn.PCM_SCALE).astype(np.float32)
    params = jrn.default_params()
    state = jrn.rnnoise_state_init((2,))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    spans = []
    for lo in range(0, 40, SPAN):
        new, y, vad = jrn.rnnoise_frames(params, state, jnp.asarray(frames[:, lo:lo + SPAN]))
        spans.append((to_np(state), np.asarray(y), np.asarray(vad), to_np(new)))
        state = new
    return frames, spans


def _port_state(tree):
    out = {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}
    out["hp_mem"] = out["hp_mem"].to(torch.float64)
    return out


def test_rnnoise_frames_match_reference(rnnoise_take):
    """The first span from a fresh state, then every later span from the
    reference's state at its start."""
    frames, spans = rnnoise_take
    assert trn.weights_source() == jrn.weights_source()
    weights = trn.default_params()
    vads = []
    for i, (start, ref_y, ref_vad, ref_end) in enumerate(spans):
        state = (trn.rnnoise_state_init(n=2, device="cpu") if i == 0
                 else _port_state(start))
        end, y, vad = trn.rnnoise_frames(weights, state, torch.as_tensor(
            frames[:, i * SPAN:(i + 1) * SPAN]))
        assert y.shape == (2, SPAN, 480) and vad.shape == (2, SPAN)
        _assert_audio(y.numpy() / trn.PCM_SCALE, ref_y / trn.PCM_SCALE)
        np.testing.assert_allclose(vad.numpy(), ref_vad, atol=1e-3, err_msg=f"span {i}")
        _assert_state(end, ref_end)
        vads.append(ref_vad)
    assert np.concatenate(vads, axis=1).max() > 0.5  # the model heard voice


def test_rnnoise_frames_over_a_batch_shape():
    """Leading axes are streams: ``[2, 1, n, 480]`` runs as two streams."""
    frames = torch.as_tensor(
        np.stack([_speech_like(48000, 0.03, seed=s) for s in (6, 7)]).reshape(2, 1, 3, 480)
        * trn.PCM_SCALE)
    state, y, vad = trn.rnnoise_frames(trn.default_params(), trn.rnnoise_state_init(
        n=2, device="cpu"), frames)
    assert y.shape == (2, 1, 3, 480) and vad.shape == (2, 1, 3)
    _, y0, _ = trn.rnnoise_frames(trn.default_params(), trn.rnnoise_state_init(
        n=1, device="cpu"), frames[:1, 0])
    torch.testing.assert_close(y[0, 0], y0[0], rtol=0, atol=1e-3)


def _processor_run(mod, x, strength, **kw):
    """Push in uneven chunks, process, pop uneven counts, soft-reset half
    way; returns every popped chunk and the final smoothed strength."""
    state = mod.processor_init(strength=strength, **kw)
    out = []
    for lo, hi, pop in ((0, 1000, 300), (1000, 1700, 900), (1700, 5000, 2000),
                        (5000, x.size, 20000)):
        state, pushed = mod.processor_push(state, x[lo:hi])
        assert pushed == hi - lo
        state, _ = mod.processor_process(state)
        state, chunk = mod.processor_pop(state, pop)
        out.append(np.asarray(chunk))
        if lo == 1700:
            state = mod.processor_soft_reset(state)
    return out, state["smoothed_strength"]


def test_processor_staging_matches_reference():
    x = _speech_like(48000, 0.2, seed=3)  # 20 frames
    ref, ref_sm = _processor_run(jrn, x, 0.6)
    got, sm = _processor_run(trn, x, 0.6, device="cpu")
    assert [c.size for c in got] == [c.size for c in ref]
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        if r.size:
            _assert_audio(g, r)
    assert sm == pytest.approx(ref_sm, abs=1e-12)
    # a disabled processor passes the staged frames through
    state = trn.processor_init(device="cpu")
    state["enabled"] = False
    state, _ = trn.processor_push(state, x[:1000])
    state, n = trn.processor_process(state)
    state, out = trn.processor_pop(state, 2000)
    assert n == 2 and np.array_equal(out, x[:960])


@pytest.mark.parametrize("fs", [16000, 48000])
def test_analyze_vad_probabilities_matches_reference(fs):
    x = _speech_like(fs, 1.0, seed=4)
    ref = np.asarray(jsil.analyze_vad_probabilities(x, fs))
    got = np.asarray(tsil.analyze_vad_probabilities(x, fs, device="cpu"))
    assert got.shape == ref.shape == (-(-x.size // (512 * fs // 16000)),)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    assert ref.max() > 0.6 and ref.min() < 0.3  # voice and its gaps told apart
    assert tsil.analyze_vad_probabilities(x[:0], fs, device="cpu") == []
    with pytest.raises(ValueError, match="16000 or 48000"):
        tsil.analyze_vad_probabilities(x, 44100, device="cpu")


def test_analyze_offline_vad_matches_reference(monkeypatch):
    x = _speech_like(16000, 0.5, seed=5)
    ref, ref_label = javad.analyze_offline_vad(x, 16000)
    got, label = tavad.analyze_offline_vad(x, 16000, device="cpu")
    assert label == ref_label == "silero"
    np.testing.assert_allclose(got, ref, atol=1e-3)
    for audio, fs in ((x[:0], 16000), (x, 44100), (x, 0)):
        assert tavad.analyze_offline_vad(audio, fs, device="cpu") == (None, "energy_fallback")
        assert javad.analyze_offline_vad(audio, fs) == (None, "energy_fallback")
    assert (tavad.CALIBRATED_VAD_DEFAULT_THRESHOLD, tavad.VAD_SPEECH_EVIDENCE_THRESHOLD,
            tavad.VAD_STRONG_SPEECH_THRESHOLD, tavad.VAD_NOISE_CONTAMINATION_THRESHOLD) == (
        javad.CALIBRATED_VAD_DEFAULT_THRESHOLD, javad.VAD_SPEECH_EVIDENCE_THRESHOLD,
        javad.VAD_STRONG_SPEECH_THRESHOLD, javad.VAD_NOISE_CONTAMINATION_THRESHOLD)

    # weights that fail validation keep the label
    def bad_weights():
        raise ValueError("weight archive key mismatch")

    monkeypatch.setattr(tsil, "default_params", bad_weights)
    assert tavad.analyze_offline_vad(x, 16000, device="cpu") == (None, "energy_fallback")
    monkeypatch.undo()

    # a failure of the run itself (a kernel that does not build or launch)
    # is not turned into the label
    def launch_fails(*args, **kwargs):
        raise RuntimeError("vad_lstm_head launch failed: unspecified launch failure")

    monkeypatch.setattr(tsil, "vad_lstm_head", launch_fails)
    with pytest.raises(RuntimeError, match="launch failed"):
        tavad.analyze_offline_vad(x, 16000, device="cpu")


DEFAULT_DEVICE_ENTRY_POINTS = {
    "chain_init": lambda: tchain.chain_init(tchain.ChainConfig()),
    "rnnoise.processor_init": lambda: trn.processor_init(),
    "analyze_vad_probabilities": lambda: tsil.analyze_vad_probabilities(
        np.zeros(512, np.float32), 16000),
    "analyze_offline_vad": lambda: tavad.analyze_offline_vad(np.ones(512, np.float32), 16000),
    "resample": lambda: tres.resample(np.zeros(64, np.float32), 48000, 16000),
    "simulate_product_resampler": lambda: tres.simulate_product_resampler(
        np.zeros(64), 48000, 16000),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_ENTRY_POINTS))
def test_entry_points_run_on_the_card_by_default(name):
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        DEFAULT_DEVICE_ENTRY_POINTS[name]()
