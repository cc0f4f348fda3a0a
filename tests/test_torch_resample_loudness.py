"""Port parity for the host-side and resampling pieces of the offline path:
the product resampler (``ops/resample.py``), BS.1770 integrated and momentary
loudness (``ops/loudness.py``), the static EQ's compaction and both EQ
magnitude responses, against the JAX package on the CPU.

Tolerances: resampled audio RMS <= 1e-4 and max <= 1e-3; the host numpy
helpers (cutoff search, loudness, responses, compaction) agree to 1e-9 or
exactly; a chunked resample equals the unchunked one.
"""

import numpy as np
import pytest
import torch

from audioforge_tpu import api as japi
from audioforge_tpu.ops import biquad as jbq
from audioforge_tpu.ops import eq as jeq
from audioforge_tpu.ops import loudness as jloud
from audioforge_tpu.ops import resample as jres
from audioforge_tpu_torch import api as tapi
from audioforge_tpu_torch.ops import biquad as tbq
from audioforge_tpu_torch.ops import eq as teq
from audioforge_tpu_torch.ops import loudness as tloud
from audioforge_tpu_torch.ops import resample as tres


def _signal(fs, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    sweep = np.sin(2 * np.pi * (200.0 + 4000.0 * t) * t)
    x = 0.3 * sweep * ((t % 0.4) < 0.3) + 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000)])
def test_resample_matches_reference(rates, monkeypatch):
    fs_in, fs_out = rates
    x = _signal(fs_in, 0.25)
    ref = np.asarray(jres.resample(x, fs_in, fs_out))
    got = tres.resample(x, fs_in, fs_out, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape == (fs_out // 4,)
    _assert_audio(got.numpy(), ref)
    # chunking changes the memory, not the result
    monkeypatch.setattr(tres, "RESAMPLE_CHUNK_OUTPUTS", 997)
    assert torch.equal(tres.resample(x, fs_in, fs_out, device="cpu"), got)
    # leading axes are takes of their own
    two = tres.resample(torch.as_tensor(np.stack([x, -x])), fs_in, fs_out)
    assert torch.equal(two[0], got) and torch.equal(two[1], -got)


def test_resample_design_matches_reference():
    for sinc_len, window in ((128, "blackman"), (64, "hann_squared")):
        assert tres._auto_cutoff(sinc_len, window) == jres._auto_cutoff(sinc_len, window)
        t_ref, c_ref = jres._phase_table(sinc_len, window)
        t_got, c_got = tres._phase_table(sinc_len, window)
        assert c_got == c_ref and np.array_equal(t_got, t_ref)
    assert tres.WINDOWS == jres.WINDOWS
    assert tres.product_resampler_configuration() == jres.product_resampler_configuration()
    with pytest.raises(ValueError, match="unsupported resampler window"):
        tres.windowed_sinc(8, 0.5, "kaiser")


@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 16000)])
def test_simulate_product_resampler_matches_reference(rates):
    x = _signal(rates[0], 0.25, seed=1)
    out_r, delay_r, frames_r, times_r = jres.simulate_product_resampler(x, *rates)
    out, delay, frames, times = tres.simulate_product_resampler(x, *rates, device="cpu")
    assert (delay, frames, len(times)) == (delay_r, frames_r, len(times_r))
    assert len(out) == len(out_r) == frames + delay
    assert out[:delay] == [0.0] * delay  # the stream is causal
    _assert_audio(out, out_r)


@pytest.mark.parametrize("bad", [
    dict(input_rate=0), dict(chunk_size=0), dict(chunk_size=2048), dict(sinc_len=100),
    dict(sinc_len=16), dict(window="kaiser"), dict(samples=[0.0, np.inf])])
def test_simulate_product_resampler_validation_matches_reference(bad):
    args = dict(samples=np.zeros(64), input_rate=48000, output_rate=16000)
    args.update(bad)
    with pytest.raises(ValueError) as ref:
        jres.simulate_product_resampler(**args)
    with pytest.raises(ValueError) as got:
        tres.simulate_product_resampler(**args, device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("fs", [48000, 44100, 16000])
def test_loudness_matches_reference(fs):
    x = _signal(fs, 2.0, seed=2)
    assert tloud.integrated_loudness_lufs(x, fs) == jloud.integrated_loudness_lufs(x, fs)
    assert tapi.measure_integrated_loudness(x, fs) == japi.measure_integrated_loudness(x, fs)
    np.testing.assert_array_equal(tloud.momentary_slices_lufs(x, fs),
                                  jloud.momentary_slices_lufs(x, fs))
    np.testing.assert_array_equal(tloud.momentary_slices_lufs(x, fs, hop_s=0.25),
                                  jloud.momentary_slices_lufs(x, fs, hop_s=0.25))
    assert tloud.momentary_slices_lufs(x[:100], fs).size == 0
    # a 1 kHz sine at -20 dB RMS reads -20 LUFS (the -0.691 offset cancels
    # the K-weighting's gain there)
    t = np.arange(fs * 3) / fs
    sine = (0.1 * np.sqrt(2.0) * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    assert tloud.integrated_loudness_lufs(sine, fs) == pytest.approx(-20.0, abs=0.1)


@pytest.mark.parametrize("bad", [
    (np.zeros(4800, np.float32), 12345), (np.zeros(0, np.float32), 48000),
    (np.array([0.0, np.nan], np.float32), 48000), (np.ones(100, np.float32), 48000),
    (np.zeros(48000, np.float32), 48000)])
def test_loudness_errors_match_reference(bad):
    with pytest.raises(ValueError) as ref:
        jloud.integrated_loudness_lufs(*bad)
    with pytest.raises(ValueError) as got:
        tloud.integrated_loudness_lufs(*bad)
    assert str(got.value) == str(ref.value)


def _bands(pkg):
    types = [0, 1, 1, 4, 1, 3, 1, 5, 1, 2]
    gains = [-2.0, 0.0, 1.5, 0.0, 2.0, 0.0, -1.5, 0.0, 0.0, 1.0]
    slopes = [12, 12, 12, 24, 12, 12, 12, 48, 12, 12]
    return [pkg.EqBandConfig(ft, f, g, q, sl, True) for ft, f, g, q, sl in zip(
        types, jeq.DEFAULT_FREQUENCIES, gains, [1.0, 1.41, 1.0, 0.7, 1.41, 4.0, 2.0, 0.7,
                                                1.41, 0.7], slopes)]


def test_static_cascade_and_responses_match_reference():
    for fs in (48000.0, 44100.0):
        full_r = jeq.bands_to_sections(_bands(jeq), fs)
        full = teq.bands_to_sections(_bands(teq), fs)
        np.testing.assert_array_equal(full, full_r)
        for got, ref in zip(teq.compact_cascade(full), jeq.compact_cascade(full_r)):
            np.testing.assert_array_equal(got, ref)
        lo, hi = teq.compact_cascade(full)
        assert lo.shape[0] >= 1 and hi.shape[0] >= 1  # both groups in use
        freqs = np.geomspace(20.0, fs / 2, 97)
        np.testing.assert_allclose(teq.magnitude_response_db(_bands(teq), freqs, fs),
                                   jeq.magnitude_response_db(_bands(jeq), freqs, fs),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(tbq.magnitude_response_db(full, freqs, fs),
                                   jbq.magnitude_response_db(full_r, freqs, fs),
                                   rtol=0, atol=1e-9)
    legacy = [(f, g, 1.2) for f, g in zip(jeq.DEFAULT_FREQUENCIES, np.linspace(-3, 3, 10))]
    freqs = [0.0, 50.0, 1000.0, 24000.0]
    np.testing.assert_allclose(tapi.eq_magnitude_response(freqs, legacy, 48000),
                               japi.eq_magnitude_response(freqs, legacy, 48000), atol=1e-9)
    v2 = [(teq.FILTER_TYPE_NAMES[b.filter_type], b.frequency_hz, b.gain_db, b.q,
           b.slope_db_per_octave, b.enabled) for b in _bands(teq)]
    np.testing.assert_allclose(tapi.eq_magnitude_response_v2(freqs, v2, 48000),
                               japi.eq_magnitude_response_v2(freqs, v2, 48000), atol=1e-9)
