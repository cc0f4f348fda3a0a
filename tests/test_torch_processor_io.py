"""Port parity for the live engine's host I/O on the CPU: the channel mixdown
(five modes, phase-safe mono over consecutive blocks), the streaming
resampler, the audio ring (native and Python), the output writer and the
native ingest.

These are host numpy and ctypes modules that the port copies from the JAX
package; they are held to the reference at 1e-6 (the resampler also to the
port's offline ``resample``, 1e-6 RMS after its start-up).
"""

import numpy as np
import pytest

from audioforge_tpu.ops import mixdown as jmx
from audioforge_tpu.ops import resample as jres
from audioforge_tpu.runtime import output_writer as jow
from audioforge_tpu_torch.ops import mixdown as tmx
from audioforge_tpu_torch.ops import resample as tres
from audioforge_tpu_torch.runtime import ingest as ting
from audioforge_tpu_torch.runtime import output_writer as tow
from audioforge_tpu_torch.runtime import ringbuffer as tring


def _speechish(rng, n):
    t = np.arange(n) / 48000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 680 * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("mode", ["average", "left", "right", "max_rms", "phase_safe_mono"])
def test_mix_to_mono_matches_reference(mode):
    rng = np.random.default_rng(1)
    left = _speechish(rng, 960)
    right = (-0.7 * np.roll(left, 3) + 0.01 * rng.standard_normal(960)).astype(np.float32)
    got, corr, diag = tmx.mix_to_mono(left, right, mode, tmx.PhaseSafeMonoState())
    ref, rcorr, rdiag = jmx.mix_to_mono(left, right, mode, jmx.PhaseSafeMonoState())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (corr is None) == (rcorr is None)
    if corr is not None:
        assert corr == pytest.approx(rcorr, abs=1e-6)
    assert diag == rdiag


def test_mix_phase_safe_over_blocks_of_a_delayed_channel():
    rng = np.random.default_rng(2)
    x = _speechish(rng, 480 * 11)
    left, right = x[5:], -x[:-5]  # right lags left by 5 samples, inverted
    ts, js = tmx.PhaseSafeMonoState(), jmx.PhaseSafeMonoState()
    strategies = set()
    for b in range(10):
        sl = slice(b * 480, (b + 1) * 480)
        got, diag = tmx.mix_phase_safe(left[sl], right[sl], ts)
        ref, rdiag = jmx.mix_phase_safe(left[sl], right[sl], js)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        assert diag.keys() == rdiag.keys()
        for k, v in diag.items():
            assert v == (pytest.approx(rdiag[k], abs=1e-6) if isinstance(v, float)
                         else rdiag[k])
        strategies.add(diag["strategy"])
    assert strategies == {"fractional_delay"}  # the rescue ran


@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 44100)])
def test_streaming_resampler_matches_reference(rates):
    fin, fout = rates
    rng = np.random.default_rng(3)
    t = np.arange(fin) / fin
    x = (0.5 * np.sin(2 * np.pi * 1000 * t) + 0.05 * rng.standard_normal(fin)).astype(
        np.float32)
    sizes = (441, 480, 1000)  # three chunk sizes in turn
    ts, js = tres.StreamingResampler(fin, fout), jres.StreamingResampler(fin, fout)
    got, ref, pos, i = [], [], 0, 0
    while pos < x.size:
        chunk = x[pos:pos + sizes[i % 3]]
        got.append(ts.process(chunk))
        ref.append(js.process(chunk))
        pos += chunk.size
        i += 1
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert ts.delay_frames == js.delay_frames
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the stream is the offline resample, time-aligned
    off = tres.resample(x, fin, fout, device="cpu").numpy()
    n = min(got.size, off.size)
    skip = 4 * ts.delay_frames  # the zero-history start-up
    err = got[skip:n] - off[skip:n]
    assert np.sqrt(np.mean(err.astype(np.float64) ** 2)) < 1e-6


RINGS = [pytest.param(tring._PythonRing, id="python"),
         pytest.param("native", id="native")]


def _ring(kind, capacity):
    if kind == "native":
        if not tring.native_ring_available():
            pytest.fail("g++ builds the native ring on this host")
        return tring._NativeRing(capacity)
    return kind(capacity)


@pytest.mark.parametrize("kind", RINGS)
def test_ring_write_read_roundtrip(kind):
    r = _ring(kind, 1024)
    assert r.capacity == 1024
    assert r.write(np.arange(100, dtype=np.float32)) == 100
    assert np.array_equal(r.read(100), np.arange(100, dtype=np.float32))


@pytest.mark.parametrize("kind", RINGS)
def test_ring_overflow_drops_and_counts(kind):
    r = _ring(kind, 256)
    assert r.write(np.ones(1000, np.float32)) == r.capacity
    assert r.dropped() == 1000 - r.capacity
    assert r.overflow_events() == 1
    r.reset_dropped()
    assert r.dropped() == 0


@pytest.mark.parametrize("kind", RINGS)
def test_ring_wraparound(kind):
    r = _ring(kind, 128)
    for i in range(40):
        assert r.write(np.full(37, float(i), np.float32)) == 37
        assert np.all(r.read(37) == float(i))


@pytest.mark.parametrize("kind", RINGS)
def test_ring_discard_and_clear(kind):
    r = _ring(kind, 256)
    r.write(np.ones(200, np.float32))
    assert r.discard(50) == 50
    assert r.available() == 150
    r.clear()
    assert r.available() == 0


def test_native_ring_builds_into_the_checkout():
    assert tring.native_ring_available()
    assert tring._BUILD_DIR.parts[-3:] == ("build", "audioforge_tpu_torch", "native")
    assert isinstance(tring.AudioRing(64), tring._NativeRing)


@pytest.mark.parametrize("block_multiple", [1, 4])
def test_output_writer_matches_reference(block_multiple):
    rng = np.random.default_rng(4)
    tc = tow.OutputWriteController(48000.0, block_multiple=block_multiple)
    jc = jow.OutputWriteController(48000.0, block_multiple=block_multiple)
    assert (tc.target_center_samples, tc.hard_backlog_samples, tc.fade_samples) == (
        jc.target_center_samples, jc.hard_backlog_samples, jc.fade_samples)
    fills = [0, 500, 1440, 2400, 2880, 3500, 200, 1920] * 3
    for i, fill in enumerate(fills):
        if i % 7 == 3:
            tc.mark_discontinuity()
            jc.mark_discontinuity()
        block = (0.3 * rng.standard_normal(480 * block_multiple)).astype(np.float32)
        got = tc.condition(block, fill, blocks=block_multiple)
        ref = jc.condition(block, fill, blocks=block_multiple)
        np.testing.assert_array_equal(got, ref)
    assert (tc.retime_adjustment_count, tc.jitter_dropped_samples) == (
        jc.retime_adjustment_count, jc.jitter_dropped_samples)
    assert tc.retime_adjustment_count > 0
    x = np.linspace(0.0, 1.0, 480).astype(np.float32)
    for ratio in (0.96, 1.0, 1.06):
        np.testing.assert_array_equal(tow.retime_audio_block(x, ratio),
                                      jow.retime_audio_block(x, ratio))


def test_native_ingest_matches_python_resampler():
    assert ting.native_ingest_available()
    rng = np.random.default_rng(5)
    ring = tring.AudioRing(1 << 18)
    ing = ting.NativeIngest(ring, channels=2, mix_mode="average", device_rate=44100)
    t = np.arange(44100) / 44100.0
    mono = (0.5 * np.sin(2 * np.pi * 1000 * t)
            + 0.05 * rng.standard_normal(44100)).astype(np.float32)
    stereo = np.stack([mono, mono], axis=1)
    total = sum(ing.push(stereo[i:i + 441]) for i in range(0, 44100, 441))
    y_native = ring.read(total)
    sr = tres.StreamingResampler(44100, 48000, sinc_len=128)
    y_py = np.concatenate([sr.process(mono[i:i + 441]) for i in range(0, 44100, 441)])
    n = min(len(y_native), len(y_py))
    assert n > 47000
    assert np.sqrt(np.mean((y_native[200:n] - y_py[200:n]) ** 2)) < 1e-6


def test_native_ingest_passthrough_modes():
    rng = np.random.default_rng(6)
    left = (0.3 * rng.standard_normal(960)).astype(np.float32)
    right = (0.1 * rng.standard_normal(960)).astype(np.float32)
    stereo = np.stack([left, right], axis=1)
    for mode, expected in (("left", left), ("right", right),
                           ("average", 0.5 * (left + right)), ("max_rms", left)):
        ring = tring.AudioRing(4096)
        ing = ting.NativeIngest(ring, channels=2, mix_mode=mode, device_rate=48000)
        w = ing.push(stereo)
        np.testing.assert_allclose(ring.read(w), expected, atol=1e-6)
