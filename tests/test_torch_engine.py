"""The serving engine's loop and control surface on the CPU: the pipelined
step, ``run_blocks``, the free-run loop, ``engine_diagnostics``,
``set_stream_eq``, and the static-buffer step against chained pure
``_serving_step`` calls.

On the card a block step is a CUDA graph replay; on the CPU the engine runs
the same code on the same static buffers with an eager step in place of the
replay, so these tests cover everything but the capture (``chip_smoke.py``
holds the replay against the eager step on the card). Most engines here run
without the suppressor, and the EQ tests without the gate and compressor, to
keep the plain twins' per-sample loops and the reference's compiles short.
The EQ gain at 1280 Hz is held against the JAX engine's, within 0.1 dB; a
retuned low band against its f64 numpy response (the reference's f32 low
bands err there, ROADMAP F2).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

# the jaxlib serializer can crash writing large serving executables: see the
# conftest fixture
pytestmark = pytest.mark.usefixtures("no_persistent_cache")

from audioforge_tpu.ops import eq as jeq
from audioforge_tpu.runtime import live_chain as jlc
from audioforge_tpu.runtime import serving as jsv
from audioforge_tpu_torch.ops import eq as teq
from audioforge_tpu_torch.runtime import live_chain as tlc
from audioforge_tpu_torch.runtime import serving as tsv

BLOCK = tsv.BLOCK
FS = 48000.0
LEAN = {"gate_enabled": False, "compressor_enabled": False}


def _tone(n_blocks, freq, amp):
    t = np.arange(n_blocks * BLOCK) / FS
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _noise(n_blocks, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(n_blocks * BLOCK)).astype(np.float32)


def _engine(capacity=1, suppressor_model=None, **chain):
    return tsv.ServingEngine(
        tsv.ServingConfig(capacity=capacity, suppressor_model=suppressor_model,
                          chain=tlc.LiveChainConfig(**chain)),
        device="cpu")


def _collecting(eng, audio):
    """Attach one stream per row of ``audio`` with a collecting sink."""
    outs = [[] for _ in audio]
    for i, x in enumerate(audio):
        slot = eng.attach(sink=lambda blk, i=i: outs[i].append(blk))
        eng.push(slot, x)
    return outs


def test_pipelined_step_delivers_step_audio_one_call_later():
    audio = [_noise(4, 1), _noise(4, 2)]
    sync, pipe = _engine(2, **LEAN), _engine(2, **LEAN)
    out_s, out_p = _collecting(sync, audio), _collecting(pipe, audio)
    metrics = []
    for i in range(4):
        metrics.append(sync.step())
        delivered = pipe.step_pipelined()
        assert len(out_p[0]) == i  # one block in flight
        if i == 0:
            assert delivered is None
        else:
            for k in ("output_rms_db", "tp_gain_reduction_db", "input_peak_db"):
                assert torch.equal(delivered[k], metrics[i - 1][k]), k
    assert torch.equal(pipe.flush_pipeline()["output_rms_db"], metrics[-1]["output_rms_db"])
    assert pipe.flush_pipeline() is None  # drained
    for s, p in zip(out_s, out_p):
        assert len(p) == 4
        np.testing.assert_array_equal(np.concatenate(p), np.concatenate(s))
    assert pipe.stream_diagnostics(0)["blocks_processed"] == 4


def test_stop_flushes_the_pipeline():
    eng = _engine(**LEAN)
    (out,) = _collecting(eng, [_noise(2, 3)])
    eng.step_pipelined()
    eng.step_pipelined()
    assert len(out) == 1
    eng.stop()
    assert len(out) == 2


def test_run_blocks_equals_steps():
    audio = [_noise(3, 4)]
    ref, eng = _engine(**LEAN), _engine(**LEAN)
    (out_r,), (out_e,) = _collecting(ref, audio), _collecting(eng, audio)
    for _ in range(3):
        ref.step()
    eng.run_blocks(3)
    np.testing.assert_array_equal(np.concatenate(out_e), np.concatenate(out_r))
    assert eng.engine_diagnostics()["steps"] == 3


def test_free_run_loop_delivers_every_pushed_block():
    audio = [_noise(3, 5)]
    ref, eng = _engine(**LEAN), _engine(**LEAN)
    (out_r,) = _collecting(ref, audio)
    out_e = []
    got = threading.Event()

    def sink(blk):
        out_e.append(blk)
        if len(out_e) >= 3:
            got.set()

    eng.push(eng.attach(sink=sink), audio[0])
    for _ in range(3):
        ref.step()
    assert eng.realtime_pacing is False and eng.pipelined_loop is True
    eng.start()
    loop = eng._thread
    try:
        assert got.wait(timeout=120.0)
    finally:
        eng.stop()
    assert not loop.is_alive() and eng._thread is None
    # past the pushed audio the loop ran underrun blocks; every step was
    # delivered, the one in flight by stop()
    steps = eng.engine_diagnostics()["steps"]
    assert len(out_e) == steps >= 3
    assert eng.stream_diagnostics(0)["underrun_count"] == steps - 3
    np.testing.assert_array_equal(np.concatenate(out_e[:3]), np.concatenate(out_r))
    time.sleep(0.05)
    assert len(out_e) == steps  # stopped


def test_control_writes_from_threads_during_the_free_run_loop():
    """Four threads each write one control of the same slot 200 times while
    the loop runs, with a short switch interval: after the loop stops, the
    next step stages every thread's last write into the static controls."""
    eng = _engine(**LEAN)
    slot = eng.attach()
    eng.push(slot, _noise(2, 8))
    starts = {"compressor_threshold_db": -30.0, "limiter_ceiling_db": -3.0,
              "gate_threshold_db": -50.0, "compressor_ratio": 6.0}
    last = {key: start - 0.01 * 199 for key, start in starts.items()}

    def writer(key):
        for i in range(200):
            eng.set_stream_params(slot, **{key: starts[key] - 0.01 * i})

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    loop = eng._thread
    try:
        threads = [threading.Thread(target=writer, args=(key,)) for key in starts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.stop()
        sys.setswitchinterval(interval)
    assert not loop.is_alive()
    eng.step()

    def same(static, expect, path=""):
        for k, v in expect.items():
            if isinstance(v, dict):
                same(static[k], v, f"{path}.{k}")
            else:
                assert static[k][slot].item() == v[0], f"{path}.{k}"

    same(eng._params_static["chain"],
         tsv._stack_tree(tlc.live_params(eng.config.chain, **last), 1))


def test_engine_diagnostics_has_the_reference_keys():
    eng_j = jsv.ServingEngine(jsv.ServingConfig(capacity=1, suppressor_model=None))
    eng_t = _engine(**LEAN)
    eng_t.attach()
    eng_t.step()
    diag = eng_t.engine_diagnostics()
    assert set(diag) == set(eng_j.engine_diagnostics())
    assert diag["steps"] == 1 and diag["step_latency"]["samples"] == 1
    assert diag["realtime_pacing"] is False and diag["pipelined_loop"] is True


def _eq_gain_db(eng, bands, x, tail_from):
    """Gain (dB) of stream 0, whose EQ ``set_stream_eq`` replaced right after
    attach, over stream 1 (flat EQ), on the output from block ``tail_from``."""
    sinks = [[], []]
    slots = [eng.attach(sink=lambda b, i=i: sinks[i].append(np.array(b)))
             for i in range(2)]
    eng.set_stream_eq(slots[0], bands)
    n_blocks = x.size // BLOCK
    for s in slots:
        eng.push(s, x)
    for _ in range(n_blocks):
        eng.step()
    rms = [np.sqrt(np.mean(np.concatenate(s[tail_from:]).astype(np.float64) ** 2))
           for s in sinks]
    return 20.0 * np.log10(rms[0] / rms[1])


def test_set_stream_eq_gain_matches_reference_engine():
    """+12 dB at 1280 Hz (Q 1) on the default layout, staged right after
    attach, so it lands a block after the slot's reset."""
    def boost(mod):
        return [mod.EqBandConfig(b.filter_type, b.frequency_hz,
                                 12.0 if abs(b.frequency_hz - 1280.0) < 1.0 else 0.0,
                                 1.0, b.slope_db_per_octave, True)
                for b in mod.default_bands()]

    x = _tone(12, 1280.0, 0.05)  # 1280 Hz: 64 periods in 5 blocks
    eng_j = jsv.ServingEngine(jsv.ServingConfig(
        capacity=2, suppressor_model=None,
        chain=jlc.LiveChainConfig(cleanup_mode=0, **LEAN)))
    gain_j = _eq_gain_db(eng_j, boost(jeq), x, tail_from=7)
    gain_t = _eq_gain_db(_engine(2, **LEAN), boost(teq), x, tail_from=7)
    assert gain_t > 6.0
    assert abs(gain_t - gain_j) <= 0.1, (gain_t, gain_j)


def test_set_stream_eq_low_band_matches_f64_response():
    """Band 3 retuned to a 100 Hz bell (+9 dB, Q 2): the measured gain of a
    100 Hz tone (whole periods per block) against the band's f64 response."""
    band = teq.EqBandConfig(1, 100.0, 9.0, 2.0)
    bands = [band if i == 3 else b for i, b in enumerate(teq.default_bands())]
    gain = _eq_gain_db(_engine(2, **LEAN), bands, _tone(12, 100.0, 0.05),
                       tail_from=6)
    b0, b1, b2, a1, a2 = teq.band_section_design(band, FS)[0]
    z = np.exp(-2j * np.pi * 100.0 / FS)
    expect = 20.0 * np.log10(abs((b0 + b1 * z + b2 * z * z) / (1.0 + a1 * z + a2 * z * z)))
    assert expect > 8.0
    assert abs(gain - expect) <= 0.1, (gain, expect)


def test_staged_eq_waits_for_a_reset_and_is_dropped_by_detach():
    eng = _engine(**LEAN)
    slot = eng.attach()
    bands = [teq.EqBandConfig(b.filter_type, b.frequency_hz, 6.0, b.q)
             for b in teq.default_bands()]
    eng.set_stream_eq(slot, bands)
    coeffs = lambda: eng._state["chain"]["eq"]["coeffs"][slot]
    flat = teq.eq_init(None, FS, n=1, device="cpu")["coeffs"][0]
    eng.step()  # the slot resets in this step: its EQ waits one more
    assert torch.equal(coeffs(), flat) and slot in eng._pending_eq
    eng.step()
    assert torch.equal(coeffs(), teq.eq_init(bands, FS, n=1, device="cpu")["coeffs"][0])
    assert not eng._pending_eq
    eng.set_stream_eq(slot, None)
    eng.detach(slot)
    assert not eng._pending_eq
    high_pass = [teq.EqBandConfig(4, 60.0, 0.0, 0.7, 24)] + teq.default_bands()[1:]
    with pytest.raises(ValueError, match="layout"):
        eng.set_stream_eq(slot, high_pass)


def test_static_buffers_match_chained_pure_steps():
    """RNNoise and the default chain, capacity 2: slot 1 attaches before the
    second block, a control write and a suppressor write land before the
    third. Every block and the final state equal the pure step chained on
    the same inputs (the reset passed as the step's mask)."""
    cfg = tsv.ServingConfig(capacity=2)
    eng = tsv.ServingEngine(cfg, device="cpu")
    audio = np.stack([_noise(4, 6), _noise(4, 7)]).reshape(2, 4, BLOCK)
    got = [[], []]
    eng.push(eng.attach(sink=lambda b: got[0].append(b)), audio[0].ravel())
    weights = eng._params_dev["supp"]["weights"]
    state = tsv._clone_tree(eng._fresh)
    vp, va = torch.zeros(2), torch.zeros(2, dtype=torch.bool)
    for b in range(4):
        if b == 1:
            eng.push(eng.attach(sink=lambda blk: got[1].append(blk)),
                     audio[1, :3].ravel())
        if b == 2:
            eng.set_stream_params(0, compressor_threshold_db=-45.0)
            eng.set_stream_suppressor(1, strength=0.3)
        reset = torch.from_numpy(eng._reset_pending.copy())
        params = tsv._to_device(eng._params, "cpu")
        params["supp"]["weights"] = weights
        x = torch.zeros(2, BLOCK)
        x[0] = torch.from_numpy(audio[0, b])
        if b >= 1:
            x[1] = torch.from_numpy(audio[1, b - 1])
        active = torch.tensor([True, b >= 1])
        eng.step()
        state, y, _ = tsv._serving_step(cfg, params, state, eng._fresh, x, active,
                                        reset, vp, va)
        np.testing.assert_array_equal(got[0][-1], y[0].numpy())
        if b >= 1:
            np.testing.assert_array_equal(got[1][-1], y[1].numpy())

    def same(a, b, path=""):
        for k, v in b.items():
            if isinstance(v, dict):
                same(a[k], v, f"{path}.{k}")
            else:
                assert torch.equal(a[k], v), f"{path}.{k}"

    same(eng._state, state)
