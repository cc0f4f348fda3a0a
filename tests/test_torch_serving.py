"""Port parity for the whole slice: the fused multi-stream serving step
(front half -> RNNoise -> back half) against the JAX ``_serving_step``.

The reference is built with the integer cleanup codes: its string modes are
compared with the integer codes, so its default "off" runs strong cleanup
(ROADMAP F1). The serving default (cleanup off, de-esser off): capacity 3
with slot 2 inactive and a reset of slot 1 in the second block; low
suppressor strength, compressor threshold and limiter ceiling make every
dynamics stage engage; the mid-stream state after one warm-up block is
handed from the reference to the port through ``convert``. The full live
chain (gentle or strong cleanup and the de-esser, the reference's de-esser
switched on in its own config, ROADMAP F3): the state after 55 reference
blocks, with the hum confirmed and a hum window ending inside the second
of the two blocks the port then runs, is handed over. Two blocks, because
RNNoise's cepstral memory carries the reference's own input high-pass error
(ROADMAP F4) and drifts past 1e-3 within a few frames.
Tolerances: audio RMS <= 1e-4 / max <= 1e-3, dB metrics <= 1e-2 dB, pitch
period and integer counters exact, other state 1e-3.
"""

import numpy as np
import pytest
import torch

# the jaxlib serializer can crash writing large serving executables — see
# the conftest fixture
pytestmark = pytest.mark.usefixtures("no_persistent_cache")

import jax
import jax.numpy as jnp

from audioforge_tpu.ops import deesser as jdes
from audioforge_tpu.runtime import live_chain as jlc
from audioforge_tpu.runtime import serving as jsv
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.parallel import fleet_mesh
from audioforge_tpu_torch.runtime import live_chain as tlc
from audioforge_tpu_torch.runtime import serving as tsv

N, T = 3, 480
PCM = 32768.0
_PCM_LEAVES = ("analysis_mem", "synthesis_mem", "pitch_buf")


def _audio(n_blocks, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / 48000.0
    voiced = sum(np.sin(2 * np.pi * 150.0 * h * t + h) / h for h in range(1, 8))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)
    x = 0.5 * (env * voiced)[None] * rng.uniform(0.5, 1.5, (N, 1))
    x = x + 0.003 * rng.standard_normal((N, t.size))
    x[0, T + 50: T + 90] *= 5.0  # a transient over full scale
    return x.astype(np.float32).reshape(N, n_blocks, T).transpose(1, 0, 2)


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _assert_tree_close(port, ref, path=""):
    for k, r in ref.items():
        p, name = port[k], f"{path}.{k}"
        if isinstance(r, dict):
            _assert_tree_close(p, r, name)
            continue
        r = np.asarray(r)
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(p, r, err_msg=name)
        elif k in _PCM_LEAVES:  # RNNoise buffers hold PCM-scaled audio
            np.testing.assert_allclose(p / PCM, r / PCM, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-3, atol=1e-3, err_msg=name)


def test_serving_step_matches_reference():
    cfg_j = jsv.ServingConfig(capacity=N,
                              chain=jlc.LiveChainConfig(cleanup_mode=0))
    cfg_t = tsv.ServingConfig(capacity=N, chain=tlc.LiveChainConfig())
    eng_j = jsv.ServingEngine(cfg_j)
    for slot in range(N):  # mostly dry and a low threshold and ceiling, so
        # the compressor and both limiters engage
        eng_j.set_stream_suppressor(slot, strength=0.05)
        eng_j.set_stream_params(slot, compressor_threshold_db=-40.0,
                                limiter_ceiling_db=-9.0)
    params_j = eng_j._device_params()
    step_j = jax.jit(jsv._serving_step, static_argnums=(0,))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)

    with np.load(jsv.rnnoise.discover_model_path()) as data:
        weights = convert.rnnoise_weights({k: data[k] for k in data.files})
    params_t = {
        "chain": convert.chain_params(eng_j._params["chain"]),
        "supp": {"weights": weights,
                 **convert.chain_params({k: v for k, v in eng_j._params["supp"].items()
                                         if k in ("strength", "enabled",
                                                  "smoothing_coeff")})},
    }
    fresh_t = convert.serving_state(to_np(eng_j._fresh))

    xs = _audio(4, seed=60)
    active = np.array([True, True, False])
    no_reset = np.zeros(N, bool)
    vp, va = np.zeros(N, np.float32), np.zeros(N, bool)
    state_j, _, _ = step_j(cfg_j, params_j, eng_j._fresh, eng_j._fresh,
                           jnp.asarray(xs[0]), jnp.asarray(active),
                           jnp.asarray(no_reset), jnp.asarray(vp), jnp.asarray(va))
    state_t = convert.serving_state(to_np(state_j))

    limited = 0.0
    for b in range(1, 4):
        reset = np.array([False, b == 2, False])
        state_j, yj, mj = step_j(cfg_j, params_j, state_j, eng_j._fresh,
                                 jnp.asarray(xs[b]), jnp.asarray(active),
                                 jnp.asarray(reset), jnp.asarray(vp), jnp.asarray(va))
        state_t, yt, mt = tsv._serving_step(
            cfg_t, params_t, state_t, fresh_t, torch.as_tensor(xs[b]),
            torch.as_tensor(active), torch.as_tensor(reset), torch.as_tensor(vp),
            torch.as_tensor(va))
        _assert_audio(yt.numpy(), yj)
        assert not np.asarray(yj)[2].any()  # the inactive slot processes silence
        for k in ("gate_gain", "compressor_gain_reduction_db",
                  "limiter_gain_reduction_db", "tp_gain_reduction_db",
                  "output_rms_db", "noise_floor_db", "gate_threshold_db"):
            np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), atol=1e-2,
                                       err_msg=k)
        np.testing.assert_array_equal(
            state_t["supp"]["model"]["last_period"].numpy(),
            np.asarray(state_j["supp"]["model"]["last_period"]))
        limited = max(limited, float(np.asarray(mj["limiter_gain_reduction_db"]).max()))
    assert limited > 0.0  # the transient engaged the limiter
    assert float(np.asarray(mj["compressor_gain_reduction_db"]).max()) > 0.0
    ref = to_np(state_j)
    _assert_tree_close(convert.to_numpy(state_t, ref), ref)


def test_step_many_matches_repeated_step():
    xs = _audio(3, seed=61)[:, :2]
    outs = {}
    for mode in ("step", "step_many"):
        eng = tsv.ServingEngine(tsv.ServingConfig(capacity=2), device="cpu")
        got = {0: [], 1: []}
        for i in range(2):
            slot = eng.attach(sink=lambda blk, i=i: got[i].append(blk.copy()))
            eng.push(slot, xs[:, i].reshape(-1))
        if mode == "step":
            for _ in range(3):
                eng.step()
        else:
            eng.step_many(3)
        outs[mode] = np.stack([np.concatenate(got[i]) for i in range(2)])
        assert eng.stream_diagnostics(0)["blocks_processed"] == 3
    np.testing.assert_array_equal(outs["step_many"], outs["step"])


CHUNK = tsv.CHUNK_BLOCKS


@pytest.mark.parametrize("n_blocks,shards", [(1, 1), (CHUNK, 1), (2 * CHUNK + 3, 1),
                                             (2 * CHUNK + 3, 2), (1, 2)])
def test_chunked_step_many_matches_repeated_step(n_blocks, shards):
    """``step_many(n)``, a pipeline over chunks of CHUNK blocks, against n x
    ``step()``, bit for bit, with what lands at the call's start: a slot
    reset, an EQ program staged and a control write on slot 0, slot 3
    detached; slot 1 runs out of audio inside the span. Every block of the
    call is a view of one ``[n, N, BLOCK]`` array, and audio a sink pushes
    during the call stays queued for the next one. The same calls as
    ``step_pipelined()`` and ``flush_pipeline()`` deliver the same blocks,
    but for the first call's block of the two streams that detach while it
    is in flight: it reaches neither them nor slot 2's next stream."""
    from audioforge_tpu_torch.ops import eq

    boost = [eq.EqBandConfig(b.filter_type, b.frequency_hz, 6.0 if i == 6 else 0.0, 1.0)
             for i, b in enumerate(eq.default_bands())]
    rng = np.random.default_rng(70 + n_blocks)
    audio = (0.2 * rng.standard_normal((4, (n_blocks + 1) * T))).astype(np.float32)
    short = T + n_blocks * T // 2 + 100   # slot 1: a partial block inside the span
    runs = {}
    for mode in ("step", "step_many", "step_pipelined"):
        kw = ({"sharding": fleet_mesh(devices=["cpu"] * 2)} if shards == 2
              else {"device": "cpu"})
        eng = tsv.ServingEngine(tsv.ServingConfig(
            capacity=4, suppressor_model=None,
            chain=tlc.LiveChainConfig(gate_enabled=False, compressor_enabled=False)), **kw)
        got = {i: [] for i in range(4)}
        bases, pushing = [], []

        def sink(i):
            def take(blk):
                got[i].append(blk.copy())
                bases.append(blk.base)
                if pushing and i == 1:
                    eng.push(1, np.full(T, 0.5, np.float32))
            return take

        for i in range(4):
            assert eng.attach(sink=sink(i)) == i
            eng.push(i, audio[i, :short] if i == 1 else audio[i])
        first = eng.step_pipelined if mode == "step_pipelined" else eng.step
        first()
        eng.detach(2)
        assert eng.attach(sink=sink(2)) == 2
        eng.push(2, audio[2])
        eng.set_stream_eq(0, boost)
        eng.set_stream_params(0, limiter_ceiling_db=-12.0)
        eng.detach(3)
        bases.clear()
        if mode == "step":
            metrics = [eng.step() for _ in range(n_blocks)][-1]
        elif mode == "step_pipelined":
            for _ in range(n_blocks):
                eng.step_pipelined()
            metrics = eng.flush_pipeline()
        else:
            pushing.append(True)
            metrics = eng.step_many(n_blocks)
            assert all(b is bases[0] for b in bases)
            assert bases[0].shape == (n_blocks, 4, T)
            # the sink's pushes wait for the next call
            assert eng._slots[1].pending.size == n_blocks * T
        diag = [eng.stream_diagnostics(i) for i in range(3)]
        runs[mode] = (got, metrics, diag, eng.steps)
    (got_s, m_s, d_s, steps_s), (got_m, m_m, d_m, steps_m) = runs["step"], runs["step_many"]
    got_p, m_p, d_p, steps_p = runs["step_pipelined"]
    for i in range(4):
        assert len(got_m[i]) == len(got_s[i]) == 1 + n_blocks * (i != 3)
        np.testing.assert_array_equal(np.stack(got_m[i]), np.stack(got_s[i]))
    assert set(m_m) == set(m_s) and all(torch.equal(m_m[k], m_s[k]) for k in m_s)
    for a, b in zip(d_m, d_s):
        assert (a["blocks_processed"], a["underrun_count"]) == (
            b["blocks_processed"], b["underrun_count"])
    assert d_m[1]["underrun_count"] == -(-(n_blocks * T - (short - T)) // T)
    assert steps_m == steps_s == n_blocks + 1
    for i in range(4):
        lost = int(i >= 2)  # the first call's block of the streams that left
        assert len(got_p[i]) == len(got_s[i]) - lost
        for p, s in zip(got_p[i], got_s[i][lost:]):
            np.testing.assert_array_equal(p, s)
    assert set(m_p) == set(m_s) and all(torch.equal(m_p[k], m_s[k]) for k in m_s)
    assert [(d["blocks_processed"], d["underrun_count"]) for d in d_p] == [
        (d["blocks_processed"], d["underrun_count"]) for d in d_s]
    assert steps_p == steps_s


def _dry_engine(capacity=2):
    """A suppressor-less engine: the chain only, cheaper on CPU."""
    return tsv.ServingEngine(tsv.ServingConfig(capacity=capacity,
                                               suppressor_model=None),
                             device="cpu")


def test_attach_detach_push_lifecycle():
    eng = _dry_engine()
    slots = [eng.attach() for _ in range(2)]
    assert sorted(slots) == [0, 1] and eng.occupancy == 2
    with pytest.raises(RuntimeError):
        eng.attach()
    eng.detach(1)
    assert eng.occupancy == 1
    with pytest.raises(ValueError):
        eng.push(1, np.zeros(T, np.float32))
    eng.step()  # slot 0 had nothing queued: an underrun
    diag = eng.stream_diagnostics(0)
    assert diag["underrun_count"] == 1 and diag["blocks_processed"] == 1
    assert "output_lufs" in diag and "suppressor_nonfinite" not in diag
    engine = eng.engine_diagnostics()
    assert engine["steps"] == 1 and engine["step_latency"]["samples"] == 1
    with pytest.raises(ValueError):
        eng.set_stream_suppressor(0, strength=0.5)


def test_stream_params_change_only_their_stream():
    x = _audio(2, seed=62)[:, 0].reshape(-1)
    outs = {}
    for threshold in (None, -50.0):
        eng = _dry_engine()
        got = {0: [], 1: []}
        for i in range(2):
            slot = eng.attach(sink=lambda blk, i=i: got[i].append(blk.copy()))
            eng.push(slot, x)
        if threshold is not None:
            eng.set_stream_params(1, compressor_threshold_db=threshold)
        eng.step_many(2)
        outs[threshold] = [np.concatenate(got[i]) for i in range(2)]
    np.testing.assert_array_equal(outs[-50.0][0], outs[None][0])
    assert np.abs(outs[-50.0][1] - outs[None][1]).max() > 1e-3


def test_unported_options_raise():
    # every option is ported: the VAD, both DeepFilterNet3 models and the
    # stream-axis sharding, which takes a FleetMesh and nothing else
    for model in ("rnnoise", "deepfilter-ll", "deepfilter", None):
        tsv.ServingConfig(suppressor_model=model, vad_enabled=True)
    with pytest.raises(ValueError):
        tsv.ServingConfig(suppressor_model="speex")
    with pytest.raises(TypeError, match="FleetMesh"):
        tsv.ServingEngine(tsv.ServingConfig(capacity=1), sharding=object(),
                          device="cpu")
    eng = tsv.ServingEngine(tsv.ServingConfig(capacity=2, suppressor_model=None),
                            sharding=fleet_mesh(devices=["cpu"] * 2))
    slot = eng.attach()
    eng.push(slot, np.full(480, 0.1, np.float32))
    assert eng.step()["output_rms_db"].shape == (2,)
    with pytest.raises(ValueError):
        tlc.LiveChainConfig(cleanup_mode="loud")


def test_engine_needs_a_card_unless_given_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsv.ServingEngine(tsv.ServingConfig(capacity=1, suppressor_model=None))
    eng = tsv.ServingEngine(tsv.ServingConfig(capacity=1, suppressor_model=None),
                            device="cpu")
    assert eng.device.type == "cpu"


HANDOVER_BLOCKS = 55
PORT_BLOCKS = 2
# hum windows (12000 samples) then end at samples 3100, 15100 and 27100, the
# last inside block 56, after the handover at 55 * 480 = 26400
WINDOW_POS0 = 8900


def _full_chain_audio(n_blocks, seed):
    """Hum (50.4 Hz + harmonic, 59.7 Hz, none) under a voice, sibilant
    bursts on streams 1 and 2, and low plosive thumps on the hum-free
    stream 2."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / 48000.0
    voiced = sum(np.sin(2 * np.pi * 150.0 * h * t + h) / h for h in range(1, 6))
    voice = 0.1 * voiced * (np.sin(2 * np.pi * 3.0 * t) > -0.2)
    sib = 0.25 * np.sin(2 * np.pi * 6800.0 * t) * (np.sin(2 * np.pi * 4.0 * t) > 0.6)
    x = np.stack([
        0.1 * np.sin(2 * np.pi * 50.4 * t) + 0.03 * np.sin(2 * np.pi * 100.8 * t),
        0.04 * np.sin(2 * np.pi * 59.7 * t + 1.0),
        np.zeros_like(t),
    ]) + voice + sib * np.array([[0.0], [1.0], [1.0]])
    for at in range(2000, t.size - 1500, 9000):
        x[2, at:at + 1500] += 0.7 * np.hanning(1500)
    x += 0.003 * rng.standard_normal(x.shape)
    return x.astype(np.float32).reshape(N, n_blocks, T).transpose(1, 0, 2)


@pytest.mark.parametrize("cleanup", ["gentle", "strong"])
def test_full_chain_step_matches_reference(cleanup):
    code = {"gentle": 1, "strong": 2}[cleanup]
    cfg_j = jsv.ServingConfig(capacity=N, chain=jlc.LiveChainConfig(
        cleanup_mode=code, deesser_enabled=True,
        deesser=jdes.DeEsserConfig(enabled=True)))
    cfg_t = tsv.ServingConfig(capacity=N, chain=tlc.LiveChainConfig(
        cleanup_mode=cleanup, deesser_enabled=True))
    eng_j = jsv.ServingEngine(cfg_j)
    for slot in range(N):
        eng_j.set_stream_suppressor(slot, strength=0.05)
        eng_j.set_stream_params(slot, compressor_threshold_db=-40.0,
                                limiter_ceiling_db=-9.0)
    params_j = eng_j._device_params()
    step_j = jax.jit(jsv._serving_step, static_argnums=(0,))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    with np.load(jsv.rnnoise.discover_model_path()) as data:
        weights = convert.rnnoise_weights({k: data[k] for k in data.files})
    params_t = {
        "chain": convert.chain_params(eng_j._params["chain"]),
        "supp": {"weights": weights,
                 **convert.chain_params({k: v for k, v in eng_j._params["supp"].items()
                                         if k in ("strength", "enabled",
                                                  "smoothing_coeff")})},
    }
    fresh_t = convert.serving_state(to_np(eng_j._fresh))

    xs = _full_chain_audio(HANDOVER_BLOCKS + PORT_BLOCKS, seed=63 + code)
    active = jnp.ones(N, bool)
    no_reset = jnp.zeros(N, bool)
    vp, va = np.zeros(N, np.float32), np.zeros(N, bool)
    routing = dict(eng_j._fresh["chain"]["routing"],
                   window_pos=jnp.full((N,), WINDOW_POS0, jnp.int32))
    state_j = dict(eng_j._fresh, chain=dict(eng_j._fresh["chain"], routing=routing))
    for b in range(HANDOVER_BLOCKS):
        state_j, _, _ = step_j(cfg_j, params_j, state_j, eng_j._fresh,
                               jnp.asarray(xs[b]), active, no_reset,
                               jnp.asarray(vp), jnp.asarray(va))
    assert bool(np.asarray(state_j["chain"]["routing"]["hum_detected"])[0])
    state_t = convert.serving_state(to_np(state_j))
    windows = int(np.asarray(state_j["chain"]["routing"]["windows_observed"])[0])

    for b in range(HANDOVER_BLOCKS, HANDOVER_BLOCKS + PORT_BLOCKS):
        state_j, yj, mj = step_j(cfg_j, params_j, state_j, eng_j._fresh,
                                 jnp.asarray(xs[b]), active, no_reset,
                                 jnp.asarray(vp), jnp.asarray(va))
        state_t, yt, mt = tsv._serving_step(
            cfg_t, params_t, state_t, fresh_t, torch.as_tensor(xs[b]),
            torch.ones(N, dtype=torch.bool), None, torch.as_tensor(vp),
            torch.as_tensor(va))
        _assert_audio(yt.numpy(), yj)
        for k in ("gate_gain", "compressor_gain_reduction_db",
                  "deesser_gain_reduction_db", "limiter_gain_reduction_db",
                  "output_rms_db", "gate_threshold_db"):
            np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), atol=1e-2,
                                       err_msg=k)
        for k in ("routing_hum_detected", "routing_rumble_detected",
                  "routing_selected_hp_hz"):
            np.testing.assert_array_equal(mt[k].numpy(), np.asarray(mj[k]), err_msg=k)
    assert float(np.asarray(mj["deesser_gain_reduction_db"]).max()) > 0.0
    # a hum window ended inside a block the port ran
    assert int(np.asarray(state_j["chain"]["routing"]["windows_observed"])[0]) == windows + 1
    ref = to_np(state_j)
    _assert_tree_close(convert.to_numpy(state_t, ref), ref)
