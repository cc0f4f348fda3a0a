"""Port parity for the single-stream engine's pieces on the CPU: the burst
halves ``front_run`` / ``back_run``, the chain latency, the suppressor
engine (RNNoise, DeepFilterNet3-LL, the passthrough of an unavailable
backend), the streaming VAD, the RNNoise processor's persistent frame
graph, and the ``convert`` round trips of their states.

Tolerances follow ROADMAP: audio RMS <= 1e-4 / max <= 1e-3, activations,
probabilities and other state 1e-3, dB metrics 1e-2, integer state exact.
The reference runs cleanup mode 0 (its string modes run strong cleanup,
ROADMAP F1). RNNoise is compared over 5 frames from a fresh state (ROADMAP
F4: its f32 input high-pass drifts from the port's f64 one over longer
spans).
"""

import numpy as np
import pytest
import torch

import jax

from audioforge_tpu.models import dfn3 as jdfn
from audioforge_tpu.models import silero as jsil
from audioforge_tpu.models import suppressor as jsupp
from audioforge_tpu.runtime import live_chain as jlc
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.models import dfn3 as tdfn
from audioforge_tpu_torch.models import rnnoise as trn
from audioforge_tpu_torch.models import silero as tsil
from audioforge_tpu_torch.models import suppressor as tsupp
from audioforge_tpu_torch.runtime import live_chain as tlc
from audioforge_tpu_torch.runtime.replay import BlockReplay

T = 480


def _voice(n_blocks, seed, scale=0.3):
    """Harmonics 3-6 of a 200 Hz voice in bursts over low noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / 48000.0
    voiced = sum(np.sin(2 * np.pi * 200.0 * h * t + h) for h in range(3, 7))
    x = scale * 0.25 * voiced * ((t % 0.05) < 0.03) + 0.003 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(config, **controls):
    def leaf(v):
        if isinstance(v, dict):
            return {k: leaf(x) for k, x in v.items()}
        return torch.full((1,), float(v), dtype=torch.float32)
    return leaf(tlc.live_params(config, **controls))


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _assert_metrics(port, ref):
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        tol = 1e-2 if k.endswith("_db") or "lufs" in k else 1e-3
        np.testing.assert_allclose(np.asarray(port[k], np.float64), r, rtol=0, atol=tol,
                                   err_msg=k)


def _assert_tree_close(port, ref, path=""):
    for k, r in ref.items():
        p, name = port[k], f"{path}.{k}"
        if isinstance(r, dict):
            _assert_tree_close(p, r, name)
            continue
        r = np.asarray(r)
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(p, r, err_msg=name)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-3, atol=1e-3, err_msg=name)


def _assert_tree_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k, v in b.items():
        if isinstance(v, dict):
            _assert_tree_equal(a[k], v, f"{path}.{k}")
        elif isinstance(v, (np.ndarray, np.generic)) or hasattr(v, "shape"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(v),
                                          err_msg=f"{path}.{k}")
        else:
            assert a[k] == v, f"{path}.{k}"


def test_front_and_back_run_match_reference():
    config = dict(gate_mode=1)
    jcfg = jlc.LiveChainConfig(cleanup_mode=0, **config)
    tcfg = tlc.LiveChainConfig(cleanup_mode="off", **config)
    controls = {"compressor_threshold_db": -40.0, "limiter_ceiling_db": -9.0}
    xs = _voice(3, seed=1, scale=1.0).reshape(3, T)
    xs[1, 50:90] *= 5.0  # a transient over full scale

    jstate = jlc.live_init(jcfg)
    jparams = jlc.live_params(jcfg, **controls)
    ref_np = _np_tree(jstate)
    jstate, jy, jfm = jlc.front_run(jcfg, jparams, jstate, xs, np.float32(0.8), True)
    evidence = {"vad_probability": np.full(3, 0.8, np.float32),
                "vad_reliability": np.ones(3, np.float32),
                "noise_floor_db": np.asarray(jfm["noise_floor_db"]),
                "live_noise_reliability": np.asarray(jfm["noise_floor_reliability"])}
    jstate, jz, jbm = jlc.back_run(jcfg, jparams, jstate, jy, evidence)

    state = convert.live_state(ref_np)
    params = _port_params(tcfg, **controls)
    front = tlc.front_replay(tcfg, params, state, k_max=3)
    back = tlc.back_replay(tcfg, params, state, k_max=3)
    state, y, fm = tlc.front_run(tcfg, params, state, xs, 0.8, True, replay=front)
    _assert_audio(y, jy)
    _assert_metrics(fm, {k: v for k, v in jfm.items()})
    port_ev = dict(evidence, noise_floor_db=fm["noise_floor_db"],
                   live_noise_reliability=fm["noise_floor_reliability"])
    state, z, bm = tlc.back_run(tcfg, params, state, y, port_ev, replay=back)
    _assert_audio(z, jz)
    _assert_metrics(bm, {k: v for k, v in jbm.items()})
    assert np.max(np.abs(z)) <= 10 ** (-9.0 / 20) + 1e-6
    assert float(bm["compressor_gain_reduction_db"].max()) > 1.0  # dynamics engaged
    ref_after = _np_tree(jstate)
    _assert_tree_close(convert.to_numpy(state, ref_after), ref_after)

    # a burst of k blocks is k single blocks, to the bit
    state1 = convert.live_state(ref_np)
    front1 = tlc.front_replay(tcfg, params, state1, k_max=1)
    back1 = tlc.back_replay(tcfg, params, state1, k_max=1)
    for b in range(3):
        _, yb, fmb = tlc.front_run(tcfg, params, state1, xs[b:b + 1], 0.8, True,
                                   replay=front1)
        assert torch.equal(torch.from_numpy(yb[0]), torch.from_numpy(y[b]))
        evb = {k: np.asarray(v)[b:b + 1] for k, v in port_ev.items()}
        _, zb, _ = tlc.back_run(tcfg, params, state1, yb, evb, replay=back1)
        assert torch.equal(torch.from_numpy(zb[0]), torch.from_numpy(z[b]))
    with pytest.raises(ValueError, match="another state"):
        tlc.front_run(tcfg, params, state1, xs, 0.8, True, replay=front)


@pytest.mark.parametrize("model", ["rnnoise", "deepfilter-ll", "deepfilter"])
@pytest.mark.parametrize("flags", [{}, {"limiter_enabled": False}])
def test_chain_latency_matches_reference(model, flags):
    supp_lat = int(jsupp.model_latency_ms(model) / 1e3 * 48000)
    assert tsupp.model_latency_ms(model) == jsupp.model_latency_ms(model)
    assert tlc.chain_latency_samples(tlc.LiveChainConfig(**flags), supp_lat) == \
        jlc.chain_latency_samples(jlc.LiveChainConfig(**flags), supp_lat)


def _engine_run(mod, engine, x, chunks, **kw):
    out = []
    for lo, hi in chunks:
        engine, _ = mod.engine_push(engine, x[lo:hi])
        engine, _ = mod.engine_process(engine)
        engine, y = mod.engine_pop(engine, hi - lo)
        out.append(np.asarray(y))
    return engine, np.concatenate(out)


def test_rnnoise_engine_matches_reference():
    x = _voice(5, seed=2)
    chunks = [(0, 700), (700, 1440), (1440, 2400)]  # 5 frames
    jeng, ref = _engine_run(jsupp, jsupp.engine_init("rnnoise", 0.7), x, chunks)
    teng, got = _engine_run(tsupp, tsupp.engine_init("rnnoise", 0.7, device="cpu"), x,
                            chunks)
    assert got.shape == ref.shape and got.dtype == np.float32
    _assert_audio(got, ref)
    assert teng["proc"]["smoothed_strength"] == pytest.approx(
        jeng["proc"]["smoothed_strength"], abs=1e-12)
    assert tsupp.engine_diagnostics(teng) == jsupp.engine_diagnostics(jeng)
    # the processor state round-trips through convert
    jproc = dict(jeng["proc"], params=_np_tree(jeng["proc"]["params"]),
                 model=_np_tree(jeng["proc"]["model"]))
    back = convert.to_numpy(convert.rnnoise_processor_state(jproc), jproc)
    _assert_tree_equal(back, jproc)


def test_deepfilter_ll_engine_matches_reference(monkeypatch):
    monkeypatch.setenv("AUDIOFORGE_ENABLE_DEEPFILTER", "1")
    assert tdfn.weights_source(True) == jdfn.weights_source(True) == "trained"
    x = _voice(3, seed=3)
    chunks = [(0, 1000), (1000, 1440)]  # 3 frames
    jeng, ref = _engine_run(jsupp, jsupp.engine_init("deepfilter-ll", 0.8), x, chunks)
    teng, got = _engine_run(tsupp, tsupp.engine_init("deepfilter-ll", 0.8, device="cpu"),
                            x, chunks)
    assert teng["backend_available"] and not teng["proc"]["backend_failed"]
    _assert_audio(got, ref)
    assert tsupp.engine_diagnostics(teng) == jsupp.engine_diagnostics(jeng)
    jproc = dict(jeng["proc"], params=_np_tree(jeng["proc"]["params"]),
                 model=_np_tree(jeng["proc"]["model"]))
    back = convert.to_numpy(convert.dfn_processor_state(jproc), jproc)
    _assert_tree_equal(back, jproc)
    _assert_tree_close(convert.to_numpy(teng["proc"], jproc)["model"], jproc["model"])
    # dfn_frames over a take of two frames, from the engines' final states
    frames = x[:2 * T].reshape(2, T)
    _, jwet = jdfn.dfn_frames(jeng["proc"]["params"], jeng["proc"]["model"], frames)
    tstate = convert.dfn_processor_state(jproc)["model"]
    _, twet = tdfn.dfn_frames(teng["proc"]["params"], tstate, torch.from_numpy(frames)[None])
    assert twet.shape == (1, 2, T)
    _assert_audio(twet[0].numpy(), np.asarray(jwet))
    # prepare builds the frame step ahead of the first frame (no capture here)
    prepared = tsupp.engine_prepare(tsupp.engine_init("deepfilter-ll", device="cpu"))
    assert isinstance(prepared["proc"]["replay"], BlockReplay)
    assert prepared["proc"]["replay"].state is prepared["proc"]["model"]


def test_unavailable_backends_pass_through_at_latency(monkeypatch):
    x = _voice(4, seed=4)
    chunks = [(0, 900), (900, 1920)]
    monkeypatch.delenv("AUDIOFORGE_ENABLE_DEEPFILTER", raising=False)
    jeng, ref = _engine_run(jsupp, jsupp.engine_init("deepfilter"), x, chunks)
    teng, got = _engine_run(tsupp, tsupp.engine_init("deepfilter", device="cpu"), x, chunks)
    assert not teng["backend_available"]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[1440:], x[:1920 - 1440])  # 30 ms late
    assert tsupp.engine_diagnostics(teng) == jsupp.engine_diagnostics(jeng)
    # with the opt-in, seeded structural weights are refused
    monkeypatch.setenv("AUDIOFORGE_ENABLE_DEEPFILTER", "1")
    monkeypatch.setattr(tdfn, "weights_source", lambda low_latency=True: "seeded")
    monkeypatch.setattr(jdfn, "weights_source", lambda low_latency=True: "seeded")
    teng = tsupp.engine_init("deepfilter-ll", device="cpu")
    jeng = jsupp.engine_init("deepfilter-ll")
    assert not teng["backend_available"] and teng["error"] == jeng["error"]
    teng, got = _engine_run(tsupp, teng, x, chunks)
    np.testing.assert_array_equal(got[480:], x[:1920 - 480])


def test_vad_stream_matches_reference():
    x = _voice(10, seed=5)
    jst = jsil.vad_stream_init(48000)
    tst = tsil.vad_stream_init(48000, device="cpu")
    probs = []
    for lo, hi in ((0, 1000), (1000, 1536), (1536, 3000), (3000, 4608)):  # 3 windows
        jst, jp = jsil.vad_stream_process(jst, x[lo:hi])
        tst, tp = tsil.vad_stream_process(tst, x[lo:hi])
        assert tp == pytest.approx(jp, abs=1e-3)
        probs.append(tp)
    assert tst["has_inference"] and tst["replay"] is not None
    ref = dict(jst, params=_np_tree(jst["params"]), context=np.asarray(jst["context"]),
               lstm_state=np.asarray(jst["lstm_state"]), dec3=_np_tree(jst["dec3"]))
    got = convert.to_numpy(tst, ref)
    _assert_tree_close({k: got[k] for k in ("context", "lstm_state", "dec3")},
                       {k: ref[k] for k in ("context", "lstm_state", "dec3")})
    assert got["smoothed_prob"] == pytest.approx(ref["smoothed_prob"], abs=1e-3)
    _assert_tree_equal(convert.to_numpy(convert.vad_stream_state(ref), ref), ref)


def test_rnnoise_processor_keeps_its_frame_graph():
    x = _voice(3, seed=6)
    state = trn.processor_init(device="cpu")
    assert state["replay"] is None
    state, _ = trn.processor_push(state, x[:960])
    state, n = trn.processor_process(state)
    replay, model = state["replay"], state["model"]
    assert n == 2 and isinstance(replay, BlockReplay) and replay.state is model
    state, _ = trn.processor_push(state, x[960:])
    state, n = trn.processor_process(state)
    assert n == 1 and state["replay"] is replay and state["model"] is model
    assert replay.n_captures == 0  # the CPU runs the step eagerly
    state = trn.processor_soft_reset(state)
    assert state["replay"] is replay


def test_rnnoise_processor_take_mode_matches_the_frame_replay():
    """``take=True`` (the offline callers' one take graph) gives the frame
    replay's output and keeps the static model state in place."""
    x = _voice(5, seed=7)
    outs = []
    for take in (False, True):
        state = trn.processor_init(strength=0.7, device="cpu")
        model = state["model"]
        for lo, hi in ((0, 1500), (1500, x.size)):
            state, _ = trn.processor_push(state, x[lo:hi])
            state, _ = trn.processor_process(state, take=take)
        assert state["model"] is model
        assert (state["replay"] is None) == take
        state, out = trn.processor_pop(state, x.size)
        outs.append((out, {k: v.clone() for k, v in model.items()}))
    (live, live_model), (offline, offline_model) = outs
    assert live.size == offline.size == 5 * 480
    np.testing.assert_allclose(offline, live, rtol=0, atol=1e-6)
    for k in live_model:
        torch.testing.assert_close(offline_model[k], live_model[k], rtol=0, atol=1e-4)


def test_live_state_round_trips_through_convert():
    for cfg in (jlc.LiveChainConfig(), jlc.LiveChainConfig(cleanup_mode=2, gate_mode=2)):
        ref = _np_tree(jlc.live_init(cfg))
        state = convert.live_state(ref)
        assert state["in_rms_acc"].shape == (1,)
        assert state["meter_coeff"].shape == ()
        assert state["eq"]["z"].dtype == torch.float64
        _assert_tree_equal(convert.to_numpy(state, ref), ref)
