"""Port parity of the serving step's model stages: the in-step Silero VAD and
the DeepFilterNet3 suppressors (LL and standard), against the JAX
``_serving_step``, and the suppressor's failure handling.

Each path runs at capacity 3 with the trained archives: the reference steps
one block from its fresh state, its state is handed to the port through
``convert`` (which also takes the weights), then both step the next three
blocks with a reset of slot 1 in the second of them. The VAD path runs the
VAD-assisted gate, so the in-step probability reaches the gate, and its
third block is its first warm one (after 4 blocks); it runs without a
suppressor, whose RNNoise form ``test_torch_serving.py`` covers (RNNoise's
cepstral memory drifts from the reference's within a few frames, ROADMAP
F4). The reference is
built with the integer cleanup code 0 (ROADMAP F1). Tolerances, those of the
serving tests: audio RMS <= 1e-4 / max <= 1e-3, dB metrics and the VAD
probability <= 1e-2 / 1e-3, integer counters and flags exact, other state
1e-3, of a leaf's largest magnitude where that is above 1: DeepFilterNet3's
feature and activation histories (``spec_feat_hist``, ``c0_hist``) hold
unit-normed spectra and conv outputs up to ~100, where the two FFTs' f32
rounding of a small bin, divided by its small norm, reaches a few 1e-3.

On the port alone: the dry path of each model is as many blocks behind as
its latency (one for LL, three for the standard model) at strength 0; a
non-finite model output bypasses to the dry path, three of them within 2 s
soft-reset the model state to a fresh one (the norms back at their linspace
starts), and the standard model alone latches the slot failed for good; the
reference's ``_supp_step`` on the same blocks agrees.
"""

import numpy as np
import pytest
import torch

# the jaxlib serializer can crash writing large serving executables — see
# the conftest fixture
pytestmark = pytest.mark.usefixtures("no_persistent_cache")

import jax
import jax.numpy as jnp

from audioforge_tpu.ops import gate as jgate
from audioforge_tpu.runtime import live_chain as jlc
from audioforge_tpu.runtime import serving as jsv
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.models import dfn3 as tdfn
from audioforge_tpu_torch.runtime import live_chain as tlc
from audioforge_tpu_torch.runtime import serving as tsv

N, T = 3, 480
PORT_BLOCKS = 3
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def _audio(n_blocks, seed):
    """``[n_blocks, N, 480]``: stream 0 a harmonic tone with pauses over
    noise, stream 1 noise at -30 dBFS with a transient over full scale,
    stream 2 noise at -50 dBFS."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / 48000.0
    tone = sum(np.sin(2 * np.pi * 200.0 * h * t + h) for h in range(3, 7))
    x = np.stack([0.2 * tone * (np.sin(2 * np.pi * 2.5 * t) > -0.2),
                  0.03 * rng.standard_normal(t.size),
                  0.003 * rng.standard_normal(t.size)])
    x[:2] += 0.003 * rng.standard_normal((2, t.size))
    x[1, T + 50: T + 90] = 1.5
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
        else:  # 1e-3, of the leaf's scale where it is above 1
            np.testing.assert_allclose(p, r, rtol=1e-3,
                                       atol=1e-3 * max(1.0, float(np.abs(r).max())),
                                       err_msg=name)


def _weights(path, convert_fn):
    with np.load(path) as data:
        return convert_fn({k: data[k] for k in data.files})


PATHS = {
    # name: (suppressor, vad_enabled, gate mode)
    "vad": (None, True, jgate.VAD_ASSISTED),
    "deepfilter-ll": ("deepfilter-ll", False, jgate.THRESHOLD_ONLY),
    "deepfilter": ("deepfilter", False, jgate.THRESHOLD_ONLY),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_serving_step_with_model_stage_matches_reference(path):
    model, vad, mode = PATHS[path]
    cfg_j = jsv.ServingConfig(capacity=N, suppressor_model=model, vad_enabled=vad,
                              chain=jlc.LiveChainConfig(cleanup_mode=0, gate_mode=mode))
    cfg_t = tsv.ServingConfig(capacity=N, suppressor_model=model, vad_enabled=vad,
                              chain=tlc.LiveChainConfig(gate_mode=mode))
    eng_j = jsv.ServingEngine(cfg_j)
    for slot in range(N):  # part wet and a low threshold and ceiling, so
        # the compressor and both limiters engage
        if model is not None:
            eng_j.set_stream_suppressor(slot, strength=0.7)
        eng_j.set_stream_params(slot, compressor_threshold_db=-40.0,
                                limiter_ceiling_db=-9.0)
    params_j = eng_j._device_params()
    step_j = jax.jit(jsv._serving_step, static_argnums=(0,))

    params_t = {"chain": convert.chain_params(eng_j._params["chain"])}
    if model is not None:
        params_t["supp"] = {
            "weights": _weights(tdfn.resolve_weight_path(model == "deepfilter-ll"),
                                convert.dfn_weights),
            **convert.chain_params({k: eng_j._params["supp"][k] for k in (
                "strength", "enabled", "smoothing_coeff", "atten_lim_db",
                "post_filter_beta")})}
    if vad:
        params_t["vad"] = {
            "weights": _weights(jsv.silero.discover_model_path(), convert.silero_weights),
            **convert.chain_params(eng_j._params["vad"])}
    fresh_t = convert.serving_state(to_np(eng_j._fresh))
    assert set(fresh_t) == set(tsv._serving_state_init(cfg_t, "cpu"))

    xs = _audio(1 + PORT_BLOCKS, seed=80)
    active = np.ones(N, bool)
    vp, va = np.full(N, 0.9, np.float32), np.ones(N, bool)  # ignored with the VAD on
    state_j, _, _ = step_j(cfg_j, params_j, eng_j._fresh, eng_j._fresh,
                           jnp.asarray(xs[0]), jnp.asarray(active),
                           jnp.asarray(np.zeros(N, bool)), jnp.asarray(vp),
                           jnp.asarray(va))
    state_t = convert.serving_state(to_np(state_j))
    for b in range(1, 1 + PORT_BLOCKS):
        reset = np.array([False, b == 2, False])
        state_j, yj, mj = step_j(cfg_j, params_j, state_j, eng_j._fresh,
                                 jnp.asarray(xs[b]), jnp.asarray(active),
                                 jnp.asarray(reset), jnp.asarray(vp), jnp.asarray(va))
        state_t, yt, mt = tsv._serving_step(
            cfg_t, params_t, state_t, fresh_t, torch.as_tensor(xs[b]),
            torch.as_tensor(active), torch.as_tensor(reset), torch.as_tensor(vp),
            torch.as_tensor(va))
        _assert_audio(yt.numpy(), yj)
        for k in ("gate_gain", "compressor_gain_reduction_db", "limiter_gain_reduction_db",
                  "tp_gain_reduction_db", "output_rms_db", "noise_floor_db",
                  "gate_threshold_db"):
            np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), atol=1e-2,
                                       err_msg=k)
        np.testing.assert_allclose(mt["vad_probability"].numpy(),
                                   np.asarray(mj["vad_probability"]), atol=1e-3)
        np.testing.assert_array_equal(mt["vad_available"].numpy(),
                                      np.asarray(mj["vad_available"]))
        for k in ("suppressor_nonfinite", "suppressor_backend_failed",
                  "suppressor_vad_probability"):
            if model is not None:
                np.testing.assert_array_equal(mt[k].numpy(), np.asarray(mj[k]), err_msg=k)
    if vad:  # warm from the 4th block on; slot 1's reset restarted its warm-up
        np.testing.assert_array_equal(mt["vad_available"].numpy(), [True, False, True])
        prob = mt["vad_probability"].numpy()
        assert prob[0] > 0.5 > prob[2]
    else:
        assert not mt["suppressor_vad_probability"].any()
    ref = to_np(state_j)
    _assert_tree_close(convert.to_numpy(state_t, ref), ref)
    back = convert.serving_state(convert.to_numpy(state_t, ref))  # round trip
    for group in [g for g in ("vad", "supp") if g in state_t]:
        for k, v in convert._tree_to_numpy(state_t[group]).items():
            if not isinstance(v, dict):
                np.testing.assert_array_equal(convert._tree_to_numpy(back[group])[k], v)


def _quiet_chain():
    return tlc.LiveChainConfig(gate_enabled=False, eq_enabled=False,
                               compressor_enabled=False, limiter_enabled=False,
                               careful_output_enabled=False)


@pytest.mark.parametrize("model,delay", [("deepfilter-ll", 1), ("deepfilter", 3)])
def test_dry_path_is_as_many_blocks_behind_as_the_model(model, delay):
    """At strength 0 the output is the dry path: the suppressor-free chain's
    output ``delay`` blocks later. 25 silent blocks first bring the 15 ms
    strength EMA from 1 to 0 (within 1e-7)."""
    rng = np.random.default_rng(81)
    x = (0.2 * np.sin(2 * np.pi * 500.0 * np.arange(7 * T) / 48000.0)
         + 0.01 * rng.standard_normal(7 * T)).astype(np.float32)
    outs = {}
    for name, supp in (("model", model), ("dry", None)):
        eng = tsv.ServingEngine(tsv.ServingConfig(capacity=1, suppressor_model=supp,
                                                  chain=_quiet_chain()), device="cpu")
        got = []
        slot = eng.attach(sink=got.append)
        if supp is not None:
            eng.set_stream_suppressor(slot, strength=0.0)
        eng.push(slot, np.zeros(25 * T, np.float32))
        eng.step_many(25)
        got.clear()
        eng.push(slot, x)
        eng.step_many(7)
        outs[name] = np.concatenate(got)
    np.testing.assert_allclose(outs["model"][delay * T:], outs["dry"][:(7 - delay) * T],
                               atol=1e-6)
    assert np.abs(outs["model"][:delay * T]).max() < 1e-6  # the silence before


@pytest.mark.parametrize("model", ["deepfilter-ll", "deepfilter"])
def test_nonfinite_output_bypasses_resets_and_latches_like_reference(model):
    """Three blocks whose model output is non-finite (NaN weights), then a
    finite one: each bad block passes the dry path, the third soft-resets
    the model state; the standard model stays failed after it, LL does
    not. Checked against the reference's ``_supp_step``."""
    low = model == "deepfilter-ll"
    arrays = {k: np.asarray(v) for k, v in tdfn.init_params().items()}
    bad_arrays = {k: v * np.float32(np.nan) for k, v in arrays.items()}
    cfg_j = jsv.ServingConfig(capacity=2, suppressor_model=model)
    cfg_t = tsv.ServingConfig(capacity=2, suppressor_model=model)
    sp = {"strength": np.ones(2, np.float32), "enabled": np.ones(2, bool),
          "smoothing_coeff": np.float32(0.5), "atten_lim_db": np.float32(30.0),
          "post_filter_beta": np.float32(0.0)}
    sj = jsv._supp_state_init(cfg_j)
    st = tsv._supp_state_init(cfg_t, "cpu")
    fresh_t = tsv._supp_state_init(cfg_t, "cpu")["model"]
    x = np.random.default_rng(82).normal(0, 0.1, (5, 2, T)).astype(np.float32)
    for b in range(5):
        w = bad_arrays if 1 <= b <= 3 else arrays
        sj, yj, mj = jsv._supp_step(cfg_j, dict(sp, weights={k: jnp.asarray(v) for k, v in
                                                             w.items()}), sj, jnp.asarray(x[b]))
        st, yt, mt = tsv._supp_step(cfg_t, dict(convert.chain_params(sp),
                                                weights=convert.dfn_weights(w)),
                                    st, fresh_t, torch.as_tensor(x[b]))
        _assert_audio(yt.numpy(), yj)
        for k in ("suppressor_nonfinite", "suppressor_soft_resets",
                  "suppressor_backend_failed"):
            np.testing.assert_array_equal(mt[k].numpy(), np.asarray(mj[k]), err_msg=k)
        if 1 <= b <= 3:  # the dry path, one (LL) or three blocks behind
            behind = b - (1 if low else 3)
            dry = x[behind] if behind >= 0 else np.zeros((2, T), np.float32)
            np.testing.assert_array_equal(yt.numpy(), dry)
        if b == 3:  # the third event soft-reset the model state
            for k in ("erb_norm", "unit_norm", "enc_gru", "spec_hist"):
                np.testing.assert_array_equal(st["model"][k].numpy(), fresh_t[k].numpy())
    assert int(st["soft_resets"][0]) == 1
    assert bool(st["backend_failed"].all()) == (not low)
    _assert_tree_close(convert._tree_to_numpy(st), to_np(sj))
