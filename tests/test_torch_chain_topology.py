"""Port parity for the live chain's topology switches: the port's
``front_block`` and ``back_block`` against the JAX halves (batched over the
stream axis as the reference's serving step maps them), block after block,
with the evidence ``front_block`` makes feeding ``back_block``.

Four configurations group the switches of ``LiveChainConfig`` so that the
reference compiles few halves: no gate and no EQ; no compressor and no
careful-output ceiling; no limiter (the back half's detector-only true-peak
branch); adaptive release with auto makeup. The reference runs cleanup mode
0 (its string modes run strong cleanup, ROADMAP F1). A low compressor
threshold and limiter ceiling and a transient over full scale make the
dynamics stages engage. Tolerances as in ``test_torch_serving.py``: audio
RMS <= 1e-4 / max <= 1e-3, dB metrics <= 1e-2 dB, integer state exact,
other state 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioforge_tpu.runtime import live_chain as jlc
from audioforge_tpu.runtime import serving as jsv
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.runtime import live_chain as tlc

N, T, BLOCKS = 2, 480, 3

CONFIGS = {
    "no gate, no EQ": {"gate_enabled": False, "eq_enabled": False},
    "no compressor, no careful output": {"compressor_enabled": False,
                                         "careful_output_enabled": False},
    "no limiter (detector only)": {"limiter_enabled": False},
    "adaptive release, auto makeup": {"adaptive_release": True,
                                      "auto_makeup_enabled": True},
}
CONTROLS = {"compressor_threshold_db": -40.0, "limiter_ceiling_db": -9.0}


def _audio(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(BLOCKS * T) / 48000.0
    voiced = sum(np.sin(2 * np.pi * 140.0 * h * t + h) / h for h in range(1, 8))
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)
    x = 0.5 * (env * voiced)[None] * rng.uniform(0.5, 1.5, (N, 1))
    x = x + 0.003 * rng.standard_normal((N, t.size))
    x[0, T + 50: T + 90] *= 5.0  # a transient over full scale
    return x.astype(np.float32).reshape(N, BLOCKS, T).transpose(1, 0, 2)


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
        else:
            np.testing.assert_allclose(p, r, rtol=1e-3, atol=1e-3, err_msg=name)


def _evidence(vp, va, fm, to_float):
    return {"vad_probability": vp, "vad_reliability": to_float(va),
            "noise_floor_db": fm["noise_floor_db"],
            "live_noise_reliability": fm["noise_floor_reliability"]}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_halves_match_reference(name):
    flags = CONFIGS[name]
    cfg_j = jlc.LiveChainConfig(cleanup_mode=0, **flags)
    cfg_t = tlc.LiveChainConfig(**flags)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)

    params_np = jax.tree_util.tree_map(lambda v: np.full(N, v, np.float32),
                                       jlc.live_params(cfg_j, **CONTROLS))
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    params_t = convert.chain_params(params_np)
    state_j = jlc.live_init(cfg_j, batch_shape=(N,))
    state_t = convert.serving_state({"chain": to_np(state_j)})["chain"]

    axes = jsv._chain_state_axes(
        jsv.ServingConfig(capacity=N, chain=cfg_j, suppressor_model=None), state_j)
    front = jax.jit(jax.vmap(
        lambda p, s, xb, vp, va: jlc.front_block(cfg_j, p, s, xb, vp, va),
        in_axes=(0, axes, 0, 0, 0), out_axes=(axes, 0, 0)))
    back = jax.jit(jax.vmap(
        lambda p, s, xb, ev: jlc.back_block(cfg_j, p, s, xb, ev),
        in_axes=(0, axes, 0, 0), out_axes=(axes, 0, 0)))

    vp, va = np.zeros(N, np.float32), np.zeros(N, bool)
    vp_t, va_t = torch.as_tensor(vp), torch.as_tensor(va)
    limited = 0.0
    for xb in _audio(seed=70):
        state_j, yj, fmj = front(params_j, state_j, jnp.asarray(xb), jnp.asarray(vp),
                                 jnp.asarray(va))
        state_t, yt, fmt = tlc.front_block(cfg_t, params_t, state_t,
                                           torch.as_tensor(xb), vp_t, va_t)
        _assert_audio(yt.numpy(), yj)
        state_j, yj, bmj = back(params_j, state_j, yj,
                                _evidence(jnp.asarray(vp), jnp.asarray(va), fmj,
                                          lambda a: a.astype(jnp.float32)))
        state_t, yt, bmt = tlc.back_block(cfg_t, params_t, state_t, yt,
                                          _evidence(vp_t, va_t, fmt,
                                                    lambda a: a.to(torch.float32)))
        _assert_audio(yt.numpy(), yj)
        metrics_t, metrics_j = {**fmt, **bmt}, {**fmj, **bmj}
        assert set(metrics_t) == set(metrics_j)
        for k in ("gate_gain", "noise_floor_db", "gate_threshold_db",
                  "compressor_gain_reduction_db", "compressor_makeup_gain_db",
                  "limiter_gain_reduction_db", "tp_gain_reduction_db",
                  "output_true_peak", "output_rms_db"):
            np.testing.assert_allclose(metrics_t[k].numpy(), np.asarray(metrics_j[k]),
                                       atol=1e-2, err_msg=k)
        limited = max(limited, float(np.asarray(bmj["tp_gain_reduction_db"]).max()),
                      float(np.asarray(bmj["limiter_gain_reduction_db"]).max()))
    # the dynamics stages this configuration keeps were engaged
    if cfg_j.compressor_enabled:
        assert float(np.asarray(bmj["compressor_gain_reduction_db"]).max()) > 0.0
    if cfg_j.limiter_enabled:
        assert limited > 0.0
    ref = to_np(state_j)
    _assert_tree_close(convert.to_numpy({"chain": state_t}, {"chain": ref})["chain"], ref)
