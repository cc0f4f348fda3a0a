"""Port parity: max-affine scan, lookahead limiter, true-peak detector and
limiter (``audioforge_tpu_torch.ops``) against the JAX reference on CPU.

Inputs are made with numpy from a seed and fed to both packages; on CPU
tensors the port runs each kernel's plain PyTorch twin.
Tolerances: audio RMS <= 1e-4 and max abs <= 1e-3 (BASELINE.md budget),
dB metrics <= 1e-2 dB, integer state exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioforge_tpu.ops import limiter as jlim
from audioforge_tpu.ops import scan as jscan
from audioforge_tpu.ops import true_peak as jtp
from audioforge_tpu_torch.ops import limiter as tlim
from audioforge_tpu_torch.ops import scan as tscan
from audioforge_tpu_torch.ops import true_peak as ttp

N, T = 3, 480


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _assert_audio(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = port - ref
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _signal(rng, n_blocks, transient_gain=3.0):
    t = np.arange(n_blocks * T) / 48000.0
    x = 0.4 * np.sin(2 * np.pi * 220.0 * t)[None] * (1.0 + 0.5 * rng.random((N, 1)))
    x = x + 0.05 * rng.standard_normal((N, n_blocks * T))
    x[:, T + 100: T + 140] *= transient_gain  # a transient over full scale
    return x.astype(np.float32)


def test_max_affine_scan_matches_reference():
    rng = np.random.default_rng(1)
    v = rng.random((N, T)).astype(np.float32)
    rho = rng.uniform(0.9, 0.999, N).astype(np.float32)
    c = ((1.0 - rho)[:, None] * v).astype(np.float32)
    u0 = rng.random(N).astype(np.float32)
    ref = jscan.max_affine_scan(jnp.asarray(v), jnp.asarray(rho)[:, None],
                                jnp.asarray(c), jnp.asarray(u0))
    port = tscan.max_affine_scan(_t(v), _t(rho), _t(c), _t(u0))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("kind", ["limiter", "true-peak"])
def test_limiter_gain_scan_matches_reference(kind):
    """The gain stage both limiters call against the reference's lines for it
    (``ops/limiter.py:127-139`` with scale 1, ``ops/true_peak.py:184-205`` with
    0.999), on windows of longer rows as the limiters pass them."""
    rng = np.random.default_rng(7)
    W = 96 if kind == "limiter" else 20
    ext = np.concatenate([_signal(rng, 1)[:, -W:], _signal(rng, 2)[:, T:]], axis=-1)
    peak_ext = (np.abs(ext) * rng.uniform(1.0, 1.3, ext.shape)).astype(np.float32)
    ceiling = rng.uniform(0.6, 0.9, N).astype(np.float32)
    rc = np.full(N, np.exp(-1.0 / (0.02 * 48000.0)), np.float32)
    gain0 = np.array([1.0, 0.5, 0.8], np.float32)
    scale = 1.0 if kind == "limiter" else 0.999
    peak, delayed = jnp.asarray(peak_ext[:, W:]), jnp.asarray(ext[:, :T])
    cj = jnp.asarray(ceiling)[:, None]
    quotient = cj * jnp.float32(scale) / jnp.maximum(peak, 1e-30)
    target = jnp.where(peak > cj, quotient if kind == "limiter"
                       else jnp.clip(quotient, 0.0, 1.0), 1.0)
    v = 1.0 - target
    rj = jnp.asarray(rc)[:, None]
    u = jscan.max_affine_scan(v, rj, (1.0 - rj) * v, 1.0 - jnp.asarray(gain0))
    gain = 1.0 - u
    y_ref = jnp.clip(delayed * gain, -cj, cj)
    g_prev = jnp.concatenate([jnp.asarray(gain0)[:, None], gain[:, :-1]], axis=-1)
    y, gain_last, min_gain, events = tscan.limiter_gain_scan(
        _t(peak_ext)[:, W:], _t(ext)[:, :T], _t(ceiling), _t(rc), _t(gain0), scale)
    _assert_audio(y.numpy(), y_ref)
    np.testing.assert_allclose(gain_last.numpy(), np.asarray(gain[:, -1]), atol=1e-5)
    np.testing.assert_allclose(min_gain.numpy(), np.asarray(gain.min(axis=-1)), atol=1e-5)
    np.testing.assert_array_equal(events.numpy(),
                                  np.asarray(jnp.any(target < g_prev, axis=-1)))
    assert events.numpy().all() and float(min_gain.min()) < 0.5  # the transient limited


def test_limiter_matches_reference():
    rng = np.random.default_rng(2)
    x = _signal(rng, 3)
    cfg_j = jlim.LimiterConfig(ceiling_db=-1.5)
    cfg_t = tlim.LimiterConfig(ceiling_db=-1.5)
    sj = jlim.limiter_init(cfg_j, (N,))
    st = tlim.limiter_init(cfg_t, n=N, device="cpu")
    pj = jlim.limiter_params(cfg_j)
    pt = {k: torch.full((N,), float(v), dtype=torch.float32)
          for k, v in tlim.limiter_params(cfg_t).items()}
    peak_gr = 0.0
    for b in range(3):
        xb = x[:, b * T:(b + 1) * T]
        sj, yj, mj = jlim.limiter_process(cfg_j, sj, jnp.asarray(xb), params=pj)
        st, yt, mt = tlim.limiter_process(cfg_t, st, _t(xb), params=pt)
        _assert_audio(yt.numpy(), yj)
        np.testing.assert_allclose(mt["peak_gr_db"].numpy(),
                                   np.asarray(mj["peak_gr_db"]), atol=1e-2)
        peak_gr = max(peak_gr, float(np.max(np.asarray(mj["peak_gr_db"]))))
    assert peak_gr > 0.0  # the transient engaged the limiter
    np.testing.assert_allclose(st["gain"].numpy(), np.asarray(sj["gain"]), atol=1e-5)
    np.testing.assert_allclose(st["history"].numpy(), np.asarray(sj["history"]))


def test_true_peak_detector_matches_reference():
    rng = np.random.default_rng(3)
    x = _signal(rng, 3)
    sj = jtp.detector_init((N,))
    st = ttp.detector_init(n=N, device="cpu")
    for b in range(3):
        xb = x[:, b * T:(b + 1) * T]
        sj, pj = jtp.detector_process(sj, jnp.asarray(xb))
        st, pt = ttp.detector_process(st, _t(xb))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-6)


def test_true_peak_limiter_matches_reference():
    rng = np.random.default_rng(4)
    x = _signal(rng, 3, transient_gain=4.0)
    cfg_j = jtp.TruePeakLimiterConfig()
    cfg_t = ttp.TruePeakLimiterConfig()
    ceiling = float(10.0 ** (-1.5 / 20.0))
    sj = jtp.tp_limiter_init((N,))
    st = ttp.tp_limiter_init(n=N, device="cpu")
    limited = 0
    for b in range(3):
        xb = x[:, b * T:(b + 1) * T]
        sj, yj, mj = jtp.tp_limiter_process(cfg_j, sj, jnp.asarray(xb),
                                            ceiling_linear=ceiling)
        st, yt, mt = ttp.tp_limiter_process(
            cfg_t, st, _t(xb), torch.full((N,), ceiling, dtype=torch.float32))
        _assert_audio(yt.numpy(), yj)
        np.testing.assert_array_equal(mt["limited_events"].numpy(),
                                      np.asarray(mj["limited_events"]))
        np.testing.assert_allclose(mt["max_gain_reduction_db"].numpy(),
                                   np.asarray(mj["max_gain_reduction_db"]), atol=1e-2)
        np.testing.assert_allclose(mt["output_true_peak"].numpy(),
                                   np.asarray(mj["output_true_peak"]), atol=1e-5)
        limited += int(np.asarray(mj["limited_events"]).sum())
        assert np.abs(yt.numpy()).max() <= ceiling + 1e-6
    assert limited > 0  # the transient engaged the limiter


@pytest.mark.parametrize("window", [1, 5, 97])
def test_sliding_window_max_matches_reference(window):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, T)).astype(np.float32)
    init = rng.standard_normal((N, max(window - 1, 1))).astype(np.float32)
    init = init[:, : window - 1] if window > 1 else None
    ref = jscan.sliding_window_max(jnp.asarray(x), window,
                                   None if init is None else jnp.asarray(init))
    port = tscan.sliding_window_max(_t(x), window,
                                    None if init is None else _t(init))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_one_pole_scan_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((N, T)).astype(np.float32)
    coeff = rng.uniform(0.9, 0.999, (N, T)).astype(np.float32)
    y0 = rng.standard_normal(N).astype(np.float32)
    ref = jscan.one_pole_scan(jnp.asarray(x), jnp.asarray(coeff), jnp.asarray(y0))
    port = tscan.one_pole_scan(_t(x), _t(coeff), _t(y0))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
