"""Port parity: the smart gate (every mode) and the block-cadence VAD
auto-gate controller against the JAX reference.

The gate is a plain PyTorch per-sample loop in the port (its kernel is
queued). Tolerances: audio RMS <= 1e-4 and max abs <= 1e-3, dB <= 1e-2 dB,
integer and boolean state exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audioforge_tpu.models import vad_gate as jvad
from audioforge_tpu.ops import gate as jgate
from audioforge_tpu_torch.models import vad_gate as tvad
from audioforge_tpu_torch.ops import gate as tgate

N, T, FS = 3, 480, 48000.0

_INT_KEYS = ("hold_remaining", "chatter_window_remaining",
             "chatter_transition_count", "chatter_cooldown",
             "chatter_event_count", "gate_state", "auto_relax_remaining")
_BOOL_KEYS = ("is_open", "effective_gate_open", "fused_gate_open")


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _bursts(seed, n_blocks):
    """Speech-like bursts over a quiet floor, so the gate opens and closes."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / FS
    env = (np.sin(2 * np.pi * 6.0 * t + rng.uniform(0, 6, (N, 1))) > 0.3)
    tone = np.sin(2 * np.pi * 180.0 * t)[None]
    x = 0.2 * env * tone + 0.002 * rng.standard_normal((N, t.size))
    return x.astype(np.float32)


@pytest.mark.parametrize("mode", [jgate.THRESHOLD_ONLY, jgate.VAD_ASSISTED,
                                  jgate.VAD_ONLY],
                         ids=["threshold_only", "vad_assisted", "vad_only"])
def test_gate_matches_reference(mode):
    n_blocks = 3
    x = _bursts(20 + mode, n_blocks)
    rng = np.random.default_rng(30 + mode)
    cfg_j = jgate.GateConfig(mode=mode)
    cfg_t = tgate.GateConfig(mode=mode)
    pkw = dict(threshold_db=-30.0, attack_ms=5.0, release_ms=60.0)
    pj = jgate.gate_params(cfg_j, **pkw)
    pt = {k: torch.full((N,), float(np.float32(v)))
          for k, v in tgate.gate_params(cfg_t, **pkw).items()}
    sj = jgate.gate_init((N,))
    st = tgate.gate_init(n=N, device="cpu")
    gains = []
    for b in range(n_blocks):
        xb = x[:, b * T:(b + 1) * T]
        prob = rng.random(N).astype(np.float32)
        prob[0] = 0.95  # confident speech on stream 0
        avail = np.array([True, True, False])
        held = rng.random(N) > 0.5
        vthr = np.full(N, 0.48, np.float32)
        sj, yj, mj = jgate.gate_process(
            cfg_j, sj, jnp.asarray(xb), vad_probability=jnp.asarray(prob),
            vad_available=jnp.asarray(avail), vad_gate_open=jnp.asarray(held),
            vad_threshold=jnp.asarray(vthr), params=pj)
        st, yt, mt = tgate.gate_process(
            cfg_t, st, torch.as_tensor(xb), torch.as_tensor(prob),
            torch.as_tensor(avail), torch.as_tensor(held), torch.as_tensor(vthr), pt)
        _assert_audio(yt.numpy(), yj)
        for k in _INT_KEYS + _BOOL_KEYS:
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]), err_msg=k)
        np.testing.assert_allclose(st["detector_level_db"].numpy(),
                                   np.asarray(sj["detector_level_db"]), atol=1e-2)
        np.testing.assert_allclose(st["current_gain"].numpy(),
                                   np.asarray(sj["current_gain"]), atol=1e-4)
        np.testing.assert_allclose(st["vad_smoothed_probability"].numpy(),
                                   np.asarray(sj["vad_smoothed_probability"]), atol=1e-5)
        gains.append(np.abs(yt.numpy()) / np.maximum(np.abs(xb), 1e-9))
    gains = np.concatenate(gains, axis=-1)[np.abs(x) > 1e-3]
    assert gains.min() < 0.01 and gains.max() > 0.1  # the gate closed and opened


@pytest.mark.parametrize("mode", [jvad.THRESHOLD_ONLY, jvad.VAD_ASSISTED],
                         ids=["threshold_only", "vad_assisted"])
def test_vad_gate_matches_reference(mode):
    cfg_j = jvad.VadGateConfig(gate_mode=mode)
    cfg_t = tvad.VadGateConfig(gate_mode=mode)
    sj = jvad.vad_gate_init(cfg_j, (N,))
    st = tvad.vad_gate_init(cfg_t, n=N, device="cpu")
    params = {"vad_threshold": 0.48, "margin_db": 10.0, "hold_time_ms": 200.0}
    pt = {k: torch.full((N,), v) for k, v in params.items()}
    pj = {k: jnp.float32(v) for k, v in params.items()}
    rng = np.random.default_rng(40 + mode)
    for _ in range(40):
        rms_db = rng.uniform(-75.0, -15.0, N).astype(np.float32)
        prob = rng.random(N).astype(np.float32)
        avail = rng.random(N) > 0.3
        sj, oj = jvad.vad_gate_process(cfg_j, sj, jnp.asarray(rms_db),
                                       jnp.asarray(prob), jnp.asarray(avail),
                                       T, params=pj)
        st, ot = tvad.vad_gate_process(cfg_t, st, torch.as_tensor(rms_db),
                                       torch.as_tensor(prob), torch.as_tensor(avail),
                                       T, params=pt)
        np.testing.assert_array_equal(ot["gate_open"].numpy(), np.asarray(oj["gate_open"]))
        for k in ("threshold_db", "noise_floor_db"):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-2)
        np.testing.assert_allclose(ot["reliability"].numpy(),
                                   np.asarray(oj["reliability"]), atol=1e-5)
    for k in ("hist_len", "hist_cursor", "bins", "timer_running", "prev_gate_open"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]), err_msg=k)
