"""Port parity: gentle and strong input cleanup (hum tracking and notches,
rumble detection and the owned adaptive high-pass) against the JAX
reference.

The reference is built with the integer cleanup codes 1/2: the live chain's
string modes reach ``routing_process`` uncompared (ROADMAP F1). On CPU the
port runs ``cleanup_scan_plain``, the plain twin of the ``cleanup_scan``
CUDA kernel, with f64 notch state where the reference runs compensated f32
scans. Streams: hum at 50.4 Hz with its harmonic under a voice, hum at
59.7 Hz, and a hum-free voice with low plosive thumps (rumble).

Two starts: the fresh state, and a reference state handed over through
``convert`` after 55 blocks, with the hum confirmed and the notches engaged,
whose ``window_pos`` makes the next window end inside a block the port runs.
Tolerances: audio RMS <= 1e-4 and max abs <= 1e-3; integer state,
``hum_detected``/``rumble_detected``/``selected_hp_hz`` exact; other state
1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioforge_tpu.ops import routing as jroute
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.ops import routing as troute

N, T, FS = 3, 480, 48000.0
MODES = {"gentle": jroute.CLEANUP_GENTLE, "strong": jroute.CLEANUP_STRONG}
HANDOVER_BLOCKS = 55
# windows (12000 samples) then complete at samples 3100, 15100 and 27100:
# the third inside block 56, after the handover at 55 * 480 = 26400
WINDOW_POS0 = 8900


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
        if r.dtype.kind in "biu" or k == "selected_hp_hz":
            np.testing.assert_array_equal(p, r, err_msg=name)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-3, atol=1e-3, err_msg=name)


def _capture(n_blocks, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / FS
    voice = 0.08 * np.sin(2 * np.pi * 190.0 * t) * (np.sin(2 * np.pi * 3.0 * t) > 0)
    x = np.stack([
        0.05 * np.sin(2 * np.pi * 50.4 * t + 0.3)
        + 0.02 * np.sin(2 * np.pi * 100.8 * t) + voice,
        0.04 * np.sin(2 * np.pi * 59.7 * t + 1.1) + 0.5 * voice,
        voice.copy(),
    ])
    for at in range(2000, t.size - 1500, 9000):  # plosive thumps
        x[2, at:at + 1500] += 0.7 * np.hanning(1500)
    x += 0.003 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def _run_reference(cfg, state, x, n_blocks):
    for b in range(n_blocks):
        state, _, _ = jroute.routing_process(cfg, state, jnp.asarray(x[:, b * T:(b + 1) * T]))
    return state


@pytest.mark.parametrize("start", ["fresh", "handover"])
@pytest.mark.parametrize("mode", list(MODES), ids=list(MODES))
def test_cleanup_matches_reference(mode, start):
    code = MODES[mode]
    cfg_j = jroute.RoutingConfig(cleanup_mode=code)
    cfg_t = troute.RoutingConfig(cleanup_mode=code)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    n_port = 4 if start == "fresh" else 3
    first = 0 if start == "fresh" else HANDOVER_BLOCKS
    x = _capture(first + n_port, seed=80 + code)
    sj = jroute.routing_init(cfg_j, (N,))
    if start == "handover":
        sj = dict(sj, window_pos=jnp.full((N,), WINDOW_POS0, jnp.int32))
        sj = _run_reference(cfg_j, sj, x, HANDOVER_BLOCKS)
        assert bool(np.asarray(sj["hum_detected"])[0])  # confirmed before the handover
        assert float(np.asarray(sj["hum_strength"])[0]) > 0.5
        st = convert.routing_state(to_np(sj))
    else:
        st = troute.routing_init(cfg_t, n=N, device="cpu")
        _assert_tree_close(convert.routing_to_numpy(st), to_np(sj))
    crossed = False
    for b in range(first, first + n_port):
        xb = x[:, b * T:(b + 1) * T]
        pos = np.asarray(sj["window_pos"])
        crossed |= bool(((pos + T > 12000) & (pos + T - 12000 < T)).any())
        sj, yj, mj = jroute.routing_process(cfg_j, sj, jnp.asarray(xb))
        st, yt, mt = troute.routing_process(cfg_t, st, torch.as_tensor(xb))
        _assert_audio(yt.numpy(), yj)
        for k in ("hum_detected", "rumble_detected", "selected_hp_hz"):
            np.testing.assert_array_equal(mt[k].numpy(), np.asarray(mj[k]), err_msg=k)
        for k in ("hum_line_hz", "hum_strength"):
            np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), atol=1e-3,
                                       err_msg=k)
    _assert_tree_close(convert.routing_to_numpy(st), to_np(sj))
    if start == "handover":
        assert crossed  # a window ended inside a block the port ran
    assert bool(np.asarray(mj["rumble_detected"])[2]) or start == "fresh"


def test_convert_round_trips_every_routing_leaf():
    cfg = troute.RoutingConfig(cleanup_mode=troute.CLEANUP_STRONG)
    st = troute.routing_init(cfg, n=2, device="cpu")
    st, _, _ = troute.routing_process(cfg, st, torch.as_tensor(_capture(1, 90)[:2]))
    back = convert.routing_state(convert.routing_to_numpy(st))

    def check(a, b):
        for k, v in a.items():
            if isinstance(v, dict):
                check(v, b[k])
            else:
                assert b[k].dtype == v.dtype and b[k].shape == v.shape, k
                np.testing.assert_allclose(b[k].double().numpy(), v.double().numpy(),
                                           rtol=1e-6, err_msg=k)
    check(st, back)
