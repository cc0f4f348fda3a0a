"""Port parity: the crossfaded biquad unit, the EQ cascade, the K-weighted
loudness meter and the routing cleanup-off path against the JAX reference.

The port runs every section with f64 state in one cascade; the reference
runs double-word-f32 or f32 scans. Tolerances: audio RMS <= 1e-4 and max
abs <= 1e-3, dB <= 1e-2, fade counters exact. The EQ cases keep the default
band layout (the reference picks its precision by band index).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioforge_tpu.ops import biquad as jbq
from audioforge_tpu.ops import eq as jeq
from audioforge_tpu.ops import loudness as jloud
from audioforge_tpu.ops import routing as jroute
from audioforge_tpu_torch.ops import biquad as tbq
from audioforge_tpu_torch.ops import eq as teq
from audioforge_tpu_torch.ops import loudness as tloud
from audioforge_tpu_torch.ops import routing as troute

N, T, FS = 2, 480, 48000.0
BENCH_GAINS = [-2.5, 1.5, -1.0, 2.0, 3.0, 2.5, 1.5, -2.0, 1.0, -1.5]


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _noise(seed, n_blocks, scale=0.2):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((N, n_blocks * T))).astype(np.float32)


def _bench_bands(mod):
    return [mod.EqBandConfig(b.filter_type, b.frequency_hz, g, 4.33,
                             b.slope_db_per_octave, True)
            for b, g in zip(mod.default_bands(), BENCH_GAINS)]


def test_unit_crossfade_in_flight_matches_reference():
    old = jbq.design(jbq.PEAKING, 1000.0, 6.0, 2.0, FS)
    new = jbq.design(jbq.PEAKING, 1500.0, -4.0, 1.0, FS)
    x = _noise(10, 3)
    sj = jbq.unit_init(jnp.asarray(np.broadcast_to(old, (N, 5)), jnp.float32))
    st = tbq.unit_init(old[None], N, "cpu")
    fade = 700  # spans the block boundary
    for b in range(3):
        if b == 1:
            sj = jbq.unit_schedule(sj, jnp.asarray(new, jnp.float32), fade)
            st = tbq.unit_schedule(st, new, fade)
        xb = x[:, b * T:(b + 1) * T]
        sj, yj = jbq.unit_process(sj, jnp.asarray(xb))
        st, yt = tbq.unit_process(st, _t(xb))
        _assert_audio(yt.numpy(), yj)
        np.testing.assert_array_equal(st["fade_remaining"][:, 0].numpy(),
                                      np.asarray(sj["fade_remaining"]))
        np.testing.assert_array_equal(st["fade_total"][:, 0].numpy(),
                                      np.asarray(sj["fade_total"]))
        np.testing.assert_allclose(st["z"][:, 0].numpy(), np.asarray(sj["z"]),
                                   atol=1e-5)
    np.testing.assert_array_equal(st["coeffs"][:, 0].numpy(), np.asarray(sj["coeffs"]))


@pytest.mark.parametrize("S", [2, 10])
def test_cascade_crossfade_ending_mid_block_matches_reference(S):
    """S sections in series (the port's plain twin in one cascade; the
    reference's ``unit_process`` per section, chained); the even sections
    crossfade over 700 samples from block 1, ending at t = 220 of block 2,
    the odd ones stay idle."""
    rng = np.random.default_rng(20 + S)
    freqs = np.geomspace(80.0, 10000.0, S)
    old = np.stack([jbq.design(jbq.PEAKING, f, g, 2.0, FS)
                    for f, g in zip(freqs, rng.uniform(-4, 4, S))])
    new = np.stack([jbq.design(jbq.PEAKING, f * 1.3, g, 1.2, FS)
                    for f, g in zip(freqs, rng.uniform(-4, 4, S))])
    fading = np.arange(S) % 2 == 0
    fade = 700
    x = _noise(30 + S, 3)
    sj = [jbq.unit_init(jnp.asarray(np.broadcast_to(c, (N, 5)), jnp.float32))
          for c in old]
    st = tbq.unit_init(old, N, "cpu")
    for b in range(3):
        if b == 1:
            sj = [jbq.unit_schedule(s, jnp.asarray(new[i], jnp.float32), fade)
                  if fading[i] else s for i, s in enumerate(sj)]
            sub = tbq.unit_schedule({k: v[:, fading] for k, v in st.items()},
                                    new[fading], fade)
            st = {k: v.clone() for k, v in st.items()}
            for k, v in sub.items():
                st[k][:, fading] = v
        xb = x[:, b * T:(b + 1) * T]
        yj = jnp.asarray(xb)
        for i in range(S):
            sj[i], yj = jbq.unit_process(sj[i], yj)
        st, yt = tbq.unit_process(st, _t(xb))
        _assert_audio(yt.numpy(), yj)
        np.testing.assert_array_equal(
            st["fade_remaining"].numpy(),
            np.stack([np.asarray(s["fade_remaining"]) for s in sj], axis=1))
        np.testing.assert_array_equal(
            st["fade_total"].numpy(),
            np.stack([np.asarray(s["fade_total"]) for s in sj], axis=1))
    assert not st["fade_remaining"].any()  # every crossfade ended in block 2
    np.testing.assert_array_equal(
        st["coeffs"][:, :, 0].numpy(),
        np.stack([np.asarray(s["coeffs"])[:, 0] for s in sj], axis=1))


def test_eq_with_band_edit_matches_reference():
    x = _noise(11, 3)
    sj = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (N,) + a.shape), jeq.eq_init(_bench_bands(jeq), FS))
    st = teq.eq_init(_bench_bands(teq), FS, n=N, device="cpu")
    run_j = jax.jit(jax.vmap(jeq.eq_process))
    edit = jax.vmap(lambda s: jeq.eq_set_band(
        s, 4, jeq.EqBandConfig(1, 1500.0, -6.0, 2.0), FS))
    for b in range(3):
        if b == 1:
            sj = edit(sj)
            st = teq.eq_set_band(st, 4, teq.EqBandConfig(1, 1500.0, -6.0, 2.0), FS)
        xb = x[:, b * T:(b + 1) * T]
        sj, yj = run_j(sj, jnp.asarray(xb))
        st, yt = teq.eq_process(st, _t(xb))
        _assert_audio(yt.numpy(), yj)
    remaining = np.concatenate([np.asarray(sj["lo"]["fade_remaining"]),
                                np.asarray(sj["hi"]["fade_remaining"])], axis=1)
    np.testing.assert_array_equal(st["fade_remaining"].numpy(), remaining)


def test_loudness_meter_matches_reference():
    n_blocks = 42  # the 400 ms window fills after 40 blocks
    x = _noise(12, n_blocks, scale=0.1)
    sj = jloud.meter_init(FS, T, (N,))
    st = tloud.meter_init(FS, T, n=N, device="cpu")
    step_j = jax.jit(jloud.meter_process)
    for b in range(n_blocks):
        xb = x[:, b * T:(b + 1) * T]
        sj, lj = step_j(sj, jnp.asarray(xb))
        st, lt = tloud.meter_process(st, _t(xb))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-2)
    assert float(np.asarray(lj).max()) > -100.0
    np.testing.assert_allclose(st["ring"].numpy(), np.asarray(sj["ring"]), rtol=1e-4)


def test_routing_off_path_matches_reference():
    rng = np.random.default_rng(13)
    t = np.arange(3 * T) / FS
    # DC offset + 30 Hz rumble + broadband content
    x = (0.1 + 0.2 * np.sin(2 * np.pi * 30.0 * t)[None]
         + 0.1 * rng.standard_normal((N, 3 * T))).astype(np.float32)
    cfg_j = jroute.RoutingConfig(cleanup_mode=0)
    cfg_t = troute.RoutingConfig(cleanup_mode=0)
    sj = jroute.routing_init(cfg_j, (N,))
    st = troute.routing_init(cfg_t, n=N, device="cpu")
    for b in range(3):
        xb = x[:, b * T:(b + 1) * T]
        sj, yj, _ = jroute.routing_process(cfg_j, sj, jnp.asarray(xb))
        st, yt, _ = troute.routing_process(cfg_t, st, _t(xb))
        _assert_audio(yt.numpy(), yj)
    np.testing.assert_allclose(st["dc_y1"].numpy(), np.asarray(sj["dc_y1"]), atol=1e-5)
    np.testing.assert_allclose(st["prefilter_z"].numpy(),
                               np.asarray(sj["prefilter_z"]), atol=1e-4)


def test_sanitize_and_meter_stats_match_reference():
    rng = np.random.default_rng(14)
    x = (1.5 * rng.standard_normal((N, T))).astype(np.float32)
    x[0, 3] = np.nan
    yj, cj, pj = jroute.sanitize_and_clamp_input(jnp.asarray(x))
    yt, ct, pt = troute.sanitize_and_clamp_input(_t(x))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-2)
    ceiling = np.float32(10 ** (-1.5 / 20))
    yj, cj, pj = jroute.sanitize_and_clamp_output(jnp.asarray(x), ceiling)
    yt, ct, pt = troute.sanitize_and_clamp_output(
        _t(x), torch.full((N,), float(ceiling)))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    acc = rng.random(N).astype(np.float32)
    coeff = np.float32(np.exp(-1.0 / (0.3 * FS)))
    sj, aj = jroute.meter_block_stats(jnp.asarray(yj), jnp.asarray(acc), coeff)
    stt, at = troute.meter_block_stats(yt, _t(acc), torch.tensor(coeff))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5)
    for k in ("peak_db", "rms_db", "crest_factor_db"):
        np.testing.assert_allclose(stt[k].numpy(), np.asarray(sj[k]), atol=1e-2)
