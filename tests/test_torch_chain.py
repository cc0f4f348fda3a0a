"""Port parity for the offline chain: ``audioforge_tpu_torch.runtime.chain``
against ``audioforge_tpu.runtime.chain`` on the CPU.

A ``(2, 3)`` batch runs 8 blocks of 480 samples through ``chain_run`` on both
sides, with bench.py's downstream configuration (de-esser, the ten-band
Auto-EQ curve at Q 4.33, the compressor with adaptive release, auto makeup
and sidechain high-pass at -24 dB / 3:1, both limiters) and variations of it:
the other stage order, compressor off, and limiter off with the flat EQ (no
section left after compaction, so no cascade runs). In the default order the
reference runs its fused de-esser -> EQ -> compressor scan (``fused=True``),
which the port runs as its three staged kernels. The input is a voiced
harmonic series with sibilant bursts (the de-esser engages) and a transient
over full scale (both limiters engage).

Tolerances: audio RMS <= 1e-4 and max <= 1e-3; dB statistics <= 1e-2 dB;
linear peaks <= 1e-4; limited-event counts exact; state leaves 1e-3
(integers exact).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioforge_tpu.ops import compressor as jcomp
from audioforge_tpu.ops import deesser as jdes
from audioforge_tpu.ops import eq as jeq
from audioforge_tpu.runtime import chain as jchain
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.ops import compressor as tcomp
from audioforge_tpu_torch.ops import deesser as tdes
from audioforge_tpu_torch.ops import eq as teq
from audioforge_tpu_torch.runtime import chain as tchain

SHAPE, N_BLOCKS, T, FS = (2, 3), 8, 480, 48000.0
GAINS = [-2.5, 1.5, -1.0, 2.0, 3.0, 2.5, 1.5, -2.0, 1.0, -1.5]

CASES = {
    "de-esser -> EQ (reference fused)": dict(fused=True),
    "EQ -> de-esser": dict(eq_before_deesser=True),
    "compressor off": dict(compressor_enabled=False),
    "limiter off, flat EQ": dict(limiter_enabled=False, flat_eq=True),
}
DB_STATS = ("deesser_gain_reduction_db", "compressor_gain_reduction_db",
            "limiter_peak_gain_reduction_db", "true_peak_limiter_gain_reduction_db")
PEAK_STATS = ("input_sample_peak", "output_sample_peak", "true_peak_limiter_input_peak",
              "output_true_peak")


def _configs(pkg_chain, pkg_des, pkg_comp, flags):
    return pkg_chain.ChainConfig(
        sample_rate=FS, deesser_enabled=True, eq_enabled=True,
        compressor_enabled=flags.get("compressor_enabled", True),
        limiter_enabled=flags.get("limiter_enabled", True),
        eq_before_deesser=flags.get("eq_before_deesser", False),
        deesser=pkg_des.DeEsserConfig(sample_rate=FS, enabled=True),
        compressor=pkg_comp.CompressorConfig(
            sample_rate=FS, enabled=True, adaptive_release=True,
            auto_makeup_enabled=True, sidechain_highpass_enabled=True, block_samples=T),
        fused=flags.get("fused", False) and pkg_chain is jchain)


def _bands(pkg_eq, flat):
    if flat:
        return None
    return [pkg_eq.EqBandConfig(b.filter_type, b.frequency_hz, g, 4.33,
                                b.slope_db_per_octave, True)
            for b, g in zip(pkg_eq.default_bands(), GAINS)]


def _audio(seed=8):
    rng = np.random.default_rng(seed)
    t = np.arange(N_BLOCKS * T) / FS
    voiced = sum(np.sin(2 * np.pi * 180.0 * h * t + h) / h for h in range(1, 6))
    sib = np.sin(2 * np.pi * 6800.0 * t) * (((t * 1000) % 40) < 18)
    x = (0.05 * voiced + 0.25 * sib)[None] * rng.uniform(0.6, 1.4, (6, 1))
    x = x + 0.003 * rng.standard_normal((6, t.size))
    x[1, 1000:1040] *= 12.0  # a transient over full scale
    return x.astype(np.float32).reshape(SHAPE + (N_BLOCKS, T))


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
        assert np.shape(p) == r.shape, name
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(p, r, err_msg=name)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-3, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_chain_run_matches_reference(name):
    flags = CASES[name]
    cfg_j = _configs(jchain, jdes, jcomp, flags)
    cfg_t = _configs(tchain, tdes, tcomp, flags)
    params_j = jcomp.compressor_params(cfg_j.compressor, threshold_db=-24.0, ratio=3.0)
    params_t = tcomp.compressor_params(cfg_t.compressor, threshold_db=-24.0, ratio=3.0)
    assert set(params_t) == set(params_j)
    flat = flags.get("flat_eq", False)
    state_j = jchain.chain_init(cfg_j, params_j, _bands(jeq, flat), batch_shape=SHAPE)
    state_t = tchain.chain_init(cfg_t, params_t, _bands(teq, flat), batch_shape=SHAPE,
                                device="cpu")
    if flat:
        assert state_t["eq"]["c"].shape == (0, 5)
    else:
        assert state_t["eq"]["c"].shape == (10, 5)

    x = _audio()
    fin_j, y_j, st_j = jchain.chain_run(cfg_j, params_j, state_j, jnp.asarray(x))
    fin_t, y_t, st_t = tchain.chain_run(cfg_t, params_t, state_t, torch.as_tensor(x))
    assert y_t.shape == x.shape
    _assert_audio(y_t.numpy(), y_j)
    assert set(st_t) == set(st_j) == set(tchain.STAT_KEYS)
    for k, ref in st_j.items():
        ref = np.asarray(ref)
        got = st_t[k].numpy()
        assert got.shape == ref.shape == SHAPE + (N_BLOCKS,), k
        assert got.dtype == ref.dtype, k
        if k in DB_STATS:
            np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0, err_msg=k)
        elif k in PEAK_STATS:
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
    # the stages this case keeps were engaged
    assert st_t["deesser_gain_reduction_db"].max() > 0.5
    if cfg_t.compressor_enabled:
        assert st_t["compressor_gain_reduction_db"].max() > 1.0
    if cfg_t.limiter_enabled:
        assert st_t["limiter_peak_gain_reduction_db"].max() > 1.0
        assert st_t["true_peak_limited_events"].sum() > 0
    ref = jax.tree_util.tree_map(np.asarray, fin_j)
    _assert_tree_close(convert.to_numpy(fin_t, ref), ref)

    if name != next(iter(CASES)):
        return
    # without audio the run keeps only the stats, and they are the same
    _, none, st_t2 = tchain.chain_run(cfg_t, params_t, state_t, torch.as_tensor(x),
                                      return_audio=False)
    assert none is None
    for k in st_t:
        assert torch.equal(st_t[k], st_t2[k]), k


def test_chain_state_round_trip():
    cfg = _configs(jchain, jdes, jcomp, {})
    params = jcomp.compressor_params(cfg.compressor, threshold_db=-24.0, ratio=3.0)
    state = jchain.chain_init(cfg, params, _bands(jeq, False), batch_shape=SHAPE)
    rng = np.random.default_rng(3)
    ref = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) if np.asarray(a).dtype.kind in "biu" else
                   (np.asarray(a) + rng.standard_normal(np.shape(a))).astype(np.float32)),
        state)
    port = convert.chain_state(ref)
    assert port["eq"]["z"].dtype == torch.float64
    assert port["eq"]["z"].shape == (6, 10, 2)
    assert port["compressor"]["meter"]["kz"].dtype == torch.float64
    assert port["deesser"]["det_z"].shape == (6, 3, 2, 2)
    # the port's own init has the same layout
    fresh = tchain.chain_init(_configs(tchain, tdes, tcomp, {}), None, _bands(teq, False),
                              batch_shape=SHAPE, device="cpu")
    back = _leaves(convert.to_numpy(port, ref))
    assert set(_leaves(fresh)) == set(_leaves(port))
    for k, v in _leaves(ref).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k


def _leaves(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{path}.{k}"))
        else:
            out[f"{path}.{k}"] = v
    return out
