"""Port parity: the reference's public names that the port carries besides
its stages' process functions — the stage resets, the EQ and biquad
setters, the weight archives' provenance, the weight-conversion contract
and the module constants — against the JAX package.

Each reset runs after a few blocks of audio through the stage on both sides;
the reset states are compared leaf by leaf as numpy: equal, or within 1e-6
where the port keeps a leaf in f64 (biquad state) and the reference in f32.
The port's layouts map to the reference's as ``convert`` maps them (the
routing state's owned high-pass has a section axis here; the EQ is one
cascade here and two precision groups there). The setters run on states
built from the same numpy leaves on both sides, then one block goes through
both (audio 1e-4 RMS, 1e-3 max, as every audio parity test here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audioforge_tpu as jpkg
import audioforge_tpu_torch as tpkg
from audioforge_tpu.models import dfn3 as jdfn
from audioforge_tpu.models import rnnoise as jrn
from audioforge_tpu.models import silero as jsil
from audioforge_tpu.models import vad_gate as jvad
from audioforge_tpu.ops import biquad as jbq
from audioforge_tpu.ops import compressor as jcomp
from audioforge_tpu.ops import deesser as jdes
from audioforge_tpu.ops import eq as jeq
from audioforge_tpu.ops import gate as jgate
from audioforge_tpu.ops import limiter as jlim
from audioforge_tpu.ops import routing as jroute
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.models import dfn3 as tdfn
from audioforge_tpu_torch.models import rnnoise as trn
from audioforge_tpu_torch.models import silero as tsil
from audioforge_tpu_torch.models import vad_gate as tvad
from audioforge_tpu_torch.ops import biquad as tbq
from audioforge_tpu_torch.ops import compressor as tcomp
from audioforge_tpu_torch.ops import deesser as tdes
from audioforge_tpu_torch.ops import eq as teq
from audioforge_tpu_torch.ops import gate as tgate
from audioforge_tpu_torch.ops import limiter as tlim
from audioforge_tpu_torch.ops import routing as troute

N, T, FS = 2, 480, 48000.0
BLOCKS = 2
MODELS = ("rnnoise.npz", "silero_vad.npz", "dfn3.npz", "dfn3_ll.npz")


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _leaves(tree, path=()):
    """``{path: numpy array}`` of a nested dict of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().cpu().numpy()}
    return {path: np.asarray(tree)}


def _assert_same_tree(port, ref):
    """Leaf by leaf: the same keys and shapes; equal values, or within 1e-6
    where the port's leaf is f64."""
    p, r = _leaves(port), _leaves(ref)
    assert sorted(p) == sorted(r)
    for k, v in p.items():
        assert v.shape == r[k].shape, k
        if v.dtype == np.float64:
            np.testing.assert_allclose(v, r[k], rtol=0, atol=1e-6, err_msg=str(k))
        else:
            assert v.dtype == r[k].dtype, (k, v.dtype, r[k].dtype)
            np.testing.assert_array_equal(v, r[k], err_msg=str(k))


def _audio(seed, n_blocks=BLOCKS):
    """Speech-like bursts with a sibilant band and a DC offset: every stage
    moves its state."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / FS
    env = np.sin(2 * np.pi * 6.0 * t + rng.uniform(0, 6, (N, 1))) > 0.2
    x = (0.3 * env * np.sin(2 * np.pi * 180.0 * t)[None]
         + 0.15 * env * np.sin(2 * np.pi * 6800.0 * t)[None]
         + 0.05 + 0.01 * rng.standard_normal((N, t.size)))
    return x.astype(np.float32)


def _blocks(seed):
    x = _audio(seed)
    return [x[:, b * T:(b + 1) * T] for b in range(BLOCKS)]


# ---------------------------------------------------------------------------
# the stage resets
# ---------------------------------------------------------------------------


def _gate():
    cfg_j, cfg_t = jgate.GateConfig(), tgate.GateConfig()
    kw = dict(threshold_db=-30.0, attack_ms=5.0, release_ms=60.0)
    pj = jgate.gate_params(cfg_j, **kw)
    pt = {k: torch.full((N,), float(np.float32(v)))
          for k, v in tgate.gate_params(cfg_t, **kw).items()}
    sj, st = jgate.gate_init((N,)), tgate.gate_init(n=N, device="cpu")
    vad = (np.full(N, 0.9, np.float32), np.ones(N, bool), np.ones(N, bool),
           np.full(N, 0.5, np.float32))
    for xb in _blocks(1):
        sj, _, _ = jgate.gate_process(
            cfg_j, sj, jnp.asarray(xb), vad_probability=jnp.asarray(vad[0]),
            vad_available=jnp.asarray(vad[1]), vad_gate_open=jnp.asarray(vad[2]),
            vad_threshold=jnp.asarray(vad[3]), params=pj)
        st, _, _ = tgate.gate_process(cfg_t, st, torch.as_tensor(xb),
                                      *(torch.as_tensor(v) for v in vad), pt)
    assert float(st["current_gain"].max()) > 0.0  # the gate opened
    return tgate.gate_reset(st), jgate.gate_reset(sj)


def _compressor():
    kw = dict(threshold_db=-30.0, release_ms=120.0, makeup_gain_db=2.5)
    cfg_j = jcomp.CompressorConfig(auto_makeup_enabled=True)
    cfg_t = tcomp.CompressorConfig(auto_makeup_enabled=True)
    pj = jcomp.compressor_params(cfg_j, **kw)
    pt = {k: torch.full((N,), float(np.float32(v)))
          for k, v in tcomp.compressor_params(cfg_t, **kw).items()}
    sj = jcomp.compressor_init(cfg_j, pj, batch_shape=(N,))
    st = tcomp.compressor_reset(cfg_t, tcomp.compressor_init(cfg_t, n=N, device="cpu"), pt)
    for xb in _blocks(2):
        sj, _, _ = jcomp.compressor_process(cfg_j, pj, sj, jnp.asarray(xb))
        st, _, _ = tcomp.compressor_process(cfg_t, pt, st, torch.as_tensor(xb))
    assert float(st["current_gr_db"].max()) > 0.0  # it compressed
    return tcomp.compressor_reset(cfg_t, st, pt), jcomp.compressor_reset(cfg_j, sj, pj)


def _routing():
    cfg_j, cfg_t = jroute.RoutingConfig(cleanup_mode=0), troute.RoutingConfig(cleanup_mode=0)
    sj, st = jroute.routing_init(cfg_j, (N,)), troute.routing_init(cfg_t, n=N, device="cpu")
    for xb in _blocks(3):
        sj, _, _ = jroute.routing_process(cfg_j, sj, jnp.asarray(xb))
        st, _, _ = troute.routing_process(cfg_t, st, torch.as_tensor(xb))
    assert float(st["dc_x1"].abs().max()) > 0.0
    reset = troute.routing_reset(cfg_t, st)
    # the reference layout, f64 leaves kept to be held within 1e-6
    port = dict(reset, adaptive_hp={k: v[:, 0] for k, v in reset["adaptive_hp"].items()})
    return port, jroute.routing_reset(cfg_j, sj)


def _deesser():
    kw = dict(enabled=True, threshold_db=-40.0)
    cfg_j, cfg_t = jdes.DeEsserConfig(**kw), tdes.DeEsserConfig(**kw)
    sj, st = jdes.deesser_init(cfg_j, (N,)), tdes.deesser_init(cfg_t, n=N, device="cpu")
    for xb in _blocks(4):
        sj, _, _ = jdes.deesser_process(cfg_j, sj, jnp.asarray(xb))
        st, _, _ = tdes.deesser_process(cfg_t, st, torch.as_tensor(xb))
    assert float(st["broadband_env"].max()) > 0.0
    return tdes.deesser_reset(cfg_t, st), jdes.deesser_reset(cfg_j, sj)


def _limiter():
    cfg_j, cfg_t = jlim.LimiterConfig(ceiling_db=-12.0), tlim.LimiterConfig(ceiling_db=-12.0)
    pj = jlim.limiter_params(cfg_j)
    pt = {k: torch.full((N,), float(v), dtype=torch.float32)
          for k, v in tlim.limiter_params(cfg_t).items()}
    sj, st = jlim.limiter_init(cfg_j, (N,)), tlim.limiter_init(cfg_t, n=N, device="cpu")
    for xb in _blocks(5):
        sj, _, _ = jlim.limiter_process(cfg_j, sj, jnp.asarray(xb), params=pj)
        st, _, _ = tlim.limiter_process(cfg_t, st, torch.as_tensor(xb), params=pt)
    assert float(st["history"].abs().max()) > 0.0
    return tlim.limiter_reset(st), jlim.limiter_reset(sj)


def _vad_gate():
    cfg_j = jvad.VadGateConfig(gate_mode=jvad.VAD_ASSISTED)
    cfg_t = tvad.VadGateConfig(gate_mode=tvad.VAD_ASSISTED)
    params = {"vad_threshold": 0.48, "margin_db": 10.0, "hold_time_ms": 200.0}
    pj = {k: jnp.float32(v) for k, v in params.items()}
    pt = {k: torch.full((N,), v) for k, v in params.items()}
    sj, st = jvad.vad_gate_init(cfg_j, (N,)), tvad.vad_gate_init(cfg_t, n=N, device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(4):
        rms_db = rng.uniform(-75.0, -15.0, N).astype(np.float32)
        prob = rng.random(N).astype(np.float32)
        avail = np.ones(N, bool)
        sj, _ = jvad.vad_gate_process(cfg_j, sj, jnp.asarray(rms_db), jnp.asarray(prob),
                                      jnp.asarray(avail), T, params=pj)
        st, _ = tvad.vad_gate_process(cfg_t, st, torch.as_tensor(rms_db),
                                      torch.as_tensor(prob), torch.as_tensor(avail), T,
                                      params=pt)
    assert int(st["hist_len"].max()) > 0
    return tvad.vad_gate_reset(cfg_t, st), jvad.vad_gate_reset(cfg_j, sj)


def _bench_bands(mod):
    gains = [-2.5, 1.5, -1.0, 2.0, 3.0, 2.5, 1.5, -2.0, 1.0, -1.5]
    return [mod.EqBandConfig(b.filter_type, b.frequency_hz, g, 2.0, b.slope_db_per_octave, True)
            for b, g in zip(mod.default_bands(), gains)]


def _eq_states():
    """Both EQs over the bench bands, with every band crossfading to a new
    curve (``eq_set_bands``) from the second block on."""
    sj = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (N,) + a.shape),
                                jeq.eq_init(_bench_bands(jeq), FS))
    st = teq.eq_init(_bench_bands(teq), FS, n=N, device="cpu")
    return sj, st


def _retuned(mod):
    """New curves for every band: the low shelf moved to 120 Hz at +4 dB
    (a retuned low band, ROADMAP F2), bells and the high shelf re-gained."""
    bands = [mod.EqBandConfig(b.filter_type, b.frequency_hz, -b.gain_db, b.q,
                              b.slope_db_per_octave, True) for b in _bench_bands(mod)]
    bands[0] = mod.EqBandConfig(0, 120.0, 4.0, 0.9, 12, True)
    return bands


def _eq():
    sj, st = _eq_states()
    run_j = jax.jit(jax.vmap(jeq.eq_process))
    for xb in _blocks(7):
        sj, _ = run_j(sj, jnp.asarray(xb))
        st, _ = teq.eq_process(st, torch.as_tensor(xb))
    # crossfades pending: the reset commits their targets
    sj = jax.vmap(lambda s: jeq.eq_set_bands(s, _retuned(jeq), FS))(sj)
    st = teq.eq_set_bands(st, _retuned(teq), FS)
    assert int(st["fade_remaining"].min()) > 0
    reset, ref = teq.eq_reset(st), jeq.eq_reset(sj)
    n_lo = ref["lo"]["z"].shape[1]
    port = {g: {k: v[:, sl] for k, v in reset.items()}
            for g, sl in (("lo", slice(0, n_lo)), ("hi", slice(n_lo, None)))}
    return port, ref


RESETS = {"gate": _gate, "compressor": _compressor, "routing": _routing,
          "deesser": _deesser, "limiter": _limiter, "vad_gate": _vad_gate, "eq": _eq}


@pytest.mark.parametrize("stage", list(RESETS))
def test_reset_matches_reference(stage):
    port, ref = RESETS[stage]()
    _assert_same_tree(port, ref)


def test_reset_keeps_device_and_streams():
    st = tgate.gate_init(n=5, device="cpu")
    reset = tgate.gate_reset(st)
    assert all(v.shape[0] == 5 and v.device.type == "cpu" for v in reset.values())
    assert reset["current_gain"] is not st["current_gain"]


# ---------------------------------------------------------------------------
# the EQ and biquad setters
# ---------------------------------------------------------------------------


def test_eq_set_bands_matches_reference_loop():
    """``eq_set_bands`` against the reference's loop of ``eq_set_band``: the
    audio of three blocks (the crossfades start in the second), the fade
    counters and the committed coefficients."""
    x = _audio(8, 3)
    sj, st = _eq_states()
    run_j = jax.jit(jax.vmap(jeq.eq_process))
    for b in range(3):
        if b == 1:
            sj = jax.vmap(lambda s: jeq.eq_set_bands(s, _retuned(jeq), FS))(sj)
            st = teq.eq_set_bands(st, _retuned(teq), FS)
        xb = x[:, b * T:(b + 1) * T]
        sj, yj = run_j(sj, jnp.asarray(xb))
        st, yt = teq.eq_process(st, torch.as_tensor(xb))
        _assert_audio(yt.numpy(), yj)
        for k in ("fade_total", "fade_remaining"):
            np.testing.assert_array_equal(
                st[k].numpy(), np.concatenate([np.asarray(sj["lo"][k]),
                                               np.asarray(sj["hi"][k])], axis=1))
    np.testing.assert_array_equal(
        st["coeffs"].numpy(), np.concatenate([np.asarray(sj["lo"]["coeffs"]),
                                              np.asarray(sj["hi"]["coeffs"])], axis=1))


def _crossfading_unit(S=3, seed=9):
    """Numpy leaves of a unit of S sections crossfading between two peaking
    curves, part of the fade gone, with filter state in both lanes."""
    rng = np.random.default_rng(seed)
    freqs = (300.0, 2000.0, 7000.0)[:S]
    old = np.stack([jbq.design(jbq.PEAKING, f, 3.0, 1.5, FS) for f in freqs])
    new = np.stack([jbq.design(jbq.PEAKING, 1.2 * f, -4.0, 1.0, FS) for f in freqs])
    coeffs = np.broadcast_to(np.stack([old, new], axis=1).astype(np.float32),
                             (N, S, 2, 5)).copy()
    z = rng.normal(0, 0.05, (N, S, 2, 2)).astype(np.float32)
    total = np.full((N, S), 700, np.int32)
    remaining = np.full((N, S), 300, np.int32)
    return {"coeffs": coeffs, "z": z, "fade_total": total, "fade_remaining": remaining}


def _unit_pair(leaves):
    sj = {k: jnp.asarray(v) for k, v in leaves.items()}
    st = {k: torch.as_tensor(v.astype(np.float64) if k == "z" else v)
          for k, v in leaves.items()}
    return sj, st


def _run_sections(sj, st, x):
    """One block through the S sections in series on both sides."""
    yj = jnp.asarray(x)
    for s in range(sj["coeffs"].shape[1]):
        sec = {k: v[:, s] for k, v in sj.items()}
        _, yj = jbq.unit_process(sec, yj)
    _, yt = tbq.unit_process(st, torch.as_tensor(x))
    _assert_audio(yt.numpy(), yj)


@pytest.mark.parametrize("setter", ["unit_set_immediate", "unit_reset_state"])
def test_unit_setter_on_crossfading_section_matches_reference(setter):
    leaves = _crossfading_unit()
    sj, st = _unit_pair(leaves)
    if setter == "unit_set_immediate":
        target = jbq.design(jbq.PEAKING, 1000.0, 6.0, 0.7, FS)
        sj = jbq.unit_set_immediate(sj, jnp.asarray(target, jnp.float32))
        st = tbq.unit_set_immediate(st, target)
        np.testing.assert_array_equal(st["z"][:, :, 1].numpy(), leaves["z"][:, :, 0])
    else:
        sj = jbq.unit_reset_state(sj)
        st = tbq.unit_reset_state(st)
        assert not st["z"].any()
    np.testing.assert_array_equal(st["coeffs"][:, :, 0].numpy(), st["coeffs"][:, :, 1].numpy())
    _assert_same_tree(st, sj)
    _run_sections(sj, st, _audio(10, 1))


# ---------------------------------------------------------------------------
# weights: provenance and the conversion contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_archive_provenance_matches_reference(name):
    path = jrn.discover_model_path().parent / name
    assert trn.archive_provenance(path) == jrn.archive_provenance(path) == "trained"


def test_archive_provenance_without_tag_is_converted(tmp_path):
    path = tmp_path / "bare.npz"
    np.savez(path, w=np.zeros(3, np.float32))
    assert trn.archive_provenance(path) == jrn.archive_provenance(path) == "converted"


def test_name_maps_equal_reference():
    assert tsil.ONNX_NAME_MAP == jsil.ONNX_NAME_MAP
    assert tdfn.TORCH_NAME_MAP == jdfn.TORCH_NAME_MAP


def _official_state_dict():
    """An official-layout DFN3 state dict built from the reference's seeded
    weights through the inverse name map, the transposed convs in torch's
    [in, out/g, kt, kf] layout (tests/test_models.py:209-218), and the
    batch-norm counters the conversion skips."""
    params = {k: np.array(v) for k, v in jdfn.init_params().items()}
    inverse = {v: k for k, v in jdfn.TORCH_NAME_MAP.items()}
    sd = {}
    for key, arr in params.items():
        if key in jdfn._TRANSPOSED_KEYS:
            g = jdfn._TRANSPOSED_KEYS[key]
            o_total, ig, kh, kw = arr.shape
            arr = arr[..., ::-1].reshape(g, o_total // g, ig, kh, kw)
            arr = arr.transpose(0, 2, 1, 3, 4).reshape(g * ig, o_total // g, kh, kw)
        sd[inverse[key]] = np.ascontiguousarray(arr)
    sd["enc.erb_conv0.2.num_batches_tracked"] = np.asarray(7)
    return sd, params


def test_convert_torch_state_dict_matches_reference():
    sd, params = _official_state_dict()
    got, ref = tdfn.convert_torch_state_dict(sd), jdfn.convert_torch_state_dict(sd)
    assert sorted(got) == sorted(ref) == sorted(params)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got[k], params[k], err_msg=k)  # round trip


@pytest.mark.parametrize("fault", ["unknown key", "wrong shape", "missing key"])
def test_convert_torch_state_dict_rejects_like_reference(fault):
    sd, _ = _official_state_dict()
    if fault == "unknown key":
        sd["enc.not_a_layer.weight"] = np.zeros(3, np.float32)
    elif fault == "wrong shape":
        sd["enc.lsnr_fc.0.bias"] = np.zeros(2, np.float32)
    else:
        del sd["df_dec.df_out.0.weight"]
    for convert_fn in (tdfn.convert_torch_state_dict, jdfn.convert_torch_state_dict):
        with pytest.raises(ValueError):
            convert_fn(sd)


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

CONSTANTS = [
    (tdfn, jdfn, "DF_BINS"), (tdfn, jdfn, "DF_LOOKAHEAD"), (tdfn, jdfn, "CONV_KERNEL_INP"),
    (tdfn, jdfn, "CONV_KERNEL"), (tdfn, jdfn, "EMB_GRU_LAYERS"),
    (tdfn, jdfn, "ERB_DEC_GRU_LAYERS"), (troute, jroute, "CLEANUP_MODE_IDS"),
    (tpkg, jpkg, "CORE_AVAILABLE"), (teq, jeq, "NUM_SECTIONS"),
]


@pytest.mark.parametrize("port,ref,name", CONSTANTS, ids=[c[2] for c in CONSTANTS])
def test_constant_equals_reference(port, ref, name):
    assert getattr(port, name) == getattr(ref, name)
    assert name in port.__all__


def test_converted_archive_loads_in_the_port():
    """The converted dict is a weight archive the port's loader takes."""
    sd, params = _official_state_dict()
    w = convert.dfn_weights(tdfn.convert_torch_state_dict(sd))
    assert sorted(w) == sorted(params)
