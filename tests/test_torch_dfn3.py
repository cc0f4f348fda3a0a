"""Port parity: DeepFilterNet3, LL and standard, against the JAX reference.

The ERB layout and tables, every layer helper (BatchNorm, the grouped
'same' freq conv, the causal conv step with its pointwise conv, the
transposed conv as a correlation over the zero-inserted input, the grouped
linear, the torch-order GRU cell, the flatten/unflatten pair, the post
filter) on seeded inputs, each conv unit as the port's frame runs it (its
GEMM form, channels-last, the case's inputs and outputs converted), and
``dfn_frame`` (the ``dfn_features`` and ``dfn_spec_synth`` kernels' plain
twins with the FFTs, conv units and GEMMs between them) over 8 frames of 2
streams with the trained archives ``models/dfn3_ll.npz`` and
``models/dfn3.npz``; the JAX frames run once per module. A frame dispatches
no convolution op. Tolerances: layers 1e-5 (f32, another summation order);
ERB gains and lsnr 1e-3 (the conversion contract of the model ports); audio
RMS 1e-4 and max 1e-3 of full scale; the seeded weights and ERB tables
exact.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from audioforge_tpu.models import dfn3 as jdfn
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.models import dfn3 as tdfn

N, F = 2, 480
N_FRAMES = 8
# (variant, atten_lim_db, post_filter_beta)
CASES = (("ll", 30.0, 0.0), ("ll", 12.0, 0.03), ("standard", 30.0, 0.0))


def _frames(seed: int) -> np.ndarray:
    """``[N_FRAMES, N, 480]``: stream 0 a voiced tone with pauses over
    noise, stream 1 noise alone."""
    rng = np.random.default_rng(seed)
    t = np.arange(N_FRAMES * F) / 48000.0
    voiced = sum(np.sin(2 * np.pi * 160.0 * h * t + h) / h for h in range(1, 10))
    x = np.stack([0.2 * voiced * (np.sin(2 * np.pi * 4.0 * t) > -0.3),
                  np.zeros_like(t)])
    x = x + 0.02 * rng.standard_normal(x.shape)
    return x.astype(np.float32).reshape(N, N_FRAMES, F).transpose(1, 0, 2)


def _archive(variant: str) -> dict:
    path = jdfn.resolve_weight_path(low_latency=variant == "ll")
    assert path is not None, "the DFN3 archives are part of the repository"
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def reference():
    """The JAX frames of every case: ``{case: [(y, erb_gains, lsnr), ...]}``
    and the final states."""
    x = _frames(70)
    out = {}
    for case in CASES:
        variant, atten, beta = case
        params = {k: jnp.asarray(v) for k, v in _archive(variant).items()
                  if not k.startswith("__")}
        state = jdfn.dfn_state_init((N,), lookahead=variant == "standard")
        frames = []
        for f in range(N_FRAMES):
            state, y, aux = jdfn.dfn_frame(params, state, jnp.asarray(x[f]), atten, beta)
            frames.append((np.asarray(y), np.asarray(aux["erb_gains"]),
                           np.asarray(aux["lsnr"])))
        out[case] = (frames, {k: np.asarray(v) for k, v in state.items()})
    return x, out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]:g}dB-beta{c[2]:g}")
def test_dfn_frame_matches_reference(reference, case):
    x, ref = reference
    variant, atten, beta = case
    params = convert.dfn_weights(_archive(variant))
    state = tdfn.dfn_state_init(n=N, lookahead=variant == "standard", device="cpu")
    frames, final = ref[case]
    for f, (yj, gj, lj) in enumerate(frames):
        state, y, aux = tdfn.dfn_frame(params, state, torch.as_tensor(x[f]), atten, beta)
        np.testing.assert_allclose(aux["erb_gains"].numpy(), gj, atol=1e-3)
        np.testing.assert_allclose(aux["lsnr"].numpy(), lj, atol=1e-3)
        err = y.numpy().astype(np.float64) - yj
        assert np.sqrt(np.mean(err ** 2)) <= 1e-4
        assert np.abs(err).max() <= 1e-3
    assert set(state) == set(final)
    for k in ("enc_gru", "erb_dec_gru", "df_gru", "erb_norm", "unit_norm",
              "spec_hist", "synthesis_mem"):
        np.testing.assert_allclose(state[k].numpy(), final[k], atol=1e-3, err_msg=k)
    gains = np.stack([g for _, g, _ in frames])
    assert gains.min() < 0.5 < gains.max()  # the model attenuates and passes


def test_erb_layout_and_tables_equal_reference():
    np.testing.assert_array_equal(tdfn.erb_widths(), jdfn.erb_widths())
    fb, spread = tdfn._erb_matrices()
    np.testing.assert_array_equal(fb, jdfn._ERB_FB_NP)
    np.testing.assert_array_equal(spread, jdfn._ERB_SPREAD_NP)
    c = tdfn._consts(torch.device("cpu"))
    widths = jdfn.erb_widths()
    np.testing.assert_array_equal(np.diff(c["erb_offsets"].numpy()), widths)
    np.testing.assert_array_equal(c["bin_band"].numpy(), np.argmax(jdfn._ERB_SPREAD_NP, 1))
    np.testing.assert_array_equal(c["window"].numpy(), jdfn._WINDOW)
    st = tdfn.dfn_state_init(n=3, lookahead=True, device="cpu")
    ref = jdfn.dfn_state_init((3,), lookahead=True)
    assert set(st) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(v), err_msg=k)


def test_init_params_equal_reference_seeded_weights():
    ref = jdfn.init_params()
    got = tdfn.init_params()
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _bn_params(rng, key, c):
    return {f"{key}.bn.g": rng.normal(1, 0.2, c), f"{key}.bn.b": rng.normal(0, 0.2, c),
            f"{key}.bn.m": rng.normal(0, 0.2, c), f"{key}.bn.v": rng.uniform(0.5, 2, c)}


# The port's activations are channels-last ([B, F, C]); the reference's
# [B, C, F]. The adapters below convert a case's inputs and outputs.
def _cl(x):
    return x.transpose(1, 2).contiguous()


def _port_bn(p, key, x):
    scale, shift = tdfn._bn_fold(p, key)
    return (x.double() * scale[:, None] + shift[:, None]).float()


def _port_freq_conv(w, x, stride, groups):
    """A 'same' conv of one time tap ``w [O, I/g, 3]``: a depthwise one as
    the port's tap sum, any other as its dense GEMM over the unfolded
    rows."""
    if groups == x.shape[1] and w.shape[0] == groups:
        return tdfn._depthwise(_cl(x), w[:, 0].T, stride).mT
    ones = torch.ones(w.shape[0], dtype=torch.float64)
    unit = tdfn._fold(w[:, :, None], None, ones, ones - 1.0, groups)
    return tdfn._gemm(unit, tdfn._cols(_cl(x), 1), None).view(x.shape[0], x.shape[2], -1).mT


def _port_conv_step(p, key, frames, stride=1, groups=1, act="relu"):
    """The reference's conv step on a window ``[kt, B, C, F]`` as the port's
    frame runs such a unit."""
    unit = tdfn._unit(p, key, groups)
    kt, b, _, f = frames.shape
    x = _cl(frames[0])
    if len(unit) == 3:
        return tdfn._separable(unit, x, stride).mT
    if kt == 1 and p[f"{key}.w"].shape[-1] == 1:
        return tdfn._pointwise(*unit, x).mT
    if kt == 1:
        return tdfn._gemm(unit, tdfn._cols(x, 1), act).view(b, f, -1).mT
    return tdfn._conv_window(unit, frames.permute(1, 0, 2, 3), act).mT


def _layer_case(name, rng):
    """``(jax fn, torch fn, numpy args)`` of one layer helper; the first arg
    of the BN and conv helpers is a params dict."""
    B, C, Fr = 3, 8, 16
    if name.endswith("_odd_f"):
        Fr = 15
    x = rng.normal(0, 1, (B, C, Fr))
    if name == "bn":
        return jdfn._bn, _port_bn, (_bn_params(rng, "u", C), "u", x)
    if name.startswith("freq_conv"):
        stride, groups = {"freq_conv": (1, 1), "freq_conv_s2_g8": (2, 8)}[name]
        w = rng.normal(0, 0.3, (C, C // groups, 3))
        return jdfn._freq_conv, _port_freq_conv, (w, x, stride, groups)
    if name.startswith("conv_step"):
        kt, stride, groups, sep, act = {
            "conv_step_kt3_g2_pw": (3, 1, 2, True, "relu"),
            "conv_step_kt3_in1": (3, 1, 1, False, "relu"),
            "conv_step_kt1_s2_dw_pw": (1, 2, C, True, "relu"),
            "conv_step_kt1_s2_dw_pw_odd_f": (1, 2, C, True, "relu"),
            "conv_step_kt1_s1_dw_pw": (1, 1, C, True, "relu"),
            "conv_step_kt5_kf1_g2": (5, 1, 2, True, "relu"),
            "conv_step_kf1_pointwise": (1, 1, 1, False, "relu"),
            "conv_step_out_sigmoid": (1, 1, 1, False, "sigmoid")}[name]
        kf = 1 if "kf1" in name else 3
        c_in = 1 if "in1" in name else C
        p = {"u.w": rng.normal(0, 0.3, (C, c_in // groups, kt, kf)),
             **_bn_params(rng, "u", C)}
        if sep:
            p["u.pw"] = rng.normal(0, 0.3, (C, C, 1, 1))
        win = rng.normal(0, 1, (kt, B, c_in, Fr))
        return jdfn._conv_step, _port_conv_step, (p, "u", win, stride, groups, act)
    if name.startswith("convt_step"):
        p = {"u.w": rng.normal(0, 0.3, (C, 1, 1, 3)), "u.pw": rng.normal(0, 0.3, (C, C, 1, 1)),
             **_bn_params(rng, "u", C)}
        port = lambda p, key, x: tdfn._convt(tdfn._unit(p, key, C), _cl(x)).mT
        return jdfn._convt_step, port, (p, "u", x)
    if name == "glinear":
        w = rng.normal(0, 0.3, (4, 6, 5))
        return jdfn._glinear_apply, tdfn._glinear_apply, (w, rng.normal(0, 1, (B, 24)))
    if name == "gru_step":
        h = 12
        p = {"g.wi": rng.normal(0, 0.3, (3 * h, 10)), "g.wh": rng.normal(0, 0.3, (3 * h, h)),
             "g.bi": rng.normal(0, 0.3, 3 * h), "g.bh": rng.normal(0, 0.3, 3 * h)}
        return (jdfn._gru_step, tdfn._gru_step,
                (p, "g", rng.normal(0, 1, (B, 10)), rng.normal(0, 1, (B, h))))
    if name == "flatten_fc":
        return jdfn._flatten_fc, lambda x: tdfn._flatten_fc(_cl(x)), (x,)
    if name == "unflatten_cf":
        port = lambda x, f: tdfn._unflatten_cf(x, f).mT
        return jdfn._unflatten_cf, port, (rng.normal(0, 1, (B, C * Fr)), Fr)
    if name == "post_filter":
        g = rng.uniform(0.0, 1.0, (B, 32))
        return jdfn._post_filter, tdfn._post_filter, (g, 0.04)
    raise KeyError(name)


LAYERS = ("bn", "freq_conv", "freq_conv_s2_g8", "conv_step_kt3_g2_pw",
          "conv_step_kt1_s2_dw_pw", "conv_step_kt5_kf1_g2", "conv_step_out_sigmoid",
          "convt_step", "glinear", "gru_step", "flatten_fc", "unflatten_cf",
          "post_filter", "conv_step_kt3_in1", "conv_step_kt1_s2_dw_pw_odd_f",
          "conv_step_kt1_s1_dw_pw", "conv_step_kf1_pointwise", "convt_step_odd_f")


@pytest.mark.parametrize("name", LAYERS)
def test_layer_helper_matches_reference(name):
    jfn, tfn, args = _layer_case(name, np.random.default_rng(LAYERS.index(name)))

    def conv(a, to):
        if isinstance(a, dict):
            return {k: conv(v, to) for k, v in a.items()}
        if isinstance(a, np.ndarray):
            return to(a.astype(np.float32))
        return a

    got = tfn(*(conv(a, torch.as_tensor) for a in args)).numpy()
    want = np.asarray(jfn(*(conv(a, jnp.asarray) for a in args)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


class _AtenOps(TorchDispatchMode):
    """The names of the aten ops dispatched under the mode."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n", (1, 4))
@pytest.mark.parametrize("variant", ("ll", "standard"))
def test_dfn_frame_runs_no_convolution(variant, n):
    """A frame's conv units run as GEMMs and tap sums: no convolution op is
    dispatched, the units' forms made at the first frame included."""
    params = convert.dfn_weights(_archive(variant))
    state = tdfn.dfn_state_init(n=n, lookahead=variant == "standard", device="cpu")
    x = torch.as_tensor(np.random.default_rng(n).normal(0, 0.1, (n, F)).astype(np.float32))
    with _AtenOps() as ops:
        state, y, _ = tdfn.dfn_frame(params, state, x)
    assert not sorted(op for op in ops.names if "conv" in op)
    assert {"addmm", "baddbmm", "addcmul_"} <= ops.names
    assert torch.isfinite(y).all()


def test_unit_forms_are_made_once_per_tensor_set():
    """A unit's GEMM form is kept for its tensors and made anew when one of
    them is replaced."""
    p = {k: torch.as_tensor(v) for k, v in tdfn.init_params().items()}
    first = tdfn._unit(p, "enc.erb_conv1", tdfn.CONV_CH)
    assert tdfn._unit(p, "enc.erb_conv1", tdfn.CONV_CH) is first
    p["enc.erb_conv1.bn.b"] = p["enc.erb_conv1.bn.b"] + 1.0
    again = tdfn._unit(p, "enc.erb_conv1", tdfn.CONV_CH)
    assert again is not first
    torch.testing.assert_close(again[2], first[2] + 1.0)


def _structured_params(erb_bias: float, df_tap):
    """The seeded weights with the heads forced to analytic outputs: ERB
    gains ``sigmoid(erb_bias)`` everywhere, the deep filter a one-hot real
    tap on history frame ``df_tap`` (None: zero)."""
    p = {k: torch.as_tensor(v) for k, v in tdfn.init_params().items()}
    for key in ("erb_dec.conv0_out.w", "erb_dec.conv0_out.bn.g", "df_dec.df_out.w",
                "df_dec.df_convp.w", "df_dec.df_convp.pw", "df_dec.df_convp.bn.g"):
        p[key] = torch.zeros_like(p[key])
    p["erb_dec.conv0_out.bn.b"] = torch.full_like(p["erb_dec.conv0_out.bn.b"], erb_bias)
    bias = torch.zeros(tdfn.DF_ORDER * 2)
    if df_tap is not None:
        bias[2 * df_tap] = 1.0
    p["df_dec.df_convp.bn.b"] = bias
    return p


def _run(params, state, x, atten, beta=0.0):
    ys = []
    for f in range(x.size // F):
        state, y, _ = tdfn.dfn_frame(params, state, torch.as_tensor(x[None, f * F:(f + 1) * F]),
                                     atten, beta)
        ys.append(y[0].numpy())
    return np.concatenate(ys)


def test_atten_lim_applied_exactly_once():
    """Full suppression (gains ~ 0, no deep filter): the output is the gain
    floor's mix of the input, so its level sits the limit below the input,
    not twice the limit."""
    params = _structured_params(-30.0, None)
    x = (0.3 * np.sin(2 * np.pi * 1000.0 * np.arange(20 * F) / 48000.0)).astype(np.float32)
    for atten_db in (30.0, 12.0):
        y = _run(params, tdfn.dfn_state_init(n=1, device="cpu"), x, atten_db)
        rms_in = np.sqrt(np.mean(x[4 * F:16 * F] ** 2))
        rms_out = np.sqrt(np.mean(y[5 * F:17 * F] ** 2))
        assert abs(-20.0 * np.log10(rms_out / rms_in) - atten_db) < 1.0


def test_variants_are_exact_delays_of_their_latency():
    """Unity gains and a one-hot tap on the frame each variant outputs (the
    current frame for LL, t-2 for the standard model): delays of one frame
    and of three."""
    n = np.arange(24 * F)
    x = (0.25 * np.sin(2 * np.pi * 331.0 * n / 48000.0)
         + 0.05 * np.sin(2 * np.pi * 47.0 * n / 48000.0)).astype(np.float32)
    y = _run(_structured_params(30.0, 4), tdfn.dfn_state_init(n=1, device="cpu"), x, 100.0)
    np.testing.assert_allclose(y[F:], x[:-F], atol=2e-4)
    y = _run(_structured_params(30.0, 2),
             tdfn.dfn_state_init(n=1, lookahead=True, device="cpu"), x, 100.0)
    np.testing.assert_allclose(y[3 * F:], x[:-3 * F], atol=2e-4)


def test_variant_archive_mismatch_rejected(tmp_path, monkeypatch):
    """An archive tagged for one latency variant is refused for the other."""
    path = tmp_path / "dfn3_ll_tagged.npz"
    np.savez(path, **tdfn.init_params(), __provenance__=np.asarray("trained"),
             __variant__=np.asarray("ll"))
    monkeypatch.setattr(tdfn, "_APP_OWNED_PATHS", {"model": path, "library": None})
    monkeypatch.setattr(tdfn, "_DEFAULT_PARAMS_CACHE", {})
    with pytest.raises(ValueError, match="variant"):
        tdfn.default_params(low_latency=False)
    assert tdfn.default_params(low_latency=True)
    assert tdfn.weights_source(low_latency=True) == "trained"


def test_runtime_config_and_weight_contract_are_enforced():
    assert tdfn.validate_runtime_config(30.0, 0.02) == (30.0, 0.02)
    for atten, beta in ((0.0, 0.0), (101.0, 0.0), (30.0, 0.06), (float("nan"), 0.0)):
        with pytest.raises(ValueError):
            tdfn.validate_runtime_config(atten, beta)
    arrays = tdfn.init_params()
    arrays["enc.lsnr.w"] = arrays["enc.lsnr.w"][:, :10]
    with pytest.raises(ValueError, match="shape"):
        tdfn.weights_from_numpy(arrays)
    del arrays["enc.lsnr.w"]
    with pytest.raises(ValueError, match="missing"):
        tdfn.weights_from_numpy(arrays)
