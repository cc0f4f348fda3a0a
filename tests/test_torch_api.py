"""Port parity for the offline simulators: ``audioforge_tpu_torch.api``
against ``audioforge_tpu.api`` on the CPU.

Each simulator runs the same take on both sides and every diagnostics key is
compared (here the chain simulators, the helpers, validation and the device
default; ``test_torch_api_studies.py`` holds the EQ, auto-makeup and
gate/suppressor simulators with the helpers of this file): audio RMS <= 1e-4 and max <= 1e-3; dB values <= 1e-2 dB; linear
levels <= 1e-4; probabilities, activities and gains <= 1e-3; counts, flags
and sizes exact (runtimes are not compared). The chain simulators run 1 s
takes at 48 kHz (20 ms analysis blocks of 960) and 44.1 kHz (882, rows not
16-byte aligned), ``simulate_eq_v2`` a 1 s take in 4800-sample blocks,
``simulate_auto_makeup_control`` 1 s at the 10 ms control cadence.

Two sizes are smaller, because the CPU runs the kernels' plain twins, which
loop over samples in Python: the gate/suppressor order study runs 0.5 s
(50 blocks of the VAD-assisted gate's twin, ~0.4 s a block, in each order),
and the batched simulator is held against four single calls on 0.2 s.

The reference's double-word EQ sections lose precision at block boundaries
(ROADMAP F6): a low-frequency section drifts ~1e-3 from the f64 filter from
the second block on. The parity cases therefore use EQ curves on which the
reference stays within tolerance (the chain's: sections it runs in plain
f32, asserted), and
``test_eq_v2_low_band_holds_the_f64_filter`` holds the port to the f64 filter
where the reference drifts (in ``test_torch_api_studies.py``).
"""

import numpy as np
import pytest
import torch

from audioforge_tpu import api as japi
from audioforge_tpu.ops import eq as jeq
from audioforge_tpu_torch import api as tapi

LEGACY_BANDS = [(80.0, 0.0, 1.41), (160.0, 0.0, 1.41), (320.0, 1.5, 1.0),
                (640.0, 0.0, 1.41), (1280.0, 2.0, 1.41), (2500.0, 0.0, 1.41),
                (5000.0, -1.5, 2.0), (8000.0, 0.0, 1.41), (12000.0, 0.0, 1.41),
                (16000.0, 1.0, 0.7)]
V2_BANDS = [("high_pass", 400.0, 0.0, 0.707, 24, True), ("bell", 160.0, 0.0, 1.41, 12, True),
            ("bell", 320.0, 0.0, 1.41, 12, True), ("bell", 640.0, 0.0, 1.41, 12, True),
            ("bell", 1280.0, 2.0, 1.41, 12, True), ("bell", 2500.0, -1.0, 1.41, 12, True),
            ("bell", 5000.0, -1.5, 2.0, 12, True), ("notch", 8000.0, 0.0, 4.0, 12, True),
            ("low_pass", 18000.0, 0.0, 0.707, 48, True),
            ("high_shelf", 16000.0, 1.0, 0.7, 12, True)]
CHAIN_SETTINGS = {"limiter_ceiling_db": -9.0, "deesser_enabled": False,
                  "compressor_threshold_db": -24.0, "return_output_audio": True}
CANDIDATES = [{"threshold_db": -30.0, "ratio": 4.0, "attack_ms": 5.0, "release_ms": 120.0},
              {"threshold_db": -24.0, "ratio": 3.0, "attack_ms": 10.0, "release_ms": 200.0},
              {"threshold_db": -18.0, "ratio": 2.0, "attack_ms": 20.0, "release_ms": 300.0},
              {"threshold_db": -12.0, "ratio": 0.5, "attack_ms": 1.0, "release_ms": 60.0}]
# compared at the linear-level tolerance
LINEAR_KEYS = {"input_sample_peak", "output_sample_peak", "input_true_peak",
               "output_true_peak", "input_rms", "output_rms"}
UNIT_KEYS = {"activity", "reliability", "gate_gain", "gate_noise_floor_reliability",
             "compressor_gain_reduction_active_ratio"}
EXACT_KEYS = {"true_peak_limited_events", "active_analysis_block_count",
              "processed_samples", "sample_count", "algorithmic_latency_samples",
              "non_finite_output", "control_block_size", "control_cadence_hz",
              "gate_chatter_event_count", "suppressor_latency_samples", "analysis_block_ms",
              "limiter_effective_ceiling_db"}


def _take(fs, seconds, seed=0):
    """Voiced bursts over a low noise floor, with a transient over the
    limiter's ceiling."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    env = np.where((t % 0.5) < 0.3, 0.3, 0.01)
    voiced = sum(np.sin(2 * np.pi * 160.0 * h * t + h) / h for h in range(1, 6))
    x = env * voiced + 0.003 * rng.standard_normal(t.size)
    x[int(0.12 * fs):int(0.12 * fs) + 40] *= 3.0
    return x.astype(np.float32)


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert err.size == 0 or np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert err.size == 0 or np.max(np.abs(err)) <= 1e-3


def _assert_diagnostics(port, ref):
    assert set(port) == set(ref)
    for k, r in ref.items():
        p = port[k]
        if k.endswith("runtime_ms"):
            continue
        if k == "output_audio":
            _assert_audio(p, r)
        elif k in EXACT_KEYS:
            assert p == r, k
        elif k in LINEAR_KEYS:
            np.testing.assert_allclose(p, r, rtol=0, atol=1e-4, err_msg=k)
        elif k in UNIT_KEYS:
            np.testing.assert_allclose(p, r, rtol=0, atol=1e-3, err_msg=k)
        else:  # dB values
            np.testing.assert_allclose(p, r, rtol=0, atol=1e-2, err_msg=k)


def _plain_f32_eq(bands, fs):
    """True when the reference runs every section of this curve in plain
    f32 (no double-word section, ROADMAP F6)."""
    lo, _ = jeq.compact_cascade(jeq.bands_to_sections(japi._legacy_bands(bands, fs), fs))
    return lo.shape[0] == 0


@pytest.mark.parametrize("fs", [48000, 44100])
def test_auto_eq_chain_matches_reference(fs):
    assert _plain_f32_eq(LEGACY_BANDS, float(fs))
    x = _take(fs, 1.0)
    ref = japi.simulate_auto_eq_chain(x, fs, LEGACY_BANDS, CHAIN_SETTINGS)
    got = tapi.simulate_auto_eq_chain(x, fs, LEGACY_BANDS, CHAIN_SETTINGS, device="cpu")
    _assert_diagnostics(got, ref)
    assert got["compressor_gain_reduction_db"] > 1.0
    assert got["limiter_gain_reduction_db"] > 1.0
    assert got["true_peak_headroom_db"] > -0.01


def test_batched_simulator_matches_reference():
    x = _take(48000, 1.0, seed=1)
    settings = {k: v for k, v in CHAIN_SETTINGS.items() if k != "return_output_audio"}
    ref = japi.simulate_auto_eq_chain_batched(x, 48000, LEGACY_BANDS, settings, CANDIDATES)
    got = tapi.simulate_auto_eq_chain_batched(x, 48000, LEGACY_BANDS, settings, CANDIDATES,
                                              device="cpu")
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        _assert_diagnostics(g, r)
    assert got[0]["compressor_gain_reduction_db"] > got[2]["compressor_gain_reduction_db"]


def test_batched_simulator_equals_single_calls():
    x = _take(48000, 0.2, seed=2)
    settings = {k: v for k, v in CHAIN_SETTINGS.items() if k != "return_output_audio"}
    batched = tapi.simulate_auto_eq_chain_batched(x, 48000, LEGACY_BANDS, settings,
                                                  CANDIDATES, device="cpu")
    for cand, b in zip(CANDIDATES, batched):
        single = tapi.simulate_auto_eq_chain(
            x, 48000, LEGACY_BANDS,
            dict(settings, compressor_threshold_db=cand["threshold_db"],
                 compressor_ratio=cand["ratio"], compressor_attack_ms=cand["attack_ms"],
                 compressor_release_ms=cand["release_ms"]), device="cpu")
        assert set(single) == set(b)
        for k, v in single.items():
            if not k.endswith("runtime_ms"):
                np.testing.assert_allclose(b[k], v, rtol=0, atol=1e-5, err_msg=k)
    assert tapi.simulate_auto_eq_chain_batched(x, 48000, LEGACY_BANDS, settings, [],
                                               device="cpu") == []


def test_batched_simulator_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        tapi.simulate_auto_eq_chain_batched(_take(48000, 0.05), 48000, LEGACY_BANDS, None,
                                            CANDIDATES, mesh=object(), device="cpu")


def test_helpers_match_reference():
    rng = np.random.default_rng(7)
    values = rng.standard_normal(37)
    for p in (0.0, 0.2, 0.5, 0.95, 1.0, 1.5):
        assert tapi.percentile(values, p) == japi.percentile(values, p)
    assert tapi.percentile([], 0.5) == japi.percentile([], 0.5) == 0.0
    gr = np.maximum(0.0, 6.0 * np.sin(np.arange(200) * 0.4) + rng.standard_normal(200))
    for trace, cadence in ((gr, 50.0), (gr[:2], 50.0), (gr, 0.0), ([1.0, np.inf, 2.0], 50.0)):
        assert tapi.compressor_pumping_score(trace, cadence) == japi.compressor_pumping_score(
            trace, cadence)


BAD_CALLS = {
    "sample rate": lambda api, **kw: api.simulate_auto_eq_chain(
        np.zeros(10, np.float32), 0.0, LEGACY_BANDS, **kw),
    "band count": lambda api, **kw: api.simulate_auto_eq_chain(
        np.zeros(10, np.float32), 48000, LEGACY_BANDS[:9], **kw),
    "band frequency": lambda api, **kw: api.simulate_auto_eq_chain_batched(
        np.zeros(10, np.float32), 48000, [(30000.0, 0.0, 1.0)] + LEGACY_BANDS[1:], None,
        CANDIDATES, **kw),
    "v2 type": lambda api, **kw: api.simulate_eq_v2(
        np.zeros(10, np.float32), 48000, [("shelf", 80.0, 0.0, 1.0, 12, True)]
        + V2_BANDS[1:], **kw),
    "v2 gain": lambda api, **kw: api.simulate_eq_v2(
        np.zeros(10, np.float32), 48000, [("bell", 80.0, 20.0, 1.0, 12, True)]
        + V2_BANDS[1:], **kw),
    "non-finite audio": lambda api, **kw: api.simulate_eq_v2(
        np.array([0.0, np.nan], np.float32), 48000, V2_BANDS, **kw),
    "noise evidence": lambda api, **kw: api.simulate_auto_makeup_control(
        np.zeros(960, np.float32), 48000, [], -60.0, 1.5, **kw),
    "VAD count": lambda api, **kw: api.simulate_auto_makeup_control(
        np.zeros(960, np.float32), 48000, [0.5], -60.0, 0.5, **kw),
    "VAD range": lambda api, **kw: api.simulate_auto_makeup_control(
        np.zeros(960, np.float32), 48000, [0.5, 1.5], -60.0, 0.5, **kw),
    "VAD reliability": lambda api, **kw: api.simulate_auto_makeup_control(
        np.zeros(960, np.float32), 48000, [], -60.0, 0.5, {"vad_reliability": 2.0}, **kw),
    "suppressor strength": lambda api, **kw: api.simulate_gate_suppressor_order(
        np.zeros(960, np.float32), [0.5, 0.5], True, 1.5, **kw),
    "gate VAD count": lambda api, **kw: api.simulate_gate_suppressor_order(
        np.zeros(960, np.float32), [0.5], True, 0.5, **kw),
    # host helpers: no device keyword
    "response frequency": lambda api, **_: api.eq_magnitude_response(
        [100.0, 30000.0], LEGACY_BANDS, 48000),
    "loudness rate": lambda api, **_: api.measure_integrated_loudness(
        np.zeros(48000, np.float32), 12345),
}


@pytest.mark.parametrize("name", list(BAD_CALLS))
def test_validation_errors_match_reference(name):
    call = BAD_CALLS[name]
    with pytest.raises(ValueError) as ref:
        call(japi)
    with pytest.raises(ValueError) as got:
        call(tapi, device="cpu")
    assert str(got.value) == str(ref.value)


NEEDS_A_DEVICE = {
    "simulate_auto_eq_chain": lambda: tapi.simulate_auto_eq_chain(
        _take(48000, 0.05), 48000, LEGACY_BANDS),
    "simulate_auto_eq_chain_batched": lambda: tapi.simulate_auto_eq_chain_batched(
        _take(48000, 0.05), 48000, LEGACY_BANDS, None, CANDIDATES),
    "simulate_eq_v2": lambda: tapi.simulate_eq_v2(_take(48000, 0.05), 48000, V2_BANDS),
    "simulate_auto_makeup_control": lambda: tapi.simulate_auto_makeup_control(
        _take(48000, 0.05), 48000, [], -60.0, 0.5),
    "simulate_gate_suppressor_order": lambda: tapi.simulate_gate_suppressor_order(
        np.zeros(960, np.float32), [0.5, 0.5], True, 0.5),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
@pytest.mark.parametrize("name", list(NEEDS_A_DEVICE))
def test_simulators_run_on_the_card_by_default(name):
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        NEEDS_A_DEVICE[name]()
