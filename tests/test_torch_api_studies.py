"""Port parity for the EQ, auto-makeup and gate/suppressor-order simulators
of ``audioforge_tpu_torch.api`` against ``audioforge_tpu.api`` on the CPU,
with the takes, tolerances and helpers of ``test_torch_api.py`` (see there).
``simulate_eq_v2`` runs a 1 s take in 4800-sample blocks,
``simulate_auto_makeup_control`` 1 s at the 10 ms control cadence, the
gate/suppressor order study 0.5 s in each order (the VAD-assisted gate's
plain twin loops over samples in Python, ~0.4 s a block).
"""

import numpy as np
import pytest
from scipy.signal import lfilter

from audioforge_tpu import api as japi
from audioforge_tpu.ops import eq as jeq
from audioforge_tpu_torch import api as tapi
from test_torch_api import V2_BANDS, _assert_diagnostics, _take


def test_eq_v2_matches_reference():
    x = _take(48000, 1.0, seed=3)
    ref = japi.simulate_eq_v2(x, 48000, V2_BANDS, return_output_audio=True)
    got = tapi.simulate_eq_v2(x, 48000, V2_BANDS, return_output_audio=True, device="cpu")
    _assert_diagnostics(got, ref)
    assert abs(got["output_rms"] - got["input_rms"]) > 1e-3  # the curve did something


def test_eq_v2_low_band_holds_the_f64_filter():
    """A 40 Hz 24 dB/oct high-pass in band 0: the reference's double-word
    sections drift from the second 4800-sample block on (F6, asserted here as
    over 1e-3); the port's f64 state follows the f64 filter of the same f32
    coefficients within 1e-6."""
    # V2_BANDS' layout and take length: the reference's compiled run is shared
    bands = [("high_pass", 40.0, 0.0, 0.707, 24, True)] + V2_BANDS[1:]
    x = _take(48000, 1.0, seed=4)
    got = tapi.simulate_eq_v2(x, 48000, bands, return_output_audio=True, device="cpu")
    coeffs = jeq.bands_to_sections(japi._v2_bands(bands, 48000.0), 48000.0)
    ref = x.astype(np.float64)
    for row in coeffs.astype(np.float32).astype(np.float64):
        ref = lfilter(row[:3], [1.0, row[3], row[4]], ref)
    np.testing.assert_allclose(got["output_audio"], ref, rtol=0, atol=1e-6)
    # the reference's drift (F6): over 1e-3 on this curve
    jax_out = japi.simulate_eq_v2(x, 48000, bands, return_output_audio=True)["output_audio"]
    assert np.abs(np.asarray(jax_out) - ref).max() > 1e-3


def test_auto_makeup_control_matches_reference():
    x = _take(48000, 1.0, seed=5)
    n_blocks = -(-x.size // 480)
    probs = np.where((np.arange(n_blocks) * 0.01) % 0.5 < 0.3, 0.9, 0.05)
    settings = {"return_output_audio": True, "target_lufs": -16.0}
    ref = japi.simulate_auto_makeup_control(x, 48000, probs, -60.0, 0.8, settings)
    got = tapi.simulate_auto_makeup_control(x, 48000, probs, -60.0, 0.8, settings,
                                            device="cpu")
    _assert_diagnostics(got, ref)
    assert max(got["makeup_gain_db"]) > 0.5  # the controller moved


@pytest.mark.parametrize("suppressor_before_gate", [True, False])
def test_gate_suppressor_order_matches_reference(suppressor_before_gate):
    x = _take(48000, 0.5, seed=6)
    n_blocks = -(-x.size // 480)
    probs = np.where((np.arange(n_blocks) * 0.01) % 0.5 < 0.3, 0.9, 0.05)
    settings = {"gate_threshold_db": -35.0}
    ref = japi.simulate_gate_suppressor_order(x, probs, suppressor_before_gate, 0.8, settings)
    got = tapi.simulate_gate_suppressor_order(x, probs, suppressor_before_gate, 0.8,
                                              settings, device="cpu")
    _assert_diagnostics(got, ref)
    gains = np.asarray(got["gate_gain"])
    assert gains.max() > 0.9 and gains.min() < 0.2  # the gate opened and shut
