"""The single-stream live engine of the port as a whole, on the CPU.

``AudioProcessor(device="cpu")._process_block`` (front half -> suppressor
engine -> back half, metric publication) is held against the JAX engine's
over four blocks with one fixed VAD snapshot, with RNNoise on the default
topology and with the suppressor off (the latency delay line); the chain
state goes across through ``convert.live_state``. Tolerances: audio RMS <=
1e-4 / max <= 1e-3, dB metrics 1e-2, other metrics 1e-3, flags and counts
exact. The reference runs cleanup mode 0 (its string modes run strong
cleanup, ROADMAP F1).

Also: a lifecycle on a virtual tone (threads for under 2 s), the rejected
double start and unknown devices, the public surface against the JAX
engine's, the card default, and the ``devices`` command.
"""

import contextlib
import io
import time

import numpy as np
import pytest
import torch

import jax

from audioforge_tpu.__main__ import _cmd_devices as jax_devices
from audioforge_tpu.models import suppressor as jsupp
from audioforge_tpu.runtime import live_chain as jlc
from audioforge_tpu.runtime import processor as jproc
from audioforge_tpu_torch import convert
from audioforge_tpu_torch.__main__ import main as cli_main
from audioforge_tpu_torch.models import suppressor as tsupp
from audioforge_tpu_torch.runtime import processor as tproc

T = 480


def _mic(n_blocks, seed):
    """A voice-band tone in bursts, hum and hiss, one loud transient."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / 48000.0
    voiced = sum(np.sin(2 * np.pi * 200.0 * h * t + h) for h in range(3, 7))
    x = (0.08 * voiced * ((t % 0.03) < 0.02) + 0.02 * np.sin(2 * np.pi * 50.4 * t)
         + 0.004 * rng.standard_normal(t.size))
    x[T + 100:T + 140] *= 8.0
    return x.astype(np.float32).reshape(n_blocks, T)


def _engines(suppressor: bool):
    vad = {"probability": 0.7, "timestamp": time.perf_counter() + 3600.0,
           "available": True}
    jp = jproc.AudioProcessor()
    tp = tproc.AudioProcessor(device="cpu")
    jp._topology["cleanup_mode"] = 0  # F1: the string modes run strong cleanup
    for p in (jp, tp):
        p.set_rnnoise_enabled(suppressor)
        p.set_rnnoise_strength(0.8)
        p.set_compressor_threshold(-35.0)
        p._vad_state = dict(vad)
        p._suppressor_guard = {"nonfinite_events": [], "last_output_at": 0.0,
                               "last_reset_at": 0.0}
    return jp, tp


def _assert_audio(port, ref):
    err = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= 1e-4
    assert np.max(np.abs(err)) <= 1e-3


def _assert_published(port: dict, ref: dict):
    assert port.keys() == ref.keys()
    for k, r in ref.items():
        g = port[k]
        if isinstance(r, (bool, str)) or k.endswith("_events") or k.endswith("count"):
            assert g == r, k
        elif isinstance(r, list):
            tol = 1e-2 if "db" in k else 1e-3
            np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=k)
        elif k.startswith("dsp_"):
            continue  # host timing
        else:
            tol = 1e-2 if "db" in k or "lufs" in k else 1e-3
            assert g == pytest.approx(r, abs=tol), k


@pytest.mark.parametrize("suppressor", [True, False], ids=["rnnoise", "off"])
def test_process_block_matches_reference(suppressor):
    jp, tp = _engines(suppressor)
    jcfg, jparams, jtopo, jpar, _ = jp._snapshot_control()
    tcfg, tparams, ttopo, tpar, _ = tp._snapshot_control()
    assert ttopo == dict(jtopo, cleanup_mode="off")
    jstate = jlc.live_init(jcfg)
    tstate = tp._fresh_state(tcfg, None)
    convert_state = convert.live_state(jax.tree_util.tree_map(np.asarray, jstate))
    for k, v in convert_state.items():  # hand the reference's state across
        tstate[k] = v
    jeng = jsupp.engine_init(jtopo["noise_model"], jpar["suppressor_strength"])
    teng = tsupp.engine_init(ttopo["noise_model"], tpar["suppressor_strength"],
                             device="cpu")
    jdelay = np.zeros(jeng["latency_samples"], np.float32)
    tdelay = np.zeros(teng["latency_samples"], np.float32)
    xs = _mic(4, seed=7)
    for b in range(4):
        jstate, jy, jeng, jdelay = jp._process_block(jcfg, jparams, jstate, xs[b:b + 1],
                                                     jeng, jdelay, jtopo)
        tstate, ty, teng, tdelay = tp._process_block(tcfg, tparams, tstate, xs[b:b + 1],
                                                     teng, tdelay, ttopo)
        assert ty.shape == (T,) and ty.dtype == np.float32
        _assert_audio(ty, jy)
        _assert_published(tp._metrics, jp._metrics)
        assert tp._counters == jp._counters
        assert tdelay.shape == jdelay.shape
        if tdelay.size:
            _assert_audio(tdelay, jdelay)
    assert jp._metrics["output_peak_db"] > -60.0  # audio went through
    # the chain state went the same way, and the port's static state stayed
    # the same tensors
    ref = jax.tree_util.tree_map(np.asarray, jstate)
    got = convert.to_numpy(tstate, ref)
    np.testing.assert_allclose(got["compressor"]["current_gr_db"],
                               ref["compressor"]["current_gr_db"], atol=1e-2)
    assert tstate is tp._state
    assert len(tp._graphs) == 1


def test_lifecycle_on_a_virtual_tone():
    p = tproc.AudioProcessor(device="cpu")
    p.set_rnnoise_enabled(False)
    captured = []
    tproc.register_virtual_output("torch-test-capture", lambda: captured.append)
    assert p.start("Test Tone Input", "torch-test-capture") == (
        "Started: Test Tone Input -> torch-test-capture")
    try:
        assert p.is_running() and p.get_active_input_device() == "Test Tone Input"
        with pytest.raises(RuntimeError, match="Already running"):
            p.start("Test Tone Input", "torch-test-capture")
        started = time.perf_counter()  # a CPU block takes ~0.4 s here
        while p._counters["blocks_processed"] < 1 and time.perf_counter() - started < 2.0:
            time.sleep(0.01)
        assert p._counters["blocks_processed"] >= 1
    finally:
        p.stop()
    assert not p.is_running() and p.get_active_input_device() is None
    d = p.get_runtime_diagnostics()
    assert d["rt_error_code"] == 0 and d["last_stream_error"] is None
    assert d.keys() == jproc.AudioProcessor().get_runtime_diagnostics().keys()
    with pytest.raises(RuntimeError, match="Failed to resolve"):
        p.start("No Such Device")
    with pytest.raises(RuntimeError, match="Failed to resolve"):
        p.start(None, "No Such Output")


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_public_surface_is_the_reference_engine_plus_device():
    assert _public(tproc.AudioProcessor) == _public(jproc.AudioProcessor) | {"device"}
    assert set(tproc.__all__) == set(jproc.__all__)


def test_engine_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tproc.AudioProcessor()
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsupp.engine_init("rnnoise")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli_main(["run", "--duration", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli_main(["diagnostics", "--settle", "0.1"])
    # run --preset is ported: on the card by default, so without one it raises
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli_main(["run", "--preset", "x.json"])
    assert tproc.AudioProcessor(device="cpu").device == torch.device("cpu")


def test_devices_prints_what_the_reference_prints(monkeypatch):
    # Both registries start from the same (empty) tables: other test files
    # on this worker register their own devices in one package only.
    for registry in (tproc, jproc):
        monkeypatch.setattr(registry, "_INPUT_DEVICES", {})
        monkeypatch.setattr(registry, "_OUTPUT_DEVICES", {})
        registry.register_virtual_input("torch-test-44k",
                                        lambda n: np.zeros(n, np.float32),
                                        sample_rate=44100)
        registry.register_virtual_output("torch-test-capture", lambda: print)
    got, ref = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(got):
        assert cli_main(["devices"]) == 0
    with contextlib.redirect_stdout(ref):
        assert jax_devices(None) == 0
    assert got.getvalue() == ref.getvalue()
    assert "input: torch-test-44k @ 44100 Hz" in got.getvalue()
