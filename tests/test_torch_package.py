"""Package-level checks of the PyTorch port: the import rule, the kernel
build's failure mode without a CUDA toolchain, the wrappers' refusal of
devices they cannot launch on, and the ``serve`` command line on CPU."""

import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from audioforge_tpu_torch import kernels
from audioforge_tpu_torch.__main__ import main as cli_main
from audioforge_tpu_torch.models import dfn3, silero
from audioforge_tpu_torch.ops import biquad, compressor, deesser, envelope, gate
from audioforge_tpu_torch.ops import routing, scan

REPO = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = ("import sys, audioforge_tpu_torch, audioforge_tpu_torch.convert, "
            "audioforge_tpu_torch.runtime.serving, audioforge_tpu_torch.models.silero, "
            "audioforge_tpu_torch.models.dfn3, audioforge_tpu_torch.ops.resample, "
            "audioforge_tpu_torch.runtime.chain, audioforge_tpu_torch.runtime.replay, "
            "audioforge_tpu_torch.api, audioforge_tpu_torch.analysis.vad, "
            "audioforge_tpu_torch.__main__; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('audioforge_tpu.') or m == 'audioforge_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_wrappers_refuse_devices_they_cannot_launch_on():
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty((2, 8), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        scan.max_affine_scan(x, torch.empty(2, **meta), x, torch.empty(2, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        scan.limiter_gain_scan(x, x, *(torch.empty(2, **meta),) * 3, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        envelope.env_scan(x, torch.empty(8, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        biquad.biquad_cascade(x, torch.empty((2, 1, 2, 5), **meta),
                              torch.empty((2, 1, 2, 2), device="meta",
                                          dtype=torch.float64),
                              torch.empty((2, 1), device="meta", dtype=torch.int32),
                              torch.empty((2, 1), device="meta", dtype=torch.int32))
    cfg = compressor.CompressorConfig()
    with pytest.raises(ValueError, match="unsupported device"):
        compressor.compressor_scan(cfg, {}, torch.empty(2, **meta), {}, x)
    with pytest.raises(ValueError, match="unsupported device"):
        gate.gate_process(gate.GateConfig(), {}, x, None, None, None, None, {})
    with pytest.raises(ValueError, match="unsupported device"):
        deesser.deesser_scan(deesser.DeEsserConfig(enabled=True), {}, x)
    with pytest.raises(ValueError, match="unsupported device"):
        routing.cleanup_scan(routing.RoutingConfig(cleanup_mode=2), {}, {}, x)


def _launcher(kernel, n):
    """A call of ``kernel``'s launch path on CPU tensors for ``n`` streams,
    taking the block ``x``; it must raise in the layout checks before it
    reaches the (absent) library."""
    if kernel == "gate_scan":
        cfg = gate.GateConfig(mode=gate.VAD_ASSISTED)
        st = gate.gate_init(n=n, device="cpu")
        p = {k: torch.zeros(n) for k in gate.PARAM_KEYS}
        z = torch.zeros(n)
        return lambda x: gate._gate_scan(cfg, st, x, z, z.bool(), z.bool(), z, p)
    if kernel == "deesser_scan":
        cfg = deesser.DeEsserConfig(enabled=True)
        st = deesser.deesser_init(cfg, n=n, device="cpu")
        return lambda x: deesser._deesser_launch(cfg, st, x)
    cfg = routing.RoutingConfig(cleanup_mode=routing.CLEANUP_STRONG)
    st = routing.routing_init(cfg, n=n, device="cpu")
    zi = torch.zeros(n, dtype=torch.int32)
    ctx = dict.fromkeys(("boundary", "hold0", "hold_after", "cand0", "cand_new",
                         "wobs0", "wobs_new"), zi)
    return lambda x: routing._cleanup_launch(cfg, st, ctx, x)


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity"])
@pytest.mark.parametrize("kernel", ["gate_scan", "deesser_scan", "cleanup_scan"])
def test_new_kernels_reject_layouts_they_do_not_take(kernel, fault):
    n, T = 3, 16
    x = torch.zeros((n, T))
    if fault == "dtype":
        call, x = _launcher(kernel, n), x.double()
    elif fault == "shape":  # a state of one stream more than the block
        call = _launcher(kernel, n + 1)
    else:
        call, x = _launcher(kernel, n), torch.zeros((T, n)).t()
    with pytest.raises(ValueError, match={"dtype": "dtype", "shape": "shape",
                                          "contiguity": "contiguous"}[fault]):
        call(x)


def test_check_tensor_rejects_layouts_the_kernels_do_not_take():
    t = torch.zeros((4, 6))
    kernels.check_tensor("ok", t, torch.float32, (4, 6), t.device)
    with pytest.raises(ValueError, match="dtype"):
        kernels.check_tensor("x", t.double(), torch.float32, (4, 6), t.device)
    with pytest.raises(ValueError, match="shape"):
        kernels.check_tensor("x", t, torch.float32, (4, 5), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.check_tensor("x", t.t(), torch.float32, (6, 4), t.device)


def test_serve_cli_processes_a_wav_on_cpu(tmp_path, capsys):
    n = 4800  # 0.1 s at 48 kHz
    t = np.arange(n) / 48000.0
    pcm = (0.3 * np.sin(2 * np.pi * 200.0 * t) * 32767).astype("<i2")
    src = tmp_path / "voice.wav"
    with wave.open(str(src), "wb") as handle:
        handle.setnchannels(1)
        handle.setsampwidth(2)
        handle.setframerate(48000)
        handle.writeframes(pcm.tobytes())
    out_dir = tmp_path / "out"
    assert cli_main(["serve", str(src), "--output-dir", str(out_dir),
                     "--device", "cpu", "--deesser"]) == 0
    with wave.open(str(out_dir / "voice.processed.wav"), "rb") as handle:
        assert handle.getnframes() == n
        y = np.frombuffer(handle.readframes(n), "<i2")
    assert np.abs(y).max() > 0
    assert "1 streams" in capsys.readouterr().out



def _model_kernel_calls(n, launch):
    """One call of each model kernel's wrapper for ``n`` CPU streams, taking
    its first tensor argument; ``launch`` calls the launch path itself (its
    layout checks, then the kernel library)."""
    f = lambda *shape: torch.zeros(shape)
    p = {k: torch.as_tensor(v) for k, v in silero.init_params().items()}
    seen = torch.zeros(n, dtype=torch.int32)
    pick = lambda wrapper, launcher: launcher if launch else wrapper
    return {
        "vad_front": lambda x: pick(silero.vad_front, silero._vad_front_launch)(
            x, f(n, 30), f(n, 576), f()),
        "vad_lstm_head": lambda g: pick(silero.vad_lstm_head, silero._vad_lstm_head_launch)(
            p, g, f(n, 2, 128), f(n), seen, f(), silero.VAD_WARMUP_BLOCKS),
        "dfn_features": lambda s: pick(dfn3.dfn_features, dfn3._dfn_features_launch)(
            s, f(n, 32), f(n, 96)),
        "dfn_spec_synth": lambda s: pick(dfn3.dfn_spec_synth, dfn3._dfn_spec_synth_launch)(
            s, f(n, 32), f(n, 5, 96, 2), f(n, 5, 96, 2), f(), f()),
    }


_MODEL_FIRST_SHAPES = {"vad_front": (480,), "vad_lstm_head": (512,),
                       "dfn_features": (481, 2), "dfn_spec_synth": (481, 2)}


@pytest.mark.parametrize("kernel", list(_MODEL_FIRST_SHAPES))
def test_model_kernels_refuse_devices_they_cannot_launch_on(kernel):
    call = _model_kernel_calls(2, launch=False)[kernel]
    with pytest.raises(ValueError, match="unsupported device"):
        call(torch.empty((2,) + _MODEL_FIRST_SHAPES[kernel], device="meta"))


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity"])
@pytest.mark.parametrize("kernel", list(_MODEL_FIRST_SHAPES))
def test_model_kernels_reject_layouts_they_do_not_take(kernel, fault):
    n, shape = 3, _MODEL_FIRST_SHAPES[kernel]
    if fault == "dtype":
        x = torch.zeros((n,) + shape, dtype=torch.float64)
    elif fault == "shape":
        x = torch.zeros((n,) + shape[:-1] + (shape[-1] + 1,))
    else:
        x = torch.zeros(shape[::-1] + (n,)).permute(*range(len(shape), -1, -1))
    with pytest.raises(ValueError, match={"dtype": "dtype", "shape": "shape",
                                          "contiguity": "contiguous"}[fault]):
        _model_kernel_calls(n, launch=True)[kernel](x)


@pytest.mark.parametrize("flags", [["--vad"], ["--suppressor", "deepfilter-ll"],
                                   ["--suppressor", "deepfilter", "--vad"]])
def test_serve_cli_runs_the_model_stages_on_cpu(tmp_path, capsys, flags):
    n = 2400  # 50 ms
    rng = np.random.default_rng(5)
    pcm = (0.1 * rng.standard_normal(n) * 32767).astype("<i2")
    src = tmp_path / "mic.wav"
    with wave.open(str(src), "wb") as handle:
        handle.setnchannels(1)
        handle.setsampwidth(2)
        handle.setframerate(48000)
        handle.writeframes(pcm.tobytes())
    out_dir = tmp_path / "out"
    assert cli_main(["serve", str(src), "--output-dir", str(out_dir), "--device", "cpu",
                     *flags]) == 0
    with wave.open(str(out_dir / "mic.processed.wav"), "rb") as handle:
        assert handle.getnframes() == n
    assert "1 streams" in capsys.readouterr().out
