"""The counting functions against PyTorch's FLOP counter over the plain
reference models, and the traffic generator's seeding (CPU)."""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from bench_torch import counts
from bench_torch.reference.models import dfn3, rnnoise, silero
from bench_torch.reference.ops import biquad
from bench_torch.reference.runtime import step as ref
from bench_torch.traffic.generator import Traffic

ROOT = Path(__file__).resolve().parents[2]
N = 4


@contextlib.contextmanager
def uncounted(module, *names):
    """Inside it, ``module.<name>`` runs outside the FLOP counter: the
    stages that the program runs as hand kernels, which ``counts`` counts
    by their own formulas."""
    saved = {n: getattr(module, n) for n in names}

    def hide(f):
        def call(*a, **k):
            with _disable_current_modes():
                return f(*a, **k)
        return call

    for n, f in saved.items():
        setattr(module, n, hide(f))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_rnnoise_counts_match_the_flop_counter():
    x = torch.randn(N, 480) * 3000.0
    w = rnnoise.load_weights(ROOT / "models/rnnoise.npz")
    st = rnnoise.rnnoise_state_init(n=N, device="cpu")
    with uncounted(biquad, "biquad_cascade"):
        measured = _flops(lambda: rnnoise.rnnoise_frame(w, st, x))
    m = counts.rnnoise_macs(counts._archive(ROOT / "models/rnnoise.npz"))
    assert m["layers"] == 86952  # Valin 2018: ~87k multiply-adds a frame
    assert 2 * N * (m["layers"] + m["dsp"] + m["pitch"]) == measured


def test_silero_counts_match_the_flop_counter():
    cfg = ref.ServingConfig(capacity=N, vad_enabled=True, suppressor_model=None)
    w = ref.load_weights(cfg, {"vad": ROOT / "models/silero_vad.npz"})
    sp = ref.stream_params(cfg, w, N)["vad"]
    st = ref._vad_state_init(cfg, "cpu")
    x = torch.randn(N, 480) * 0.1
    with uncounted(silero, "vad_front", "vad_lstm_head"):
        measured = _flops(lambda: ref._vad_step(sp, st, x))
    m = counts.silero_macs(counts._archive(ROOT / "models/silero_vad.npz"))
    assert 2 * N * m["layers"] == measured


def test_dfn3_ll_counts_match_the_flop_counter():
    w = dfn3.load_weights(ROOT / "models/dfn3_ll.npz")
    st = dfn3.dfn_state_init(n=N, device="cpu")
    x = torch.randn(N, 480) * 0.1
    with uncounted(dfn3, "dfn_features", "dfn_spec_synth"):
        measured = _flops(lambda: dfn3.dfn_frame(w, st, x, torch.tensor(30.0),
                                                 torch.tensor(0.0)))
    m = counts.dfn3_macs(counts._archive(ROOT / "models/dfn3_ll.npz"))
    assert 2 * N * m["layers"] == measured


@pytest.mark.parametrize("config", ["full_rnnoise_vad", "default_dfn3_ll"])
def test_stage_bounds_are_a_least_time(config):
    import json
    cfg = json.loads((ROOT / f"bench_torch/configs/{config}.json").read_text())
    totals = counts.step_totals(cfg, 1024, ROOT)
    # a block of 1,024 streams is bounded well under the card's 3.6-6 ms
    # replay: the sum of bounds is a floor, not an estimate
    assert 0 < totals["bound_s"] < 1e-3
    assert totals["peak_s"] <= totals["bound_s"]


MIX = {"signal": "mic_capture", "pool_streams": 8, "pool_seconds": 0.5, "probe_latest": 0.8}


def test_same_seed_same_traffic_other_seed_other():
    a, b, c = (Traffic(MIX, 16, 2, s) for s in (2**31 + 3, 2**31 + 3, 2**31 + 4))
    assert np.array_equal(a.pool, b.pool)
    assert np.array_equal(a.offset, b.offset) and np.array_equal(a.probe_at, b.probe_at)
    assert np.array_equal(a.probe_input(1, 5), b.probe_input(1, 5))
    assert not np.array_equal(a.pool, c.pool)
    assert not np.array_equal(a.offset, c.offset)


def test_traffic_keeps_every_stream_class_and_the_probes_spread():
    t = Traffic(MIX, 64, 8, 7)
    assert np.array_equal(t.source % 4, np.arange(64) % 4)
    assert np.array_equal(t.probe_slots // 8, np.arange(8))  # one in each eighth of the fleet
    assert np.array_equal(t.probe_source % 4, t.probe_slots % 4)
    assert np.array_equal(t.probe_slots % 4, np.arange(8) % 4)  # two probes a class
    assert ((0 <= t.probe_at) & (t.probe_at < 0.8)).all()
    # the slot within its range is drawn: over seeds, each of a range's
    # slots of the class comes up
    drawn = {int(Traffic(MIX, 64, 8, s).probe_slots[2]) for s in range(40)}
    assert drawn == {18, 22}


def test_idle_time_goes_to_the_innermost_open_span():
    from bench_torch.harness import idle_by_span

    dev = [(10, 20), (15, 30), (40, 50), (60, 61)]
    host = [(0, 100, "step"), (35, 55, "deliver"), (70, 90, "check")]
    busy, idle = idle_by_span(dev, host, 0, 100)
    assert busy == 31
    assert idle == {"step": 39, "deliver": 10, "check": 20}
    busy, idle = idle_by_span(dev, [(5, 25, "push")], 0, 100)
    assert idle == {"outside the benchmark's spans": 64, "push": 5}
