"""The program ``live`` (one user's microphone through ``AudioProcessor``,
``live_rnnoise.rt``) on the CPU: its result line, its check against the
planted faults and the controls, its probes' plan, its counts, and the
parent's tracer stopping it at once.

On the CPU a block of the full chain takes over a second, so the engine
runs in slow motion (``SIZES``: a tick of 1.5 s, the virtual devices pacing
it, the VAD's staleness stretched as much) with short stretches, segments
in a fixed order and no lead.

    python -m pytest bench_torch/tests/test_live_program.py -q -p no:cacheprovider -n 4
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch import counts, harness
from bench_torch.counts import live as live_counts
from bench_torch.programs import live
from bench_torch.programs.live_faults import FAULTS
from bench_torch.programs.live_readings import CONTROLS
from bench_torch.reference.models import rnnoise, silero
from bench_torch.tests.test_counts_traffic import uncounted

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "live_rnnoise.rt"
CONFIG = json.loads((ROOT / "bench_torch/configs/live_rnnoise.json").read_text())
# three probes (classes 0, 1, 2: the sibilant class shows the de-esser) in
# the first three segments of 25 blocks after the window's start
SIZES = {"mix": {"tick_ms": 1500.0, "lead_seconds": 0.0, "drain_seconds": 3.0,
                 "segment_seconds": 0.25, "segment_order": [2, 0, 1, 3], "probe_wait_s": 120.0},
         "check": {"blocks": 6, "probes": 3}}
SECONDS = 96.0
SEED = 2**31 + 11

DRIVE = """
import json, sys, time
t0 = time.perf_counter()
import torch
torch.set_num_threads(2)
from bench_torch import harness
bench = json.loads(open("BENCHMARK.json").read())
cell = harness.find_cell(bench, {cell!r})
r = harness.run_cell(bench, cell, {seed}, {seconds}, {trace}, t0, device="cpu",
                     sizes={sizes!r})
harness.print_result(r)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                           "audioforge_tpu"))
print(json.dumps({{"imported": bad}}))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_exactly_the_contract_keys(trace):
    """Through the harness's dispatch, the reference in a worker process."""
    proc = subprocess.run([sys.executable, "-c", DRIVE.format(cell=CELL, seed=SEED,
                                                              seconds=SECONDS, trace=trace,
                                                              sizes=SIZES)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    result, modules = json.loads(lines[-2]), json.loads(lines[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert result["correct"] is True, result["check"]
    # in slow motion the engine's last blocks may land after the drain
    assert 0 <= result["failed"] < result["attempted"]
    assert result["check"]["probes_checked"] == {"value": 3, "limit": 3}
    assert set(result["check"]) == {"probes_checked", *CONFIG["check"]["limits"]}
    assert result["check"]["dropped_spans"]["value"] == 0
    want = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    got = set(result["metrics"])
    # on the CPU no graph is captured and the card's readers find nothing
    on_cpu = {"live_block_p99_ms.rt", "live_pickup_ms.rt", "live_burst_ms.rt",
              "live_dropped_blocks.rt"}
    assert got == (on_cpu if trace else {"block_p50_ms", "setup_s"}) and got <= want
    assert modules["imported"] == []
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


def _run(hook, reference=True):
    torch.set_num_threads(2)
    return live.run_cell(BENCH, harness.find_cell(BENCH, CELL), SEED, SECONDS, False,
                         time.perf_counter(), device="cpu", sizes=SIZES, engine_hook=hook,
                         reference=reference, workers=0)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    result = _run(FAULTS[fault])
    assert result["check"]["probes_checked"]["value"] == 3
    assert result["correct"] is False, result["check"]


def test_the_sound_program_is_correct_and_the_controls_are_not():
    """The program's probes pass every limit; the reference in TF32, and
    with float32 biquads, each in the program's place, fail the check on
    the same probes."""
    r = _run(None, reference=False)
    data = r["probes"]
    assert data["checked"] == 3 and r["live"]["dropped_spans"] == 0
    blocks = SIZES["check"]["blocks"]
    n = data["checked"]
    both = live.reference_job(CONFIG, data["schedule"], live.with_ulp_up(data["probes"]),
                              blocks)
    classes = np.asarray(data["classes"])
    limits = CONFIG["check"]["limits"]

    def verdict(numbers):
        return harness.verdict(dict(numbers, probes_checked=(n, n), dropped_spans=0),
                               limits)[0]
    got = live.compare_all(data["got"], data["after"], classes, both, n)
    assert verdict(got), got
    for kind in CONTROLS:
        y, after = live.reference_job(CONFIG, data["schedule"], data["probes"], blocks, kind)
        numbers = live.compare_all(list(y), after, classes, both, n)
        assert not verdict(numbers), (kind, numbers)


def test_the_probes_cover_every_class_and_the_schedule_its_toggles():
    mix = json.loads((ROOT / "bench_torch/traffic/rt.json").read_text())
    audio, classes, seg = live.live_take(mix, SEED, 30.0)
    assert seg == 400 and audio.size == classes.size * seg * live.BLOCK
    assert all(sorted(classes[i:i + 4]) == [0, 1, 2, 3] for i in range(0, classes.size - 3, 4))
    # a window that starts about 2.15 s into the stream, as on the card
    lo = 215 + 20
    plan = live.plan_probes(np.random.default_rng(3), classes, seg, lo, lo + 3000 - 68 - 40,
                            16, 60)
    assert sorted(c for _, c in plan) == sorted(list(range(4)) * 4)
    for b, c in plan:
        assert classes[b // seg] == c and b % seg + 68 <= seg
    sched = live.control_schedule(mix, SEED, 30.0)
    assert [t for t, *_ in sched] == [2.0 * i for i in range(15)]
    assert [(t, d) for t, _, _, d in sched if d is not None] == [(10.0, False), (20.0, True)]
    assert all(abs(g) <= 6.0 for _, _, g, _ in sched)


def test_live_counts_match_the_flop_counter():
    """The RNNoise frame and a Silero window of one stream: the counted
    stages against PyTorch's FLOP counter over the plain reference."""
    stages = {s.name: s for s in live_counts.live_stages(CONFIG, ROOT)}
    w = rnnoise.load_weights(ROOT / "models/rnnoise.npz")
    st = rnnoise.rnnoise_state_init(n=1, device="cpu")
    x = torch.randn(1, 480) * 3000.0
    from bench_torch.reference.ops import biquad

    with uncounted(biquad, "biquad_cascade"), FlopCounterMode(display=False) as fc:
        rnnoise.rnnoise_frame(w, st, x)
    frame = stages["RNNoise frame"]
    assert frame.f32_ops == fc.get_total_flops() + 2 * counts._rfft_ops(960)
    vw = silero.load_weights(ROOT / "models/silero_vad.npz")
    with FlopCounterMode(display=False) as fc:
        silero.silero_infer(vw, torch.randn(1, 576) * 0.1,
                            torch.zeros(silero._N_LAYERS, 1, silero._STATE_DIM))
    model = stages["Silero worker: STFT, encoder and LSTM"]
    assert model.f32_ops == fc.get_total_flops()
    assert model.launches == pytest.approx(480 / 1536)
    totals = live_counts.live_totals(CONFIG, ROOT)
    assert totals["peak_s"] <= totals["bound_s"] < 1e-5


def test_the_parents_tracer_stops_the_program_at_once(monkeypatch):
    """A port whose tracer has no ``clock_ns`` has no live spans: the
    program exits before it builds anything."""
    from audioforge_tpu_torch.runtime import tracing

    monkeypatch.delattr(tracing, "clock_ns")
    t0 = time.perf_counter()
    with pytest.raises(SystemExit):
        _run(None)
    assert time.perf_counter() - t0 < 5.0
