"""The program ``chain`` (Auto Voice Setup's compressor search through the
port's ``api.simulate_auto_eq_chain_batched``, ``voice_setup_search.wave1_10s``)
on the CPU at tiny sizes: its result line, its check against planted faults
and against the controls, its search's candidates, its stage counts, its
reference against the port, and the serving cells' numbers through the
harness's dispatch.

    python -m pytest bench_torch/tests/test_chain_program.py -q -p no:cacheprovider -n 4
"""

import importlib.util
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
from bench_torch.programs import chain as prog_chain
from bench_torch.programs import chain_readings
from bench_torch.programs.chain_faults import FAULTS
from bench_torch.tests.test_counts_traffic import uncounted
from bench_torch.traffic.generator import Searches, first_wave

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "voice_setup_search.wave1_10s"
CONFIG = json.loads((ROOT / "bench_torch/configs/voice_setup_search.json").read_text())
MIX = json.loads((ROOT / "bench_torch/traffic/wave1_10s.json").read_text())
# takes of two 20 ms blocks, 6 candidates (the incumbent, a 3-point sweep,
# 2 Halton points), four probe calls (one a class) of two candidates each, all
# due at once (so the first four calls of the window, which SECONDS holds on
# the CPU)
TINY = {"take_seconds": 0.04, "takes": 4, "threshold_sweep": 3, "halton_points": 2,
        "probe_calls": 4, "probe_latest": 0.0}
SIZES = {"mix": TINY, "check": {}}
SECONDS = 20.0

DRIVE = """
import json, sys, time
t0 = time.perf_counter()
import torch
torch.set_num_threads(2)
from bench_torch import harness
bench = json.loads(open("BENCHMARK.json").read())
cell = harness.find_cell(bench, {cell!r})
r = harness.run_cell(bench, cell, 2**31 + 11, {seconds}, {trace}, t0, device="cpu",
                     sizes={sizes!r})
harness.print_result(r)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                           "audioforge_tpu"))
print(json.dumps({{"imported": bad}}))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_exactly_the_contract_keys(trace):
    """Through the harness's dispatch, the reference in worker processes."""
    proc = subprocess.run([sys.executable, "-c", DRIVE.format(cell=CELL, seconds=SECONDS,
                                                              trace=trace, sizes=SIZES)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    result, modules = json.loads(lines[-2]), json.loads(lines[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % 6 == 0 and result["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert result["check"]["probes_checked"] == {"value": 8, "limit": 8}
    assert set(result["check"]) == {"probes_checked", *CONFIG["check"]["limits"]}
    want = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    got = set(result["metrics"])
    # the trace's readers find no device work on the CPU, and the port's CPU
    # path captures no graph, so a traced CPU run reports nothing
    assert got <= want and (trace or got == {"audio_s_per_s", "setup_s"})
    assert modules["imported"] == []
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


def _run(hook):
    torch.set_num_threads(2)
    return prog_chain.run_cell(BENCH, harness.find_cell(BENCH, CELL), 2**31 + 21, SECONDS, False,
                               time.perf_counter(), device="cpu", sizes=SIZES,
                               engine_hook=hook, workers=0)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    result = _run(FAULTS[fault])
    assert result["correct"] is False, result["check"]


def test_the_sound_program_is_correct():
    result = _run(None)
    assert result["correct"] is True, result["check"]
    assert result["check"]["probes_checked"]["value"] == 8
    assert result["check"]["diagnostics_gap_max"]["value"] == 0.0


@pytest.mark.parametrize("kind", chain_readings.CONTROLS)
def test_a_control_fails_the_check(kind):
    """The reference one precision below the configuration's, in the
    program's place, on two seeds' probes."""
    limits = CONFIG["check"]["limits"]
    for seed in (2**31 + 1, 2**31 + 2):
        s = Searches(dict(MIX, **TINY), CONFIG, seed)
        rows = {}
        for what in ("want", "moved", kind):
            parts = []
            for j in range(len(s.probe_at)):
                take = s.takes[s.probe_take[j]]
                cands = [s.candidates[i] for i in s.probe_candidates[j]]
                parts.append(prog_chain.reference_job(
                    CONFIG, harness.one_ulp_up(take) if what == "moved" else take, cands,
                    None if what in ("want", "moved") else kind))
            rows[what] = (np.concatenate([y for y, _ in parts]),
                          {k: np.concatenate([st[k] for _, st in parts]) for k in parts[0][1]})
        classes = np.repeat(s.probe_class, s.probe_candidates.shape[1])
        numbers = prog_chain.compare_rows(rows[kind], rows["want"], rows["moved"], classes)
        assert any(not numbers[k] <= v for k, v in limits.items() if k in numbers), numbers


def test_the_f32_cascade_is_the_f64_cascade_to_float32_rounding():
    """Over two blocks, the second from each one's own state. The EQ's
    high-Q sections amplify float32's rounding: over 20 random inputs the gap
    is 4e-5 to 1.5e-4 of the output, so 1e-3; a cascade that filtered
    otherwise would be off by the order of the output itself."""
    from bench_torch.reference.ops import biquad
    from bench_torch.reference.runtime import chain, search

    c = torch.as_tensor(chain.eq_coeffs(search.legacy_bands(CONFIG["bands"]), 48000.0))
    x = torch.randn(2, 3, 480, generator=torch.Generator().manual_seed(2**31 + 9)) * 0.1

    def two_blocks():
        z = torch.zeros((3, c.shape[0], 2), dtype=torch.float64)
        y0, z = biquad.apply_fixed(c, z, x[0])
        y1, _ = biquad.apply_fixed(c, z, x[1])
        return torch.cat([y0, y1], dim=1).double()

    y64 = two_blocks()
    with chain_readings.lower("f32_biquad"):
        y32 = two_blocks()
    assert 0 < float((y32 - y64).norm() / y64.norm()) < 1e-3


def test_the_first_wave_is_voice_setups():
    """The incumbent, 33 thresholds from -55 to -6 dB, then Halton points in
    bases 2, 3, 5 and 7 over the four bounds."""
    wave = first_wave(CONFIG["incumbent"], CONFIG["search_bounds"], 33, 16)
    assert len(wave) == 50 and wave[0] == CONFIG["incumbent"]
    sweep = [c["threshold_db"] for c in wave[1:34]]
    assert sweep[0] == -55.0 and sweep[-1] == -6.0 and np.allclose(np.diff(sweep), 49 / 32)
    assert all(c["ratio"] == 3.0 for c in wave[1:34])
    assert np.allclose([wave[34][k] for k in ("threshold_db", "ratio", "attack_ms",
                                              "release_ms")],
                       [-55 + 49 / 2, 1.5 + 4.5 / 3, 3 + 22 / 5, 60 + 260 / 7])
    assert np.allclose(wave[35]["threshold_db"], -55 + 49 / 4)


def test_probes_hold_every_class_and_distinct_candidates():
    s = Searches(MIX, CONFIG, 2**31 + 7)
    assert s.takes.shape == (8, 480000)
    assert list(s.probe_class) == [0, 1, 2, 3]
    assert list(s.probe_take % 4) == [0, 1, 2, 3]
    assert all(len(set(c)) == 2 for c in s.probe_candidates)
    assert np.all(np.diff(s.probe_at) >= 0) and s.probe_at.max() < MIX["probe_latest"]
    again = Searches(MIX, CONFIG, 2**31 + 7)
    assert np.array_equal(again.takes, s.takes) and np.array_equal(again.probe_take, s.probe_take)


def test_chain_stage_counts_match_the_flop_counter():
    """The stages that run no hand kernel count what PyTorch's counter
    counts on the port's CPU path: the three true-peak interpolators'
    products of a 20 ms block."""
    from audioforge_tpu_torch import api
    from audioforge_tpu_torch.ops import biquad
    from audioforge_tpu_torch.runtime import chain

    n, T = 4, 960
    cfg, params, _ = api._chain_config_from_settings(48000.0, CONFIG["settings"])
    bands = api._legacy_bands(CONFIG["bands"], 48000.0)
    p = chain.comp_param_tensors(params, n, "cpu")
    st = chain.chain_init(cfg, params, bands, batch_shape=(n,), device="cpu")
    x = torch.randn(n, T) * 0.1
    with uncounted(biquad, "biquad_cascade"):
        with FlopCounterMode(display=False) as counter:
            chain.chain_block(cfg, p, st, x)
    stages = counts.chain_stages(CONFIG, n)
    fir = sum(s.launches for s in stages if s.name.startswith("true-peak"))
    assert fir == 3
    assert counter.get_total_flops() == fir * 2 * counts.TP_MACS * n * T
    assert {s.name for s in stages} >= {"deesser_scan", "compressor_scan", "limiter_gain_scan",
                                        "biquad_cascade x 10", "biquad_cascade x 2"}
    totals = counts.chain_totals(CONFIG, 50)
    assert 0 < totals["peak_s"] <= totals["bound_s"] < 1e-3


def _variant(**settings) -> dict:
    return dict(CONFIG, settings={**CONFIG["settings"], **settings})


@pytest.mark.parametrize("config", [CONFIG, _variant(eq_before_deesser=True),
                                    _variant(compressor_enabled=False),
                                    _variant(compressor_auto_makeup_enabled=True,
                                             compressor_adaptive_release=False)],
                         ids=["search", "eq_first", "compressor_off", "auto_makeup"])
def test_the_reference_is_the_ports_render_on_the_cpu(config):
    """The whole-take reference against the port's entry point on the CPU
    (its plain twins), 5 blocks of 3 candidates of each class's take, and
    the port's diagnostics against the reference's arithmetic over the
    port's rows. The audio within 1e-5 relative RMS and each stat within
    1e-4 of the larger of 1 and its largest value: the reference runs its
    recurrences in float64 and the port in float32, whose rounding moves the
    audio by up to 4e-6 of its RMS and the stats by up to 2e-5 of theirs on
    these takes; a change in what either computes moves them by far more.
    The diagnostics agree exactly."""
    from audioforge_tpu_torch import api
    from bench_torch.reference.runtime import search

    torch.set_num_threads(2)
    s = Searches(dict(MIX, **{**TINY, "take_seconds": 0.1}), config, 2**31 + 3)
    cands = [s.candidates[i] for i in (0, 1, 4)]
    kept = {}
    sound = api._run_chain

    def keep(*args):
        kept["rows"] = sound(*args)
        return kept["rows"]
    api._run_chain = keep
    try:
        for take in s.takes:
            sims = api.simulate_auto_eq_chain_batched(take, 48000.0, config["bands"],
                                                      config["settings"], cands, device="cpu")
            ys, stats = kept["rows"]
            want, want_stats = prog_chain.reference_job(config, take, cands)
            y, w = ys.astype(np.float64), want.astype(np.float64)
            assert np.sqrt(np.mean((y - w) ** 2)) <= 1e-5 * np.sqrt(np.mean(w ** 2))
            assert set(stats) == set(want_stats)
            for k in want_stats:
                a, b = stats[k].astype(np.float64), want_stats[k].astype(np.float64)
                assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max()), k
            data = {"takes": [take], "got": [ys], "stats": [stats], "diagnostics": sims}
            assert prog_chain.diagnostics_gap(config, data) == 0.0
    finally:
        api._run_chain = sound


def _harness_without_dispatch(tmp: Path):
    """``harness.py`` with the dispatch to ``programs/`` cut out: the
    serving path as it was before programs other than the engine."""
    src = (ROOT / "bench_torch/harness.py").read_text()
    start = src.index('    program = load_json(HERE / "configs"')
    end = src.index("    config, mix, fleet = cell_files(cell)\n")
    path = tmp / "harness_without_dispatch.py"
    path.write_text(src[:start] + src[end:])
    spec = importlib.util.spec_from_file_location("bench_torch._harness_without_dispatch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.HERE = harness.HERE  # its configs, mixes and readers are the benchmark's
    return module


@pytest.mark.parametrize("cell", ["full_rnnoise_vad.batch", "default_dfn3_ll.paced"])
def test_a_serving_cell_reads_the_same_through_the_dispatch(cell, tmp_path):
    """At one seed, a tiny serving cell's probes come out the same, and
    compare the same, through the dispatch as without it."""
    sizes = {"fleet": 8, "mix": {"call_blocks": 3, "pool_streams": 8, "pool_seconds": 0.5,
                                 "tick_ms": 1000.0, "probe_latest": 0.0},
             "check": {"probes": 2, "blocks": 3}}
    torch.set_num_threads(2)
    found = harness.find_cell(BENCH, cell)
    runs = [h.run_cell(BENCH, found, 2**31 + 31, 3.0, False, time.perf_counter(),
                       device="cpu", sizes=sizes, reference=False)
            for h in (harness, _harness_without_dispatch(tmp_path))]
    a, b = (r["probes"] for r in runs)
    assert a["checked"] == b["checked"] == 2
    assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["got"], b["got"])
    assert runs[0]["failed"] == runs[1]["failed"] == 0


def test_run_prints_no_result_when_the_jax_package_was_loaded(monkeypatch, capsys):
    import types

    sys.path.insert(0, str(ROOT / "bench_torch"))
    try:
        import run
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def fake_run_cell(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "audioforge_tpu", types.ModuleType("audioforge_tpu"))
        return {"check": {}}
    monkeypatch.setattr(harness, "run_cell", fake_run_cell)
    code = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and not out.out.strip()
    assert "audioforge_tpu" in out.err
