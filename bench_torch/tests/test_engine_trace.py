"""``engine_trace.py`` on the CPU: the engine's idle split on synthetic
device intervals and spans, the harness's reduced trace left as it is, the
new readers on synthetic runs, where the spans go on and off in a run, and
a TINY traced run with and without the program's tracer."""

import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from bench_torch import engine_trace, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {"fleet": 8, "mix": {"call_blocks": 3, "pool_streams": 8, "pool_seconds": 0.5,
                            "tick_ms": 2000.0, "probe_latest": 0.0},
        "check": {"probes": 2, "blocks": 3}}
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Event:
    def __init__(self, start, end, name, kind):
        self._s, self._e, self._n, self._k = start, end, name, kind

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def name(self):
        return self._n

    def device_type(self):
        return self._k


class _Prof:
    """What ``reduce_trace`` reads of a ``torch.profiler.profile``."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _span(sid, name, start, end, parent=None):
    return {"name": name, "id": sid, "parent": parent, "start_ns": start, "end_ns": end,
            "call": 1, "thread": 1, "attrs": {}}


# one step_many call inside the benchmark's span: device work 20-30, 40-70
# and 90-95; the engine gathers 12-20, launches 20-40 (the capture at 30-35),
# waits 40-75 and delivers 80-98
DEVICE = [_Event(20, 30, "kernel_a", CUDA), _Event(40, 70, "kernel_b", CUDA),
          _Event(90, 95, "memcpy", CUDA), _Event(20, 30, "step_many", CUDA)]
AROUND = [_Event(0, 10, "push", CPU), _Event(11, 99, "step_many", CPU),
          _Event(99, 100, "check", CPU)]
SNAP = {"spans": [_span(1, "engine.step_many", 11, 98),
                  _span(2, "engine.gather", 12, 20, 1),
                  _span(3, "engine.launch", 20, 40, 1),
                  _span(4, "engine.capture", 30, 35, 3),
                  _span(5, "engine.wait", 40, 75, 1),
                  _span(6, "engine.deliver", 80, 98, 1)],
        "samples": {}, "counters": {}}
for s in SNAP["spans"]:
    if s["name"] == "engine.step_many":
        s["attrs"] = {"n_blocks": 3, "shards": 1}
# the call before, with the profiler off: gather 4, wait 60, deliver 6
BEFORE = {"spans": [dict(_span(11, "engine.step_many", 0, 80), call=11,
                         attrs={"n_blocks": 3, "shards": 1}),
                    dict(_span(12, "engine.gather", 1, 5, 11), call=11),
                    dict(_span(13, "engine.wait", 10, 70, 11), call=11),
                    dict(_span(14, "engine.deliver", 72, 78, 11), call=11)],
          "samples": {"replay.stage_ms.suppressor": [[70, 2.0], [71, 3.0]],
                      "replay.stage_ms.front": [[70, 1.0]],
                      "replay.stage_ms.vad": [[70, 0.5]],
                      "replay.stage_ms.back": [[70, 1.5]]},
          "counters": {}}


def test_engine_idle_splits_the_stretch_and_leaves_the_harness_keys():
    prof = _Prof(DEVICE + AROUND)
    plain = harness.reduce_trace(prof, 3)
    hooks = engine_trace.Hooks(harness, engine_trace._tracer(), 1)
    hooks.profiled, hooks.unprofiled = SNAP, BEFORE
    traced = hooks.reduce(prof, 3)
    assert set(traced) == set(plain) | {"engine"}
    assert {k: traced[k] for k in plain} == plain
    e = traced["engine"]
    assert e["window_ns"] == 100 and e["busy_ns"] == 45
    assert sum(e["idle_ns"].values()) == 100 - 45
    assert e["idle_ns"] == {engine_trace.OUTSIDE: 11 + 2, "engine.step_many": 5 + 1,
                            "engine.gather": 8, "engine.launch": 5, "engine.capture": 5,
                            "engine.wait": 5, "engine.deliver": 10 + 3}
    assert e["calls"] == 1 and e["clock_misaligned"] == 0
    # the self times and the stages come from the call before, not the profiled one
    u = e["unprofiled"]
    assert u["blocks"] == 3
    assert u["self_ns"] == {"engine.step_many": 80 - 70, "engine.gather": 4,
                            "engine.wait": 60, "engine.deliver": 6}
    assert u["stage_ms"] == {"suppressor": 2.5, "front": 1.0, "vad": 0.5, "back": 1.5}
    # idle under the host's stages, the launch's left out of both sides
    share = _reader("device_idle_engine_pct.batch")({"mix": {"loop": "closed"},
                                                     "trace": traced})
    assert share == pytest.approx(100.0 * (8 + 5 + 13 + 6) / (100 - 5))
    assert _reader("engine_gather_ms.batch")({"mix": {"loop": "closed"},
                                              "trace": traced}) == 4 / 1e6 / 3
    assert _reader("replay_dsp_ms.batch")({"mix": {"loop": "closed"}, "trace": traced}) == 3.0


def test_a_root_outside_the_benchmarks_span_is_misaligned():
    late = dict(SNAP, spans=[dict(s, start_ns=s["start_ns"] + 200_000,
                                  end_ns=s["end_ns"] + 200_000) for s in SNAP["spans"]])
    e = engine_trace.split_engine([(20, 30)], [(11, 99, "step_many")], late, 3)
    assert e["clock_misaligned"] == 1
    close = dict(SNAP, spans=[dict(s, end_ns=s["end_ns"] + 50_000) for s in SNAP["spans"]])
    assert engine_trace.split_engine([(20, 30)], [(11, 99, "step_many")], close,
                                     3)["clock_misaligned"] == 0


def test_no_engine_spans_add_nothing():
    prof = _Prof(DEVICE + AROUND)
    hooks = engine_trace.Hooks(harness, None, 1)  # a program without a tracer
    assert "engine" not in hooks.reduce(prof, 3)
    hooks.profiled = {"spans": [], "samples": {}, "counters": {}}
    assert "engine" not in hooks.reduce(prof, 3)
    # the profiled stretch alone: the idle split, and no self times
    hooks.profiled = SNAP
    assert hooks.reduce(prof, 3)["engine"]["unprofiled"] is None


def _reader(name):
    path = ROOT / "bench_torch" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"engine_trace_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("metric", [m["name"] for m in engine_trace.ENGINE_METRICS])
def test_each_new_reader_reads_its_loop_and_nothing_else(metric):
    read = _reader(metric)
    engine = engine_trace.split_engine([(20, 30), (40, 70), (90, 95)],
                                       [(11, 99, "step_many")], SNAP, 3)
    engine["unprofiled"] = engine_trace.unprofiled_part(BEFORE)
    loop = "closed" if metric.endswith(".batch") else "open"
    other = "open" if loop == "closed" else "closed"
    value = read({"mix": {"loop": loop}, "trace": {"busy_s": 4.5e-8, "engine": engine}})
    assert isinstance(value, float) and value >= 0.0
    assert read({"mix": {"loop": other}, "trace": {"busy_s": 4.5e-8, "engine": engine}}) is None
    assert read({"mix": {"loop": loop}, "trace": {"busy_s": 4.5e-8}}) is None
    assert read({"mix": {"loop": loop}, "trace": None}) is None
    if "idle" not in metric:  # the profiled stretch alone reads no self time
        assert read({"mix": {"loop": loop}, "trace": {"busy_s": 4.5e-8,
                                                      "engine": dict(engine, unprofiled=None)}}) is None


def test_spans_go_on_a_stretch_before_the_profiled_one():
    assert engine_trace.spans_from({"loop": "closed", "call_blocks": 100}, 30.0) == 1
    # 3,000 ticks: the profiled ticks start at the 1,500th
    assert engine_trace.spans_from({"loop": "open", "tick_ms": 10.0}, 30.0) == 1400
    assert engine_trace.spans_from({"loop": "open", "tick_ms": 10.0}, 1.0) == 0


def test_tiny_run_traces_the_call_before_and_the_profiled_call():
    """Spans on over the window's second call (the profiler off) and its
    third (profiled), off before and after: one engine call each."""
    from audioforge_tpu_torch.runtime import tracing

    cell = harness.find_cell(BENCH, "default_dfn3_ll.batch")
    torch.set_num_threads(2)
    sizes = dict(TINY, mix=dict(TINY["mix"], call_blocks=2))
    with engine_trace.engine_hooks({"loop": "closed"}, 4.0) as hooks:
        harness.run_cell(BENCH, cell, 2**31 + 29, 4.0, True, time.perf_counter(),
                         device="cpu", sizes=sizes, reference=False)
        calls = hooks.calls
    assert calls >= 3 and not tracing.enabled()
    for snap in (hooks.unprofiled, hooks.profiled):
        roots = [s for s in snap["spans"] if s["parent"] is None]
        assert [(r["name"], r["attrs"]["n_blocks"]) for r in roots] == [("engine.step_many", 2)]
    assert hooks.unprofiled["spans"][-1]["end_ns"] < hooks.profiled["spans"][0]["start_ns"]


def test_new_metrics_follow_the_files_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    names = {m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]}
    for m in engine_trace.ENGINE_METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["name"] not in names and m["layer"] in layers
        assert (ROOT / "bench_torch" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]]["workloads"]


@pytest.mark.parametrize("cell, tracer", [("default_dfn3_ll.batch", True),
                                          ("default_dfn3_ll.paced", True),
                                          ("default_dfn3_ll.batch", False)])
def test_tiny_traced_run_on_the_cpu(cell, tracer, monkeypatch, capsys):
    """A CPU trace holds no device work: every new reader finds nothing and
    none raises, with the program's tracer and without one (the parent
    program's case); the harness comes out of the hooks as it went in."""
    if not tracer:
        monkeypatch.setattr(engine_trace, "_tracer", lambda: None)
    hooks = (harness.warm_up, harness._Run.step, harness._Run.start_profile,
             harness._Run.stop_profile, harness.reduce_trace)
    torch.set_num_threads(2)
    result = engine_trace.traced_run(BENCH, harness.find_cell(BENCH, cell), 2**31 + 13, 2.0,
                                     time.perf_counter(), device="cpu", sizes=TINY)
    # the probes attach before the first call; a tick of the tiny paced mix
    # outlasts the window, so its probes go unchecked
    assert result["correct"] is cell.endswith(".batch")
    assert not set(result["metrics"]) & {m["name"] for m in engine_trace.ENGINE_METRICS}
    assert (harness.warm_up, harness._Run.step, harness._Run.start_profile,
            harness._Run.stop_profile, harness.reduce_trace) == hooks
    from audioforge_tpu_torch.runtime import tracing
    assert not tracing.enabled()
