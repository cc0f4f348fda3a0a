"""The port's tracer (``runtime/tracing.py``) and the serving engine's spans,
counters and stage marks, on the CPU: the span tree of ``step``,
``step_many`` and ``step_pipelined``, spans off by default, the reset spans
against the engine's pending work, the ring's bound, and the spans' clock
against ``torch.profiler``'s."""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from audioforge_tpu_torch.runtime import live_chain as tlc
from audioforge_tpu_torch.runtime import serving as tsv
from audioforge_tpu_torch.runtime import tracing

BLOCK = tsv.BLOCK
ROOT = Path(__file__).resolve().parents[1]
CHILDREN = ("engine.gather", "engine.stage_vad", "engine.launch", "engine.wait",
            "engine.unpack", "engine.deliver")


@pytest.fixture
def spans_on():
    tracing.reset()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.reset()


def _engine(capacity=2):
    # no suppressor, gate or compressor: the plain twins' loops stay short
    return tsv.ServingEngine(
        tsv.ServingConfig(capacity=capacity, suppressor_model=None,
                          chain=tlc.LiveChainConfig(gate_enabled=False,
                                                    compressor_enabled=False)),
        device="cpu")


def _calls(spans):
    """Spans grouped by call id, each group's root first."""
    calls = {}
    for s in spans:
        calls.setdefault(s["call"], []).append(s)
    return {c: sorted(g, key=lambda s: s["parent"] is not None) for c, g in calls.items()}


def test_engine_calls_make_one_span_tree_each(spans_on):
    eng = _engine()
    got = []
    for _ in range(2):
        eng.push(eng.attach(sink=got.append), np.zeros(10 * BLOCK, np.float32))
    eng.step()
    eng.step_many(3)
    eng.step_pipelined()
    eng.step_pipelined()
    spans = tracing.snapshot()["spans"]
    calls = _calls(spans)
    roots = [g[0] for g in calls.values()]
    assert [r["name"] for r in roots] == ["engine.step", "engine.step_many",
                                         "engine.step_pipelined", "engine.step_pipelined"]
    assert [r["attrs"] for r in roots] == [{"n_blocks": 1, "shards": 1},
                                           {"n_blocks": 3, "shards": 1},
                                           {"n_blocks": 1, "shards": 1},
                                           {"n_blocks": 1, "shards": 1}]
    by_id = {s["id"]: s for s in spans}
    for root in roots:
        group = calls[root["call"]]
        assert root["parent"] is None and root["call"] == root["id"]
        for s in group[1:]:
            # every child lies inside its parent, on the same thread
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
            assert s["thread"] == root["thread"]
        direct = [s["name"] for s in group if s["parent"] == root["id"]]
        # the first pipelined call has no block to deliver yet
        want = CHILDREN[:3] if root is roots[2] else CHILDREN
        assert direct == list(want), (root["name"], direct)
    # the first step's gather ran the slots' resets and the control write
    first = calls[roots[0]["call"]]
    gather = next(s for s in first if s["name"] == "engine.gather")
    assert [s["name"] for s in first if s["parent"] == gather["id"]] == ["engine.reset"] * 2
    # the second pipelined call delivers the block the first one launched
    deliver = [s for s in calls[roots[3]["call"]] if s["name"] == "engine.deliver"]
    assert [d["attrs"]["cause"] for d in deliver] == [roots[2]["call"]]
    assert [s["attrs"]["cause"] for s in spans if s["name"] == "engine.deliver"
            and s["call"] in (roots[0]["call"], roots[1]["call"])] == [None, None]
    eng.flush_pipeline()
    last = tracing.snapshot()["spans"][-1]
    assert last["name"] == "engine.flush_pipeline"
    flushed = [s for s in tracing.snapshot()["spans"] if s["call"] == last["call"]
               and s["name"] == "engine.deliver"]
    assert [d["attrs"]["cause"] for d in flushed] == [roots[3]["call"]]


def test_spans_off_record_nothing():
    tracing.disable()
    tracing.reset()
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b", n_blocks=1)
    eng = _engine(1)
    eng.push(eng.attach(), np.zeros(BLOCK, np.float32))
    eng.step()
    tracing.count("probe", 2)
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["samples"] == {} and not snap["enabled"]
    # counters stay on; the CPU engine replays no graph, so counts nothing
    assert snap["counters"] == {"probe": 2}


def test_a_process_that_never_enables_spans_records_none():
    code = textwrap.dedent("""
        import json
        import numpy as np
        from audioforge_tpu_torch.runtime import live_chain as tlc
        from audioforge_tpu_torch.runtime import serving as tsv
        from audioforge_tpu_torch.runtime import tracing
        eng = tsv.ServingEngine(tsv.ServingConfig(
            capacity=1, suppressor_model=None,
            chain=tlc.LiveChainConfig(gate_enabled=False, compressor_enabled=False)),
            device="cpu")
        eng.push(eng.attach(sink=lambda block: None), np.zeros(960, np.float32))
        eng.step()
        eng.step_pipelined()
        snap = tracing.snapshot()
        print(json.dumps([len(snap["spans"]), len(snap["samples"])]))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[0, 0]"


def test_reset_spans_follow_the_engines_pending_work(spans_on):
    """An ``engine.reset`` span under the gather for each kind of eager
    device work pending, the slots' resets and the control writes, and none
    in a step with nothing pending."""
    eng = _engine(3)
    slots = [eng.attach(sink=lambda block: None) for _ in range(3)]
    for slot in slots:
        eng.push(slot, np.zeros(8 * BLOCK, np.float32))

    def resets_in_next_step(call):
        tracing.reset()
        call()
        spans = tracing.snapshot()["spans"]
        gather = [s["id"] for s in spans if s["name"] == "engine.gather"]
        return sum(s["name"] == "engine.reset" and s["parent"] in gather for s in spans)

    # the attached slots' resets and their controls
    assert resets_in_next_step(eng.step) == 2
    assert resets_in_next_step(lambda: eng.step_many(2)) == 0
    eng.set_stream_params(slots[0], compressor_threshold_db=-30.0)
    assert resets_in_next_step(eng.step) == 1
    eng.detach(slots[2])
    assert eng.attach(sink=lambda block: None) == slots[2]
    assert resets_in_next_step(eng.step) == 2
    eng.set_stream_eq(slots[1], None)
    assert resets_in_next_step(eng.step_pipelined) == 1
    assert resets_in_next_step(eng.step_pipelined) == 0
    eng.flush_pipeline()
    assert tracing.snapshot()["counters"] == {}


def _chunk_counts():
    counters = tracing.snapshot()["counters"]
    return counters.get("engine.span_chunks", 0), counters.get("engine.span_chunks_hidden", 0)


def test_span_chunks_count_step_many_chunks_only():
    """``engine.span_chunks`` grows by ceil(n / CHUNK_BLOCKS) a
    ``step_many(n)`` and not at all in ``step()`` or ``step_pipelined()``;
    the hidden chunks are some of them."""
    eng = _engine(2)
    c = tsv.CHUNK_BLOCKS
    for _ in range(2):
        eng.push(eng.attach(sink=lambda block: None), np.zeros(8 * c * BLOCK, np.float32))
    for call, chunks in ((eng.step, 0), (eng.step_pipelined, 0), (eng.step_pipelined, 0),
                         (lambda: eng.step_many(1), 1), (lambda: eng.step_many(c), 1),
                         (lambda: eng.step_many(c + 1), 2),
                         (lambda: eng.step_many(2 * c + 3), 3)):
        before = _chunk_counts()
        call()
        after = _chunk_counts()
        assert after[0] - before[0] == chunks
        assert after[1] - before[1] <= chunks and after[1] <= after[0]
    eng.flush_pipeline()


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


@pytest.mark.parametrize("events,hidden", [([], 0), ([True], 0), ([False], 1),
                                           ([True, False], 1), ([False, False], 1)])
def test_a_chunk_is_hidden_when_a_shard_still_runs_it(events, hidden):
    """A chunk counts as hidden when any shard's event has not completed at
    the host's wait, once; its blocks are then written and delivered."""
    eng = _engine(1)
    got = []
    eng.attach(sink=got.append)
    targets = [(0, eng._slots[0], eng._slots[0].generation)]
    yh = torch.arange(2 * BLOCK, dtype=torch.float32).reshape(1, 2, 1, BLOCK)
    buf = torch.zeros((2, 1, tsv.CHUNK_BLOCKS * BLOCK))
    buf[1, 0, :2 * BLOCK] = yh.reshape(-1)
    out = np.zeros((3, 1, BLOCK), np.float32)
    before = _chunk_counts()[1]
    eng._land_chunk(out, (buf, [_Event(e) for e in events], 1, 3, None), targets, False,
                    overlapped=True)
    assert _chunk_counts()[1] - before == hidden
    np.testing.assert_array_equal(out[1:, 0], yh[0, :, 0].numpy())
    assert [b.base is out for b in got] == [True, True]


def test_stage_marks_come_in_order():
    eng = _engine(1)
    sh = eng._shards[0]
    marks = []
    state = tsv._clone_tree(sh._state)
    eng._step_in_place(sh, state, marks.append)
    assert tuple(marks) == tsv.STAGE_MARKS


def test_ring_keeps_the_newest_and_counts_the_dropped():
    tr = tracing.Tracer(ring=4)
    tr.enable()
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    snap = tr.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["s6", "s7", "s8", "s9"]
    assert snap["dropped_spans"] == 6
    tr.reset()
    assert tr.snapshot()["spans"] == [] and tr.snapshot()["dropped_spans"] == 0


def test_spans_share_the_profilers_clock(spans_on):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # its first range sets up
            pass
        for i in range(5):
            with tracing.span(f"clock_probe_{i}"), \
                    torch.profiler.record_function(f"clock_probe_{i}"):
                time.sleep(0.001)
    marked = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock_probe_")}
    spans = {s["name"]: s["start_ns"] for s in tracing.snapshot()["spans"]}
    assert sorted(marked) == sorted(spans)
    for name, t in marked.items():
        assert abs(spans[name] - t) < 200_000, (name, spans[name] - t)


def test_self_time_leaves_out_the_children():
    spans = [
        {"name": "root", "id": 1, "parent": None, "start_ns": 0, "end_ns": 100},
        {"name": "a", "id": 2, "parent": 1, "start_ns": 10, "end_ns": 40},
        {"name": "b", "id": 3, "parent": 2, "start_ns": 15, "end_ns": 25},
        {"name": "a", "id": 4, "parent": 1, "start_ns": 50, "end_ns": 60},
    ]
    assert tracing.self_ns(spans) == {"root": 60, "a": 30, "b": 10}


def test_counts_and_span_stacks_hold_across_threads():
    """More threads than cores count and nest spans at once, with a short
    switch interval: no count is lost and every child names its own
    thread's parent."""
    import threading

    tr = tracing.Tracer()
    tr.enable()
    n_threads, n = 16, 300

    def work():
        for _ in range(n):
            with tr.span("outer"):
                tr.count("c")
                with tr.span("inner"):
                    tr.count("c", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = tr.snapshot()
    assert snap["counters"]["c"] == 3 * n * n_threads
    by_id = {s["id"]: s for s in snap["spans"]}
    inner = [s for s in snap["spans"] if s["name"] == "inner"]
    assert len(inner) == n * n_threads
    for s in inner:
        parent = by_id[s["parent"]]
        assert parent["name"] == "outer" and parent["thread"] == s["thread"]
        assert s["call"] == parent["id"]


LIVE_CHILDREN = ["live.front", "live.suppressor", "live.back", "live.publish",
                 "live.condition"]
# the engine's own counters that the spans have to agree with
LIVE_COUNTERS = ("input_backlog_recovery_count", "output_underrun_total")


class _FloodThenTrickle:
    """A virtual microphone that floods the engine (no pacing) for its first
    120 callbacks, so that it drains bursts and drops backlog, then comes
    every 30 ms, so that the DSP thread waits for it."""

    def __init__(self):
        self.calls = 0
        self.rng = np.random.default_rng(17)

    def __call__(self, n):
        self.calls += 1
        if self.calls > 120:
            time.sleep(0.03)
        return (0.05 * self.rng.standard_normal(n)).astype(np.float32)


def _live_run(seen=lambda snap, counters: True, timeout_s=30.0) -> tuple:
    """The live engine on the CPU (a short chain: no gate, compressor or
    suppressor) unpaced, bursts of up to 4 blocks, until ``seen(snapshot,
    the engine's counters)`` or ``timeout_s``; the tracer's snapshot and the
    engine's counters after ``stop()``."""
    from audioforge_tpu_torch.runtime import processor as proc

    source = _FloodThenTrickle()
    proc.register_virtual_input("trace-mic", lambda: source)
    proc.register_virtual_output("trace-sink", lambda: (lambda block: time.sleep(0.001)))
    p = proc.AudioProcessor(device="cpu")
    p.realtime_pacing = False
    p._max_drain_blocks = 4
    for off in (p.set_gate_enabled, p.set_compressor_enabled, p.set_rnnoise_enabled):
        off(False)
    p.start("trace-mic", "trace-sink")
    t0 = time.perf_counter()
    try:
        while (not seen(tracing.snapshot(), dict(p._counters))
               and time.perf_counter() - t0 < timeout_s):
            time.sleep(0.02)
    finally:
        p.stop()
    assert not any(t.is_alive() for t in p._threads)
    return tracing.snapshot(), dict(p._counters)


def _live_seen(snap, counters) -> bool:
    names = {s["name"] for s in snap["spans"]}
    ks = [s["attrs"].get("k", 1) for s in snap["spans"] if s["name"] == "live.burst"]
    return (all(counters[c] for c in LIVE_COUNTERS) and any(k > 1 for k in ks)
            and {"live.wait", "live.vad_window"} <= names)


def test_live_engine_spans_and_counters(spans_on):
    """Every burst is one ``live.burst`` tree (its stages in order) whose
    ``first_sample`` advances by its blocks plus the samples dropped; the
    engine's own counters agree with the spans; the wait, the VAD worker's
    windows and the output callbacks have spans of their own, on their own
    threads."""
    snap, c = _live_run(_live_seen)
    assert snap["dropped_spans"] == 0
    assert all(c[name] for name in LIVE_COUNTERS), c
    spans = snap["spans"]
    bursts = [s for s in spans if s["name"] == "live.burst"]
    assert bursts and all(set(b["attrs"]) == {"k", "first_sample"} for b in bursts)
    assert all(b["parent"] is None for b in bursts)
    ks = [b["attrs"]["k"] for b in bursts]
    assert sum(ks) == c["blocks_processed"] and max(ks) > 1
    firsts = np.array([b["attrs"]["first_sample"] for b in bursts])
    gaps = np.diff(firsts) - BLOCK * np.array(ks[:-1])
    assert (gaps >= 0).all() and firsts[0] + gaps.sum() == c["input_backlog_dropped_samples"]
    for b in bursts:
        children = sorted((s for s in spans if s["parent"] == b["id"]),
                          key=lambda s: s["start_ns"])
        assert [s["name"] for s in children] == LIVE_CHILDREN
        assert all(s["thread"] == b["thread"] for s in children)
    dsp = bursts[0]["thread"]
    waits = [s for s in spans if s["name"] == "live.wait"]
    assert all(s["thread"] == dsp and s["parent"] is None for s in waits)
    outputs = [s for s in spans if s["name"] == "live.output"]
    assert all(set(s["attrs"]) == {"underrun"} for s in outputs)
    assert sum(s["attrs"]["underrun"] for s in outputs) == c["output_underrun_total"]
    vad = [s for s in spans if s["name"] == "live.vad_window"]
    assert len({dsp, outputs[0]["thread"], vad[0]["thread"]}) == 3


def test_live_engine_spans_off_record_nothing():
    tracing.disable()
    tracing.reset()
    snap, c = _live_run(lambda snap, counters: counters["blocks_processed"] >= 8)
    assert snap["spans"] == [] and snap["dropped_spans"] == 0
    assert c["blocks_processed"] >= 8
    tracing.reset()
