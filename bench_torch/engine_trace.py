"""A traced run of one cell with the engine's own spans: where inside
``ServingEngine`` the card's idle time falls, the engine's host time by
stage, and the replay's device time by chain stage.

    python3 bench_torch/engine_trace.py --workload <name> --seed <n> --seconds <s>
    python3 bench_torch/engine_trace.py --workload <name> --seed <n> --span-cost <calls>

The first form runs the cell as ``run.py --trace 1`` does, with the
program's spans (``audioforge_tpu_torch.runtime.tracing``) on over two
stretches of the window of the same length: first with the profiler off
(the call before the profiled one, or the 100 ticks before the profiled
ticks), then over the profiled stretch. Under ``torch.profiler``'s CUDA
tracing a graph launch holds the host for several milliseconds, which moves
the host's time from ``engine.wait`` into ``engine.launch`` and stretches
the replay's stages; so the engine's self times and the replay's stage
times (the ``replay.stage_ms.*`` samples) come from the first stretch, and
the profiled one gives only the device's idle time by the innermost engine
span open at each moment (``harness.idle_by_span`` over the engine's spans)
and how many engine calls lie outside the benchmark's span around them by
more than :data:`SLACK_NS` (``clock_misaligned``). Both go under the
reduced trace's key "engine"; the idle split is printed on standard error,
and the result line carries the metrics of :data:`ENGINE_METRICS` (one
reader each in ``metrics/``). With a program that has no tracer the
additions find nothing and those readers return None.

The second form runs the cell's engine calls back to back with the spans
on and off in turns and the profiler off: the spans' cost.

TEMPORARY: the harness is not edited here. :func:`engine_hooks` wraps
``harness.warm_up``, ``_Run.step``, ``_Run.start_profile``,
``_Run.stop_profile`` and ``harness.reduce_trace`` in this process with
what a change to ``harness.py`` would add; once ``harness.py`` has those
lines, the hooks and :func:`spans_from` go.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# an engine call's root spans, and the benchmark's span around each
ROOTS = ("engine.step", "engine.step_many", "engine.step_pipelined")
AROUND = ("step", "step_many")
SLACK_NS = 100_000
OUTSIDE = "outside the engine's spans"
# the profiled ticks of the harness's open loop
PROFILED_TICKS = 100

ENGINE_METRICS = [
    {"name": "engine_gather_ms.batch", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "engine host", "moves": "audio_s_per_s",
     "workloads": ["full_rnnoise_vad.batch", "default_dfn3_ll.batch"]},
    {"name": "engine_gather_ms.paced", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "engine host", "moves": "block_p50_ms",
     "workloads": ["full_rnnoise_vad.paced", "default_dfn3_ll.paced"]},
    {"name": "engine_wait_ms.paced", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "engine graph", "moves": "block_p50_ms",
     "workloads": ["full_rnnoise_vad.paced", "default_dfn3_ll.paced"]},
    {"name": "engine_deliver_ms.paced", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "engine host", "moves": "block_p50_ms",
     "workloads": ["full_rnnoise_vad.paced", "default_dfn3_ll.paced"]},
    {"name": "device_idle_engine_pct.batch", "unit": "%", "better": "lower",
     "source": "device_trace", "layer": "device", "moves": "audio_s_per_s",
     "workloads": ["full_rnnoise_vad.batch", "default_dfn3_ll.batch"]},
    {"name": "device_idle_engine_pct.paced", "unit": "%", "better": "lower",
     "source": "device_trace", "layer": "device", "moves": "block_p50_ms",
     "workloads": ["full_rnnoise_vad.paced", "default_dfn3_ll.paced"]},
    {"name": "replay_suppressor_ms.batch", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "model step", "moves": "audio_s_per_s",
     "workloads": ["full_rnnoise_vad.batch", "default_dfn3_ll.batch"]},
    {"name": "replay_dsp_ms.batch", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "kernels", "moves": "audio_s_per_s",
     "workloads": ["full_rnnoise_vad.batch", "default_dfn3_ll.batch"]},
]


def _tracer():
    """The program's tracer, or None for a program without one."""
    try:
        from audioforge_tpu_torch.runtime import tracing
    except ImportError:
        return None
    return tracing


def reduce_engine(prof, snap: dict, blocks: int):
    """:func:`split_engine` on the profiler's trace of the stretch: the same
    device intervals and benchmark spans as ``harness.reduce_trace`` reads."""
    from bench_torch import harness

    import torch

    dev, around = [], []
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        cuda = e.device_type() == torch.autograd.DeviceType.CUDA
        if name in harness.SPANS:
            if not cuda:
                around.append((start, end, name))
        elif cuda:
            dev.append((start, end))
    return split_engine(dev, around, snap, blocks)


def split_engine(dev: list, around: list, snap: dict, blocks: int):
    """The profiled stretch's part of "engine", from the device intervals
    ``dev`` [(start, end)], the benchmark's host spans ``around`` [(start,
    end, name)] and the tracer's ``snapshot()`` of the stretch: the idle
    split by engine span, and ``clock_misaligned``. None when the program
    recorded no engine span there."""
    from bench_torch import harness

    spans = [s for s in (snap or {}).get("spans", []) if s["name"].startswith("engine.")]
    if not dev or not spans:
        return None
    lo = min([h[0] for h in around] + [d[0] for d in dev])
    hi = max([h[1] for h in around] + [d[1] for d in dev])
    busy, idle = harness.idle_by_span(
        dev, sorted((s["start_ns"], s["end_ns"], s["name"]) for s in spans), lo, hi)
    idle[OUTSIDE] = idle.pop("outside the benchmark's spans", 0)
    calls = [(h[0], h[1]) for h in around if h[2] in AROUND]
    roots = [s for s in spans if s["name"] in ROOTS]
    misaligned = sum(not any(a - SLACK_NS <= s["start_ns"] and s["end_ns"] <= b + SLACK_NS
                             for a, b in calls) for s in roots)
    return {"busy_ns": busy, "window_ns": hi - lo, "blocks": blocks, "idle_ns": idle,
            "calls": len(roots), "clock_misaligned": misaligned}


def unprofiled_part(snap: dict):
    """The engine's self ns by span and the replay's device ms by stage (the
    mean of the ``replay.stage_ms.*`` samples) over a stretch the profiler
    was off, from the tracer's ``snapshot()`` of it; None without a call."""
    spans = [s for s in (snap or {}).get("spans", []) if s["name"].startswith("engine.")]
    blocks = sum(s["attrs"].get("n_blocks", 0) for s in spans if s["name"] in ROOTS)
    if not blocks:
        return None
    stage_ms = {k.rsplit(".", 1)[1]: float(np.mean([v for _, v in samples]))
                for k, samples in snap.get("samples", {}).items()
                if k.startswith("replay.stage_ms.") and samples}
    return {"blocks": blocks, "self_ns": _tracer().self_ns(spans), "stage_ms": stage_ms}


def spans_from(mix: dict, seconds: float) -> int:
    """The window's call at which the spans go on: the call before the
    profiled one (``harness.closed_loop`` profiles its third), or
    :data:`PROFILED_TICKS` ticks before the profiled ticks (``open_loop``
    profiles from the middle tick)."""
    if mix["loop"] == "closed":
        return 1
    n_ticks = int(round(seconds / (mix["tick_ms"] / 1e3)))
    return max(n_ticks // 2 - PROFILED_TICKS, 0)


class Hooks:
    """What a harness change would add: spans on from the window's call
    ``first`` (after clearing the tracer); at the profiler's start, the
    snapshot of that stretch, then the tracer cleared again; at its stop,
    the snapshot of the profiled stretch, spans off; the reduced trace
    gains "engine", whose idle split is printed on standard error."""

    def __init__(self, harness, tracing, first: int):
        self.tracing, self.first = tracing, first
        self.calls = None   # the window's engine calls so far (None in the warm-up)
        self.unprofiled = self.profiled = None
        self.warm_up, self.step = harness.warm_up, harness._Run.step
        self.start, self.stop = harness._Run.start_profile, harness._Run.stop_profile
        self.reduce_trace = harness.reduce_trace

    def on_warm_up(self, run, mix) -> None:
        self.warm_up(run, mix)
        self.calls = 0

    def on_step(self, run, k: int) -> None:
        if self.tracing is not None and self.calls == self.first and not self.tracing.enabled():
            self.tracing.reset()
            self.tracing.enable()
        if self.calls is not None:
            self.calls += 1
        self.step(run, k)

    def start_profile(self, run) -> None:
        self.start(run)
        if self.tracing is not None and run.profiler is not None:
            if self.tracing.enabled():
                self.unprofiled = self.tracing.snapshot()
            self.tracing.reset()
            self.tracing.enable()

    def stop_profile(self, run) -> None:
        if self.tracing is not None and run.profiler is not None:
            self.tracing.disable()
            self.profiled = self.tracing.snapshot()
        self.stop(run)

    def reduce(self, prof, blocks: int) -> dict:
        traced = self.reduce_trace(prof, blocks)
        engine = reduce_engine(prof, self.profiled, blocks) if traced.get("busy_s") else None
        if engine is not None:
            engine["unprofiled"] = unprofiled_part(self.unprofiled)
            traced["engine"] = engine
            print_split(engine)
        return traced


@contextlib.contextmanager
def engine_hooks(mix: dict, seconds: float):
    """Within: the harness runs with :class:`Hooks` (TEMPORARY, see the
    module's docstring)."""
    from bench_torch import harness

    hooks = Hooks(harness, _tracer(), spans_from(mix, seconds))
    harness.warm_up = hooks.on_warm_up
    harness._Run.step = lambda run, k: hooks.on_step(run, k)
    harness._Run.start_profile = lambda run: hooks.start_profile(run)
    harness._Run.stop_profile = lambda run: hooks.stop_profile(run)
    harness.reduce_trace = hooks.reduce
    try:
        yield hooks
    finally:
        harness.warm_up, harness._Run.step = hooks.warm_up, hooks.step
        harness._Run.start_profile, harness._Run.stop_profile = hooks.start, hooks.stop
        harness.reduce_trace = hooks.reduce_trace
        if hooks.tracing is not None:
            hooks.tracing.disable()


def print_split(engine: dict) -> None:
    """The engine's idle split, self times and stage times on standard error."""
    idle = sorted(engine["idle_ns"].items(), key=lambda kv: -kv[1])
    window = engine["window_ns"]
    parts = ", ".join(f"{k} {v / 1e9:.4f} s" for k, v in idle)
    print(f"engine idle by span over {window / 1e9:.4f} s (busy {engine['busy_ns'] / 1e9:.4f}"
          f" s, idle {(window - engine['busy_ns']) / 1e9:.4f} s): {parts}; calls "
          f"{engine['calls']}, clock_misaligned {engine['clock_misaligned']}", file=sys.stderr)
    u = engine["unprofiled"]
    if u is not None:
        own = {k: round(v / 1e6 / u["blocks"], 4) for k, v in u["self_ns"].items()}
        print(f"engine, profiler off, {u['blocks']} blocks: self ms a block {own}; replay "
              f"stage ms {u['stage_ms']}", file=sys.stderr)


def traced_run(bench: dict, cell: dict, seed: int, seconds: float, t_start: float,
               **kw) -> dict:
    """``harness.run_cell`` with the trace on, under :func:`engine_hooks`,
    reporting the metrics of :data:`ENGINE_METRICS` beside the benchmark's."""
    from bench_torch import harness

    mix = dict(harness.cell_files(cell)[1], **(kw.get("sizes") or {}).get("mix", {}))
    bench = dict(bench, per_layer=bench["per_layer"] + ENGINE_METRICS)
    with engine_hooks(mix, seconds):
        return harness.run_cell(bench, cell, seed, seconds, True, t_start, **kw)


def span_cost(bench: dict, cell: dict, seed: int, calls: int, device: str = "cuda") -> dict:
    """The cell's engine calls (``step()``, or ``step_many`` of the mix's
    ``call_blocks``, after a push of as many blocks a stream) back to back,
    ``calls`` of them, with the spans on and off in turns of a tenth and the
    profiler off: the median wall ms of a call each way."""
    from bench_torch import harness
    from bench_torch.traffic.generator import Traffic

    tracing = _tracer()
    config, mix, fleet = harness.cell_files(cell)
    k = int(mix.get("call_blocks", 1))
    check = config["check"]
    traffic = Traffic(mix, fleet, int(check["probes"]), seed)
    eng = harness.build_engine(config, fleet, device)
    run = harness._Run(eng, traffic, fleet, int(check["blocks"]), float("inf"), False)
    harness.warm_up(run, mix)
    times = {True: [], False: []}
    turn = max(calls // 10, 1)
    for c in range(calls):
        on = (c // turn) % 2 == 1
        (tracing.enable if on else tracing.disable)()
        run.push(k)
        t0 = time.perf_counter()
        eng.step() if k == 1 else eng.step_many(k)
        times[on].append(time.perf_counter() - t0)
        run.sinks.close()
        if (c + 1) % turn == 0:
            tracing.reset()
    tracing.disable()
    return {"fleet": fleet, "call_blocks": k, "calls": calls,
            "call_ms_off": 1e3 * float(np.median(times[False])),
            "call_ms_on": 1e3 * float(np.median(times[True]))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--span-cost", type=int, default=0)
    args = parser.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "bench_torch" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    if args.span_cost:
        print(json.dumps(span_cost(bench, cell, args.seed, args.span_cost)), flush=True)
        return 0
    harness.print_result(traced_run(bench, cell, args.seed, args.seconds, T_START))
    return 0


if __name__ == "__main__":
    sys.exit(main())
