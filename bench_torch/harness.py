"""One run of one cell: build the serving engine of a configuration, warm it
up on the cell's traffic, measure for the window, check the probe streams
against the plain reference, and read the cell's metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<mix>.json`` (with
``traffic/fleets/<mix>.<config>.json`` where the mix's fleet comes from a
sweep) and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .counts import step_totals
from .traffic.generator import Traffic

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_files(cell: dict) -> tuple:
    """The cell's configuration and mix, and the mix's fleet for it."""
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    fleet = mix["fleet"]
    if fleet == "sweep":
        fleet = load_json(HERE / "traffic" / "fleets"
                          / f"{cell['traffic']}.{cell['config']}.json")["fleet"]
    return config, mix, int(fleet)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics (those
    listing the cell, and those without a list), or with ``trace`` the
    per-layer metrics that list it."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_torch_metric_{len(name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# --------------------------------------------------------------- the program
def build_engine(config: dict, fleet: int, device: str):
    """The program's serving engine for ``config`` at ``fleet`` streams, its
    weights loaded from the configuration's archives by the program's own
    loaders."""
    from audioforge_tpu_torch.models import dfn3, rnnoise, silero
    from audioforge_tpu_torch.ops import gate
    from audioforge_tpu_torch.runtime import live_chain as lc
    from audioforge_tpu_torch.runtime.serving import ServingConfig, ServingEngine

    root = HERE.parent
    chain = dict(config.get("chain", {}))
    if "gate_mode" in chain:
        chain["gate_mode"] = getattr(gate, chain["gate_mode"])
    serving = config["serving"]
    arch = {k: root / v for k, v in config["archives"].items()}
    weights = {}
    if serving.get("suppressor_model") == "rnnoise":
        weights["rnnoise_weights"] = rnnoise.load_weights(arch["rnnoise"], device)
    elif serving.get("suppressor_model") is not None:
        weights["dfn_weights"] = dfn3.load_weights(arch["dfn3"])
    if serving.get("vad_enabled"):
        weights["vad_weights"] = silero.load_weights(arch["vad"])
    cfg = ServingConfig(capacity=fleet, chain=lc.LiveChainConfig(**chain), **serving)
    return ServingEngine(cfg, device=device, **weights)


class _Sinks:
    """The streams' sinks: each records when it was called and counts its
    blocks; the first active slot's also keeps the delivered array whole (for
    the bulk check) and, while tracing, opens the "deliver" span; a probe's
    keeps its first ``keep`` blocks."""

    def __init__(self, fleet: int):
        self.times = np.zeros(fleet)
        self.counts = np.zeros(fleet, np.int64)
        self.landed = None
        self.tracing = False
        self.span = None
        self.kept = {}

    def make(self, i: int, keep: int = 0):
        times, counts, pc = self.times, self.counts, time.perf_counter
        if keep:
            store = self.kept.setdefault(i, [])
        if i == 0:
            def first(block):
                times[0] = pc()
                counts[0] += 1
                if self.landed is None:
                    self.landed = block.base
                    if self.tracing:
                        self.span = torch.profiler.record_function("deliver")
                        self.span.__enter__()
                if keep and len(store) < keep:
                    store.append(block.copy())
            return first
        if keep:
            def probe(block):
                times[i] = pc()
                counts[i] += 1
                if len(store) < keep:
                    store.append(block.copy())
            return probe

        def sink(block):
            times[i] = pc()
            counts[i] += 1
        return sink

    def close(self) -> np.ndarray:
        """After a step: end the deliver span; return the delivered array."""
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
        landed, self.landed = self.landed, None
        return landed


def _bad_blocks(landed: np.ndarray, ceiling: float) -> int:
    """Stream-blocks of ``[blocks, N, 480]`` that are not finite or pass the
    limiter's ceiling. When all are good (a NaN fails both comparisons) it
    reads the array twice and allocates nothing."""
    if landed.max() <= ceiling and landed.min() >= -ceiling:
        return 0
    bad = ~np.isfinite(landed).all(axis=-1) | (np.abs(landed).max(axis=-1) > ceiling)
    return int(bad.sum())


class _Run:
    """The window's loop over the engine, shared by both loop kinds."""

    def __init__(self, eng, traffic: Traffic, fleet: int, keep: int, ceiling: float,
                 trace: bool):
        self.eng, self.traffic, self.fleet = eng, traffic, fleet
        self.keep, self.ceiling, self.trace = keep, ceiling, trace
        self.sinks = _Sinks(fleet)
        self.pos = np.zeros(fleet, np.int64)
        self.probes = []       # (probe index, slot) attached in the window
        self.failed = 0
        self.profiler = None
        self.profiled_blocks = 0
        for i in range(fleet):
            if eng.attach(sink=self.sinks.make(i)) != i:
                raise RuntimeError("the engine did not fill its slots in order")

    def span(self, name: str):
        if self.profiler is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def reattach(self, slot: int, sink) -> None:
        """A call ends and another takes its slot (a fresh stream)."""
        self.eng.detach(slot)
        if self.eng.attach(sink=sink) != slot:
            raise RuntimeError("a freed slot was not reused")
        self.pos[slot] = 0

    def attach_probe(self, j: int) -> None:
        slot = int(self.traffic.probe_slots[j])
        self.sinks.kept.pop(slot, None)
        self.reattach(slot, self.sinks.make(slot, keep=self.keep))
        self.traffic.attach_probe(j)
        self.probes.append((j, slot))

    def push(self, k: int) -> None:
        with self.span("push"):
            eng, traffic, pos = self.eng, self.traffic, self.pos
            for i in range(self.fleet):
                eng.push(i, traffic.blocks(i, int(pos[i]), k) if k > 1
                         else traffic.block(i, int(pos[i])))
            pos += k

    def step(self, k: int) -> None:
        self.sinks.tracing = self.profiler is not None
        if k == 1:
            with self.span("step"):
                self.eng.step()
        else:
            with self.span("step_many"):
                self.eng.step_many(k)
        landed = self.sinks.close()
        with self.span("check"):
            self.failed += _bad_blocks(landed, self.ceiling)
        if self.profiler is not None:
            self.profiled_blocks += k

    def start_profile(self) -> None:
        if self.trace and self.profiler is None and self.profiled_blocks == 0:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.eng.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.start()

    def stop_profile(self) -> None:
        if self.profiler is not None:
            if self.eng.device.type == "cuda":
                torch.cuda.synchronize()
            self.profiler.stop()
            self.trace_events, self.profiler = self.profiler, None


def warm_up(run: _Run, mix: dict) -> None:
    """Every shape and path the window uses, before it: the graph capture,
    both host buffers of the step's span (two calls), a slot's reset, the
    sinks."""
    k = int(mix.get("call_blocks", 1))
    for rep in range(2 if k > 1 else 3):
        if rep == 1:
            run.reattach(run.fleet - 1, run.sinks.make(run.fleet - 1))
        run.push(k)
        run.step(k)
    run.sinks.counts[:] = 0
    run.failed = 0
    if run.eng.device.type == "cuda":
        torch.cuda.synchronize()
    # the set-up's objects (the imports, the engine, the pool) move out of
    # the collector's reach, so that a collection inside the window walks
    # only what the window allocated, as in a long-running server
    gc.collect()
    gc.freeze()


def closed_loop(run: _Run, mix: dict, seconds: float) -> dict:
    """Calls of ``call_blocks`` blocks back to back: push a span a stream,
    ``step_many``, check the delivered blocks. With the trace on, the third
    call runs under the profiler and the window's clock stops for it, so
    that the other calls are those of an untraced run."""
    k, P = int(mix["call_blocks"]), len(run.traffic.probe_at)
    calls, j, traced_s = 0, 0, 0.0
    pc = time.perf_counter
    t0 = pc()
    while pc() - t0 - traced_s < seconds:
        while j < P and pc() - t0 - traced_s >= run.traffic.probe_at[j] * seconds:
            run.attach_probe(j)
            j += 1
        profiled = run.trace and calls == 2
        tc = pc()
        if profiled:
            run.start_profile()
        run.push(k)
        run.step(k)
        if profiled:
            run.stop_profile()
            traced_s = pc() - tc
        calls += 1
    window = pc() - t0
    offered = calls * k * run.fleet
    delivered = int(run.sinks.counts.sum())
    run.failed += offered - delivered
    untraced = calls - (traced_s > 0)
    return {"window_s": window, "blocks": calls * k, "offered": offered,
            "delivered": delivered, "calls": calls,
            "untraced_block_s": (window - traced_s) / max(untraced * k, 1)}


def open_loop(run: _Run, mix: dict, seconds: float) -> dict:
    """Ticks every ``tick_ms``: at each due tick push one block a stream, then
    ``step()``. A late tick is not skipped; its blocks are timed from when
    they were due. At the window's close one more step drains; ticks left
    undone count as failed. With the trace on, 100 ticks from the middle run
    under the profiler, and the schedule after them starts again from the
    moment the profiler has stopped, so that the ticks after them are those
    of an untraced run."""
    tick = mix["tick_ms"] / 1e3
    n_ticks = int(round(seconds / tick))
    probe_ticks = {}
    for j, p in enumerate(run.traffic.probe_at):
        probe_ticks.setdefault(int(p * n_ticks), []).append(j)
    lat = np.empty((n_ticks, run.fleet))
    step_s = np.empty(n_ticks)
    trace_at = n_ticks // 2 if run.trace else -1
    sinks, pc = run.sinks, time.perf_counter
    t0 = pc() + 0.002
    start, close = t0, t0 + seconds
    done, drained = 0, False
    while done < n_ticks:
        due = t0 + done * tick
        now = pc()
        if now >= close:
            if drained:
                break
            drained = True
        if now < due:
            if due - now > 0.0015:
                time.sleep(due - now - 0.001)
            while pc() < due:
                pass
        for j in probe_ticks.get(done, ()):
            run.attach_probe(j)
        if done == trace_at:
            run.start_profile()
        run.push(1)
        ts = pc()
        run.step(1)
        step_s[done] = pc() - ts
        lat[done] = sinks.times - due
        done += 1
        if done == trace_at + 100:
            run.stop_profile()
            # the clock stops for the traced ticks: the next tick is due now
            shift = pc() - (t0 + done * tick)
            t0, close = t0 + shift, close + shift
    run.stop_profile()
    offered = n_ticks * run.fleet
    delivered = int(sinks.counts.sum())
    run.failed += offered - delivered
    # the traced ticks ran under the profiler: the latencies leave them out
    kept = np.ones(done, bool)
    kept[max(trace_at, 0):trace_at + 100] = trace_at < 0
    return {"window_s": max(pc(), close) - start, "blocks": done, "offered": offered,
            "delivered": delivered, "latencies_ms": 1e3 * lat[:done][kept].ravel(),
            "step_s": step_s[:done][kept], "late_ticks": int((lat[:done, 0] > tick).sum())}


# ---------------------------------------------------------------- the trace
# the benchmark's own host spans (the profiler also shows them on the device
# as annotations, which are no device work)
SPANS = ("push", "step", "step_many", "deliver", "check")


def idle_by_span(dev: list, host: list, lo: int, hi: int) -> tuple:
    """``(busy, {span: idle})`` in ns over ``[lo, hi)``: the union of the
    device intervals ``dev`` [(start, end)], and the time in between split
    by the innermost host span open at each moment (``host`` [(start, end,
    name)], nested or apart), the rest under "outside the benchmark's
    spans"."""
    starts = np.array(sorted(d[0] for d in dev), np.int64)
    ends = np.array([d[1] for d in sorted(dev)], np.int64)
    ends = np.maximum.accumulate(ends)           # the union's running end
    new = np.ones(starts.size, bool)
    new[1:] = starts[1:] > ends[:-1]
    first = np.flatnonzero(new)                  # each busy run's first interval
    run_s, run_e = starts[first], ends[np.r_[first[1:] - 1, starts.size - 1]]
    busy = int((run_e - run_s).sum())
    # idle gaps: before the first run, between runs, after the last
    gs = np.r_[lo, run_e]
    ge = np.r_[run_s, hi]
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    cum = np.r_[0, np.cumsum(ge - gs)]

    def idle_before(t):
        """Idle time in ``[lo, t)``."""
        t = np.asarray(t, np.int64)
        i = np.searchsorted(gs, t, side="right") - 1
        inside = np.where(i >= 0, np.clip(t - gs[np.maximum(i, 0)], 0,
                                          ge[np.maximum(i, 0)] - gs[np.maximum(i, 0)]), 0)
        return cum[np.maximum(i, 0)] * (i >= 0) + inside

    # elementary intervals between the spans' boundaries, each labelled by
    # the innermost (latest started) span covering it
    bounds = sorted({lo, hi, *(h[0] for h in host), *(h[1] for h in host)})
    idle_at = idle_before(bounds)
    idle = {}
    for a, b, ia, ib in zip(bounds, bounds[1:], idle_at, idle_at[1:]):
        label = "outside the benchmark's spans"
        for hs, he, name in host:
            if hs > a:
                break
            if he >= b:
                label = name
        idle[label] = idle.get(label, 0) + int(ib - ia)
    return busy, idle


def reduce_trace(prof, blocks: int) -> dict:
    """Device busy time (the union of kernel, copy and set intervals), the
    traced stretch's length, the ops that took most device time, and the
    device's idle time by the benchmark's host span that was open."""
    dev, host, by_op = [], [], {}
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if name in SPANS:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append((start, end, name))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((start, end))
            by_op[name[:160]] = by_op.get(name[:160], 0) + (end - start)
    if not dev:
        return {"busy_s": None}
    host.sort()
    lo = min([h[0] for h in host] + [min(d[0] for d in dev)])
    hi = max([h[1] for h in host] + [max(d[1] for d in dev)])
    busy, idle = idle_by_span(dev, host, lo, hi)
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "blocks": blocks,
            "busy_ms_per_block": busy / 1e6 / blocks,
            "device_ops": top(by_op), "idle_gaps": top(idle)}


# ---------------------------------------------------------------- the check
def ref_chain(config: dict):
    """The configuration's chain as the reference's ``LiveChainConfig``."""
    from .reference.ops import gate as ref_gate
    from .reference.runtime import live_chain as ref_lc

    chain = dict(config.get("chain", {}))
    if "gate_mode" in chain:
        chain["gate_mode"] = getattr(ref_gate, chain["gate_mode"])
    return ref_lc.LiveChainConfig(**chain)


def ref_live_params(config: dict) -> dict:
    from .reference.runtime import live_chain as ref_lc

    return ref_lc.live_params(ref_chain(config))


def reference_rows(config: dict, x: np.ndarray) -> np.ndarray:
    """The plain reference over ``x [n, k * 480]``, fresh streams, on the
    CPU in this process. Its loops run sample by sample, so their cost is
    per block whatever ``n`` is: every row goes in one batch."""
    from .reference.runtime import step as ref

    torch.set_num_threads(1)
    cfg = ref.ServingConfig(capacity=x.shape[0], chain=ref_chain(config), **config["serving"])
    weights = ref.load_weights(cfg, {k: HERE.parent / v for k, v in config["archives"].items()})
    return ref.run_streams(cfg, weights, x).astype(np.float64)


def _rel_rms(a: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each row's RMS distance from ``want`` over ``want``'s RMS."""
    diff = np.nan_to_num(a.astype(np.float64) - want, nan=np.inf)
    return (np.sqrt(np.mean(diff ** 2, axis=1))
            / np.maximum(np.sqrt(np.mean(want ** 2, axis=1)), 1e-9))


def compare(got: np.ndarray, want: np.ndarray, moved: np.ndarray, classes: np.ndarray) -> dict:
    """The numbers a check compares, from the probes' outputs ``got [P, n]``,
    the reference's ``want``, the reference's over the inputs one ULP up
    ``moved``, and the probes' stream classes ``[P]``. Each probe's error is
    its RMS distance from ``want`` over ``want``'s RMS, and its move the
    same of ``moved``. For each class: the median of its probes' errors over
    the median of their moves (at least float32's epsilon), so that the
    error is counted in the reference's own sensitivity to rounding on that
    class's signal; the largest of these over the classes is compared (a
    fault of one class's path moves all of its probes)."""
    rel, move = _rel_rms(got, want), _rel_rms(moved, want)
    eps = float(np.finfo(np.float32).eps)
    err_c, move_c = [], []
    for c in np.unique(classes):
        err_c.append(float(np.median(rel[classes == c])))
        move_c.append(float(np.median(move[classes == c])))
    ratio = [e / max(m, eps) for e, m in zip(err_c, move_c)]
    return {"class_err_ratio_max": max(ratio), "class_err_ratio": ratio,
            "class_median_err": err_c, "class_ulp_move": move_c,
            "probe_err_max": float(rel.max()),
            "probe_max_abs_err": float(np.abs(np.nan_to_num(got - want, nan=np.inf)).max())}


def one_ulp_up(x: np.ndarray) -> np.ndarray:
    """Every float32 sample of ``x`` one unit in the last place higher."""
    return np.nextafter(x, np.float32(np.inf)).astype(np.float32)


def probe_data(run: _Run, keep: int) -> dict:
    """The probes that delivered their first ``keep`` blocks: their inputs
    ``x``, outputs ``got`` and classes, and how many of all were."""
    traffic = run.traffic
    probes = [j for j, s in run.probes if len(run.sinks.kept.get(s, [])) == keep]
    data = {"checked": len(probes), "of": len(traffic.probe_at),
            "classes": traffic.probe_class[probes]}
    if probes:
        data["x"] = np.stack([traffic.probe_input(j, keep) for j in probes])
        data["got"] = np.stack([np.concatenate(run.sinks.kept[int(traffic.probe_slots[j])])
                                for j in probes])
    return data


def check_probes(config: dict, data: dict) -> dict:
    """The probes' outputs against the plain reference run over the same
    inputs from fresh streams, and over the inputs one ULP up (in the same
    batch). Returns the compared numbers."""
    out = {"probes_checked": (data["checked"], data["of"])}
    if data["checked"]:
        x, n = data["x"], data["checked"]
        both = reference_rows(config, np.concatenate([x, one_ulp_up(x)]))
        out.update(compare(data["got"], both[:n], both[n:], data["classes"]))
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {value, limit}})``: every compared number within
    its limit and every probe checked."""
    shown = {}
    n, P = numbers["probes_checked"]
    shown["probes_checked"] = {"value": n, "limit": P}
    ok = n == P
    for name, limit in limits.items():
        v = numbers.get(name, float("inf"))
        shown[name] = {"value": v, "limit": limit}
        ok = ok and bool(v <= limit)
    return ok, shown


# ---------------------------------------------------------------- the cell
def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", sizes: dict | None = None, engine_hook=None,
             reference: bool = True) -> dict:
    """One run of ``cell``. ``sizes`` (tests) overrides the fleet, the mix's
    fields and the probes' count and length; ``engine_hook(engine)`` may
    replace engine methods (tests plant faults with it). Without
    ``reference`` the check is left to the caller: the result holds the
    probes' data under "probes" and no verdict."""
    program = load_json(HERE / "configs" / f"{cell['config']}.json").get("program")
    if program is not None:
        # a program other than the serving engine runs the whole cell:
        # programs/<program>.py, with these arguments, returns the result
        module = importlib.import_module(f"{__package__}.programs.{program}")
        return module.run_cell(bench, cell, seed, seconds, trace, t_start, device=device,
                               sizes=sizes, engine_hook=engine_hook, reference=reference)
    config, mix, fleet = cell_files(cell)
    check = dict(config["check"])
    if sizes:
        fleet = sizes.get("fleet", fleet)
        mix = {**mix, **sizes.get("mix", {})}
        check.update(sizes.get("check", {}))
    keep = int(check["blocks"])
    traffic = Traffic(mix, fleet, int(check["probes"]), seed)
    eng = build_engine(config, fleet, device)
    if engine_hook is not None:
        engine_hook(eng)
    ceiling = float(ref_live_params(config)["limiter_ceiling_linear"])
    run = _Run(eng, traffic, fleet, keep, ceiling * (1 + 1e-6), trace)
    warm_up(run, mix)
    setup_s = time.perf_counter() - t_start
    loop = closed_loop if mix["loop"] == "closed" else open_loop
    window = loop(run, mix, seconds)
    gc.unfreeze()
    cuda = device.startswith("cuda")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = None
    if trace and hasattr(run, "trace_events"):
        traced = reduce_trace(run.trace_events, run.profiled_blocks)
        del run.trace_events
    del eng, run.eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    data = probe_data(run, keep)
    if reference:
        t_check = time.perf_counter()
        numbers = check_probes(config, data)
        print(f"{cell['name']}: seed {seed}, fleet {fleet}, set-up {setup_s:.2f} s, window "
              f"{window['window_s']:.2f} s ({window['blocks']} blocks), reference "
              f"{time.perf_counter() - t_check:.2f} s, failed {run.failed}; by class: error "
              f"{numbers.get('class_median_err')}, the reference's one-ULP move "
              f"{numbers.get('class_ulp_move')}, their ratio {numbers.get('class_err_ratio')}; "
              f"worst probe {numbers.get('probe_err_max')}",
              file=sys.stderr)
        correct, shown = verdict(numbers, check["limits"])
    measured = {**window, "setup_s": setup_s, "fleet": fleet, "mix": mix, "trace": traced,
                "device": torch.device(device).type,
                "counts": step_totals(config, fleet, HERE.parent)}
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = reader(m["name"])(measured)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not reference:
        return {"attempted": int(window["offered"]), "failed": int(run.failed),
                "metrics": metrics, "probes": data}
    result = {"correct": correct, "attempted": int(window["offered"]),
              "failed": int(run.failed), "metrics": metrics, "device": device_info(device, peak)}
    if traced is not None and traced.get("busy_s"):
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["check"] = shown
    return result


def device_info(device: str, peak: int) -> dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


def print_result(result: dict) -> None:
    """The compared numbers beside their limits on standard error, then the
    result as the last line of standard output."""
    for name, v in result["check"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
