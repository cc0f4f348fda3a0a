"""The program ``chain``: the port's offline chain through its entry point
``api.simulate_auto_eq_chain_batched``, as Auto Voice Setup's compressor
search calls it (``voice_setup.py`` ``_calibrate_compressor``).

A call is one search's first wave: one recorded take rendered under each of
the wave's candidates by one call of the entry point, which cuts the take
into 20 ms blocks, renders the candidates as the streams of one batch
(``_run_chain``: the take staged once and expanded over them, ``chain_init``,
``chain_run`` with its CUDA graph, the audio and the nine stats fetched) and
returns a diagnostics dict a candidate. Calls run back to back over the
window (closed loop), the takes in turn. A rendered candidate whose
diagnostics report a non-finite output, or a sample past the limiter's
ceiling, is failed.

The entry point's ``_run_chain`` is wrapped, so that a probed call keeps its
probed candidates' output blocks and stats beside the diagnostics it
returns. With the trace on, the second call of the window runs with the
program's tracer on (its ``replay.capture`` span and ``replay.*`` counters)
and the third under ``torch.profiler``, with host ranges around the entry
point and its steps (:data:`SPANS`), the window's clock stopped for it.

The result line, the metrics' readers, the comparison and the verdict are
the harness's; the loop, its spans and the check are this file's.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

from .. import harness
from ..counts import chain_totals
from ..traffic.generator import Searches

# the profiled call's host ranges: the entry point, the steps inside it that
# it looks up as module attributes, and the harness's own count
SPANS = ("search", "blocks", "run_chain", "init", "chain_run", "diagnostics", "check")
# a landed sample may pass the ceiling by float32's rounding of it, no more
CEILING_MARGIN_DB = 20.0 * np.log10(1.0 + 1e-6)


class Program:
    """The entry point under the configuration's settings. A test's hook may
    replace ``settings``, ``bands`` or ``run_chain`` (the entry point's
    ``_run_chain``, which renders the candidates) to plant a fault in the
    timed path."""

    def __init__(self, config: dict, device: str):
        from audioforge_tpu_torch import api

        self.api, self.device = api, torch.device(device)
        self.fs = float(config["sample_rate"])
        self.settings = dict(config["settings"])
        self.bands = [tuple(b) for b in config["bands"]]
        self.run_chain = api._run_chain
        self.keep = None   # the candidates whose rows the next call keeps
        self.kept = None

    def _render(self, *args):
        ys, stats = self.run_chain(*args)
        if self.keep is not None:
            self.kept = (ys[self.keep].copy(), {k: v[self.keep].copy() for k, v in stats.items()})
        return ys, stats

    @contextlib.contextmanager
    def installed(self):
        """Inside it, the entry point renders through :meth:`_render`."""
        sound = self.api._run_chain
        self.api._run_chain = self._render
        try:
            yield
        finally:
            self.api._run_chain = sound

    def call(self, take: np.ndarray, candidates: list) -> list:
        return self.api.simulate_auto_eq_chain_batched(take, self.fs, self.bands, self.settings,
                                                       candidates, device=self.device)


@contextlib.contextmanager
def _ranges(api):
    """The entry point's steps under profiler ranges of their own."""
    from audioforge_tpu_torch.runtime import chain as chain_rt

    places = [(api, "_take_blocks", "blocks"), (api, "_run_chain", "run_chain"),
              (chain_rt, "chain_init", "init"), (chain_rt, "chain_run", "chain_run"),
              (api, "_diagnostics", "diagnostics")]
    sound = [getattr(m, attr) for m, attr, _ in places]

    def ranged(fn, name):
        def run(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run
    for (m, attr, name), fn in zip(places, sound):
        setattr(m, attr, ranged(fn, name))
    try:
        yield
    finally:
        for (m, attr, _), fn in zip(places, sound):
            setattr(m, attr, fn)


class _Loop:
    """The window's calls, their counts and the probes' outputs."""

    def __init__(self, prog: Program, searches: Searches, trace: bool):
        self.prog, self.searches, self.trace = prog, searches, trace
        self.failed = 0
        self.kept = {}   # probe -> (output blocks [k, nb, T], stats, diagnostics)
        self.profiler = None
        self.tracer = None

    def span(self, name: str):
        if self.profiler is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def call(self, c: int, probe: int | None = None) -> None:
        """Call ``c``; a probe's call renders the probe's take and keeps its
        candidates."""
        s = self.searches
        take = s.probe_take[probe] if probe is not None else c % len(s.takes)
        keep = None if probe is None else s.probe_candidates[probe]
        self.prog.keep = keep
        with self.span("search"):
            sims = self.prog.call(s.takes[take], s.candidates)
        with self.span("check"):
            for d in sims:
                bound = d["limiter_effective_ceiling_db"] + CEILING_MARGIN_DB
                self.failed += (bool(d["non_finite_output"])
                                or not d["output_sample_peak_db"] <= bound)
            if probe is not None:
                self.kept[probe] = (*self.prog.kept, [sims[i] for i in keep])
        self.prog.keep = self.prog.kept = None

    def traced_call(self, c: int, probe) -> None:
        """Call ``c`` with the program's tracer on (the profiler off): the
        ``replay.capture`` spans and the ``replay.*`` counters of one call."""
        from audioforge_tpu_torch.runtime import tracing

        tracing.reset()
        tracing.enable()
        try:
            self.call(c, probe)
        finally:
            tracing.disable()
        snap = tracing.snapshot()
        capture_ns = sum(s["end_ns"] - s["start_ns"] for s in snap["spans"]
                         if s["name"] == "replay.capture")
        self.tracer = {"capture_ms": capture_ns / 1e6,
                       "captures": snap["counters"].get("replay.captures", 0),
                       "replays": snap["counters"].get("replay.replays", 0)}

    def profiled_call(self, c: int, probe) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.prog.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        self.profiler = prof
        prof.start()
        with _ranges(self.prog.api):
            self.call(c, probe)
        if self.prog.device.type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        self.profiler, self.trace_events = None, prof


def window(loop: _Loop, seconds: float, blocks_a_call: int) -> dict:
    """Calls back to back; probe ``j`` is the first call that starts once its
    share of the window has passed. With the trace on, call 1 runs with the
    program's tracer on and call 2 under the profiler, the window's clock
    stopped for it."""
    s = loop.searches
    P = len(s.probe_at)
    calls, j, traced_s = 0, 0, 0.0
    pc = time.perf_counter
    t0 = pc()
    while pc() - t0 - traced_s < seconds:
        probe = None
        if j < P and pc() - t0 - traced_s >= s.probe_at[j] * seconds:
            probe, j = j, j + 1
        if loop.trace and calls == 1:
            loop.traced_call(calls, probe)
        elif loop.trace and calls == 2:
            tc = pc()
            loop.profiled_call(calls, probe)
            traced_s = pc() - tc
        else:
            loop.call(calls, probe)
        calls += 1
    window_s = pc() - t0
    untraced = calls - (traced_s > 0)
    # audio_s_per_s counts 480-sample blocks of audio landed on the host
    return {"window_s": window_s, "blocks": calls * blocks_a_call, "calls": calls,
            "delivered": calls * len(s.candidates) * s.takes.shape[1] / 480,
            "untraced_block_s": (window_s - traced_s) / max(untraced * blocks_a_call, 1)}


# ---------------------------------------------------------------- the trace
def reduce_take_trace(prof, blocks: int) -> dict:
    """The profiled call: device busy time (the union of every device
    interval), the kernels' union and the host-device copies' union a block,
    the ops that took most device time, and the device's idle time by the
    innermost of :data:`SPANS` open at each moment (``harness.idle_by_span``)."""
    dev, kern, copy, host, by_op = [], [], [], [], {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start, end, name = e.start_ns(), e.start_ns() + e.duration_ns(), e.name()
        if name in SPANS:
            if e.device_type() != cuda:
                host.append((start, end, name))
        elif e.device_type() == cuda:
            dev.append((start, end))
            by_op[name[:160]] = by_op.get(name[:160], 0) + (end - start)
            if name.startswith("Memcpy HtoD") or name.startswith("Memcpy DtoH"):
                copy.append((start, end))
            elif not name.startswith(("Memcpy", "Memset")):
                kern.append((start, end))
    if not kern:
        return {"busy_s": None}
    host.sort()
    lo = min([h[0] for h in host] + [min(d[0] for d in dev)])
    hi = max([h[1] for h in host] + [max(d[1] for d in dev)])
    busy, idle = harness.idle_by_span(dev, host, lo, hi)
    kernel_ns = harness.idle_by_span(kern, [], lo, hi)[0]
    copy_ns = harness.idle_by_span(copy, [], lo, hi)[0] if copy else 0
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "blocks": blocks,
            "kernel_ms_per_block": kernel_ns / 1e6 / blocks,
            "copy_ms_per_block": copy_ns / 1e6 / blocks,
            "device_ops": top(by_op), "idle_gaps": top(idle)}


# ---------------------------------------------------------------- the check
def reference_job(config: dict, take: np.ndarray, candidates: list, control: str | None = None):
    """The plain reference's render of ``take`` under ``candidates`` (or
    control ``control`` of it, ``chain_readings.CONTROLS``), on the CPU:
    ``(output blocks [C, nb, T] float32, {stat: [C, nb]})``."""
    from ..reference.runtime import chain, search

    torch.set_num_threads(1)
    fs = float(config["sample_rate"])
    cfg, base, _ = search.chain_config(fs, config["settings"])
    T = search.analysis_block(fs)
    blocks, _, _ = search.take_blocks(take, T)
    params = search.candidate_params(base, candidates, fs)
    bands = search.legacy_bands(config["bands"])
    args = (cfg, params, bands, blocks.reshape(1, -1), np.zeros(len(candidates), int), T)
    if control is None:
        return chain.render(*args)
    from .chain_readings import lower

    with lower(control):
        return chain.render(*args)


def run_jobs(jobs: list, workers: int) -> list:
    """:func:`reference_job` over ``jobs`` (argument tuples), side by side
    in ``workers`` processes of their own, or in this one for 0."""
    if workers <= 0:
        return [reference_job(*job) for job in jobs]
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
        futures = [pool.submit(reference_job, *job) for job in jobs]
        return [f.result() for f in futures]


def probe_data(loop: _Loop) -> dict:
    """The probes that landed: for each probed candidate its take, its
    parameters, its class, and the program's output blocks, stats and
    diagnostics."""
    s = loop.searches
    probes = sorted(loop.kept)
    data = {"checked": sum(len(s.probe_candidates[j]) for j in probes),
            "of": s.probe_candidates.size, "probes": probes, "takes": [], "candidates": [],
            "classes": [], "got": [], "stats": [], "diagnostics": []}
    for j in probes:
        ys, stats, sims = loop.kept[j]
        data["takes"].append(s.takes[s.probe_take[j]])
        data["candidates"].append([s.candidates[i] for i in s.probe_candidates[j]])
        data["classes"] += [int(s.probe_class[j])] * len(sims)
        data["got"].append(ys)
        data["stats"].append(stats)
        data["diagnostics"] += sims
    return data


def reference_rows(config: dict, data: dict, workers: int) -> tuple:
    """The reference over the probes' takes and over the takes one ULP up:
    ``(want, moved)``, each ``(output blocks [P, nb, T], {stat: [P, nb]})``
    in the probes' order."""
    jobs = [(config, x, cands) for take, cands in zip(data["takes"], data["candidates"])
            for x in (take, harness.one_ulp_up(take))]
    out = run_jobs(jobs, workers)
    join = lambda part: (np.concatenate([y for y, _ in part]),
                         {k: np.concatenate([st[k] for _, st in part]) for k in part[0][1]})
    return join(out[0::2]), join(out[1::2])


def diagnostics_gap(config: dict, data: dict) -> float:
    """The largest gap between a probed candidate's diagnostics and those the
    reference works out from the same take and the candidate's own output
    blocks and stats (its runtime left out)."""
    from ..reference.runtime import search

    fs = float(config["sample_rate"])
    _, _, ceiling = search.chain_config(fs, config["settings"])
    T = search.analysis_block(fs)
    gap, i = 0.0, 0
    for take, ys, stats in zip(data["takes"], data["got"], data["stats"]):
        t = search.Take(*search.take_blocks(take, T))
        for c in range(len(ys)):
            want = search.diagnostics({k: v[c] for k, v in stats.items()}, ys[c], t, ceiling)
            got = data["diagnostics"][i]
            i += 1
            for k, v in want.items():
                d = abs(float(got.get(k, np.nan)) - float(v))
                gap = max(gap, d if np.isfinite(d) else np.inf)
    return gap


def compare_rows(got: tuple, want: tuple, moved: tuple, classes: np.ndarray) -> dict:
    """The compared numbers of rows ``(output blocks, stats)`` against the
    reference's: the audio and each float stat by the harness's rule (a
    class's median error over its median one-ULP move), and the limited
    events' count by its largest gap over a take."""
    flat = lambda y: y.reshape(len(y), -1)
    audio = harness.compare(flat(got[0]), flat(want[0]).astype(np.float64),
                            flat(moved[0]).astype(np.float64), classes)
    stat = {k: harness.compare(got[1][k], want[1][k].astype(np.float64),
                               moved[1][k].astype(np.float64), classes)["class_err_ratio_max"]
            for k in want[1] if k != "true_peak_limited_events"}
    events = np.abs(got[1]["true_peak_limited_events"].sum(-1).astype(np.int64)
                    - want[1]["true_peak_limited_events"].sum(-1).astype(np.int64))
    return {"class_err_ratio_max": audio["class_err_ratio_max"],
            "class_err_ratio": audio["class_err_ratio"],
            "class_median_err": audio["class_median_err"],
            "class_ulp_move": audio["class_ulp_move"], "probe_err_max": audio["probe_err_max"],
            "stat_err_ratio_max": max(stat.values()), "stat_err_ratio": stat,
            "events_gap_max": int(events.max())}


def stacked(data: dict) -> tuple:
    """The program's probed rows as one ``(output blocks, stats)``."""
    return (np.concatenate(data["got"]),
            {k: np.concatenate([st[k] for st in data["stats"]]) for k in data["stats"][0]})


def check_probes(config: dict, data: dict, workers: int) -> dict:
    """The probes against the plain reference: the rows against the
    reference's over the same takes and one ULP up, and the diagnostics
    against the reference's arithmetic over the program's rows."""
    out = {"probes_checked": (data["checked"], data["of"])}
    if data["checked"]:
        want, moved = reference_rows(config, data, workers)
        out.update(compare_rows(stacked(data), want, moved, np.asarray(data["classes"])))
        out["diagnostics_gap_max"] = diagnostics_gap(config, data)
    return out


# ---------------------------------------------------------------- the cell
def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", sizes: dict | None = None, engine_hook=None,
             reference: bool = True, workers: int | None = None) -> dict:
    """One run of ``cell`` (see :func:`harness.run_cell`): ``sizes`` overrides
    the mix's fields (``mix``) and the check's (``check``);
    ``engine_hook(program)`` may replace the :class:`Program`'s settings or
    its renderer. The reference runs in ``workers`` processes (one a take
    and its copy one ULP up, up to the CPUs; 0: in this one)."""
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    mix = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    check = dict(config["check"])
    if sizes:
        mix = {**mix, **sizes.get("mix", {})}
        check.update(sizes.get("check", {}))
    searches = Searches(mix, config, seed)
    prog = Program(config, device)
    if engine_hook is not None:
        engine_hook(prog)
    loop = _Loop(prog, searches, trace)
    nb = -(-searches.takes.shape[1] // round(prog.fs * 0.020))
    with prog.installed():
        # warm-up: a call of a take and of a probe's take (the kernels' first
        # launches, the allocator's blocks, a capture and its replays)
        loop.call(0)
        loop.call(1, 0)
        loop.failed = 0
        loop.kept.clear()
        cuda = prog.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        measured = window(loop, seconds, nb)
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = None
    if trace and hasattr(loop, "trace_events"):
        traced = reduce_take_trace(loop.trace_events, nb)
        del loop.trace_events
    del prog, loop.prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    data = probe_data(loop)
    n_cand = len(searches.candidates)
    measured.update(setup_s=setup_s, mix=mix, trace=traced, device=torch.device(device).type,
                    counts=chain_totals(config, n_cand), tracer=loop.tracer)
    metrics = {}
    for m in harness.cell_metrics(bench, cell["name"], trace):
        value = harness.reader(m["name"])(measured)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = measured["calls"] * n_cand
    if not reference:
        return {"attempted": attempted, "failed": int(loop.failed), "metrics": metrics,
                "probes": data}
    if workers is None:
        workers = min(2 * len(data["takes"]), os.cpu_count() or 1)
    t_check = time.perf_counter()
    numbers = check_probes(config, data, workers)
    print(f"{cell['name']}: seed {seed}, set-up {setup_s:.2f} s, window "
          f"{measured['window_s']:.2f} s ({measured['calls']} calls), reference "
          f"{time.perf_counter() - t_check:.2f} s, failed {loop.failed}; audio by class: error "
          f"{numbers.get('class_median_err')}, the reference's one-ULP move "
          f"{numbers.get('class_ulp_move')}, their ratio {numbers.get('class_err_ratio')}; "
          f"stats {numbers.get('stat_err_ratio')}", file=sys.stderr)
    if loop.tracer is not None:
        print(f"{cell['name']}: the traced call's replay.capture "
              f"{loop.tracer['capture_ms']:.3f} ms, replay.captures "
              f"{loop.tracer['captures']}, replay.replays {loop.tracer['replays']}",
              file=sys.stderr)
    correct, shown = harness.verdict(numbers, check["limits"])
    result = {"correct": correct, "attempted": attempted, "failed": int(loop.failed),
              "metrics": metrics, "device": harness.device_info(device, peak)}
    if traced is not None and traced.get("busy_s"):
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["check"] = shown
    return result
