"""The program ``live``: audio-forge's own deployment, one user's microphone
through the port's live engine ``AudioProcessor`` in real time.

A run builds the engine with the configuration's controls and starts it on
two virtual devices: a microphone that plays the mix's take (one seeded
``mic_capture`` take of 4 s segments of its four classes in a seed-drawn
order), called by the engine's own paced input thread every 10 ms, and an
output device drained by its paced output thread. The program's tracer is on
from before ``start()``. The window starts 2 s after the first output block
reaches the sink and lasts ``--seconds``; from this thread the UI's control
traffic comes inside it (an EQ band's gain every 2 s, the de-esser off at
10 s and on at 20 s); a drain of 0.5 s follows it.

A block is timed from its input tick (its source call, where a device
callback fires) to the end of the ``live.burst`` span that wrote it into
the output ring, the hand-off to the output callback; the ring's queue after
it is the output writer's fixed target and not the program's speed. The
window's blocks are those ticked in it. ``failed``: blocks with no output
by the window's end plus the drain, and blocks not finite or above the
limiter's ceiling; a late block is not failed, and a block the engine
discarded in a backlog drop is counted by ``live_dropped_blocks.rt`` (a
drop turns on the length of one capture stall in a run). With the trace on,
a stretch of 100 blocks after the drain times every graph round trip of the
engine with CUDA events (:func:`time_replays`).

The check: 16 seed-drawn stretches of 60 blocks, four in segments of each
class. At the DSP thread's last poll before a stretch the chain's and the
suppressor engine's state are copied on the card (outside the timed burst),
and the chain's state again at its first poll after the burst that ends the
stretch; a wrapper on ``_process_block`` keeps each of its bursts' input
rows, the VAD snapshot it used (a wrapper on ``live_chain.front_run``), how
many of the UI's changes were applied, and its output rows before the
output writer. After the window the plain reference
(``reference/runtime/live_processor.py``, its control values its own from
the configuration) renders them on the CPU over the inputs and over the
inputs one ULP up, in a worker process. Compared (:func:`compare_all`):
the output, probe by probe against each probe's own one-ULP move, over all
probes and class by class, and the chain's state at the stretches' ends,
stage by stage. The output writer's retiming and fades are host numpy with
tests of their own; the check does not cover them.

The result line, the metrics' readers, the comparison and the verdict are
the harness's; the run, its spans and the check are this file's.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

from .. import harness
from ..counts.live import live_totals
from ..reference.runtime.live_chain import effective_limiter_ceiling_db
from ..traffic.generator import CLASSES, FS, mic_capture

BLOCK = 480
MIC, SINK = "bench-live-mic", "bench-live-sink"
# the host spans of the DSP thread that split the timed stretch's idle
DSP_SPANS = ("live.burst", "live.front", "live.suppressor", "live.back", "live.publish",
             "live.condition", "live.wait")
# a landed sample may pass the ceiling by float32's rounding of it, no more
CEILING_MARGIN = 1.0 + 1e-6


# ---------------------------------------------------------------- traffic
def live_take(mix: dict, seed: int, seconds: float) -> tuple:
    """The take: ``(audio [n], class of each segment, blocks a segment)``.
    Segments of ``segment_seconds`` of ``mic_capture``'s four classes, each
    run of four in a seed-drawn order, long enough for the lead, the
    window, the drain and the profiled blocks with room to spare (past its
    end the microphone plays it again)."""
    rng = np.random.default_rng([seed, 0x6C69])
    seg = int(round(mix["segment_seconds"] * FS / BLOCK))
    total_s = mix["lead_seconds"] + seconds + mix["drain_seconds"] + 8.0
    n_seg = -(-int(round(total_s * FS / BLOCK)) // seg)
    cycles = -(-n_seg // CLASSES)
    if "segment_order" in mix:  # a fixed order (the CPU tests' short windows)
        order = np.tile(np.asarray(mix["segment_order"]), cycles)
    else:
        order = np.concatenate([rng.permutation(CLASSES) for _ in range(cycles)])
    classes = order[:n_seg]
    pool = mic_capture(CLASSES, n_seg * seg, int(rng.integers(2**62)))
    audio = np.concatenate([pool[c, i * seg * BLOCK:(i + 1) * seg * BLOCK]
                            for i, c in enumerate(classes)])
    return audio, classes, seg


def control_schedule(mix: dict, seed: int, seconds: float) -> list:
    """The UI's changes, ``(t_s, band, gain_db, deesser or None)`` from the
    window's start: an EQ band's gain every ``eq_every_s`` (band and gain
    drawn), the de-esser off and on at their times."""
    rng = np.random.default_rng([seed, 0x7569])
    from audioforge_tpu_torch.ops import eq as eq_ops

    out = []
    for t in np.arange(0.0, seconds, mix["eq_every_s"]):
        band = int(rng.integers(eq_ops.NUM_BANDS))
        gain = float(rng.uniform(-mix["eq_gain_db"], mix["eq_gain_db"]))
        deesser = (False if np.isclose(t, mix["deesser_off_at_s"])
                   else True if np.isclose(t, mix["deesser_on_at_s"]) else None)
        out.append((float(t), band, gain, deesser))
    return out


def plan_probes(rng, classes: np.ndarray, seg: int, lo: int, hi: int, probes: int,
                blocks: int) -> list:
    """``probes`` stretches' first blocks in ``[lo, hi)``, probe ``j`` in a
    segment of class ``j % 4``, with room in its segment for the stretch
    and a drain burst's shift (the take repeats past its end)."""
    b = np.arange(lo, max(lo, hi))
    fits = (b % seg) + blocks + 8 <= seg
    out = []
    for j in range(probes):
        c = j % CLASSES
        ok = b[fits & (classes[(b // seg) % len(classes)] == c)]
        if not ok.size:
            raise RuntimeError(f"blocks {lo}-{hi} hold no stretch of {blocks} blocks of class {c}")
        out.append((int(rng.choice(ok)), c))
    return sorted(out)


class Mic:
    """The virtual microphone: each call is an input tick (its time on the
    tracer's clock is kept) and returns the take's next block, after
    ``pace`` seconds where it paces the engine itself (slow motion)."""

    def __init__(self, audio: np.ndarray, clock, pace: float = 0.0):
        self.audio, self.clock, self.pace = audio, clock, pace
        self.blocks = audio.size // BLOCK
        self.ticks = []

    @property
    def calls(self) -> int:
        return len(self.ticks)

    def __call__(self, n: int) -> np.ndarray:
        if n != BLOCK:
            raise ValueError(f"the engine pulled {n} samples: this program needs one block a "
                             "tick (host block multiple 1 at 48 kHz)")
        at = len(self.ticks) % self.blocks * BLOCK
        self.ticks.append(self.clock())
        if self.pace:
            time.sleep(self.pace)
        return self.audio[at:at + BLOCK]


class Sink:
    """The virtual output device: the time of its first block (pacing the
    engine itself in slow motion, as the microphone)."""

    def __init__(self, clock, pace: float = 0.0):
        self.clock, self.pace, self.first_ns = clock, pace, None

    def __call__(self, block) -> None:
        if self.first_ns is None:
            self.first_ns = self.clock()
        if self.pace:
            time.sleep(self.pace)


# ---------------------------------------------------------------- the run
class Recorder:
    """Wrappers on the engine's timed path: ``_process_block`` (each burst's
    first block, its output's finite and ceiling checks, the probes'
    bursts), ``live_chain.front_run`` (the VAD snapshot a burst used),
    ``_snapshot_control`` (which of the UI's changes it took) and the input
    ring's ``available`` (the probes' entry and end states at the DSP
    thread's poll). Installed after a test's fault hook, so that they see
    what the engine was given and what it returned."""

    def __init__(self, proc, ceiling: float, blocks: int):
        self.proc, self.ceiling, self.blocks = proc, ceiling, blocks
        self.processed = 0
        self.bad = []            # blocks not finite or above the ceiling
        self.issued = 0          # the UI's changes made so far
        self.consumed = 0        # of them, those the engine's control snapshots took
        self.plan = []           # (first block, class) of the probes not yet entered
        self.probes = []         # entered: {start, class, entry, bursts, blocks, after}
        self.closing = []        # probes whose stretch ended at the last burst
        self.vad = None
        self.dsp = None
        self._sound = {}

    def install(self) -> None:
        from audioforge_tpu_torch.runtime import live_chain

        proc = self.proc
        self._sound = {"process": proc._process_block, "front_run": live_chain.front_run,
                       "snapshot": proc._snapshot_control}
        proc._process_block = self._process_block
        proc._snapshot_control = self._snapshot_control
        live_chain.front_run = self._front_run

    def install_poll(self) -> None:
        """After ``start()``: the input ring exists."""
        ring = self.proc._in_ring
        self._sound["available"] = ring.available
        ring.available = self._available

    def uninstall(self) -> None:
        from audioforge_tpu_torch.runtime import live_chain

        if "front_run" in self._sound:
            live_chain.front_run = self._sound["front_run"]

    def _dropped_blocks(self) -> int:
        with self.proc._lock:
            return self.proc._counters["input_backlog_dropped_samples"] // BLOCK

    def applied(self) -> int:
        """The UI's changes the engine has applied: those made before its
        last control snapshot."""
        return self.consumed

    def _snapshot_control(self):
        with self.proc._lock:  # the UI's changes are made under it too
            issued = self.issued
            out = self._sound["snapshot"]()
            self.consumed = issued
        return out

    def _front_run(self, config, params, state, xs, vad_probability, vad_available, **kw):
        self.vad = (float(vad_probability), bool(vad_available))
        return self._sound["front_run"](config, params, state, xs, vad_probability,
                                        vad_available, **kw)

    def _available(self) -> int:
        n = self._sound["available"]()
        if threading.get_ident() == self.dsp:
            if self.closing:
                self._leave()
            if self.plan:
                nxt = self.processed + self._dropped_blocks()
                if self.plan[0][0] <= nxt:
                    self._enter(nxt)
        return n

    def _leave(self) -> None:
        """Copy the chain's state (on the card, no wait) for the probes whose
        stretch the last burst ended."""
        from audioforge_tpu_torch.runtime.replay import clone_tree

        after = clone_tree(self.proc._state)
        for p in self.closing:
            p["after"] = after
        self.closing = []

    def _enter(self, nxt: int) -> None:
        """Copy the entry state (on the card, no wait) for every planned
        probe that starts at the next burst."""
        from audioforge_tpu_torch.runtime.replay import clone_tree

        proc = self.proc
        sp = proc._engine["proc"]
        entry = {"state": clone_tree(proc._state), "model": clone_tree(sp["model"]),
                 "smoothed_strength": float(sp["smoothed_strength"]),
                 "dry_delay": np.array(sp.get("dry_delay", np.zeros(BLOCK, np.float32))),
                 "in_buf": np.array(sp["in_buf"]), "out_buf": np.array(sp["out_buf"]),
                 "applied": self.applied()}
        while self.plan and self.plan[0][0] <= nxt:
            start, c = self.plan.pop(0)
            self.probes.append({"start": start, "class": c, "entry": entry, "bursts": [],
                                "blocks": 0})

    def _process_block(self, config, params, state, x, engine, supp_delay, topo):
        self.dsp = threading.get_ident()
        first = self.processed + self._dropped_blocks()
        open_ = [p for p in self.probes if p["blocks"] < self.blocks]
        if open_:
            rec = {"x": np.array(x, np.float32), "applied": self.applied()}
        out = self._sound["process"](config, params, state, x, engine, supp_delay, topo)
        y = np.asarray(out[1], np.float32).reshape(-1, BLOCK)
        k = y.shape[0]
        self.processed += k
        ok = np.isfinite(y).all(axis=1) & (np.abs(y).max(axis=1) <= self.ceiling)
        if not ok.all():
            self.bad += [first + i for i in np.flatnonzero(~ok)]
        if open_:
            rec.update(vad=self.vad, y=y.copy())
            for p in open_:
                p["bursts"].append(rec)
                p["blocks"] += k
                if p["blocks"] >= self.blocks:
                    self.closing.append(p)
        return out


def apply_controls(proc, controls: dict) -> None:
    """The configuration's controls into the engine's control state, each
    group holding exactly the engine's keys."""
    from audioforge_tpu_torch.ops import gate

    for group, have in (("params", proc._params), ("topology", proc._topology),
                        ("deesser", proc._deesser)):
        if set(controls[group]) != set(have):
            raise ValueError(f"the configuration's {group} {sorted(controls[group])} are not "
                             f"the engine's {sorted(have)}")
    proc._params.update(controls["params"])
    proc._topology.update(controls["topology"],
                          gate_mode=getattr(gate, controls["topology"]["gate_mode"]))
    proc._deesser.update(controls["deesser"])


def check_archives(config: dict) -> None:
    """The engine loads its weights from the configuration's archives."""
    from audioforge_tpu_torch.models import rnnoise, silero

    for key, module in (("rnnoise", rnnoise), ("vad", silero)):
        want = (harness.HERE.parent / config["archives"][key]).resolve()
        got = module.discover_model_path()
        if got is None or got.resolve() != want:
            raise RuntimeError(f"the engine would load {key} weights from {got}, not {want}")


def _sleep_until(clock, t_ns: int) -> None:
    while True:
        left = (t_ns - clock()) / 1e9
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


class ReplayTimer:
    """Every graph round trip of the engine (``BlockReplay._run_chunk``: the
    rows' copy to the card, the replays, the copy back) between a pair of
    timing events on the stream of the thread that runs it, the DSP thread's
    halves and frame and the VAD worker's windows alike: the start event
    recorded before the call, the end event as the chunk's own ``_done``
    after its copy back. Installed for a stretch, on the card only."""

    def __init__(self):
        self.pairs = []

    def __enter__(self):
        from audioforge_tpu_torch.runtime import replay

        sound = self.sound = replay.BlockReplay._run_chunk
        pairs = self.pairs

        def run_chunk(br, rows):
            if br.device.type != "cuda" or br.graph is None:
                return sound(br, rows)
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            br._done = torch.cuda.Event(enable_timing=True)
            out = sound(br, rows)
            pairs.append((start, br._done))
            return out
        replay.BlockReplay._run_chunk = run_chunk
        return self

    def __exit__(self, *exc):
        from audioforge_tpu_torch.runtime import replay

        replay.BlockReplay._run_chunk = self.sound
        return False


def time_replays(proc, n: int, clock) -> tuple:
    """About ``n`` blocks with every graph round trip timed
    (:class:`ReplayTimer`): ``(device intervals [(start_ns, end_ns)] on the
    spans' clock, the stretch's start and end there)``. A reference event
    recorded on a stream of its own and waited for pins the card's clock to
    the host's (to the wait's latency, some microseconds)."""
    ref = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(torch.cuda.Stream()):
        ref.record()
    ref.synchronize()
    t_ref = clock()
    with proc._lock:
        b0 = proc._counters["blocks_processed"]
    t0 = time.perf_counter()
    with ReplayTimer() as timer:
        while time.perf_counter() - t0 < 30.0:
            with proc._lock:
                if proc._counters["blocks_processed"] >= b0 + n:
                    break
            time.sleep(0.005)
    t_end = clock()
    torch.cuda.synchronize()
    dev = [(t_ref + int(ref.elapsed_time(a) * 1e6), t_ref + int(ref.elapsed_time(b) * 1e6))
           for a, b in timer.pairs]
    return dev, t_ref, t_end


def time_stretches(proc, n: int, clock, tries: int = 3) -> list:
    """:func:`time_replays` over stretches of ``n`` blocks, until one runs as
    the window does, in bursts of one block: at most a quarter of its
    bursts drained more (at most ``tries`` stretches; all are returned)."""
    from audioforge_tpu_torch.runtime import tracing

    out = []
    for _ in range(tries):
        dev, lo, hi = time_replays(proc, n, clock)
        ks = [s["attrs"]["k"] for s in tracing.snapshot()["spans"]
              if s["name"] == "live.burst" and lo <= s["start_ns"] < hi]
        out.append((dev, lo, hi))
        if ks and sum(k > 1 for k in ks) <= len(ks) / 4:
            break
    return out


def reduce_replays(stretches: list, spans: list) -> dict:
    """The timed stretch (the last of ``stretches``, the first that ran in
    bursts of one block, or the last tried): device time a block (the union
    of every round trip's interval, over the blocks of the ``live.burst``
    spans that start in it), its bursts drained more than one block, and
    the card's idle time by the DSP thread's innermost span
    (``harness.idle_by_span``)."""
    dev, lo, hi = stretches[-1]
    bursts = [s["attrs"]["k"] for s in spans
              if s["name"] == "live.burst" and lo <= s["start_ns"] < hi]
    blocks = sum(bursts)
    if not dev or not blocks:
        return {"busy_s": None}
    host = sorted((s["start_ns"], s["end_ns"], s["name"]) for s in spans
                  if s["name"] in DSP_SPANS and s["end_ns"] > lo and s["start_ns"] < hi)
    busy, idle = harness.idle_by_span(dev, host, lo, hi)
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "blocks": blocks,
            "busy_ms_per_block": busy / 1e6 / blocks,
            "idle_gaps": [[k, v / 1e9] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
            "round_trips": len(dev), "bursts": len(bursts),
            "drained_bursts": sum(k > 1 for k in bursts), "stretches": len(stretches)}


def window_numbers(snap: dict, mic: Mic, ws: int, we: int, drain_ns: int, bad: list) -> dict:
    """The window's blocks from the tracer's snapshot: their latencies,
    pickups and burst times, the dropped and failed blocks, the captures,
    and the DSP thread's self times a block."""
    from audioforge_tpu_torch.runtime import tracing

    spans = snap["spans"]
    bursts = sorted((s for s in spans if s["name"] == "live.burst"),
                    key=lambda s: s["attrs"].get("first_sample", -1))
    if not bursts:
        raise RuntimeError("no live.burst span: the engine records no spans")
    ticks = np.asarray(mic.ticks, np.int64)
    n = ticks.size
    start = np.full(n, -1, np.int64)
    end = np.full(n, -1, np.int64)
    per_block = np.zeros(n)
    dropped = np.zeros(n, bool)
    covered_to = 0
    for s in bursts:
        a = s["attrs"]
        first, k = a["first_sample"] // BLOCK, a["k"]
        dropped[covered_to:min(first, n)] = True
        sl = slice(first, min(first + k, n))
        start[sl], end[sl] = s["start_ns"], s["end_ns"]
        per_block[sl] = (s["end_ns"] - s["start_ns"]) / k
        covered_to = first + k
    win = np.flatnonzero((ticks >= ws) & (ticks < we))
    done = win[(end[win] >= 0) & (end[win] <= we + drain_ns)]
    bad_in = np.intersect1d(np.asarray(bad, np.int64), done).size
    n_dropped = int(dropped[win].sum())
    ids = {s["id"] for s in bursts if s["start_ns"] >= ws and s["end_ns"] <= we + drain_ns}
    tree = [s for s in spans if s["id"] in ids or s["parent"] in ids]
    window_blocks = int(sum(s["attrs"]["k"] for s in bursts if s["id"] in ids))
    own = tracing.self_ns(tree)
    caps = [[(s["start_ns"] - ws) / 1e9, (s["end_ns"] - s["start_ns"]) / 1e6] for s in spans
            if s["name"] == "replay.capture" and ws <= s["start_ns"] < we + drain_ns]
    return {
        "attempted": int(win.size),
        "failed": int(win.size - n_dropped - done.size + bad_in),
        "dropped_blocks": n_dropped,
        "latencies_ms": (end[done] - ticks[done]) / 1e6,
        "pickup_ms": (start[done] - ticks[done]) / 1e6,
        "burst_ms": per_block[done] / 1e6,
        "self_ms": {k: v / 1e6 / max(window_blocks, 1) for k, v in sorted(own.items())},
        "captures": caps,
        "capture_ms": sum(ms for _, ms in caps) if caps else None,
        "underruns": int(sum(bool(s["attrs"].get("underrun")) for s in spans
                             if s["name"] == "live.output" and ws <= s["start_ns"] < we)),
        "dropped_spans": int(snap["dropped_spans"]),
    }


# ---------------------------------------------------------------- the check
def _host(tree):
    """A state tree's tensors as host arrays (so that a worker process is
    sent bytes, not shared tensor handles)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def probe_data(rec: Recorder, config: dict, schedule: list, blocks: int, probes: int) -> dict:
    """The probes that ran their ``blocks`` and whose end state was copied:
    each as the reference's
    :func:`~bench_torch.reference.runtime.live_processor.render` takes it
    (every block of its bursts, ``end`` of them), with the program's output
    ``got [blocks * 480]``, its chain state after its last burst ``after``
    and its class; the UI's changes as the reference's schedule."""
    strength = float(config["controls"]["params"]["suppressor_strength"])
    out = {"checked": 0, "of": probes, "probes": [], "got": [], "after": [], "classes": [],
           "schedule": {"eq": [(b, g) for _, b, g, _ in schedule], "deesser": []}}
    on = bool(config["controls"]["topology"]["deesser_enabled"])
    for _, _, _, d in schedule:
        on = on if d is None else d
        out["schedule"]["deesser"].append(on)
    for p in rec.probes:
        if p["blocks"] < blocks or "after" not in p:
            continue
        e = p["entry"]
        rows = {"x": [], "vad_probability": [], "vad_fresh": [], "applied": [], "y": []}
        for r in p["bursts"]:
            k = r["x"].shape[0]
            rows["x"].append(r["x"])
            rows["y"].append(r["y"])
            rows["vad_probability"] += [r["vad"][0]] * k
            rows["vad_fresh"] += [r["vad"][1]] * k
            rows["applied"] += [r["applied"]] * k
        probe = {"state": _host(e["state"]), "entry_applied": e["applied"],
                 "supp": {"model": _host(e["model"]), "strength": strength,
                          "smoothed_strength": e["smoothed_strength"],
                          "dry_delay": e["dry_delay"], "in_buf": e["in_buf"],
                          "out_buf": e["out_buf"]},
                 "end": p["blocks"], "x": np.concatenate(rows["x"]),
                 "vad_probability": np.asarray(rows["vad_probability"]),
                 "vad_fresh": np.asarray(rows["vad_fresh"]),
                 "applied": np.asarray(rows["applied"])}
        out["probes"].append(probe)
        out["got"].append(np.concatenate(rows["y"])[:blocks].reshape(-1))
        out["after"].append(_host(p["after"]))
        out["classes"].append(p["class"])
        out["checked"] += 1
    return out


def reference_job(config: dict, schedule: dict, probes: list, blocks: int,
                  control: str | None = None) -> tuple:
    """The plain reference's render of ``probes`` (or control ``control``
    of it, ``live_readings.CONTROLS``) on the CPU: ``(y [P, blocks * 480],
    each probe's chain state after its end)``."""
    from ..reference.models import rnnoise
    from ..reference.runtime import live_processor

    torch.set_num_threads(1)
    weights = rnnoise.load_weights(harness.HERE.parent / config["archives"]["rnnoise"])
    args = (probes, config["controls"], schedule, weights, blocks)
    if control is None:
        return live_processor.render(*args)
    from .live_readings import lower

    with lower(control):
        return live_processor.render(*args)


def run_jobs(jobs: list, workers: int) -> list:
    """:func:`reference_job` over ``jobs`` (argument tuples), side by side
    in ``workers`` processes of their own, or in this one for 0."""
    if workers <= 0:
        return [reference_job(*job) for job in jobs]
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
        futures = [pool.submit(reference_job, *job) for job in jobs]
        return [f.result() for f in futures]


def with_ulp_up(probes: list) -> list:
    """The probes, then each again with its input one ULP up."""
    return probes + [dict(p, x=harness.one_ulp_up(p["x"])) for p in probes]


def _vector(tree, like) -> np.ndarray:
    """The leaves of a state tree (or a leaf) at the paths of the tree
    ``like`` as one float64 vector, in the order of its keys."""
    if isinstance(like, dict):
        parts = [_vector(tree[k], v) for k, v in sorted(like.items())]
        return np.concatenate(parts) if parts else np.zeros(0)
    return np.asarray(tree, np.float64).ravel()


def compare_states(got: list, want: list, moved: list) -> dict:
    """The chain's state at the probes' ends, stage by stage (a top-level
    key of the reference's state, its leaves as one vector): each probe's
    RMS distance from the reference's over the reference's RMS, and its
    move the same of the reference's over the inputs one ULP up; for each
    stage the median of the probes' distances over the median of their
    moves (at least float32's epsilon), in the reference's own sensitivity
    to rounding, as the serving rule counts the output."""
    eps = float(np.finfo(np.float32).eps)
    ratio, each = {}, {}
    for stage in want[0]:
        err, move = [], []
        for g, w, m in zip(got, want, moved):
            wv = _vector(w[stage], w[stage])
            scale = max(float(np.sqrt(np.mean(wv ** 2))) if wv.size else 0.0, 1e-30)
            gv = np.nan_to_num(_vector(g[stage], w[stage]), nan=np.inf)
            mv = _vector(m[stage], w[stage])
            err.append(float(np.sqrt(np.mean((gv - wv) ** 2))) / scale if wv.size else 0.0)
            move.append(float(np.sqrt(np.mean((mv - wv) ** 2))) / scale if wv.size else 0.0)
        ratio[stage] = float(np.median(err)) / max(float(np.median(move)), eps)
        each[stage] = [err, move]
    return {"state_err_ratio_max": max(ratio.values()), "state_err_ratio": ratio,
            "state_probe_err_move": each}


def compare_all(got: list, after: list, classes, both: tuple, n: int) -> dict:
    """The compared numbers of ``n`` probes from the reference's render of
    them and of them one ULP up (``both``: the outputs and end states of the
    ``2 n`` streams). The output: each probe's relative RMS error over its
    own one-ULP move (at least float32's epsilon); their median over the
    probes (``probe_err_ratio_median``: a fault or a lower precision of the
    whole chain moves every probe) and, for each class, the smallest of its
    probes', the largest over the classes (``class_floor_ratio_max``: a
    fault of one class's path moves all of its probes). Some probes of a
    sound run read far above their move: a gate decision that flips in a
    quiet gated probe, and the compressor's release, which the input's
    one-ULP move does not reach, drifting apart over a loud one; these move
    neither number. The end states' largest stage
    (``state_err_ratio_max``). The serving rule's ``class_err_ratio_max``
    is reported beside them."""
    y, states = both
    y = np.asarray(y, np.float64)
    got = np.stack(got)
    classes = np.asarray(classes)
    out = harness.compare(got, y[:n], y[n:], classes)
    eps = float(np.finfo(np.float32).eps)
    rel, move = harness._rel_rms(got, y[:n]), harness._rel_rms(y[n:], y[:n])
    ratio = rel / np.maximum(move, eps)
    out["probe_err_ratio_median"] = float(np.median(ratio))
    out["class_floor_ratio_max"] = float(max(ratio[classes == c].min()
                                             for c in np.unique(classes)))
    out["probe_err_move"] = [rel.tolist(), move.tolist()]
    out.update(compare_states(after, states[:n], states[n:]))
    return out


def check_probes(config: dict, data: dict, blocks: int, workers: int) -> dict:
    """The probes against the plain reference over the same inputs and the
    inputs one ULP up (one batch, one job: the reference's cost is its
    sample loops, whatever the batch)."""
    out = {"probes_checked": (data["checked"], data["of"])}
    if data["checked"]:
        both = run_jobs([(config, data["schedule"], with_ulp_up(data["probes"]), blocks)],
                        workers)[0]
        out.update(compare_all(data["got"], data["after"], data["classes"], both,
                               data["checked"]))
    return out


# ---------------------------------------------------------------- the cell
def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", sizes: dict | None = None, engine_hook=None,
             reference: bool = True, workers: int | None = None) -> dict:
    """One run of ``cell`` (see :func:`harness.run_cell`): ``sizes``
    overrides the mix's fields (``mix``) and the check's (``check``);
    ``engine_hook(processor)`` may replace the engine's methods or the
    port's functions before the run (it may return a callable that undoes
    it, called at the end). The reference runs in ``workers`` processes (1
    unless given; 0: in this one)."""
    from audioforge_tpu_torch.runtime import tracing

    if not hasattr(tracing, "clock_ns"):
        raise SystemExit("this port's live engine records no live.* spans: the program "
                         "'live' cannot time its blocks")
    from audioforge_tpu_torch.runtime import processor as proc_mod

    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    mix = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    check = dict(config["check"])
    if sizes:
        mix = {**mix, **sizes.get("mix", {})}
        check.update(sizes.get("check", {}))
    blocks, n_probes = int(check["blocks"]), int(check["probes"])
    check_archives(config)
    audio, classes, seg = live_take(mix, seed, seconds)
    schedule = control_schedule(mix, seed, seconds)
    dev = torch.device(device)
    clock = tracing.clock_ns

    proc = proc_mod.AudioProcessor(device=device)
    apply_controls(proc, config["controls"])
    proc.realtime_pacing = bool(config["engine"]["realtime_pacing"])
    # a tick longer than a block runs the engine in slow motion (the CPU
    # tests): its devices pace it, its own pacing off, and the VAD
    # posterior's staleness stretched as much
    tick_ms = float(mix["tick_ms"])
    pace = tick_ms / 1e3 if tick_ms > 1e3 * BLOCK / FS else 0.0
    stale_ms = proc_mod.VAD_STALE_MS
    if pace:
        proc.realtime_pacing = False
        proc_mod.VAD_STALE_MS = stale_ms * tick_ms / (1e3 * BLOCK / FS)
    if (proc._host_block_multiple, proc._max_drain_blocks) != (
            config["engine"]["host_block_multiple"], config["engine"]["max_drain_blocks"]):
        raise RuntimeError("the engine's host block multiple and drain cap are not the "
                           "configuration's (an AUDIOFORGE_* variable is set)")
    undo = engine_hook(proc) if engine_hook is not None else None
    ceiling_db = effective_limiter_ceiling_db(
        config["controls"]["params"]["limiter_ceiling_db"],
        config["controls"]["topology"]["careful_output_enabled"])
    rec = Recorder(proc, 10.0 ** (ceiling_db / 20.0) * CEILING_MARGIN, blocks)
    rec.install()
    tracing.reset()
    tracing.enable()
    mic, sink = Mic(audio, clock, pace), Sink(clock, pace)
    proc_mod.register_virtual_input(MIC, lambda: mic)
    proc_mod.register_virtual_output(SINK, lambda: sink)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    traced = None
    try:
        proc.start(MIC, SINK)
        rec.install_poll()
        t0 = time.perf_counter()
        while sink.first_ns is None and time.perf_counter() - t0 < 120.0:
            time.sleep(0.002)
        if sink.first_ns is None:
            raise RuntimeError("no output block reached the sink")
        ws = sink.first_ns + int(mix["lead_seconds"] * 1e9)
        we = ws + int(seconds * 1e9)
        drain = int(mix["drain_seconds"] * 1e9)
        gc.collect()
        _sleep_until(clock, ws)
        setup_s = time.perf_counter() - t_start
        rng = np.random.default_rng([seed, 0x7072])
        # the stretches start 200 ms into the window, and end 400 ms before its end
        lo = mic.calls + int(np.ceil(200.0 / tick_ms))
        hi = (lo + int(seconds * 1e3 / tick_ms) - blocks - 8 - int(np.ceil(600.0 / tick_ms)))
        rec.plan = plan_probes(rng, classes, seg, lo, hi, n_probes, blocks)
        for t, band, gain, deesser in schedule:
            _sleep_until(clock, ws + int(t * 1e9))
            with proc._lock:
                proc.set_eq_band_gain(band, gain)
                if deesser is not None:
                    proc.set_deesser_enabled(deesser)
                rec.issued += 1
        _sleep_until(clock, we + drain)
        t_wait = time.perf_counter()
        while ((rec.plan or any(p["blocks"] < blocks for p in rec.probes))
               and time.perf_counter() - t_wait < mix["probe_wait_s"]):
            time.sleep(0.01)
        if trace and dev.type == "cuda":
            traced = time_stretches(proc, int(mix["profiled_blocks"]), clock)
    finally:
        proc.stop()
        tracing.disable()
        rec.uninstall()
        proc_mod.VAD_STALE_MS = stale_ms
        if callable(undo):
            undo()
    snap = tracing.snapshot()
    tracing.reset()
    diag_error = proc._recovery["last_error"]
    if diag_error:
        raise RuntimeError(f"the engine failed: {diag_error}")
    numbers = window_numbers(snap, mic, ws, we, drain, rec.bad)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if traced is not None:
        traced = reduce_replays(traced, snap["spans"])
    data = probe_data(rec, config, schedule[:rec.issued], blocks, n_probes)
    measured = {"setup_s": setup_s, "mix": mix, "device": dev.type, "trace": traced,
                "latencies_ms": numbers["latencies_ms"], "live": numbers,
                "counts": live_totals(config, harness.HERE.parent)}
    metrics = {}
    for m in harness.cell_metrics(bench, cell["name"], trace):
        value = harness.reader(m["name"])(measured)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not reference:
        return {"attempted": numbers["attempted"], "failed": numbers["failed"],
                "metrics": metrics, "probes": data, "live": numbers}
    t_check = time.perf_counter()
    checked = check_probes(config, data, blocks, 1 if workers is None else workers)
    checked["dropped_spans"] = numbers["dropped_spans"]
    print(f"{cell['name']}: seed {seed}, set-up {setup_s:.2f} s, window {seconds:g} s "
          f"({numbers['attempted']} blocks, {numbers['dropped_blocks']} dropped, "
          f"{numbers['underruns']} underruns), reference {time.perf_counter() - t_check:.2f} s, "
          f"failed {numbers['failed']}; captures in the window (s from its start, ms) "
          f"{numbers['captures']}; self ms a block {numbers['self_ms']}; by class: error "
          f"{checked.get('class_median_err')}, the reference's one-ULP move "
          f"{checked.get('class_ulp_move')}, their ratio {checked.get('class_err_ratio')}; "
          f"the end state's ratio by stage {checked.get('state_err_ratio')}", file=sys.stderr)
    if traced is not None:
        print(f"{cell['name']}: timed {traced.get('blocks')} blocks in "
              f"{traced.get('bursts')} bursts ({traced.get('drained_bursts')} drained; "
              f"stretch {traced.get('stretches')} tried), {traced.get('round_trips')} "
              f"round trips, busy {traced.get('busy_ms_per_block')} ms a block, idle by "
              f"span {traced.get('idle_gaps')}", file=sys.stderr)
    correct, shown = harness.verdict(checked, check["limits"])
    result = {"correct": correct, "attempted": numbers["attempted"], "failed": numbers["failed"],
              "metrics": metrics, "device": harness.device_info(device, peak)}
    if traced is not None and traced.get("busy_s"):
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"idle_gaps": traced["idle_gaps"],
                               "drained_bursts": [traced["drained_bursts"], traced["bursts"]],
                               "self_ms": [[k, v] for k, v in numbers["self_ms"].items()]}
    result["check"] = shown
    return result

