"""The port's tracer: counters for the whole process, and spans, off by default.

Counters (:func:`count`) are always on: the graph replays count captures
(``replay.captures``) and replays (``replay.replays``), and the serving
engine's ``step_many`` its chunks (``engine.span_chunks``) and those still
running on the card when the host came to wait for them
(``engine.span_chunks_hidden``). Spans (:func:`span`) record
only between :func:`enable` and :func:`disable`; while they are off,
:func:`span` returns one shared null context, so an off span costs a flag
check. Samples (:func:`sample`), the serving engine's device time per stage
of its graph replay, are also taken only while spans are on.

A span records its name, start and end, its id, its parent (the span open
on the same thread when it started), the thread, its call (the id of the
outermost span open on the thread: every span of one engine call shares it)
and its attributes. Spans go into a ring of :data:`RING` entries; the
oldest give way, and ``dropped_spans`` counts them.

Spans are stamped in nanoseconds since the epoch, the clock on which
``torch.profiler`` stamps its host events: the monotonic
``time.perf_counter_ns`` plus its offset to ``time.time_ns`` taken at
:func:`enable`, so that a span lines up with the profiler's trace of the
same stretch. Spans do not go through ``torch.profiler.record_function``,
whose ranges a CUDA trace also shows as device annotations.

:func:`snapshot` is the only way out: spans, counters and samples as plain
lists and dicts. :func:`reset` clears them;
:func:`self_ns` sums a snapshot's spans' self time by name.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

__all__ = ["RING", "Tracer", "TRACER", "enable", "disable", "enabled", "span", "count",
           "sample", "current_call", "snapshot", "reset", "self_ns"]

RING = 65536

_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "id", "parent", "call", "start")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.id = next(tr._ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tr = self.tracer
        tr._stack().pop()
        off = tr._offset
        tr._record((self.name, self.start + off, end + off, self.id, self.parent,
                    threading.get_ident(), self.call, self.attrs))
        return False


class Tracer:
    """Counters, and spans and samples kept in rings of ``ring`` entries."""

    def __init__(self, ring: int = RING):
        self.on = False
        self._offset = 0
        self._spans = collections.deque(maxlen=ring)
        self._samples = {}
        self._counters = {}
        self._dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, entry: tuple) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(entry)

    def enable(self) -> None:
        """Record spans and samples from now on."""
        self._offset = time.time_ns() - time.perf_counter_ns()
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, **attrs):
        """A context manager that records ``name`` over its block while spans
        are on; the shared null context while they are off."""
        if not self.on:
            return _NULL
        return _Span(self, name, attrs)

    def current_call(self):
        """The call id of the spans open on this thread; None when none is."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].call if stack else None

    def count(self, name: str, k: int = 1) -> None:
        """Add ``k`` to counter ``name`` (always on)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + k

    def sample(self, name: str, value: float) -> None:
        """Record ``value`` under ``name`` with its time, while spans are on."""
        if not self.on:
            return
        t = time.perf_counter_ns() + self._offset
        with self._lock:
            ring = self._samples.get(name)
            if ring is None:
                ring = self._samples[name] = collections.deque(maxlen=self._spans.maxlen)
            ring.append((t, float(value)))

    def snapshot(self) -> dict:
        """Spans, counters and samples as plain lists and dicts."""
        with self._lock:
            spans = [{"name": n, "start_ns": s, "end_ns": e, "id": i, "parent": p,
                      "thread": t, "call": c, "attrs": dict(a)}
                     for n, s, e, i, p, t, c, a in self._spans]
            return {"enabled": self.on, "spans": spans, "dropped_spans": self._dropped,
                    "counters": dict(self._counters),
                    "samples": {k: [list(v) for v in ring]
                                for k, ring in self._samples.items()}}

    def reset(self) -> None:
        """Clear the spans, samples, counters and the dropped-span count."""
        with self._lock:
            self._spans.clear()
            self._samples.clear()
            self._counters.clear()
            self._dropped = 0


# the process's tracer, which the port records into
TRACER = Tracer()
enable = TRACER.enable
disable = TRACER.disable
span = TRACER.span
count = TRACER.count
sample = TRACER.sample
current_call = TRACER.current_call
snapshot = TRACER.snapshot
reset = TRACER.reset


def enabled() -> bool:
    """Whether spans are on."""
    return TRACER.on


def self_ns(spans: list) -> dict:
    """Self time in ns by span name, summed over ``spans`` (a snapshot's):
    each span's duration less the durations of its children among them."""
    children = {}
    for s in spans:
        if s["parent"] is not None:
            children[s["parent"]] = children.get(s["parent"], 0) + s["end_ns"] - s["start_ns"]
    out = {}
    for s in spans:
        own = s["end_ns"] - s["start_ns"] - children.get(s["id"], 0)
        out[s["name"]] = out.get(s["name"], 0) + own
    return out
