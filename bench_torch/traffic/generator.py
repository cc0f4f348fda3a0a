"""The one traffic generator: a seeded pool of microphone-like audio and,
for a mix's parameters, which stream plays which part of it and when the
probe streams (calls that attach inside the window) start.

``mic_capture`` is a copy of the port's smoke test's generator, kept here so
that later changes to the smoke test leave the benchmark's inputs alone.
"""

from __future__ import annotations

import numpy as np

BLOCK = 480
FS = 48000.0
CLASSES = 4      # mic_capture's stream classes: stream i is of class i % 4


def _voice_on(t: np.ndarray, phase) -> np.ndarray:
    """Where ``mic_capture``'s voice sounds: a 3 Hz on/off envelope."""
    return np.sin(2 * np.pi * 3.0 * t + phase) > -0.2


def mic_capture(n: int, n_blocks: int, seed: int) -> np.ndarray:
    """Four stream classes (i % 4) under a voice: 0 hum at 50.4 Hz with its
    harmonic, 1 hum at 59.7 Hz, 2 sibilance (0.25 at 6.8 kHz over a 0.05
    body), 3 low plosive thumps; ``[n, n_blocks * 480]``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * BLOCK) / FS
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    f0 = rng.uniform(120.0, 200.0, (n, 1))
    voiced = sum(np.sin(2 * np.pi * f0 * h * t + h * phase) / h for h in range(1, 5))
    voice = 0.08 * voiced * _voice_on(t, phase)
    cls = np.arange(n)[:, None] % CLASSES
    x = voice + 0.003 * rng.standard_normal((n, t.size))
    x += (cls == 0) * (0.1 * np.sin(2 * np.pi * 50.4 * t + phase)
                       + 0.03 * np.sin(2 * np.pi * 100.8 * t + phase))
    x += (cls == 1) * 0.08 * np.sin(2 * np.pi * 59.7 * t + phase)
    sib = 0.25 * np.sin(2 * np.pi * 6800.0 * t + phase)
    x = np.where(cls == 2, 0.05 * voiced + sib, x)
    thump = np.zeros(t.size)
    for at in range(2000, t.size - 1500, 9000):
        thump[at:at + 1500] += 0.7 * np.hanning(1500)
    x += (cls == 3) * thump
    return x.astype(np.float32)


class Traffic:
    """A mix's audio for ``fleet`` streams from ``seed``.

    ``pool [pool_streams, pool_blocks, 480]``: the signal's pool; stream
    ``i`` plays pool stream ``i % pool_streams`` (so its class is ``i % 4``)
    cyclically from its own block offset. Probes: ``probes`` calls that
    attach in place of a stream of the fleet, one in each of ``probes``
    equal ranges of slots, probe ``j`` in a slot of class ``j % 4`` (so
    every class has as many probes), each at a drawn share of the window in
    ``[0, probe_latest)``, playing a pool stream of its class from a drawn
    offset."""

    def __init__(self, mix: dict, fleet: int, probes: int, seed: int):
        if mix["signal"] != "mic_capture":
            raise ValueError(f"unknown signal {mix['signal']!r}")
        rng = np.random.default_rng([seed, 0x6175])
        self.pool_streams = int(mix["pool_streams"])
        self.pool_blocks = int(round(mix["pool_seconds"] * FS / BLOCK))
        self.pool = mic_capture(self.pool_streams, self.pool_blocks,
                                int(rng.integers(2**62))).reshape(
            self.pool_streams, self.pool_blocks, BLOCK)
        self.fleet = fleet
        self.source = np.arange(fleet) % self.pool_streams
        self.offset = rng.integers(0, self.pool_blocks, fleet)
        span = fleet // probes
        self.probe_class = np.arange(probes) % CLASSES
        lo = np.arange(probes) * span
        first = lo + (self.probe_class - lo) % CLASSES  # the range's first slot of the class
        if (first >= lo + span).any():
            raise ValueError(f"{probes} probes over {fleet} streams: a probe's range of "
                             "slots holds none of its class")
        count = (lo + span - 1 - first) // CLASSES + 1  # the range's slots of the class
        self.probe_slots = first + CLASSES * rng.integers(0, count)
        self.probe_at = np.sort(rng.uniform(0.0, mix["probe_latest"], probes))
        self.probe_source = (self.probe_class
                             + CLASSES * rng.integers(0, self.pool_streams // CLASSES, probes))
        self.probe_offset = rng.integers(0, self.pool_blocks, probes)

    def attach_probe(self, j: int) -> int:
        """Stream ``probe_slots[j]`` now plays probe ``j``'s audio from its
        first block; returns the slot."""
        slot = int(self.probe_slots[j])
        self.source[slot] = self.probe_source[j]
        self.offset[slot] = self.probe_offset[j]
        return slot

    def block(self, stream: int, b: int) -> np.ndarray:
        """Stream ``stream``'s block ``b`` (counted from its attach): a view."""
        return self.pool[self.source[stream], (self.offset[stream] + b) % self.pool_blocks]

    def blocks(self, stream: int, b: int, k: int) -> np.ndarray:
        """Its blocks ``[b, b + k)`` as one ``[k * 480]`` array."""
        idx = (self.offset[stream] + b + np.arange(k)) % self.pool_blocks
        return self.pool[self.source[stream], idx].reshape(-1)

    def probe_input(self, j: int, k: int) -> np.ndarray:
        """Probe ``j``'s first ``k`` blocks ``[k * 480]``."""
        idx = (self.probe_offset[j] + np.arange(k)) % self.pool_blocks
        return self.pool[self.probe_source[j], idx].reshape(-1)


def halton(index: int, base: int) -> float:
    """The ``index``-th point of the van der Corput sequence in ``base``."""
    out, scale = 0.0, 1.0
    while index > 0:
        scale /= base
        out += scale * (index % base)
        index //= base
    return out


def first_wave(incumbent: dict, bounds: dict, sweep: int, points: int) -> list:
    """A Voice Setup compressor search's first wave (``voice_setup.py``
    ``_calibrate_compressor``): the incumbent, the incumbent at ``sweep``
    thresholds spread evenly over the threshold's bounds, and ``points``
    Halton points (bases 2, 3, 5, 7) over the four parameters' bounds."""
    lo, hi = bounds["threshold_db"]
    wave = [dict(incumbent)]
    wave += [dict(incumbent, threshold_db=float(t)) for t in np.linspace(lo, hi, sweep)]
    wave += [{k: b[0] + halton(i, base) * (b[1] - b[0])
              for (k, b), base in zip(bounds.items(), (2, 3, 5, 7))}
             for i in range(1, points + 1)]
    return wave


class Searches:
    """A search mix's takes and candidates from ``seed``.

    ``takes`` recorded takes of ``take_seconds`` each, take ``i`` of
    ``mic_capture``'s class ``i % 4``; call ``c`` renders take ``c % takes``
    under every candidate of the first wave. Probes: ``probe_calls`` calls,
    call ``j`` at a drawn share of the window in ``[0, probe_latest)``,
    rendering a drawn take of class ``j % 4`` in place of its turn's, with
    ``probe_candidates`` drawn candidates of it kept."""

    def __init__(self, mix: dict, config: dict, seed: int):
        if mix["signal"] != "mic_capture":
            raise ValueError(f"unknown signal {mix['signal']!r}")
        rng = np.random.default_rng([seed, 0x7365])
        n = int(mix["takes"])
        blocks = int(round(mix["take_seconds"] * FS / BLOCK))
        self.takes = mic_capture(n, blocks, int(rng.integers(2**62)))
        self.candidates = first_wave(config["incumbent"], config["search_bounds"],
                                     int(mix["threshold_sweep"]), int(mix["halton_points"]))
        calls, per = int(mix["probe_calls"]), int(mix["probe_candidates"])
        if n % CLASSES or n < CLASSES:
            raise ValueError(f"{n} takes do not hold every class alike")
        self.probe_class = np.arange(calls) % CLASSES
        self.probe_take = self.probe_class + CLASSES * rng.integers(0, n // CLASSES, calls)
        self.probe_candidates = np.stack([rng.choice(len(self.candidates), per, replace=False)
                                          for _ in range(calls)])
        self.probe_at = np.sort(rng.uniform(0.0, mix["probe_latest"], calls))
