"""Faults planted in the live engine's timed path, for the CPU tests and for
the readings on the card: each is a hook ``fault(processor)`` that replaces
an engine method or a function of the port before the run, so that the rest
of a run (its threads, its traffic, its probes, its check) is driven as it
is. A hook that replaces a module's function returns the callable that puts
it back."""

from __future__ import annotations


def _swap(module, name, value):
    sound = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, sound)


def eq_gain_off(proc) -> None:
    """Every EQ gain the UI sets lands 0.1 dB off."""
    sound = proc.set_eq_band_gain
    proc.set_eq_band_gain = lambda band, gain_db: sound(band, gain_db + 0.1)


def deesser_skipped(proc) -> None:
    """The chain is built without the de-esser, whatever the UI says."""
    sound = proc._build_config
    proc._build_config = lambda topo, par, dee: sound(dict(topo, deesser_enabled=False),
                                                      par, dee)


def block_repeated(proc) -> None:
    """Every 5th burst's first block is the block before it again."""
    sound = proc._process_block
    seen = {"bursts": 0, "last": None}

    def process(config, params, state, x, *rest):
        seen["bursts"] += 1
        last, seen["last"] = seen["last"], x[-1].copy()
        if seen["bursts"] % 5 == 0 and last is not None:
            x = x.copy()
            x[0] = last
        return sound(config, params, state, x, *rest)
    proc._process_block = process


def vad_ignored(proc):
    """The front half takes every VAD snapshot as stale: the gate runs
    without the posterior."""
    from audioforge_tpu_torch.runtime import live_chain

    sound = live_chain.front_run

    def front_run(config, params, state, xs, vad_probability, vad_available, **kw):
        return sound(config, params, state, xs, 0.0, False, **kw)
    return _swap(live_chain, "front_run", front_run)


def ema_skipped(proc):
    """RNNoise's strength takes its target at once, without its 15 ms EMA."""
    from audioforge_tpu_torch.models import rnnoise

    sound = rnnoise.processor_init

    def init(*args, **kwargs):
        return dict(sound(*args, **kwargs), smoothing_coeff=1.0)
    return _swap(rnnoise, "processor_init", init)


FAULTS = {f.__name__: f for f in (eq_gain_off, deesser_skipped, block_repeated, vad_ignored)}
# faults that the traffic cannot show: the suppressor's strength stays at 1,
# the EMA's fixed point from its first frame, so skipping the EMA changes no
# output (the readings run it too)
UNSEEN = {f.__name__: f for f in (ema_skipped,)}
