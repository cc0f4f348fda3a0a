"""Faults planted in the compressor search's timed path, for the CPU tests
and for the readings on the card: each is a hook ``fault(program)`` that
replaces a setting or the renderer of a :class:`~.chain.Program`, so that
the rest of a run (its loop, its probes, its check) is driven as it is."""

from __future__ import annotations

import contextlib
from dataclasses import replace


def _wrap_output(prog, edit) -> None:
    """The renderer's output ``(audio [B, nb, T], stats)`` passes through
    ``edit`` before the entry point turns it into diagnostics."""
    sound = prog.run_chain

    def run(*args):
        ys, stats = sound(*args)
        ys, stats = ys.copy(), {k: v.copy() for k, v in stats.items()}
        edit(ys, stats)
        return ys, stats
    prog.run_chain = run


def eq_gain_off(prog) -> None:
    """The 160 Hz band's gain 0.1 dB off (one EQ section)."""
    f, g, q = prog.bands[1]
    prog.bands[1] = (f, g + 0.1, q)


def deesser_skipped(prog) -> None:
    """The de-esser is not run."""
    prog.settings["deesser_enabled"] = False


def block_repeated(prog) -> None:
    """A late block of every candidate (three quarters into the take) is the
    one before it again."""
    def edit(ys, stats):
        late = ys.shape[1] * 3 // 4
        ys[:, late] = ys[:, late - 1]
    _wrap_output(prog, edit)


def tp_release_changed(prog) -> None:
    """The true-peak limiter releases in 60 ms instead of the configured 80."""
    sound = prog.run_chain

    def run(cfg, *args):
        return sound(replace(cfg, tp_release_ms=0.75 * cfg.tp_release_ms), *args)
    prog.run_chain = run


def state_unchanged(prog) -> None:
    """Each block starts from the state the take started with."""
    from audioforge_tpu_torch.runtime import chain, replay

    def frozen(cfg, params, state, x, return_audio=True):
        n, nb, T = x.shape
        p = chain.comp_param_tensors(params, n, x.device)

        def step(st, block):
            _, y, stats = chain.chain_block(cfg, p, st, block["x"])
            return st, dict(stats, y=y)
        _, rows = replay.run_take(step, state, {"x": x.transpose(0, 1)}, nb)
        ys = rows.pop("y").transpose(0, 1).contiguous()
        return state, ys, {k: v.t() for k, v in rows.items()}

    sound = prog.run_chain

    def run(*args):
        with _swapped(chain, "chain_run", frozen):
            return sound(*args)
    prog.run_chain = run


@contextlib.contextmanager
def _swapped(module, name, value):
    sound = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, sound)


def half_left_out(prog) -> None:
    """The second half of the candidates is never rendered: its output
    stays 0."""
    def edit(ys, stats):
        ys[ys.shape[0] // 2:] = 0.0
    _wrap_output(prog, edit)


def answer_altered(prog) -> None:
    """One sample of every block is altered where the chain produces it."""
    def edit(ys, stats):
        ys[:, :, 7] += 0.01
    _wrap_output(prog, edit)


def detector_low(prog) -> None:
    """The output true-peak detector reads 1 % low."""
    def edit(ys, stats):
        stats["output_true_peak"] *= 0.99
    _wrap_output(prog, edit)


def percentile_off(prog) -> None:
    """The diagnostics' 95th percentile of gain reduction is the 90th."""
    api = prog.api
    sound = api.percentile

    def run(*args):
        with _swapped(api, "percentile",
                      lambda v, p: sound(v, 0.90 if p == 0.95 else p)):
            return prog_call(*args)
    prog_call = prog.call
    prog.call = run


FAULTS = {f.__name__: f for f in (eq_gain_off, deesser_skipped, block_repeated,
                                  state_unchanged, half_left_out, answer_altered,
                                  detector_low, percentile_off)}
# faults that the traffic cannot show: neither limiter reduces gain on its
# takes, so a limiter's release changes no output (the readings run them too)
UNSEEN = {f.__name__: f for f in (tp_release_changed,)}
