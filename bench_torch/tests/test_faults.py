"""A run's check against faults planted in the timed path (CPU, tiny
sizes): the harness's look for a card is skipped, the rest of a run is
driven, and ``correct`` must come out false for each fault a cell can have
and true for the sound program. One card holds a cell, so no exchange
between chips exists to leave out."""

import json
import time
from pathlib import Path

import pytest
import torch

from bench_torch import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# every slot of the 8 holds a probe: each stream class has two
SIZES = {"fleet": 8, "mix": {"call_blocks": 3, "pool_streams": 8, "pool_seconds": 0.5,
                             "probe_latest": 0.1},
         "check": {"probes": 8, "blocks": 3}}


def _state_unchanged(eng):
    """Each step returns its state as it found it."""
    from audioforge_tpu_torch.runtime import serving

    def step(shard, state):
        _, y, m = serving._serving_step(eng.config, shard._params_dev, state, shard._fresh,
                                        shard._x, shard._active, None, shard._vad_prob,
                                        shard._vad_avail)
        return y, m
    eng._step_in_place = step


def _half_left_out(eng):
    """The second half of the slots is never processed: its output stays 0."""
    sound = eng._step_in_place

    def step(shard, state):
        y, m = sound(shard, state)
        y = y.clone()
        y[y.shape[0] // 2:] = 0.0
        return y, m
    eng._step_in_place = step


def _answer_altered(eng):
    """One sample of every block is altered where the step produces it."""
    sound = eng._step_in_place

    def step(shard, state):
        y, m = sound(shard, state)
        y = y.clone()
        y[:, 7] += 0.01
        return y, m
    eng._step_in_place = step


def _one_class_altered(eng):
    """One sample of every block is altered in the sibilant class's slots
    alone (slot % 4 == 2), as a fault of a path that serves one class."""
    sound = eng._step_in_place

    def step(shard, state):
        y, m = sound(shard, state)
        y = y.clone()
        y[2::4, 7] += 0.01
        return y, m
    eng._step_in_place = step


def _run(hook, cell="default_dfn3_ll.batch"):
    torch.set_num_threads(2)
    return harness.run_cell(BENCH, harness.find_cell(BENCH, cell), 2**31 + 21, 3.0, False,
                            time.perf_counter(), device="cpu", sizes=SIZES, engine_hook=hook)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered,
                                   _one_class_altered])
def test_a_planted_fault_is_not_correct(fault):
    assert _run(fault)["correct"] is False


def test_the_sound_program_is_correct():
    result = _run(None)
    assert result["correct"] is True
    assert result["check"]["probes_checked"]["value"] == 8
