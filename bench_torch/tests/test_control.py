"""The TF32 control, at a size a CPU test run holds: the plain reference
computed in TF32 in the program's place must fail the configuration's
check, on two seeds. (On the chip, ``bench_torch/control.py`` runs it at
each cell's own size; PERF.md gives those readings.)"""

import json
from pathlib import Path

import pytest
import torch

from bench_torch import control, harness
from bench_torch.control import to_tf32

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-11 + 2**-20,
                      float("inf"), -2.5])
    want = torch.tensor([1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0 + 2**-10, float("inf"), -2.5])
    assert torch.equal(to_tf32(x), want)


@pytest.mark.parametrize("cell, blocks", [("full_rnnoise_vad.batch", 8),
                                          ("default_dfn3_ll.batch", 16)])
def test_the_tf32_control_fails_the_check(cell, blocks):
    config, mix, fleet = harness.cell_files(harness.find_cell(BENCH, cell))
    limits = config["check"]["limits"]
    for seed in (2**31 + 1, 2**31 + 2):
        numbers = control.probe_numbers(config, mix, fleet, seed,
                                        {"probes": 2, "blocks": blocks})
        assert any(numbers[k] > v for k, v in limits.items()), numbers
