"""The live engine's burst, ``AudioProcessor(device="cpu")._process_block``,
against the plain burst of ``bench_torch/reference/runtime/live_processor.py``
over blocks of a capture, with the same seeded RNNoise weights (the
reference's ``init_params``) on both sides and a fixed VAD snapshot (the
burst reads the VAD worker's probability; Silero itself does not run in
it). The controls are those of the benchmark's ``live_rnnoise``
configuration: strong cleanup, the VAD-assisted gate, the de-esser on.

Both sides run the chain's recurrences sample by sample on the CPU (about
a second a block each), so the cases are short: the full chain over 4
blocks, the suppressor off over 2, and one burst of 3."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audioforge_tpu_torch.models import rnnoise as port_rnnoise
from audioforge_tpu_torch.models import suppressor as supp
from audioforge_tpu_torch.ops import gate as port_gate
from audioforge_tpu_torch.runtime.processor import AudioProcessor
from bench_torch.reference.models import rnnoise as ref_rnnoise
from bench_torch.reference.runtime import live_chain as ref_lc
from bench_torch.reference.runtime import live_processor as ref

ROOT = Path(__file__).resolve().parents[1]
CONTROLS = json.loads((ROOT / "bench_torch/configs/live_rnnoise.json").read_text())["controls"]
SEED = 0x1717
# Both sides are float32 torch on the CPU over the same operations and read
# equal to the last bit here. The room is for a twin of a hand kernel that
# orders a sum otherwise than the reference's plain loop: a few float32
# roundings a block that the chain's recurrences carry on. 2e-5 of full
# scale is some 170 float32 steps at the output's peak; a stage left out or
# run with other settings moves the output by 1e-3 or more.
ATOL = 2e-5


def _capture(n_blocks: int) -> np.ndarray:
    """A voiced take with hum under dominant sibilance (the de-esser's
    detector acts on a sibilant band above the voice's): the cleanup, the
    gate, the de-esser and RNNoise all act on it."""
    rng = np.random.default_rng(SEED)
    t = np.arange(n_blocks * ref.BLOCK) / 48000.0
    voice = sum(np.sin(2 * np.pi * 150.0 * h * t) / h for h in range(1, 5))
    x = (0.05 * voice * (np.sin(2 * np.pi * 3.0 * t) > -0.2)
         + 0.08 * np.sin(2 * np.pi * 50.4 * t) + 0.25 * np.sin(2 * np.pi * 6800.0 * t)
         + 0.003 * rng.standard_normal(t.size))
    return x.astype(np.float32).reshape(n_blocks, ref.BLOCK)


def _processor(k: int, suppressor_on: bool):
    p = AudioProcessor(device="cpu")
    p._params.update(CONTROLS["params"])
    p._topology.update(CONTROLS["topology"], suppressor_enabled=suppressor_on,
                       gate_mode=getattr(port_gate, CONTROLS["topology"]["gate_mode"]))
    p._deesser.update(CONTROLS["deesser"])
    p._max_drain_blocks = k  # the halves' graphs take bursts of k blocks
    return p


@pytest.mark.parametrize("case,bursts,suppressor_on,strength", [
    ("full chain", [1] * 4, True, 1.0),
    ("suppressor off", [1, 1], False, 1.0),
    # a drain burst of three blocks; the strength moved off 1, so that the
    # suppressor's 15 ms EMA acts on every frame
    ("burst of 3", [3], True, 0.6),
])
def test_process_block_is_the_plain_burst(case, bursts, suppressor_on, strength):
    weights = ref_rnnoise.init_params(SEED)
    x = _capture(sum(bursts))
    vad = (0.7, True)
    k = max(bursts)

    p = _processor(k, suppressor_on)
    config, params, topo, _, _ = p._snapshot_control()
    state = p._fresh_state(config, None)
    engine = supp.engine_init("rnnoise", strength, device="cpu",
                              rnnoise_params=port_rnnoise.weights_from_numpy(weights, "cpu"))
    delay = np.zeros(engine["latency_samples"], np.float32)
    p._vad_state = {"probability": vad[0], "timestamp": 1e12, "available": vad[1]}

    controls = dict(CONTROLS, topology=dict(CONTROLS["topology"],
                                            suppressor_enabled=suppressor_on))
    rcfg = ref.chain_config(controls, controls["topology"]["deesser_enabled"])
    flat = p._params_flat.numpy().copy()
    # the engine's control buffer is the reference's own live_params, value for
    # value (the reference builds its values itself)
    assert np.array_equal(flat, _flat(ref_lc.live_params(rcfg, **_kwargs())))
    blocks = len(x)
    probe = {"state": ref_lc.live_init(rcfg, n=1, device="cpu"),
             "supp": ref.supp_init(strength), "entry_applied": 0, "x": x,
             "vad_probability": np.full(blocks, vad[0]), "vad_fresh": np.full(blocks, vad[1]),
             "applied": np.zeros(blocks, int)}

    got, b = [], 0
    with torch.inference_mode():
        for n in bursts:
            state, y, engine, delay = p._process_block(config, params, state, x[b:b + n],
                                                       engine, delay, topo)
            got.append(np.asarray(y, np.float64))
            b += n
    got = np.concatenate(got)
    want, _ = ref.render([probe], controls, {"eq": [], "deesser": []},
                         ref_rnnoise.weights_from_numpy(weights, "cpu"), blocks)
    want = want[0].astype(np.float64)
    assert np.sqrt(np.mean(want ** 2)) > 1e-3, "the compared output is near silence"
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=case)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _flat(tree):
    return np.float32([float(v) for v in _leaves(tree)])


def _kwargs():
    """``live_params``' keywords from the configuration's controls, as the
    engine passes them."""
    keys = ("gate_threshold_db", "gate_attack_ms", "gate_release_ms", "vad_threshold",
            "vad_hold_time_ms", "gate_margin_db", "compressor_threshold_db",
            "compressor_ratio", "compressor_attack_ms", "compressor_release_ms",
            "compressor_makeup_gain_db", "compressor_target_lufs",
            "noise_reference_reliability", "limiter_ceiling_db", "limiter_release_ms")
    return {k: CONTROLS["params"][k] for k in keys}
