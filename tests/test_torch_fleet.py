"""Fleet sharding of the port (``audioforge_tpu_torch.parallel``, the sharded
``ServingEngine`` and ``simulate_auto_eq_chain_batched(mesh=...)``) on the
CPU, where a fleet is shards on ``cpu``.

- The helpers give the JAX helpers' results on the cases of
  ``tests/test_sharding.py``; shard then gather returns a tree unchanged; an
  axis that more than one dimension could be raises; ``fleet_mesh``'s
  errors are the JAX ones.
- The sharded engine equals the unsharded engine over 3 blocks of 8
  streams, each with its own data: 1e-6 max abs without a suppressor (the
  JAX package's own bound for its sharded engine), 1e-4 RMS / 1e-3 max with
  RNNoise; and the JAX engine sharded over its 8 CPU devices within 1e-4
  RMS / 1e-3 max. The reference is built with ``cleanup_mode=0`` (ROADMAP
  F1: its string "off" runs strong cleanup).
- The sharded sweep pads 5 candidates to 8 over 4 shards: every float within
  1e-5 of the unsharded sweep (``tests/test_sharding.py``'s check), and
  within the cross-package tolerances of ``tests/test_torch_api.py`` of the
  JAX sweep with ``mesh=fleet_mesh()``.
- ``dryrun_multichip(2, devices=["cpu"] * 2)`` gives the corpus values of
  the unsharded chain.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.usefixtures("no_persistent_cache")

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from audioforge_tpu import api as japi
from audioforge_tpu.parallel import fleet as jfleet
from audioforge_tpu.runtime import live_chain as jlc
from audioforge_tpu.runtime import serving as jsv
from audioforge_tpu_torch import api as tapi
from audioforge_tpu_torch.ops import eq as teq
from audioforge_tpu_torch.ops import gate as tgate
from audioforge_tpu_torch.parallel import dryrun as tdry
from audioforge_tpu_torch.parallel import fleet as tfleet
from audioforge_tpu_torch.runtime import chain as tchain
from audioforge_tpu_torch.runtime import live_chain as tlc
from audioforge_tpu_torch.runtime import serving as tsv

BLOCK = tsv.BLOCK
CAPACITY = 8
N_BLOCKS = 3


def _cpu_mesh(n):
    return tfleet.fleet_mesh(devices=["cpu"] * n)


# ------------------------------------------------------------------ helpers

@pytest.mark.parametrize("n_cands,n_devices", [(5, 8), (5, 1), (8, 4), (0, 4), (3, 2)])
def test_pad_candidates_matches_reference(n_cands, n_devices):
    cands = [{"i": i} for i in range(n_cands)]
    assert tfleet.pad_candidates(cands, n_devices) == jfleet.pad_candidates(cands, n_devices)


@pytest.mark.parametrize("batched,unbatched", [
    ((16, 480), (480,)), ((40, 16, 2), (40, 2)), ((16,), ()), ((2, 5), (2, 5)),
    ((3, 4, 5), (9, 9)), ((2, 2, 2), (2, 2))])
def test_batch_axis_of_matches_reference(batched, unbatched):
    assert (tfleet.batch_axis_of(batched, unbatched)
            == jfleet.batch_axis_of(batched, unbatched))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_then_gather_returns_the_tree(n_shards):
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((8, 5)).astype(np.float32),
            "nested": {"z": torch.as_tensor(rng.standard_normal((3, 8, 5))),
                       "shared": torch.arange(6).reshape(2, 3)},
            "scalar": 0.25, "pair": [np.arange(8), 7]}
    ref = {"a": np.zeros(5), "nested": {"z": np.zeros((3, 5)), "shared": np.zeros((2, 3))},
           "scalar": 0.0, "pair": [0, 0]}
    mesh = _cpu_mesh(n_shards)
    shards = tfleet.shard_batched_tree(tree, ref, mesh)
    assert len(shards) == n_shards
    assert shards[-1]["a"].shape == (8 // n_shards, 5)
    assert shards[0]["nested"]["z"].shape == (3, 8 // n_shards, 5)
    assert shards[-1]["nested"]["shared"].shape == (2, 3)
    back = tfleet.gather_batched_tree(shards, ref, "cpu")
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
    assert torch.equal(back["nested"]["z"], tree["nested"]["z"])
    assert torch.equal(back["nested"]["shared"], tree["nested"]["shared"])
    assert float(back["scalar"]) == 0.25
    np.testing.assert_array_equal(back["pair"][0].numpy(), np.arange(8))
    assert int(back["pair"][1]) == 7


def test_ambiguous_axis_raises():
    # a batch of 2 against a 2-element state axis: either axis could be it
    tree, ref = {"z": np.zeros((2, 2, 2))}, {"z": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="several candidate batch axes"):
        tfleet.shard_batched_tree(tree, ref, _cpu_mesh(2))
    shards = tfleet.shard_batched_tree({"z": np.arange(8.0).reshape(2, 2, 2)}, ref,
                                       _cpu_mesh(2), axis=1)
    np.testing.assert_array_equal(shards[1]["z"].numpy(),
                                  np.arange(8.0).reshape(2, 2, 2)[:, 1:])
    # a shard's own batch may collide with another axis where the whole
    # batch did not: the gather then asks for the axis too
    whole = np.arange(16.0).reshape(2, 4, 2)
    shards = tfleet.shard_batched_tree({"z": whole}, ref, _cpu_mesh(2))
    with pytest.raises(ValueError, match="several candidate batch axes"):
        tfleet.gather_batched_tree(shards, ref, "cpu")
    back = tfleet.gather_batched_tree(shards, ref, "cpu", axis=1)
    np.testing.assert_array_equal(back["z"].numpy(), whole)
    with pytest.raises(ValueError, match="equal shards"):
        tfleet.shard_batched_tree({"x": np.zeros((5, 3))}, {"x": np.zeros(3)},
                                  _cpu_mesh(2))


def test_fleet_mesh_errors_match_reference(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tfleet.fleet_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(jax.devices()))
    mesh = tfleet.fleet_mesh()
    assert mesh.axis_name == "candidates" == jfleet.fleet_mesh().axis_names[0]
    assert mesh.size == len(jax.devices())
    assert tfleet.fleet_mesh(4).devices == tuple(torch.device("cuda", i) for i in range(4))
    with pytest.raises(ValueError) as want:
        jfleet.fleet_mesh(10_000)
    with pytest.raises(ValueError) as got:
        tfleet.fleet_mesh(10_000)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="requested 3 devices, 2 available"):
        tfleet.fleet_mesh(3, devices=["cpu"] * 2)


# ----------------------------------------------------------- serving engine

def _stream_audio(n_blocks, seed=7):
    """Each stream its own voiced signal and noise level, [N, n_blocks * 480]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * BLOCK) / 48000.0
    out = []
    for i in range(CAPACITY):
        f0 = 110.0 + 23.0 * i
        voiced = sum(np.sin(2 * np.pi * f0 * h * t + h) / h for h in range(1, 6))
        env = 0.5 + 0.4 * np.sin(2 * np.pi * (2.0 + 0.3 * i) * t)
        out.append(0.2 * env * voiced + (0.002 + 0.002 * i) * rng.standard_normal(t.size))
    return np.asarray(out, np.float32)


def _drive(eng, audio, n_blocks=N_BLOCKS):
    outs = [[] for _ in range(CAPACITY)]
    for i in range(CAPACITY):
        assert eng.attach(sink=lambda b, i=i: outs[i].append(b.copy())) == i
        eng.push(i, audio[i, : n_blocks * BLOCK])
    for _ in range(n_blocks):
        eng.step()
    return np.stack([np.concatenate(o) for o in outs])


def _assert_close(got, ref, rms, peak):
    err = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    assert np.sqrt(np.mean(err ** 2)) <= rms
    assert np.abs(err).max() <= peak


@pytest.fixture(scope="module")
def unsharded_outputs():
    audio = _stream_audio(N_BLOCKS)
    return audio, {model: _drive(tsv.ServingEngine(
        tsv.ServingConfig(capacity=CAPACITY, suppressor_model=model), device="cpu"), audio)
        for model in (None, "rnnoise")}


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("model", [None, "rnnoise"])
def test_sharded_engine_equals_unsharded(unsharded_outputs, n_shards, model,
                                         record_property):
    audio, ref = unsharded_outputs
    eng = tsv.ServingEngine(tsv.ServingConfig(capacity=CAPACITY, suppressor_model=model),
                            sharding=_cpu_mesh(n_shards))
    got = _drive(eng, audio)
    record_property("bit_equal", bool(np.array_equal(got, ref[model])))
    print(f"{n_shards} shards, suppressor {model}: bit-equal "
          f"{np.array_equal(got, ref[model])}")
    if model is None:
        assert np.abs(got - ref[model]).max() <= 1e-6
    else:
        _assert_close(got, ref[model], 1e-4, 1e-3)
    assert np.abs(got).max() > 1e-3
    diag = eng.shard_diagnostics()
    assert diag["shards"] == n_shards and diag["devices"] == ["cpu"] * n_shards
    assert eng.engine_diagnostics()["steps"] == N_BLOCKS
    assert eng.device == torch.device("cpu")


def test_sharded_engine_covers_every_control():
    """Attach, controls, suppressor writes, staged EQ programs, a slot reset,
    the external VAD, ``step_many``, ``step_pipelined`` and the diagnostics,
    on a 2-shard engine and on the unsharded one: the same blocks and
    metrics (1e-6)."""
    cfg = tsv.ServingConfig(capacity=4, suppressor_model=None,
                            chain=tlc.LiveChainConfig(gate_mode=tgate.VAD_ASSISTED))
    audio = _stream_audio(8, seed=11)[:4]
    bands = [teq.EqBandConfig(b.filter_type, b.frequency_hz, g, 1.41,
                              b.slope_db_per_octave, True)
             for b, g in zip(teq.default_bands(), (3, -2, 1, 0, 2, -1, 0, 1, -2, 2))]
    runs = []
    for kw in ({"device": "cpu"}, {"sharding": _cpu_mesh(2)}):
        eng = tsv.ServingEngine(cfg, **kw)
        outs = [[] for _ in range(4)]
        for i in range(4):
            eng.attach(sink=lambda b, i=i: outs[i].append(b.copy()))
            eng.push(i, audio[i])
        eng.set_stream_params(1, compressor_threshold_db=-40.0, limiter_ceiling_db=-6.0)
        eng.set_stream_params(3, gate_threshold_db=-20.0)
        eng.set_stream_eq(2, bands)
        vad = np.array([0.9, 0.1, 0.8, 0.95], np.float32)
        avail = np.array([True, True, False, True])
        metrics = [eng.step(vad, avail)]
        metrics.append(eng.step_many(2, vad, avail))
        eng.detach(3)
        eng.attach(sink=lambda b: outs[3].append(b.copy()))
        eng.push(3, audio[3, 3 * BLOCK:])
        eng.set_stream_eq(0, bands)
        assert eng.step_pipelined() is None
        metrics.append(eng.step_pipelined(vad))
        metrics.append(eng.flush_pipeline())
        diag = [eng.stream_diagnostics(s) for s in range(4)]
        runs.append((np.concatenate([np.concatenate(o) for o in outs]), metrics, diag,
                     dict(eng.engine_diagnostics(), **eng.shard_diagnostics())))
    (y0, m0, d0, e0), (y1, m1, d1, e1) = runs
    assert y0.shape == y1.shape == (4 * 5 * BLOCK,)
    assert np.abs(y0 - y1).max() <= 1e-6
    for a, b in zip(m0, m1):
        assert set(a) == set(b)
        for key in a:
            assert b[key].shape == (4,) and b[key].device == torch.device("cpu")
            np.testing.assert_allclose(b[key].numpy().astype(np.float64),
                                       a[key].numpy().astype(np.float64), atol=1e-6,
                                       err_msg=key)
    assert d0 == d1
    assert e0["steps"] == e1["steps"] == 5 and e1["shards"] == 2


def test_sharding_arguments():
    cfg = tsv.ServingConfig(capacity=4, suppressor_model=None)
    with pytest.raises(ValueError, match="equal shards"):
        tsv.ServingEngine(tsv.ServingConfig(capacity=3, suppressor_model=None),
                          sharding=_cpu_mesh(2))
    with pytest.raises(ValueError, match="conflicts"):
        tsv.ServingEngine(cfg, sharding=_cpu_mesh(2), device="cuda")
    eng = tsv.ServingEngine(cfg, sharding=_cpu_mesh(2), device="cpu")
    assert [(sh.lo, sh.hi) for sh in eng._shards] == [(0, 2), (2, 4)]
    # each shard holds its own copy of the leaves every stream shares
    a, b = (sh._state["chain"]["meter_coeff"] for sh in eng._shards)
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


def test_sharded_engine_matches_jax_sharded_engine():
    """The set-up of ``tests/test_serving.py``'s sharded-engine test: the JAX
    engine sharded over its 8 CPU devices against the port sharded over 4
    CPU shards, 3 blocks of noise."""
    devices = jax.devices()
    assert len(devices) == 8, "conftest forces an 8-device CPU mesh"
    sharding = NamedSharding(Mesh(np.asarray(devices), ("streams",)),
                             PartitionSpec("streams"))
    eng_j = jsv.ServingEngine(jsv.ServingConfig(
        capacity=CAPACITY, suppressor_model=None,
        chain=jlc.LiveChainConfig(deesser_enabled=False, cleanup_mode=0)), sharding=sharding)
    eng_t = tsv.ServingEngine(tsv.ServingConfig(capacity=CAPACITY, suppressor_model=None),
                              sharding=_cpu_mesh(4))
    outs = {e: [[] for _ in range(CAPACITY)] for e in ("j", "t")}
    for i in range(CAPACITY):
        eng_j.attach(sink=lambda b, i=i: outs["j"][i].append(b.copy()))
        eng_t.attach(sink=lambda b, i=i: outs["t"][i].append(b.copy()))
    rng = np.random.default_rng(7)
    for _ in range(N_BLOCKS):
        for i in range(CAPACITY):
            blk = (0.1 * rng.standard_normal(BLOCK)).astype(np.float32)
            eng_j.push(i, blk)
            eng_t.push(i, blk)
        eng_j.step()
        eng_t.step()
    ref = np.stack([np.concatenate(o) for o in outs["j"]])
    got = np.stack([np.concatenate(o) for o in outs["t"]])
    _assert_close(got, ref, 1e-4, 1e-3)
    assert np.abs(ref).max() > 1e-3


# ----------------------------------------------------------- candidate sweep

# the cross-package tolerances of tests/test_torch_api.py
_EXACT = {"true_peak_limited_events", "active_analysis_block_count", "processed_samples",
          "analysis_block_ms", "limiter_effective_ceiling_db", "non_finite_output"}
_LINEAR = {"input_sample_peak", "output_sample_peak", "input_true_peak", "output_true_peak"}


def _sweep_inputs():
    rng = np.random.default_rng(0x5EED)
    fs = 48000.0
    t = np.arange(int(fs * 0.2)) / fs
    speech = (0.15 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 3.0 * t) > 0)
              + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    bands = [(b.frequency_hz, 1.0 if i == 4 else 0.0, 4.33)
             for i, b in enumerate(teq.default_bands())]
    cands = [{"threshold_db": -45.0 + 3.0 * i, "ratio": 2.0 + 0.2 * i,
              "attack_ms": 10.0, "release_ms": 200.0}
             for i in range(5)]  # 5 candidates over 4 shards: pads to 8
    return speech, fs, bands, cands


def test_sharded_sweep_matches_unsharded_and_reference():
    speech, fs, bands, cands = _sweep_inputs()
    plain = tapi.simulate_auto_eq_chain_batched(speech, fs, bands, None, cands,
                                                device="cpu")
    sharded = tapi.simulate_auto_eq_chain_batched(speech, fs, bands, None, cands,
                                                  mesh=_cpu_mesh(4))
    ref = japi.simulate_auto_eq_chain_batched(speech, fs, bands, None, cands,
                                              mesh=jfleet.fleet_mesh())
    assert len(plain) == len(sharded) == len(ref) == 5
    for a, b, r in zip(plain, sharded, ref):
        assert set(a) == set(b) == set(r)
        for k, v in a.items():
            if isinstance(v, float) and not k.endswith("runtime_ms"):
                assert abs(v - float(b[k])) < 1e-5, k
        for k, v in r.items():
            if k.endswith("runtime_ms"):
                continue
            if k in _EXACT:
                assert b[k] == v, k
            elif k in _LINEAR:
                assert abs(b[k] - v) <= 1e-4, k
            else:
                assert abs(b[k] - v) <= 1e-2, k
    # lower thresholds compress more
    assert sharded[0]["compressor_gain_reduction_db"] > sharded[-1]["compressor_gain_reduction_db"]


# ------------------------------------------------------------------ dry run

def test_dryrun_multichip_on_cpu_shards(capsys):
    corpus = tdry.dryrun_multichip(2, devices=["cpu"] * 2)
    out = capsys.readouterr().out
    assert "dryrun_multichip(2) OK" in out and "serving dryrun OK" in out
    cfg, params, bands = tdry.dryrun_chain_config()
    audio = tdry.dryrun_audio(4)
    state = tchain.chain_init(cfg, params, eq_bands=bands, batch_shape=(4,), device="cpu")
    _, _, stats = tchain.chain_run(cfg, params, state, torch.as_tensor(audio),
                                   return_audio=False)
    want = {k: float(v) for k, v in tdry.corpus_reductions(stats).items()}
    assert corpus == want
    assert np.isfinite(corpus["max_true_peak"]) and corpus["max_true_peak"] > 0


def test_dataclass_mesh_is_frozen():
    mesh = _cpu_mesh(2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.devices = ()
    with pytest.raises(ValueError):
        tfleet.FleetMesh(())
