"""One step of the full chain and of the serving engine over a fleet.

Counterpart of the JAX package's ``dryrun_multichip`` (``__graft_entry__``):
the batched offline chain sharded two streams a shard with a corpus
reduction gathered on the first device, then the serving engine at the
production configuration sharded over the same devices, one step each.
"""

from __future__ import annotations

import numpy as np

from .fleet import device_scope, fleet_mesh, gather_batched_tree, shard_batched_tree

__all__ = ["DRYRUN_EQ_GAINS_DB", "dryrun_chain_config", "dryrun_audio", "corpus_reductions",
           "dryrun_multichip"]

# active bands, so that the compacted EQ cascade carries real per-stream state
DRYRUN_EQ_GAINS_DB = (-2.0, 1.0, -1.0, 2.0, 3.0, 2.0, 1.0, -2.0, 1.0, -1.0)
_N_BLOCKS = 2


def dryrun_chain_config():
    """The dry run's offline chain: de-esser, EQ, adaptive compressor with
    auto makeup and sidechain high-pass, both limiters. Returns
    ``(config, compressor params, eq bands)``."""
    from ..ops import compressor as comp_ops
    from ..ops import deesser as des_ops
    from ..ops import eq as eq_ops
    from ..runtime import chain as chain_rt

    fs, block = 48000.0, 480
    cfg = chain_rt.ChainConfig(
        sample_rate=fs, deesser_enabled=True, eq_enabled=True, compressor_enabled=True,
        limiter_enabled=True, deesser=des_ops.DeEsserConfig(sample_rate=fs, enabled=True),
        compressor=comp_ops.CompressorConfig(
            sample_rate=fs, enabled=True, adaptive_release=True, auto_makeup_enabled=True,
            sidechain_highpass_enabled=True, block_samples=block))
    bands = [eq_ops.EqBandConfig(b.filter_type, b.frequency_hz, g, 4.33,
                                 b.slope_db_per_octave, True)
             for b, g in zip(eq_ops.default_bands(), DRYRUN_EQ_GAINS_DB)]
    return cfg, comp_ops.compressor_params(cfg.compressor), bands


def dryrun_audio(n_streams: int) -> np.ndarray:
    """The dry run's input ``[n_streams, 2, 480]``, from seed 0."""
    return (np.random.default_rng(0).standard_normal((n_streams, _N_BLOCKS, 480))
            .astype(np.float32) * 0.1)


def corpus_reductions(stats) -> dict:
    """The corpus aggregates over a fleet's stats: mean compressor gain
    reduction, max output true peak, summed true-peak limiter events."""
    return {"mean_gr_db": stats["compressor_gain_reduction_db"].mean(),
            "max_true_peak": stats["output_true_peak"].max(),
            "limited_events": stats["true_peak_limited_events"].sum()}


def dryrun_multichip(n_devices: int, *, devices=None) -> dict:
    """Run the full batched chain over a fleet of ``n_devices`` shards (the
    first ``n_devices`` CUDA devices, or of ``devices``: ``["cuda:0"] * 2``
    runs two shards on one card, ``["cpu"] * 2`` on the CPU), two streams a
    shard, one take of two blocks, with the corpus reductions gathered on the
    first device; then the serving engine at the production configuration
    (RNNoise, de-esser, VAD-assisted gate with auto threshold, in-step VAD)
    sharded over the same devices, one stream a shard, one step. Prints two
    "OK" lines and raises where a result is not finite; returns the corpus
    values as floats."""
    from ..ops import gate as gate_ops
    from ..runtime import chain as chain_rt
    from ..runtime import live_chain as lc
    from ..runtime.serving import ServingConfig, ServingEngine

    mesh = fleet_mesh(n_devices, devices=devices)
    batch = 2 * mesh.size  # two streams a shard
    cfg, params, bands = dryrun_chain_config()
    audio = dryrun_audio(batch)
    # the stream axis is axis 0 of the take (its block axis may be as long)
    shards = shard_batched_tree(audio, np.zeros(audio.shape[1:], np.float32), mesh, axis=0)
    results = []
    for dev, blocks in zip(mesh.devices, shards):
        with device_scope(dev):
            state = chain_rt.chain_init(cfg, params, eq_bands=bands,
                                        batch_shape=(blocks.shape[0],), device=dev)
            _, _, stats = chain_rt.chain_run(cfg, params, state, blocks, return_audio=False)
            results.append(stats)
    ref = {k: np.zeros(v.shape[1:]) for k, v in results[0].items()}
    stats = gather_batched_tree(results, ref, mesh.devices[0], axis=0)
    corpus = {k: float(v) for k, v in corpus_reductions(stats).items()}
    if not (np.isfinite(corpus["mean_gr_db"]) and np.isfinite(corpus["max_true_peak"])):
        raise RuntimeError(f"dryrun_multichip: non-finite corpus values {corpus}")
    print(f"dryrun_multichip({n_devices}) OK: mean_gr={corpus['mean_gr_db']:.3f} dB, "
          f"max_tp={corpus['max_true_peak']:.4f}, "
          f"devices={[str(d) for d in mesh.devices]}", flush=True)

    eng = ServingEngine(
        ServingConfig(capacity=mesh.size, suppressor_model="rnnoise", vad_enabled=True,
                      chain=lc.LiveChainConfig(deesser_enabled=True,
                                               gate_mode=gate_ops.VAD_ASSISTED,
                                               auto_threshold_enabled=True)),
        sharding=mesh)
    for _ in range(mesh.size):
        eng.attach()
    metrics = eng.step()
    rms = metrics["output_rms_db"].cpu().numpy()
    if not np.all(np.isfinite(rms)):
        raise RuntimeError(f"dryrun_multichip: non-finite serving output RMS {rms}")
    print(f"serving dryrun OK: {eng.occupancy} streams (rnnoise + de-esser + in-step VAD) "
          f"sharded over {mesh.size} devices", flush=True)
    return corpus
