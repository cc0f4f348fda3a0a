"""The live engine's burst, plain: what ``AudioProcessor._process_block``
renders for one stream's burst of ``k`` blocks of 480 samples, from a given
state, in plain torch on the CPU (float32 audio and weights, float64 biquad
and cleanup state, TF32 off). Nothing here imports the program or launches
a kernel.

A burst:

1. :func:`~.live_chain.front_block` on each block in turn, every block with
   the same VAD snapshot (the worker's probability and whether it is fresh);
2. the RNNoise engine's FIFO (:func:`suppress`): the burst pushed, each
   whole 480-sample frame through the soft clip and PCM scaling and
   ``rnnoise_frame``, the wet frame mixed with the dry path one frame late
   at the strength's 15 ms EMA (a step a frame), the mix popped, a
   non-finite sample scrubbed to 0;
3. :func:`~.live_chain.back_block` on each block, with the auto makeup's
   evidence: the VAD snapshot for every block and the front half's noise
   floor and its reliability of that block.

Departures from ``_process_block``: the suppressor's starvation reset and
its soft reset after three non-finite frames in 2 s are not modelled (a
burst is whole frames, so the FIFO never starves, and the check's audio is
finite); no metric is published; the halves run eagerly where the program
replays their graphs; the controls arrive as the configuration's settings,
from which this module builds the chain's topology (:func:`chain_config`),
its control values (:func:`control_values`) and the EQ bands the UI set
(:func:`eq_coefficients`).

:func:`render` renders the probes of the benchmark's check, each a run of
bursts from a recorded entry state with the UI's control changes applied
between bursts as the engine applies them, all probes as the streams of
one batch (the chain's loops run sample by sample, so a block costs the
same whatever the batch).
"""

from __future__ import annotations

import inspect
from dataclasses import replace

import numpy as np
import torch

from ..models import rnnoise
from ..ops import deesser as des_ops
from ..ops import eq as eq_ops
from ..ops import gate as gate_ops
from . import live_chain as lc

BLOCK = lc.BLOCK_SAMPLES
FRAME = rnnoise.FRAME_SIZE
SAMPLE_RATE = 48000.0
# the suppressor's strength follows its target with a 15 ms EMA, a step a frame
STRENGTH_COEFF = float(1.0 - np.exp(-(FRAME / SAMPLE_RATE / 0.015)))


def no_tf32() -> None:
    """Float32 products stay float32 on a card too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- the controls
def chain_config(controls: dict, deesser_enabled: bool) -> lc.LiveChainConfig:
    """The chain's topology from a configuration's ``controls`` (its
    ``topology`` and ``deesser`` groups, as the engine keeps them), with the
    de-esser on or off. The de-esser's attack and release are fixed inside
    its detector, so they are not part of its configuration."""
    topo, dee = controls["topology"], controls["deesser"]
    dee_cfg = des_ops.DeEsserConfig(
        sample_rate=SAMPLE_RATE, enabled=bool(deesser_enabled),
        **{k: v for k, v in dee.items() if k not in ("attack_ms", "release_ms")})
    return lc.LiveChainConfig(
        sample_rate=SAMPLE_RATE, cleanup_mode=topo["cleanup_mode"],
        gate_enabled=topo["gate_enabled"], gate_mode=getattr(gate_ops, topo["gate_mode"]),
        auto_threshold_enabled=topo["auto_threshold_enabled"],
        deesser_enabled=bool(deesser_enabled), eq_enabled=topo["eq_enabled"],
        compressor_enabled=topo["compressor_enabled"],
        adaptive_release=topo["adaptive_release"],
        auto_makeup_enabled=topo["auto_makeup_enabled"],
        sidechain_highpass_enabled=topo["sidechain_highpass_enabled"],
        limiter_enabled=topo["limiter_enabled"],
        careful_output_enabled=topo["careful_output_enabled"], deesser=dee_cfg)


def control_values(config: lc.LiveChainConfig, controls: dict, n: int) -> dict:
    """The chain's control values from a configuration's ``params``:
    :func:`~.live_chain.live_params` of those it takes, each leaf as an
    ``[n]`` float32 tensor."""
    keys = set(inspect.signature(lc.live_params).parameters) - {"config"}
    tree = lc.live_params(config, **{k: v for k, v in controls["params"].items() if k in keys})

    def leaves(node):
        if isinstance(node, dict):
            return {k: leaves(v) for k, v in node.items()}
        return torch.full((n,), float(node), dtype=torch.float32)
    return leaves(tree)


def bands_after(edits: list, n: int) -> list:
    """The EQ's bands after the first ``n`` of ``edits`` (``(band, gain_db)``
    pairs) on the engine's default bands."""
    bands = eq_ops.default_bands()
    for band, gain in edits[:n]:
        bands[band] = replace(bands[band], gain_db=float(gain))
    return bands


def _designs(bands) -> torch.Tensor:
    layout = eq_ops.eq_layout(bands)
    rows = [eq_ops.band_section_design(b, SAMPLE_RATE)[:cap] for b, cap in zip(bands, layout)]
    return torch.as_tensor(np.concatenate(rows).astype(np.float32))


def eq_coefficients(eq_state: dict, before: list, now: list) -> dict:
    """``eq_state`` with its coefficients replaced by this package's designs
    of the bands ``now``: the target lane always, the active lane too
    except in a section still crossfading, whose active lane holds the
    bands ``before`` the last edit. The filter state and the crossfade's
    counters stay."""
    old, new = _designs(before), _designs(now)
    fading = (eq_state["fade_remaining"] > 0)[..., None]
    active = torch.where(fading, old, new)
    return dict(eq_state, coeffs=torch.stack([active, new.expand_as(active)], dim=2))


# -------------------------------------------------------------- the render
def supp_init(strength: float = 1.0) -> dict:
    """The RNNoise engine's FIFO of one stream, fresh."""
    return {"model": rnnoise.rnnoise_state_init(n=1, device="cpu"),
            "strength": float(strength), "smoothed_strength": 1.0,
            "dry_delay": np.zeros(FRAME, np.float32), "in_buf": np.zeros(0, np.float32),
            "out_buf": np.zeros(0, np.float32)}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def _stack(trees: list, shared=frozenset(), path=()) -> dict:
    """Streams' trees of one layout as one tree, the stream axis first;
    the leaves at ``shared`` paths (no stream axis) from the first."""
    out = {}
    for k, v in trees[0].items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _stack([t[k] for t in trees], shared, p)
        else:
            out[k] = v if p in shared else torch.cat([torch.as_tensor(t[k]) for t in trees])
    return out


def _where(mask: torch.Tensor, a: dict, b: dict) -> dict:
    """Tree ``a`` where ``mask [N]`` is set, else tree ``b``."""
    return {k: _where(mask, v, b[k]) if isinstance(v, dict)
            else torch.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), v, b[k])
            for k, v in a.items()}


def _suppress(weights: dict, supp: dict, frame: torch.Tensor) -> tuple:
    """One block of every stream ``[N, 480]`` through the RNNoise engine's
    FIFO, a frame each: the model on the soft-clipped PCM-scaled frame, the
    wet frame mixed with the stream's previous frame at the smoothed
    strength (a float64 EMA, the mix in float32), a non-finite sample
    scrubbed to 0."""
    scaled = torch.clamp(rnnoise.soft_clip(frame) * rnnoise.PCM_SCALE,
                         -rnnoise.PCM_MODEL_LIMIT, rnnoise.PCM_MODEL_LIMIT)
    model, wet, _ = rnnoise.rnnoise_frame(weights, supp["model"], scaled)
    sm = supp["strength"] * STRENGTH_COEFF + supp["smoothed"] * (1.0 - STRENGTH_COEFF)
    mixed = (wet / rnnoise.PCM_SCALE * sm.to(torch.float32)[:, None]
             + supp["dry"] * (1.0 - sm).to(torch.float32)[:, None])
    supp = dict(supp, model=model, smoothed=sm, dry=frame)
    return supp, torch.where(torch.isfinite(mixed), mixed, 0.0)


def _row(state: dict, i: int, shared=frozenset(), path=()) -> dict:
    """Stream ``i``'s slice of a stacked state tree (``[1, ...]`` leaves),
    as host arrays; the leaves at ``shared`` paths left out."""
    out = {}
    for k, v in state.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _row(v, i, shared, p)
        elif p not in shared:
            out[k] = v[i:i + 1].detach().cpu().numpy().copy()
    return out


def render(probes: list, controls: dict, schedule: dict, weights: dict, blocks: int) -> tuple:
    """Each probe's first ``blocks`` blocks from its entry state, the probes
    as the streams of one batch. A probe holds ``state`` (the chain state,
    ``[1]`` tensors or arrays), ``supp`` (the FIFO of :func:`supp_init`, its
    ``strength`` the configuration's), ``entry_applied`` (how many of the
    UI's control changes the engine had applied at entry), and per block ``x
    [B, 480]``, ``vad_probability [B]`` and ``vad_fresh [B]`` (the snapshot
    its burst used) and ``applied [B]``, and may hold ``end``: render it
    ``end`` blocks (``B`` at least that, ``end`` at least ``blocks``) and
    return its chain state after them. ``schedule``: the UI's changes in
    order, ``eq`` a ``(band, gain_db)`` each and ``deesser`` the de-esser's
    state after each. The control values are the configuration's
    (:func:`control_values`). With ``controls``' suppressor off its latency
    is a one-frame delay, empty at entry.

    The engine renders a burst of ``k`` blocks half by half (k front blocks,
    the FIFO's k frames, k back blocks); this goes block by block, front,
    FIFO and back, which is the same: the front half, the FIFO and the back
    half keep states of their own. A control change applies before the
    first block of the burst that applied it, as the engine applies it
    between bursts: a de-esser toggle resets the de-esser's state, an EQ
    edit crossfades its band. Streams with the de-esser off skip it (the
    batch runs it and keeps their input and state). Returns ``(y [P, blocks
    * 480] float32, [each probe's chain state after its end as host arrays,
    or None]``), the state without the leaves the streams share."""
    no_tf32()
    n = len(probes)
    ends = [p.get("end") for p in probes]
    total = max([blocks] + [e for e in ends if e is not None])
    eq_edits, deesser = schedule["eq"], schedule["deesser"]
    initial = bool(controls["topology"]["deesser_enabled"])
    on_after = lambda g: deesser[g - 1] if g else initial  # noqa: E731
    cfg_on, cfg_off = chain_config(controls, True), chain_config(controls, False)
    params = control_values(cfg_off, controls, n)
    cur = torch.tensor([int(p["entry_applied"]) for p in probes])
    entry = []
    for p, g in zip(probes, cur.tolist()):
        st = _tensors(p["state"])
        st["eq"] = eq_coefficients(st["eq"], bands_after(eq_edits, max(g - 1, 0)),
                                   bands_after(eq_edits, g))
        entry.append(st)
    shared = frozenset(lc.SHARED_LEAVES)
    state = _stack(entry, shared)
    on = torch.tensor([on_after(g) for g in cur.tolist()])
    suppressor = bool(controls["topology"]["suppressor_enabled"])
    supp = None
    if suppressor:
        for p in probes:
            if p["supp"]["in_buf"].size or p["supp"]["out_buf"].size:
                raise ValueError("a probe's FIFO holds a part frame at entry")
        supp = {"model": _stack([_tensors(p["supp"]["model"]) for p in probes]),
                "strength": torch.tensor([p["supp"]["strength"] for p in probes],
                                         dtype=torch.float64),
                "smoothed": torch.tensor([p["supp"]["smoothed_strength"] for p in probes],
                                         dtype=torch.float64),
                "dry": torch.as_tensor(np.stack([p["supp"]["dry_delay"] for p in probes]))}
    delay = torch.zeros((n, FRAME))

    def col(key, b):
        # a probe's rows past its own end repeat its last (their output is not kept)
        return torch.as_tensor(np.stack([p[key][min(b, len(p[key]) - 1)] for p in probes]))

    out = torch.empty((n, total, BLOCK))
    after = [None] * n
    with torch.no_grad():
        for b in range(total):
            want = col("applied", b).to(torch.int64)
            while bool((cur < want).any()):
                g = int(cur[cur < want].min())
                mask = (cur == g) & (want > g)
                if deesser[g] != on_after(g):
                    reset = lc.live_init(cfg_on, n=n, device="cpu")["deesser"]
                    state["deesser"] = _where(mask, reset, state["deesser"])
                    on = torch.where(mask, torch.tensor(deesser[g]), on)
                band = eq_edits[g][0]
                now = bands_after(eq_edits, g + 1)
                edited = eq_ops.eq_set_band(state["eq"], band, now[band], SAMPLE_RATE,
                                            layout=eq_ops.eq_layout(now))
                state["eq"] = _where(mask, edited, state["eq"])
                cur = torch.where(mask, g + 1, cur)
            prob = col("vad_probability", b).to(torch.float32)
            fresh = col("vad_fresh", b).to(torch.bool)
            state, y, fm = lc.front_block(cfg_off, params, state, col("x", b).to(torch.float32),
                                          prob, fresh)
            if suppressor:
                supp, y = _suppress(weights, supp, y)
            else:
                y, delay = delay, y
            if bool(on.any()):
                ds, yd, _ = des_ops.deesser_process(cfg_on.deesser_effective, state["deesser"], y)
                y = torch.where(on[:, None], yd, y)
                state = dict(state, deesser=_where(on, ds, state["deesser"]))
            evidence = {"vad_probability": prob, "vad_reliability": fresh.to(torch.float32),
                        "noise_floor_db": fm["noise_floor_db"],
                        "live_noise_reliability": fm["noise_floor_reliability"]}
            state, out[:, b], _ = lc.back_block(cfg_off, params, state, y, evidence)
            for i, e in enumerate(ends):
                if e == b + 1:
                    after[i] = _row(state, i, shared)
    return out[:, :blocks].reshape(n, -1).numpy(), after
