"""Convert the reference package's trees (as numpy arrays) to this port's.

The JAX package and this port hold the same state and controls with a few
differences of layout:

- biquad state (EQ lanes, K-weighting, the 80 Hz high-pass, the owned
  adaptive high-pass, the hum and harmonic notches, the RNNoise input
  high-pass) is f64 here, f32 there;
- the EQ is one cascade here and two precision groups (``lo``, ``hi``) there;
- the owned adaptive high-pass is a one-section cascade here, so its leaves
  carry a section axis (``[N, 1, ...]``).

The VAD group (``vad``) and the DeepFilterNet3 model states have the same
leaves in both packages. :func:`rnnoise_weights`, :func:`silero_weights` and
:func:`dfn_weights` validate a model's weight arrays and make them tensors.

:func:`serving_state`, :func:`routing_state`, :func:`chain_state` and
:func:`chain_params` map numpy trees (for example
``jax.tree_util.tree_map(np.asarray, tree)``) to tensors; :func:`to_numpy`
(serving and offline chain states) and :func:`routing_to_numpy` map a port
state back. Every leaf round-trips; integer counters and flags keep their
dtype.

The single-stream engine's states: :func:`live_state` (the reference's live
chain state of one stream, no batch axis) becomes the port's ``n=1`` state;
:func:`rnnoise_processor_state`, :func:`dfn_processor_state` and
:func:`vad_stream_state` map the reference's processor and streaming VAD
dicts (host fields as they are, the model state with a stream axis, the
Silero LSTM state ``[2, 1, 128]`` as ``[1, 2, 128]``). :func:`to_numpy`
maps each back, given the reference dict as its template.

The offline chain (``runtime/chain.py``) holds its streams on one axis where
the reference keeps any batch shape, and its static EQ as one ``(S, 5)``
cascade ``c`` with ``z [N, S, 2]`` (f64) where the reference keeps
``c_lo``/``c_hi`` and ``z_lo``/``z_hi [k, ..., 2]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .models import dfn3, rnnoise, silero

__all__ = ["rnnoise_weights", "silero_weights", "dfn_weights", "chain_params", "serving_state",
           "routing_state", "chain_state", "to_numpy", "routing_to_numpy", "live_state",
           "rnnoise_processor_state", "dfn_processor_state", "vad_stream_state"]

# (path inside the routing state) -> leaves held in f64 by the port
_ROUTING_F64_LEAVES = (
    ("prefilter_z",),
    ("adaptive_hp", "z"),
    ("hum_notch", "z"),
    ("harmonic_notch", "z"),
)
# (path inside the serving state) -> leaves held in f64 by the port
_F64_LEAVES = (
    ("chain", "compressor", "meter", "kz"),
    ("chain", "out_lufs", "kz"),
    ("chain", "eq", "z"),
    ("supp", "model", "hp_mem"),
)


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def rnnoise_weights(arrays: dict, device="cpu") -> dict:
    """RNNoise weight dict (numpy) -> validated f32 tensors."""
    return rnnoise.weights_from_numpy(arrays, device)


def silero_weights(arrays: dict, device="cpu") -> dict:
    """Silero VAD weight dict (numpy) -> validated f32 tensors."""
    return silero.weights_from_numpy(arrays, device)


def dfn_weights(arrays: dict, device="cpu") -> dict:
    """DeepFilterNet3 weight dict (numpy, either variant) -> validated f32
    tensors."""
    return dfn3.weights_from_numpy(arrays, device)


def _has(tree, path) -> bool:
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return True


def chain_params(tree, device="cpu") -> dict:
    """Stacked live-chain controls (``[N]`` numpy leaves) -> tensors."""
    return _tree_to_torch(tree, device)


def routing_state(tree, device="cpu") -> dict:
    """A reference routing state (numpy leaves, stream axis first) -> the
    port's."""
    out = _tree_to_torch(tree, device)
    out["adaptive_hp"] = {k: v.unsqueeze(1).contiguous()
                          for k, v in out["adaptive_hp"].items()}
    for path in _ROUTING_F64_LEAVES:
        _set(out, path, _get(out, path).to(torch.float64))
    return out


def serving_state(tree, device="cpu") -> dict:
    """A reference serving state (numpy leaves, stream axis first) -> the
    port's serving state."""
    out = _tree_to_torch(tree, device)
    chain = out["chain"]
    chain["routing"] = routing_state(tree["chain"]["routing"], device)
    eq = chain["eq"]
    chain["eq"] = {k: torch.cat([eq["lo"][k], eq["hi"][k]], dim=1).contiguous()
                   for k in eq["lo"]}
    for path in _F64_LEAVES:
        if _has(out, path):
            _set(out, path, _get(out, path).to(torch.float64))
    return out


# offline chain leaves shared by every stream (no batch axis)
_CHAIN_SHARED = (("compressor", "meter", "coeffs"),)
_CHAIN_F64 = (("compressor", "meter", "kz"),)


def _chain_batch_shape(tree) -> tuple:
    return tuple(np.shape(tree["compressor"]["current_gr_db"]))


def _map_leaves(tree, fn, path=()):
    return {k: _map_leaves(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def chain_state(tree, device="cpu") -> dict:
    """A reference offline chain state (numpy leaves, any batch shape) -> the
    port's (one stream axis, one EQ cascade)."""
    batch = _chain_batch_shape(tree)
    nb, n = len(batch), math.prod(batch)

    def leaf(path, v):
        a = np.asarray(v)
        if path not in _CHAIN_SHARED:
            a = a.reshape((n,) + a.shape[nb:])
        t = torch.as_tensor(np.array(a), device=device)
        return t.to(torch.float64) if path in _CHAIN_F64 else t

    out = _map_leaves({k: v for k, v in tree.items() if k != "eq"}, leaf)
    eq = tree["eq"]
    z = [np.moveaxis(np.asarray(eq[k]), 0, -2).reshape(n, -1, 2) for k in ("z_lo", "z_hi")]
    out["eq"] = {
        "c": torch.as_tensor(np.concatenate([np.asarray(eq["c_lo"]), np.asarray(eq["c_hi"])],
                                            axis=0).astype(np.float32), device=device),
        "z": torch.as_tensor(np.concatenate(z, axis=1), dtype=torch.float64, device=device),
    }
    return out


def _chain_to_numpy(state, template) -> dict:
    batch = _chain_batch_shape(template)
    out = _tree_to_numpy({k: v for k, v in state.items() if k != "eq"})
    out = _map_leaves(out, lambda path, a: a if path in _CHAIN_SHARED
                      else a.reshape(batch + a.shape[1:]))
    k_lo = np.shape(template["eq"]["c_lo"])[0]
    c = state["eq"]["c"].detach().cpu().numpy()
    z = state["eq"]["z"].detach().cpu().numpy().astype(np.float32)
    z = np.moveaxis(z.reshape(batch + z.shape[1:]), -2, 0)
    out["eq"] = {"c_lo": c[:k_lo], "c_hi": c[k_lo:], "z_lo": z[:k_lo], "z_hi": z[k_lo:]}
    return out


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    a = tree.detach().cpu().numpy()
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _routing_layout(routing: dict) -> dict:
    """Drop the owned high-pass's section axis (numpy leaves)."""
    return dict(routing, adaptive_hp={k: v[:, 0]
                                      for k, v in routing["adaptive_hp"].items()})


def routing_to_numpy(state) -> dict:
    """A port routing state -> the reference layout (numpy)."""
    return _routing_layout(_tree_to_numpy(state))


# (path inside a live chain state) -> leaves every stream shares
_LIVE_SHARED = (("meter_coeff",), ("out_lufs", "coeffs"), ("compressor", "meter", "coeffs"))


def _with_stream_axis(tree, shared=()):
    return _map_leaves(tree, lambda path, v: np.asarray(v) if path in shared
                       else np.asarray(v)[None])


def _without_stream_axis(tree, shared=()):
    return _map_leaves(tree, lambda path, v: v if path in shared else v[0])


def live_state(tree, device="cpu") -> dict:
    """A reference live chain state of one stream (numpy leaves, no batch
    axis) -> the port's ``n=1`` state."""
    return serving_state({"chain": _with_stream_axis(tree, _LIVE_SHARED)}, device)["chain"]


def _host_fields(proc, skip):
    return {k: (np.array(v, np.float32) if isinstance(v, np.ndarray) else v)
            for k, v in proc.items() if k not in skip}


def rnnoise_processor_state(proc, device="cpu") -> dict:
    """A reference RNNoise processor dict (numpy) -> the port's."""
    out = _host_fields(proc, ("params", "model"))
    out["params"] = rnnoise_weights(proc["params"], device)
    model = _tree_to_torch(_with_stream_axis(proc["model"]), device)
    model["hp_mem"] = model["hp_mem"].to(torch.float64)
    out.update(model=model, replay=None)
    return out


def dfn_processor_state(proc, device="cpu") -> dict:
    """A reference DeepFilterNet3 processor dict (numpy) -> the port's."""
    out = _host_fields(proc, ("params", "model"))
    out["params"] = dfn_weights(proc["params"], device)
    out.update(model=_tree_to_torch(_with_stream_axis(proc["model"]), device),
               replay=None)
    return out


def vad_stream_state(state, device="cpu") -> dict:
    """A reference streaming VAD dict (numpy) -> the port's."""
    lstm = np.asarray(state["lstm_state"], np.float32)  # [2, 1, 128]
    model = {
        "context": np.asarray(state["context"], np.float32)[None],
        "lstm": np.ascontiguousarray(np.moveaxis(lstm, 1, 0)),
        "dec3": {"hist": np.asarray(state["dec3"]["hist"], np.float32)[None]},
        "smoothed": np.full(1, state["smoothed_prob"], np.float32),
        "seen": np.full(1, 1 if state["has_inference"] else 0, np.int32),
    }
    return {
        "params": silero_weights(state["params"], device),
        "config": dict(state["config"]),
        "buffer": np.array(state["buffer"], np.float32),
        "model": _tree_to_torch(model, device),
        "smoothed_prob": float(state["smoothed_prob"]),
        "has_inference": bool(state["has_inference"]),
        "replay": None,
    }


def _weights_to_numpy(params) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _processor_to_numpy(proc) -> dict:
    out = {k: v for k, v in proc.items() if k not in ("params", "model", "replay")}
    out["params"] = _weights_to_numpy(proc["params"])
    out["model"] = _without_stream_axis(_tree_to_numpy(proc["model"]))
    return out


def _vad_stream_to_numpy(state) -> dict:
    m = _tree_to_numpy(state["model"])
    return {
        "params": _weights_to_numpy(state["params"]),
        "config": dict(state["config"]),
        "buffer": np.array(state["buffer"], np.float32),
        "context": m["context"][0],
        "lstm_state": np.ascontiguousarray(np.moveaxis(m["lstm"], 0, 1)),
        "dec3": {"hist": m["dec3"]["hist"][0]},
        "smoothed_prob": float(state["smoothed_prob"]),
        "has_inference": bool(state["has_inference"]),
    }


def to_numpy(state, template) -> dict:
    """A port state -> the reference layout (numpy). ``template`` is a
    reference state of the same kind (numpy): a serving, offline chain or
    live chain state (it supplies the EQ group split and the batch shape),
    an RNNoise or DeepFilterNet3 processor dict, or a streaming VAD dict."""
    if "tp_detector" in template:
        return _chain_to_numpy(state, template)
    if "lstm_state" in template:
        return _vad_stream_to_numpy(state)
    if "in_buf" in template:
        return _processor_to_numpy(state)
    if "meter_coeff" in template:
        chain = to_numpy({"chain": state},
                         {"chain": _with_stream_axis(template, _LIVE_SHARED)})["chain"]
        return _without_stream_axis(chain, _LIVE_SHARED)
    out = _tree_to_numpy(state)
    chain = out["chain"]
    n_lo = np.shape(template["chain"]["eq"]["lo"]["z"])[1]
    eq = chain["eq"]
    chain["eq"] = {"lo": {k: v[:, :n_lo] for k, v in eq.items()},
                   "hi": {k: v[:, n_lo:] for k, v in eq.items()}}
    chain["routing"] = _routing_layout(chain["routing"])
    return out
