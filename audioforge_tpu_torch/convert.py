"""Convert the reference package's trees (as numpy arrays) to this port's.

The JAX package and this port hold the same state and controls with a few
differences of layout:

- biquad state (EQ lanes, K-weighting, the 80 Hz high-pass, the RNNoise
  input high-pass) is f64 here, f32 there;
- the EQ is one cascade here and two precision groups (``lo``, ``hi``) there;
- the routing state here holds only what the cleanup-off path reads, and
  there is no de-esser state (the de-esser is not ported yet).

:func:`serving_state` and :func:`chain_params` map numpy trees (for example
``jax.tree_util.tree_map(np.asarray, tree)``) to tensors; :func:`to_numpy`
maps a port state back, taking the leaves this port does not carry from a
reference ``template``. Integer counters and flags keep their dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import rnnoise

__all__ = ["rnnoise_weights", "chain_params", "serving_state", "to_numpy"]

_ROUTING_KEYS = ("dc_x1", "dc_y1", "prefilter_z", "hum_line_hz")
# (path inside the serving state) -> leaves held in f64 by the port
_F64_LEAVES = (
    ("chain", "routing", "prefilter_z"),
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


def chain_params(tree, device="cpu") -> dict:
    """Stacked live-chain controls (``[N]`` numpy leaves) -> tensors."""
    return _tree_to_torch(tree, device)


def serving_state(tree, device="cpu") -> dict:
    """A reference serving state (numpy leaves, stream axis first) -> the
    port's serving state."""
    out = _tree_to_torch(tree, device)
    chain = out["chain"]
    chain.pop("deesser", None)
    chain["routing"] = {k: chain["routing"][k] for k in _ROUTING_KEYS}
    eq = chain["eq"]
    chain["eq"] = {k: torch.cat([eq["lo"][k], eq["hi"][k]], dim=1).contiguous()
                   for k in eq["lo"]}
    for path in _F64_LEAVES:
        if path[0] in out:
            _set(out, path, _get(out, path).to(torch.float64))
    return out


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    a = tree.detach().cpu().numpy()
    return a.astype(np.float32) if a.dtype == np.float64 else a


def to_numpy(state, template) -> dict:
    """A port serving state -> the reference layout (numpy). ``template`` is
    a reference serving state (numpy) that supplies the EQ group split and
    the leaves the port does not carry (cleanup routing state, de-esser)."""
    out = _tree_to_numpy(state)
    chain, ref = out["chain"], template["chain"]
    n_lo = np.shape(ref["eq"]["lo"]["z"])[1]
    eq = chain["eq"]
    chain["eq"] = {"lo": {k: v[:, :n_lo] for k, v in eq.items()},
                   "hi": {k: v[:, n_lo:] for k, v in eq.items()}}
    chain["routing"] = {**ref["routing"], **chain["routing"]}
    if "deesser" in ref:
        chain["deesser"] = ref["deesser"]
    return out
