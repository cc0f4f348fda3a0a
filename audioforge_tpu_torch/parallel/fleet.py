"""Fleet sharding: spread streams or candidates over several devices.

Counterpart of ``audioforge_tpu/parallel/fleet.py``. Every candidate of a
calibration sweep and every stream of the serving engine is independent, so
a fleet shards as pure data parallelism: each device runs the same step on
its own contiguous range of the batch and no data crosses devices inside a
step (SURVEY §2.9). Where the JAX package hands GSPMD a sharded array, the
port keeps one tree per shard, each on its shard's device, and gathers the
results itself.

Recipe:

1. ``mesh = fleet_mesh()``: one shard per CUDA device (``fleet_mesh(2)``
   the first two; ``fleet_mesh(devices=["cuda:0"] * 2)`` two shards on one
   card, ``devices=["cpu"] * 4`` four on the CPU).
2. Pad the candidate list to a multiple of the shard count
   (:func:`pad_candidates`): shards are equal.
3. :func:`shard_batched_tree` cuts every batched leaf into one contiguous
   range per shard (the batch axis found by shape against an unbatched
   reference) and copies every shared leaf to each shard's device.
4. Run the ordinary batch function once per shard, each on its device;
   :func:`gather_batched_tree` puts the results back together.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels

__all__ = [
    "CANDIDATE_AXIS",
    "FleetMesh",
    "fleet_mesh",
    "pad_candidates",
    "batch_axis_of",
    "shard_batched_tree",
    "gather_batched_tree",
    "device_scope",
    "mesh_devices",
]

CANDIDATE_AXIS = "candidates"


@dataclass(frozen=True)
class FleetMesh:
    """A 1-D fleet of shards: shard ``k`` runs on ``devices[k]``. A device
    may appear more than once (several shards on one card, or on the
    CPU). ``axis_name`` is kept for the JAX signature; nothing reads it,
    since the port has no named axes or collectives."""

    devices: tuple
    axis_name: str = CANDIDATE_AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a fleet mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(device) -> torch.device:
    """``device`` resolved (a CUDA device raises without a card), a CUDA
    device with its index, so that per-device caches never mix cards."""
    dev = kernels.resolve_device(device, "fleet_mesh")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def fleet_mesh(n_devices: int | None = None, *, devices=None,
               axis_name: str = CANDIDATE_AXIS) -> FleetMesh:
    """A fleet over the first ``n_devices`` of ``devices`` (every CUDA
    device by default; without a card it raises). The one axis is the
    candidate or stream batch axis: pure data parallelism."""
    if devices is None:
        kernels.resolve_device("cuda", "fleet_mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, {len(devices)} available"
            )
        devices = devices[:n_devices]
    return FleetMesh(tuple(devices), axis_name)


def pad_candidates(param_sets: list, n_devices: int) -> tuple[list, int]:
    """Pad a candidate list to a multiple of the device count by repeating
    the last candidate (equal shards per device). Returns
    ``(padded_list, original_count)``."""
    b = len(param_sets)
    if b == 0 or n_devices <= 1:
        return list(param_sets), b
    pad = (-b) % n_devices
    return list(param_sets) + [param_sets[-1]] * pad, b


def batch_axis_of(batched_shape, unbatched_shape) -> int | None:
    """Locate the inserted batch axis: the index whose removal turns
    ``batched_shape`` into ``unbatched_shape``. Returns None when the leaf
    is not batched (shared across candidates). When several indices
    qualify (equal-sized dims) the first is returned — any qualifying axis
    yields a valid, semantics-preserving sharding."""
    found = _batch_axes(batched_shape, unbatched_shape)
    return found[0] if found else None


def _batch_axes(batched_shape, unbatched_shape) -> list:
    """Every index whose removal turns ``batched_shape`` into
    ``unbatched_shape``."""
    b, u = tuple(batched_shape), tuple(unbatched_shape)
    if len(b) != len(u) + 1:
        return []
    return [i for i in range(len(b)) if b[:i] + b[i + 1:] == u]


def device_scope(device: torch.device):
    """The context in which work for ``device`` is issued: its CUDA device
    made current (the kernels launch on the current device's stream), or
    nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def mesh_devices(mesh, device, who: str) -> tuple:
    """The devices of ``mesh`` (a :class:`FleetMesh`, else TypeError),
    resolved; ``device``, when given, must be the mesh's first (else
    ValueError)."""
    if not isinstance(mesh, FleetMesh):
        raise TypeError(f"{who}: the mesh must be a FleetMesh (parallel.fleet_mesh), "
                        f"not {type(mesh).__name__}")
    devices = tuple(kernels.resolve_device(d, who) for d in mesh.devices)
    if device is not None:
        want, first = torch.device(device), devices[0]
        if want.type != first.type or (want.index is not None
                                       and want.index != first.index):
            raise ValueError(f"{who}: device {want} conflicts with the mesh's first "
                             f"device {first}")
    return devices


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _split_axis(shape, ref_shape, axis, what: str) -> int | None:
    """The batch axis of a leaf, or None for a shared leaf. A split decides
    what each shard computes, so where several axes qualify (a batch of 2
    against a 2-element state axis) the caller must name it."""
    found = _batch_axes(shape, ref_shape)
    if axis is not None:
        ax = axis % len(shape) if len(shape) else axis
        return ax if ax in found else None
    if len(found) > 1:
        raise ValueError(
            f"{what}: shape {tuple(shape)} against the unbatched {tuple(ref_shape)} has "
            f"several candidate batch axes {found}; pass axis= to name the one to split")
    return found[0] if found else None


def _map(fn, tree, ref, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], ref[k], path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, r, path + (i,)) for i, (t, r) in
                          enumerate(zip(tree, ref)))
    return fn(tree, ref, path)


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.as_tensor(np.asarray(leaf))


def shard_batched_tree(tree, ref_tree, mesh: FleetMesh, *, axis: int | None = None):
    """One tree per shard of ``mesh``: every batched leaf of ``tree`` cut into
    equal contiguous ranges along its batch axis, range ``k`` on
    ``mesh.devices[k]``, and every shared leaf copied to each shard's
    device. ``ref_tree`` is the unbatched single-candidate counterpart that
    locates each leaf's batch axis by shape; where more than one axis
    qualifies, ``axis`` must name it (else ValueError). Leaves may be
    tensors, numpy arrays or numbers; they come back as tensors."""
    S = mesh.size
    per_leaf = {}

    def cut(leaf, ref, path):
        t = _tensor(leaf)
        ax = _split_axis(t.shape, _shape(ref), axis, "/".join(map(str, path)) or "leaf")
        if ax is None:
            per_leaf[path] = [t.to(dev, copy=True) for dev in mesh.devices]
            return None
        if t.shape[ax] % S:
            raise ValueError(
                f"batch of {t.shape[ax]} along axis {ax} does not split into {S} "
                "equal shards (pad it with pad_candidates)")
        per_leaf[path] = [c.to(dev, copy=True).contiguous() for c, dev in
                          zip(torch.chunk(t, S, dim=ax), mesh.devices)]
        return None

    _map(cut, tree, ref_tree)
    return [_map(lambda leaf, ref, path, k=k: per_leaf[path][k], tree, ref_tree)
            for k in range(S)]


def gather_batched_tree(shards, ref_tree, device, *, axis: int | None = None):
    """The inverse of :func:`shard_batched_tree`: one tree on ``device``, every
    batched leaf the concatenation of the shards' ranges in shard order, every
    shared leaf the first shard's. A shard's batch may match another axis of
    its leaf where the whole batch did not: then ``axis`` must name it, as
    for the split."""
    dev = torch.device(device)
    first = shards[0]

    def join(leaf, ref, path):
        ax = _split_axis(_shape(leaf), _shape(ref), axis, "/".join(map(str, path)) or "leaf")
        parts = [_leaf_at(s, path) for s in shards]
        if ax is None:
            return parts[0].to(dev)
        return torch.cat([p.to(dev) for p in parts], dim=ax)

    return _map(join, first, ref_tree)


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
