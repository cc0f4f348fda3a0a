"""Run one block step over a whole take: a CUDA graph replay per block.

Counterpart of the ``lax.scan`` that the JAX package runs inside one ``jit``
for a take (``runtime/chain.py:342``, ``models/rnnoise.py:890``,
``api.py:681``, ``api.py:752``, ``models/silero.py:411``). :func:`run_take`
advances a state block by block through ``step(state, block) -> (state,
outputs)``:

- On a CUDA device the step, the state's copy-back and the writes of the
  block's outputs into preallocated rows are captured once as a
  ``torch.cuda.CUDAGraph``; each block is one replay. The graph reads the
  block's inputs from the take's tensors at a device-side block index that it
  advances itself, so a replay needs nothing from the host.
- On the CPU the same step runs eagerly, block after block.

The capture follows the rules the serving engine keeps
(``ServingEngine._capture``): an eager warm-up on a copy of the state, on the
capture stream, first creates what the step sets up lazily; no device tensor
may be built from host data inside the step (cache it per device instead);
the kernel launches the capture recorded are added to
``kernels.launch_counts`` on every replay, the warm-up's and the capture's own
are not counted; a failed capture raises, there is no eager path on the card.
"""

from __future__ import annotations

import time

import torch

from .. import kernels

__all__ = ["clone_tree", "leaf_pairs", "copy_into", "TakeReplay", "run_take"]


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def leaf_pairs(dst, src, out):
    """``(dst, src)`` leaves of two trees of one layout, by ``dst``'s keys,
    where ``src`` is not ``dst`` itself."""
    for k, d in dst.items():
        if isinstance(d, dict):
            leaf_pairs(d, src[k], out)
        elif src[k] is not d:
            out.append((d, src[k]))
    return out


def copy_into(dst, src) -> None:
    """Copy tree ``src`` into the tensors of tree ``dst``. A source that
    shares memory with a written destination is cloned first, so that no
    copy reads what another one wrote."""
    pairs = leaf_pairs(dst, src, [])
    if not pairs:
        return
    written = {d.untyped_storage().data_ptr() for d, _ in pairs}
    torch._foreach_copy_(
        [d for d, _ in pairs],
        [s.clone() if s.untyped_storage().data_ptr() in written else s
         for _, s in pairs])


class TakeReplay:
    """A step captured over static state, inputs and output rows.

    ``inputs`` maps names to tensors whose first axis is the block axis
    (views are fine; a block is gathered by index). ``step(state, block)``
    takes the state tree and a dict of the block's inputs and returns the new
    state and a dict of output tensors; output ``k`` of block ``b`` lands in
    ``rows[k][b]``."""

    def __init__(self, step, state, inputs: dict, n_blocks: int):
        self.step, self.inputs, self.n_blocks = step, inputs, n_blocks
        self.state = state
        self.rows: dict = {}
        self.graph = None
        self.capture_seconds = 0.0
        self.graph_launches: dict = {}

    def _store(self, out: dict, idx) -> None:
        for k, o in out.items():
            if k not in self.rows:
                self.rows[k] = torch.empty((self.n_blocks,) + tuple(o.shape),
                                           dtype=o.dtype, device=o.device)
            self.rows[k].index_copy_(0, idx, o.unsqueeze(0))

    def _body(self, state, idx) -> None:
        block = {k: v.index_select(0, idx).squeeze(0) for k, v in self.inputs.items()}
        new_state, out = self.step(state, block)
        copy_into(state, new_state)
        self._store(out, idx)
        idx.add_(1)

    def capture(self) -> None:
        device = next(iter(self.inputs.values())).device
        with torch.cuda.device(device):
            counts = dict(kernels.launch_counts)
            self._idx = torch.zeros(1, dtype=torch.long, device=device)
            self.state = clone_tree(self.state)  # the static state buffers
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                self._body(clone_tree(self.state), self._idx)
            torch.cuda.current_stream(device).wait_stream(stream)
            before = dict(kernels.launch_counts)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self._body(self.state, self._idx)
            graph.instantiate()
            self.capture_seconds = time.perf_counter() - t0
            self.graph_launches = {k: v - before[k]
                                   for k, v in kernels.launch_counts.items()
                                   if v > before[k]}
            kernels.launch_counts.update(counts)
            self._idx.zero_()
            self._replays = 0
            self.graph = graph

    def replay(self) -> None:
        """Run the next block (at most ``n_blocks`` replays: the graph reads
        the block at its own index)."""
        if self._replays >= self.n_blocks:
            raise RuntimeError(f"the take has {self.n_blocks} blocks; all were replayed")
        self._replays += 1
        self.graph.replay()
        for name, k in self.graph_launches.items():
            kernels.launch_counts[name] += k

    def run(self):
        """Run every block. Returns ``(final_state, rows)``."""
        if self.n_blocks == 0:
            return self.state, {}
        if next(iter(self.inputs.values())).device.type != "cuda":
            for b in range(self.n_blocks):
                self.state, out = self.step(self.state,
                                            {k: v[b] for k, v in self.inputs.items()})
                self._store(out, torch.tensor([b]))
            return self.state, self.rows
        if self.graph is None:
            self.capture()
        for _ in range(self.n_blocks):
            self.replay()
        return self.state, self.rows


def run_take(step, state, inputs: dict, n_blocks: int):
    """Advance ``state`` by ``n_blocks`` blocks of ``inputs`` (block axis
    first) through ``step``: one graph replay a block on the card, the step
    eagerly on the CPU. Returns ``(final_state, rows)`` with ``rows[k]`` of
    shape ``[n_blocks, ...]``."""
    return TakeReplay(step, state, inputs, n_blocks).run()
