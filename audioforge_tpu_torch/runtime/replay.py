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

Every graph of the package is captured by :func:`capture_graph` (the
serving engine's too), so one set of rules holds for all: an eager warm-up on
a copy of the state, on the capture stream, first creates what the step sets
up lazily; no device tensor may be built from host data inside the step
(cache it per device instead); the kernel launches the capture recorded are
added to ``kernels.launch_counts`` on every replay, the warm-up's and the
capture's own are not counted; one capture at a time in the process, on the
calling thread's one capture stream, with ``capture_error_mode=
"thread_local"``; a failed capture raises, there is no eager path on the card.
The tracer counts every capture (``replay.captures``) and every replay
(``replay.replays``), and spans each capture, warm-up included, from the
moment it holds the capture lock (``replay.capture``).

:class:`BlockReplay` is the graph of a live engine: one block step captured
once and replayed for every block while its topology lives, over static
state that the caller keeps (the counterpart of a ``jit`` cache entry). Each
:meth:`BlockReplay.run` stages a burst of input rows with one copy to the
card, replays the graph once per block and brings the burst's output rows
back with one copy.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import kernels
from . import tracing

__all__ = ["clone_tree", "leaf_pairs", "copy_into", "capture_graph", "TakeReplay",
           "run_take", "BlockReplay"]


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


_CAPTURE_LOCK = threading.Lock()
_local = threading.local()


def _capture_stream(dev) -> torch.cuda.Stream:
    """The calling thread's capture stream on ``dev``, one for all its
    captures: cuBLAS keeps a workspace (32 MiB on Hopper) for each handle and
    stream, and a graph keeps the workspace it captured, so a new stream per
    capture would cost a workspace per graph."""
    streams = _local.__dict__.setdefault("streams", {})
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(dev)
    return streams[dev]


def capture_graph(device, body, state):
    """Capture ``body(state)`` on CUDA ``device`` as a graph: first one eager
    ``body`` on a copy of ``state`` (the warm-up), then the capture, both on
    the thread's capture stream inside a recording of its launches, under the
    process-wide capture lock. Returns ``(graph, out, launches, seconds)``:
    what the captured ``body`` returned, the kernel launches of one replay
    and the capture's seconds. Raises when the capture fails."""
    dev = torch.device(device)
    with (_CAPTURE_LOCK, tracing.span("replay.capture"), torch.cuda.device(dev),
          kernels.recording_launches()):
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            body(clone_tree(state))
        torch.cuda.current_stream(dev).wait_stream(stream)
        with kernels.recording_launches() as recorded:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out = body(state)
            graph.instantiate()
            seconds = time.perf_counter() - t0
    tracing.count("replay.captures")
    return graph, out, dict(recorded), seconds


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
        self._idx = torch.zeros(1, dtype=torch.long, device=device)
        self.state = clone_tree(self.state)  # the static state buffers
        graph, _, self.graph_launches, self.capture_seconds = capture_graph(
            device, lambda st: self._body(st, self._idx), self.state)
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
        kernels.add_launches(self.graph_launches)
        tracing.count("replay.replays")

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


class BlockReplay:
    """One block step over static tensors, captured once and replayed.

    ``step(state, block) -> (new_state, out)``: ``block`` maps the names of
    ``inputs`` (name -> per-block shape) to f32 views of one input row;
    ``out`` maps names to the block's output tensors. A block's inputs travel
    as one flat f32 row, its outputs as another (bools and integers as f32,
    exact below 2**24), in the order of the dicts. ``state`` is the caller's
    static state tree: every run updates it in place, on the card and on the
    CPU alike. On the card the graph of the step, the state's copy-back and
    the output row's write is captured at the first :meth:`run` by
    :func:`capture_graph` and each block is one replay that reads its row at a device-side index the graph advances
    itself. A failed capture raises; there is no eager path on the card. On
    the CPU the same step runs eagerly, row by row. An instance counts its
    own captures in ``n_captures`` and their seconds in ``capture_seconds``.
    """

    def __init__(self, step, state, inputs: dict, *, device, k_max: int = 8):
        self.step, self.state, self.k_max = step, state, int(k_max)
        self.device = torch.device(device)
        self._in_layout, self.in_width = self._layout(inputs)
        self._out_layout = None
        self.out_width = None
        self._x = torch.zeros((self.k_max, self.in_width), dtype=torch.float32,
                              device=self.device)
        self._rows = None
        self._idx = None
        self._host_in = self._host_out = None
        self._done = None
        self.graph = None
        self.graph_launches: dict = {}
        self.capture_seconds = 0.0
        self.n_captures = 0

    @staticmethod
    def _layout(spec: dict):
        layout, offset = [], 0
        for name, shape in spec.items():
            shape = tuple(shape)
            numel = int(np.prod(shape, dtype=np.int64))
            layout.append((name, shape, offset, numel))
            offset += numel
        return layout, offset

    def _unpack_in(self, row) -> dict:
        return {name: row[o:o + k].reshape(shape)
                for name, shape, o, k in self._in_layout}

    def _pack_out(self, out: dict) -> torch.Tensor:
        if self._out_layout is None:
            self._out_layout, self.out_width = self._layout(
                {name: tuple(v.shape) for name, v in out.items()})
        return torch.cat([v.reshape(-1).to(torch.float32) for v in out.values()])

    def _body(self, state, idx) -> None:
        row = self._x.index_select(0, idx).squeeze(0)
        new_state, out = self.step(state, self._unpack_in(row))
        packed = self._pack_out(out)  # before the copy-back: out may alias state
        copy_into(state, new_state)
        if self._rows is None:
            self._rows = torch.zeros((self.k_max, self.out_width), dtype=torch.float32,
                                     device=self.device)
        self._rows.index_copy_(0, idx, packed.unsqueeze(0))
        idx.add_(1)

    def capture(self) -> None:
        """Capture the step (see the class); raises when the capture fails."""
        self._idx = torch.zeros(1, dtype=torch.long, device=self.device)
        graph, _, self.graph_launches, seconds = capture_graph(
            self.device, lambda st: self._body(st, self._idx), self.state)
        self.capture_seconds += seconds
        self.n_captures += 1
        self._host_in = torch.empty((self.k_max, self.in_width), dtype=torch.float32,
                                    pin_memory=True)
        self._host_out = torch.empty((self.k_max, self.out_width), dtype=torch.float32,
                                     pin_memory=True)
        self._done = torch.cuda.Event()
        self.graph = graph

    def prepare(self) -> None:
        """Capture now on the card (once), so that the first :meth:`run`
        pays no capture; nothing on the CPU."""
        if self.device.type == "cuda" and self.graph is None:
            self.capture()

    def _run_chunk(self, rows: np.ndarray) -> np.ndarray:
        k = rows.shape[0]
        if self.device.type != "cuda":
            out = []
            for b in range(k):
                block = self._unpack_in(torch.from_numpy(rows[b]).to(self.device))
                new_state, o = self.step(self.state, block)
                out.append(self._pack_out(o))
                copy_into(self.state, new_state)
            return torch.stack(out).cpu().numpy()
        self.prepare()
        self._host_in[:k].numpy()[:] = rows
        self._x[:k].copy_(self._host_in[:k], non_blocking=True)
        self._idx.zero_()
        for _ in range(k):
            self.graph.replay()
        self._host_out[:k].copy_(self._rows[:k], non_blocking=True)
        self._done.record()
        kernels.add_launches({name: n * k for name, n in self.graph_launches.items()})
        tracing.count("replay.replays", k)
        self._done.synchronize()
        return self._host_out[:k].numpy().copy()

    def run(self, rows) -> dict:
        """Advance the state by one block per row of ``rows [k, in_width]``
        (any k: bursts longer than ``k_max`` go in chunks). Returns the
        outputs as host arrays ``name -> [k, *shape]`` (f32)."""
        rows = np.ascontiguousarray(rows, np.float32).reshape(-1, self.in_width)
        if rows.shape[0] == 0:
            raise ValueError("BlockReplay.run needs at least one row")
        chunks = [self._run_chunk(rows[s:s + self.k_max])
                  for s in range(0, rows.shape[0], self.k_max)]
        packed = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        return {name: packed[:, o:o + n].reshape((-1,) + shape)
                for name, shape, o, n in self._out_layout}
