"""Captured step programs: the port's counterpart of ``jax.jit``'s compiled
executable.

The JAX package runs a frame as one compiled program (``step_fused``), and
a batched step likewise. On a card the counterpart is a CUDA graph: the
launches of one call of a function with no host branch, captured once and
replayed with no Python between the kernels. :class:`CapturedStep` holds
such a program with static buffers for its inputs:

- ``fn(state, *args) -> (new_state, *outputs)``: ``state`` is a record of
  tensors (a ``VOState`` without its key), ``args`` more records or tensors
  (the frame, the RANSAC draws). Its first result has the structure of
  ``state``: it is copied back into the state buffers, so the next call can
  take the returned state as it is.
- Each call copies its inputs into the buffers (a buffer handed back as its
  own input is not copied), then, on a CUDA device, replays the graph: the
  first call warms ``fn`` up on a side stream and captures it, and a
  failed capture or replay raises (there is no eager fallback). On the CPU,
  or where the caller asks for no graph (``graph=False``: a program whose
  calls cannot be captured, as gloo's collectives cannot), the same object
  calls ``fn`` eagerly on the same buffers.
- Inside the program, every output that shares memory with an input buffer
  is cloned first, and the new state is copied back into the state buffers
  last: a replay never reads a buffer it has already written, and no output
  changes when the buffers do.
- **Lifetime.** The returned state is the state buffers and the returned
  outputs are the program's output buffers: both stay valid until the next
  call of the same object, which overwrites them. Clone what must outlive it.
- **Memory.** Each graph has its own memory pool (``torch.cuda.graph``'s
  default): the stage programs of one engine replay in any order, which a
  shared pool allows only in capture order.
- **Spans.** ``spans=`` names the program's stages (``utils/logging.py``).
  A program first called while spans are on owns a slot buffer
  (``slots``): each run (the warm-up, the capture, every replay) writes a
  timestamp when it starts, one at each ``logging.mark`` inside ``fn`` and
  one after its tail (``logging.record_marks`` reads them back as spans).
  Otherwise nothing is marked. The warm-up and the capture are the host
  spans ``capture.warmup`` and ``capture.graph``, whose seconds are
  ``warmup_s`` and ``capture_s``; ``pool_bytes`` is the card memory the
  graph's pool holds after the capture.
- **Counters.** ``hamming_nn_top2.launches``, ``ba_lm_pose.launches``,
  ``ba_update_state.calls`` and ``ba_update_state_dist.calls`` count in
  Python, so a replay would not
  move them. The capture records what one call adds to each and each replay
  adds it; the warm-up and the capture itself are set-up and leave them as
  they were. A ``parallel.mesh.PointsMesh`` handed as ``mesh`` is treated
  the same way: the collectives one call appends to its ``record`` are
  appended again on each replay (an NCCL collective is captured into the
  graph with the kernels around it; the communicator is made by the
  warm-up).

Nothing is captured or built when this module is imported.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from monocular_visual_odometry_tpu_torch.models import ba
from monocular_visual_odometry_tpu_torch.ops import consts, features
from monocular_visual_odometry_tpu_torch.ops.cuda import ba_lm, hamming
from monocular_visual_odometry_tpu_torch.parallel import dist_ba
from monocular_visual_odometry_tpu_torch.utils import logging as lg

# the Python-side counters a replay moves: name -> (function, attribute)
COUNTERS = {"hamming_nn_top2": (hamming.hamming_nn_top2, "launches"),
            "ba_lm_pose": (ba_lm.ba_lm_pose, "launches"),
            "ba_update_state": (ba.ba_update_state, "calls"),
            "ba_update_state_dist": (dist_ba.ba_update_state_dist, "calls")}
# caches of device tensors the programs read: an entry made during a capture
# would land in the graph's pool, an evicted one would free memory a graph
# still reads; both are unbounded and filled by the warm-up
_CACHES = (consts._cached, features._atlas_constants)


def _counts() -> dict:
    return {k: getattr(f, a) for k, (f, a) in COUNTERS.items()}


def _add_counts(delta: dict) -> None:
    for k, (f, a) in COUNTERS.items():
        setattr(f, a, getattr(f, a) + delta[k])


def finish(state_bufs: list, new, outs, inputs: list, into: list | None = None):
    """A program's tail after its function: every output that shares memory
    with a tensor of ``inputs`` cloned, and every leaf of ``new`` that is not
    its state buffer (``state_bufs``, flat) copied into ``into`` (default: the
    state buffers themselves) last, cloned first where it shares memory with
    an input. ``into`` lets a profile run the same copies without changing
    the state it reads. Returns the outputs."""
    taken = {t.untyped_storage().data_ptr() for t in inputs if t is not None}
    shares = lambda t: t is not None and t.untyped_storage().data_ptr() in taken
    copies = []
    for i, (buf, t) in enumerate(zip(state_bufs, tree_flatten(new)[0])):
        if t is buf:
            continue
        if (t is None) != (buf is None) or t.shape != buf.shape or t.dtype != buf.dtype:
            raise ValueError("CapturedStep: fn's new state changes a field's shape or dtype")
        copies.append((i, t.clone() if shares(t) else t))
    outs = tree_map(lambda t: t.clone() if shares(t) else t, outs)
    dest = state_bufs if into is None else into
    for i, t in copies:
        dest[i].copy_(t)
    return outs


class CapturedStep:
    """``fn`` as a captured program with static input buffers (see the module
    docstring). ``graph``: capture on a CUDA device (False runs ``fn``
    eagerly on the buffers there too); ``mesh``: the mesh whose ``record``
    ``fn`` appends to, if any. Attributes: ``calls``, ``replays``,
    ``per_call`` (what one call adds to each counter), ``per_call_record``
    (what one call appends to the mesh's record), ``warmup_s`` and
    ``capture_s`` (seconds of the first call's warm-up and capture),
    ``pool_bytes`` (the graph pool's card memory after the capture);
    ``spans``: the program's span names, ``slots``: its slot buffer (None
    unless spans were on at its first call). A call is :meth:`load` then
    :meth:`replay` (capturing first on a card); a profile replays a loaded
    program on its own."""

    def __init__(self, fn: Callable, *, graph: bool = True, mesh=None,
                 spans: Sequence[str] = ()):
        self.fn = fn
        self.graph = graph
        self.mesh = mesh
        self.spans = tuple(spans)
        self.slots = None
        self.calls = self.replays = 0
        self.per_call: dict = {}
        self.per_call_record: list = []
        self.warmup_s = self.capture_s = self.pool_bytes = None
        self._spec = None      # the inputs' structure
        self._bufs = None      # input buffers, flat (None where the input is None)
        self._n_state = 0      # the first _n_state buffers are the state's
        self._outs = None      # the captured program's outputs
        self._cuda_graph = None

    def _n_record(self) -> int:
        return 0 if self.mesh is None else len(self.mesh.record)

    # -- buffers ------------------------------------------------------------

    def load(self, state, *args) -> None:
        """Copy the inputs into the buffers without running (a buffer handed
        back as its own input is not copied); the first load makes them."""
        leaves, spec = tree_flatten((state, *args))
        if self._bufs is None:
            self._spec = spec
            self._n_state = len(tree_flatten(state)[0])
            self._bufs = [None if t is None else t.clone() for t in leaves]
            if self.spans and lg.spans_on():
                self.slots = torch.empty(len(self.spans) + 1, dtype=torch.int64,
                                         device=self._bufs[0].device)
            return
        if spec != self._spec:
            raise ValueError(f"CapturedStep: the inputs' structure changed:\n{spec}\n"
                             f"captured with\n{self._spec}")
        for buf, t in zip(self._bufs, leaves):
            if t is buf:
                continue
            if (buf is None) != (t is None) or (t is not None and (
                    t.shape != buf.shape or t.dtype != buf.dtype or t.device != buf.device)):
                raise ValueError(f"CapturedStep: an input changed shape, dtype or device "
                                 f"({None if t is None else (t.shape, t.dtype, t.device)}; "
                                 f"buffer {None if buf is None else (buf.shape, buf.dtype)})")
            if t is not None:
                buf.copy_(t)

    def _inputs(self):
        return tree_unflatten(self._bufs, self._spec)

    # -- the program ----------------------------------------------------------

    def _marked(self):
        """One run's markers (``logging.marking``), or nothing."""
        return (contextlib.nullcontext() if self.slots is None
                else lg.marking(self.spans, self.slots))

    def _body(self):
        """``fn`` on the buffers, then :func:`finish`. Returns the outputs
        (``fn``'s results after the state)."""
        st, *args = self._inputs()
        with self._marked():
            new, *outs = self.fn(st, *args)
            if tree_flatten(new)[1] != tree_flatten(st)[1]:
                raise ValueError("CapturedStep: fn's new state has another structure than its "
                                 "input state")
            return finish(self._bufs[:self._n_state], new, outs, self._bufs)

    def _capture(self) -> None:
        before, n_before = _counts(), self._n_record()
        with lg.timed("capture.warmup") as warmup:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), self._marked():
                st, *args = self._inputs()
                self.fn(st, *args)  # warm-up: libraries, constants, the kernel's set-up
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
        with lg.timed("capture.graph") as capture:
            warm, n_warm = _counts(), self._n_record()
            sizes = [c.cache_info().currsize for c in _CACHES]
            graph = torch.cuda.CUDAGraph()
            # Python's cycle collector must not run inside the capture: a graph
            # it destroys there (an engine gone out of use) frees memory, which a
            # capture does not permit, and the capture fails. thread_local:
            # another thread (the CLI's frame loader) may use the CUDA API.
            gc.collect()
            reserved = torch.cuda.memory_reserved()
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    outs = self._body()
            finally:
                if was_enabled:
                    gc.enable()
            torch.cuda.synchronize()
            # the graph's own pool is new: what the capture added is what it holds
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            after = _counts()
            if [c.cache_info().currsize for c in _CACHES] != sizes:
                raise RuntimeError("CapturedStep: a cached device constant was created during "
                                   "the capture (the warm-up must create every one)")
            for k, (f, a) in COUNTERS.items():
                setattr(f, a, before[k])
            self.per_call = {k: after[k] - warm[k] for k in COUNTERS}
            if self.mesh is not None:
                self.per_call_record = self.mesh.record[n_warm:]
                del self.mesh.record[n_before:]
        self.warmup_s, self.capture_s = warmup.seconds, capture.seconds
        self._cuda_graph, self._outs = graph, outs

    def _graphed(self) -> bool:
        return self.graph and self._bufs[0].device.type == "cuda"

    def replay(self):
        """The program once on the buffers as they stand: on a CUDA device a
        replay of the graph a first call captured, elsewhere ``fn`` eagerly.
        Returns ``(new_state, *outputs)`` and moves the counters as a call
        does."""
        if self._bufs is None:
            raise RuntimeError("CapturedStep.replay: no inputs loaded yet")
        if self._graphed():
            if self._cuda_graph is None:
                raise RuntimeError("CapturedStep.replay: nothing captured yet")
            self._cuda_graph.replay()
            self.replays += 1
            _add_counts(self.per_call)
            if self.mesh is not None:
                self.mesh.record.extend(self.per_call_record)
            outs = self._outs
        else:
            before, n_before = _counts(), self._n_record()
            outs = self._body()
            after = _counts()
            self.per_call = {k: after[k] - before[k] for k in COUNTERS}
            if self.mesh is not None:
                self.per_call_record = self.mesh.record[n_before:]
        return (self._inputs()[0], *outs)

    def __call__(self, state, *args):
        """One step: returns ``(new_state, *outputs)``, both valid until the
        next call of this object."""
        self.load(state, *args)
        self.calls += 1
        if self._graphed() and self._cuda_graph is None:
            self._capture()
        return self.replay()
