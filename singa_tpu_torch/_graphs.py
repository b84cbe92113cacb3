"""CUDA graphs of the port's steps: the protocol that the captured
training step and ``predict`` (:mod:`singa_tpu_torch.model`), the
serving engine's steps (:mod:`singa_tpu_torch.serving.engine`) and
``GPT.generate``'s decode loop (:mod:`singa_tpu_torch.models.gpt`)
share.  Private to the port.

Per key (an input signature, a step of one engine):

* the first call runs the step eagerly on the owner's side stream: the
  warm-up a capture needs (lazy state, cuBLAS workspaces for that
  stream, the kernels' libraries and plans) and a real step;
* the second call captures the step on that stream and replays it; the
  capture launches nothing, so the kernel wrappers' ``launches*``
  counters, which tick while it records, are put back, and the graph
  keeps the counts it recorded: every replay credits them;
* the storage of every state tensor the step reads or writes is
  recorded at capture; the owner compares it before each replay and
  captures again when a tensor moved;
* a capture that fails raises: nothing falls back to the eager step.

A step that draws random numbers names its generators at capture: each
is registered with the graph (``CUDAGraph.register_generator_state``),
so a replay reads the generator's seed and Philox offset as they stand
when it is launched and advances the offset by what the captured draws
advance it by, as the eager step would.  Scratch that a captured kernel
reads is allocated while the graph records, from the graph's private
pool, which the graph holds for its lifetime (the kernel wrappers
allocate their scratch per call).

:meth:`GraphCache.call` is the whole protocol; the owners (the model,
the serving engine, ``generate``) say what a key, a step and its state
are.
"""

from __future__ import annotations

import time
import weakref

import torch

from .ops import elementwise, flash_attention, lstm_cell, paged_attention
from .tensor import Tensor

__all__ = ["captures_on", "launch_counts", "register_counters", "Graph",
           "GraphCache"]

# the modules whose ``launches*`` counters a replay credits
KERNEL_MODULES = (flash_attention, paged_attention, lstm_cell, elementwise)


def captures_on(device) -> bool:
    """Whether steps on ``device`` (a ``torch.device``) are captured:
    on a CUDA card; the CPU runs them eagerly."""
    return device.type == "cuda"


def launch_counts() -> dict:
    """Every kernel wrapper's ``launches*`` counter, by (module, name)."""
    return {(m, n): v for m in KERNEL_MODULES for n, v in vars(m).items()
            if n.startswith("launches") and isinstance(v, int)}


# every dict of counts a replay credits, by its owner: each kernel
# module's namespace (its ``launches*`` attributes are entries there) and
# the ``counters`` of each registered owner (the communicators' and
# DistOpt's collective counts).  A counter is an int entry; a capture
# records the entries it changed (a module's constants never change)
_COUNTERS = weakref.WeakKeyDictionary({m: vars(m) for m in KERNEL_MODULES})


def register_counters(owner) -> None:
    """Have every replay credit ``owner.counters`` (a dict of counts its
    owner adds to as it issues work, such as a communicator's
    collectives) with what the capture recorded, as the kernel
    counters are credited."""
    _COUNTERS[owner] = owner.counters


def _counts() -> dict:
    """Every counter of ``_COUNTERS``, by (owner, key)."""
    return {(owner, k): v for owner, d in list(_COUNTERS.items())
            for k, v in list(d.items()) if type(v) is int}


def _torch_tensors(x):
    if isinstance(x, Tensor):
        yield x.data
    elif isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _torch_tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _torch_tensors(v)


class Graph:
    """One captured step: the graph, its input buffers and outputs, the
    storage of the state it was captured against, and the kernel
    launches a replay credits."""

    __slots__ = ("graph", "inputs", "outputs", "state", "launches")

    def __init__(self, graph, inputs, outputs, state, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.state = state
        self.launches = launches

    def load(self, raw):
        """Copy ``raw`` into the input buffers (non-tensors pass)."""
        with torch.no_grad():
            for buf, r in zip(self.inputs, raw):
                if isinstance(buf, torch.Tensor):
                    buf.copy_(r)

    def replay(self):
        self.graph.replay()
        for (owner, name), n in self.launches.items():
            _COUNTERS[owner][name] += n


_COLD = object()


class GraphCache:
    """The graphs of one owner by key, the keys whose eager first call
    ran (``warm``: key -> the owner's state identity then), the start of
    the eager first call of the keys not yet captured (``building``),
    the side stream, and the captures and replays by kind (a key's
    first item)."""

    def __init__(self):
        self.graphs: dict = {}
        self.warm: dict = {}
        self.building: dict = {}
        self.captures: dict = {}
        self.replays: dict = {}
        self._stream = None

    def drop(self):
        """Forget every graph and first call (the counts stay)."""
        self.graphs = {}
        self.warm = {}
        self.building = {}

    def forget(self, key):
        """Forget the graph and the first call of ``key``."""
        self.graphs.pop(key, None)
        self.warm.pop(key, None)
        self.building.pop(key, None)

    def call(self, key, device, fn, args, state_fn, generators=(), k=1,
             own_inputs=False, warm_id=None, on_built=None):
        """``fn(*args)`` as the step ``key``, ``k`` times in a row: a
        graph whose storage (``state_fn()``) moved is dropped; a key with
        no graph runs its first call eagerly (again when ``warm_id()``,
        the identity of the owner's state, differs from what it gave
        after that call), and the call after captures it with
        ``generators`` registered; then the graph replays.  With
        ``own_inputs`` the tensors among ``args`` are copied into the
        graph's own buffers before each replay (inputs that change from
        call to call); otherwise the graph reads ``args`` where they lie.
        ``on_built(t0)`` is called once a key's graph is captured after
        an eager first call, with the ``time.perf_counter()`` at that
        call's start (the key's build: warm-up and capture).  Returns
        the eager call's output or the graph's own output buffers."""
        entry = self.graphs.get(key)
        if entry is not None and entry.state != state_fn():
            del self.graphs[key]
            entry = None
        if entry is None:
            ident = warm_id() if warm_id is not None else None
            if self.warm.get(key, _COLD) != ident:
                self.building.setdefault(key, time.perf_counter())
                out = self.eager(device, fn, *args)
                self.warm[key] = warm_id() if warm_id is not None else None
                k -= 1
                if k == 0:
                    return out
            bufs = [torch.empty(a.shape, dtype=a.dtype, device=device)
                    if isinstance(a, torch.Tensor) else a
                    for a in args] if own_inputs else None
            entry = self.capture(key, device, fn,
                                 args if bufs is None else bufs, state_fn,
                                 inputs=bufs or (), generators=generators)
            t0 = self.building.pop(key, None)
            if t0 is not None and on_built is not None:
                on_built(t0)
        entry.load(args)
        self.replay(entry, key[0], k)
        return entry.outputs

    def side_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def eager(self, device, fn, *args):
        """``fn(*args)`` on the side stream, ordered after the current
        stream's work and before its later work; the output's tensors
        are recorded on the current stream."""
        side = self.side_stream(device)
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args)
        cur.wait_stream(side)
        for t in _torch_tensors(out):
            t.record_stream(cur)
        return out

    def capture(self, key, device, fn, args, state_fn, inputs=(),
                generators=()):
        """Capture ``fn(*args)`` under ``key`` on the side stream, with
        ``generators`` registered; ``state_fn()`` gives the storage the
        graph is bound to, and must give the same after the capture.
        Returns the :class:`Graph`."""
        state = state_fn()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        before = _counts()
        try:
            with torch.cuda.graph(graph, stream=self.side_stream(device)):
                out = fn(*args)
        finally:
            recorded = {c: n - before.get(c, 0)
                        for c, n in _counts().items()
                        if n != before.get(c, 0)}
            for (owner, name), n in recorded.items():  # nothing ran yet
                _COUNTERS[owner][name] -= n
        if state_fn() != state:
            raise RuntimeError(
                "state was created or rebound while the step was captured: "
                "the graph would hold storage its owner does not")
        entry = Graph(graph, list(inputs), out, state, recorded)
        self.graphs[key] = entry
        kind = key[0]
        self.captures[kind] = self.captures.get(kind, 0) + 1
        return entry

    def replay(self, entry, kind, k=1):
        for _ in range(k):
            entry.replay()
        self.replays[kind] = self.replays.get(kind, 0) + k


def addresses(tensors) -> tuple:
    """The storage a graph is bound to: each tensor's identity and data
    address (a :class:`Tensor`'s own identity, its data's address)."""
    return tuple((id(t), (t.data if isinstance(t, Tensor) else t).data_ptr())
                 for t in tensors)
