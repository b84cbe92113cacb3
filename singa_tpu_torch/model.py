"""Model API of the port.  Counterpart: ``singa_tpu/model.py`` ``Model``
(:78).

A :class:`Model` is a :class:`~singa_tpu_torch.layer.Layer` with
``set_optimizer``, ``train`` / ``eval``, ``get_states`` / ``set_states``,
``compile``, ``run_k_steps``, ``predict`` and ``save_states`` /
``load_states``.  ``compile(inputs, ...)`` runs one forward pass on the
placeholder inputs under ``torch.no_grad()`` so the lazy parameters
materialise, names every state by its dotted attribute path (model.py:226;
optimizer state names derive from these), places the state on the
inputs' device and wraps the subclass's ``train_one_batch`` so that
numpy or torch batches arrive as :class:`Tensor` on that device.

Graph mode (reference model.py:288-390, :613-704, where ``use_graph=True``
traces the whole step into one XLA program with donated state).  Every
Tensor input enters the step as a fresh ``Tensor`` that requires no
gradient (:570-572) and every Tensor output leaves without a creator
(:389), detached from the step's graph, so an output fed back as the next
step's input (an RNN's carried state, the char-RNN's truncated BPTT)
cuts the gradient there.

* On the card, the step is a CUDA graph, one per input signature (the
  Tensor arguments' shapes and dtypes, the other arguments' values and
  the autograd training flag; reference ``_split_args``, :260).  The
  first call of a signature runs the step eagerly on a side stream: it
  is the warm-up a capture needs (lazy optimizer state, cuBLAS
  workspaces, the kernels' libraries) and it is step 1, one real update
  as in the reference.  The second call captures the step on that stream
  and replays it once; every later call copies its inputs into the
  graph's input buffers (a numpy batch is uploaded straight into them),
  replays, and clones the outputs out of the graph's buffers, so a loss
  or logits held from step s keep their values after step s + 1.  The
  state (parameters, buffers, optimizer state, the loss scale, the step
  counter, the norm) is updated in place, so the graph reads and writes
  the model's own storage: ``set_states`` and ``load_states`` copy into
  it and the next replay sees the new values.  The storage of every
  state tensor is recorded at capture and checked before each replay; a
  tensor rebound since (``Tensor.to_device``, a new ``.data``) makes the
  step capture again, and a different set of state tensors (a new
  optimizer, ``track_grad_norm`` switched on) makes the next call a new
  first call.  A capture that fails raises: nothing falls back to the
  eager step.  The kernel wrappers' launch counters tick while the step
  is captured; the capture's own ticks are taken back (it launches
  nothing) and every replay adds the counts the capture recorded, so
  the counters still count the kernels the card ran.  The step must not
  synchronise with the host or draw random numbers (no layer of the port
  does either in training), and nothing outside it may hold an autograd
  graph over the parameters (a clone of one that was not detached): its
  backward would meet a gradient accumulator made on another stream, and
  the capture fails.
* On the CPU, ``use_graph=True`` runs the same step eagerly, with the
  boundary kept: the plain path, as for the kernels.
* ``use_graph=False`` runs the eager step and passes inputs and outputs
  through as they are, on either device.

``run_k_steps(k, *xs)`` (reference :392) takes k steps on one batch and
returns the last step's outputs: k replays with no host sync between
them on the card (the first call of a signature takes its first step
eagerly, as above), k eager steps on the CPU; either way equal to k
``train_one_batch`` calls.  ``predict(*xs)`` (:709) runs the forward in
eval mode under ``torch.no_grad()`` (params of param precision in the
compute dtype and outputs in the output dtype under a mixed policy),
captured per input signature on the card in the same way, eagerly on
the CPU; it leaves the training flag as it found it.
``save_states`` / ``load_states`` (:790-903) write and read the
reference's zip of ``tensor_dict.npz`` (the model's states and, under
``opt.``, the optimizer's) and ``states_attr.npz`` (aux states), so a
checkpoint crosses between the two packages by name; the write is
staged, fsynced and renamed into place.  The snapshot and orbax formats
raise ``NotImplementedError``.
``sequential`` is accepted and ignored, as in the reference, which stores
it and reads it nowhere.

Mixed precision (``compile(precision=...)`` or
:meth:`Model.set_precision_policy`; reference model.py:108, :288-310,
:626-651): under an active policy every ``train_one_batch`` call runs
``Policy.begin_step`` (compute-dtype leaves for the float32 masters),
casts float32 batch inputs to the compute dtype, runs the user's step,
then ``end_step`` and casts the step's outputs to the output dtype, in
eager and in graph mode alike; the parameters, the optimizer's state
and the checkpoints stay float32.
A ``communicator``, a ``mesh``, ``debug`` and ``lint`` raise
``NotImplementedError`` naming their slice.
"""

from __future__ import annotations

import io
import os
import zipfile

import numpy as np
import torch

from . import autograd
from . import precision as _precision
from .device import get_device
from .layer import Layer
from .ops import elementwise, flash_attention, lstm_cell, paged_attention
from .tensor import _NARROW, Tensor

__all__ = ["Model"]

# the modules whose ``launches*`` counters a replay credits
_KERNEL_MODULES = (flash_attention, paged_attention, lstm_cell, elementwise)


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} belongs to a later slice of the "
                              f"port (ROADMAP.md queue 1, {where})")


def _launch_counts() -> dict:
    return {(m, n): v for m in _KERNEL_MODULES for n, v in vars(m).items()
            if n.startswith("launches") and isinstance(v, int)}


def _atomic_publish(tmp: str, final: str) -> None:
    """Durably publish ``tmp`` as ``final``: fsync the staged bytes, then
    rename over the previous version (the port's copy of
    ``singa_tpu/snapshot.py`` ``atomic_publish``)."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, final)


class _Graph:
    """One captured step (or forward) of one input signature: the graph,
    its input buffers and outputs, the storage of the state it was
    captured against, and the kernel launches a replay credits."""

    __slots__ = ("graph", "inputs", "outputs", "state", "launches")

    def __init__(self, graph, inputs, outputs, state, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.state = state
        self.launches = launches

    def load(self, raw):
        with torch.no_grad():
            for buf, r in zip(self.inputs, raw):
                if isinstance(buf, torch.Tensor):
                    buf.copy_(r)

    def replay(self):
        self.graph.replay()
        for (mod, name), n in self.launches.items():
            setattr(mod, name, getattr(mod, name) + n)


class Model(Layer):
    TENSOR_DICT = "tensor_dict.npz"
    STATES_ATTR = "states_attr.npz"

    def __init__(self, name=None):
        super().__init__(name)
        self.training = True
        self.optimizer = None
        self.device = None
        self.graph_mode = False
        self._user_tob = None
        self.precision_policy = None   # a precision.Policy or None
        self._graphs = {}      # (kind, signature) -> _Graph
        self._warm = {}        # (kind, signature) -> state ids after call 1
        self._stream = None    # the side stream of first calls and captures
        self.graph_captures = {}   # kind ("train", "predict") -> count
        self.graph_replays = {}

    # ------------------------------------------------------------------
    # configuration (reference-parity API)
    # ------------------------------------------------------------------
    def set_optimizer(self, optimizer):
        self.optimizer = optimizer
        if self.precision_policy is not None and optimizer is not None:
            optimizer.attach_precision_policy(self.precision_policy)

    def set_precision_policy(self, policy):
        """Install a mixed-precision policy (``"bfloat16"``,
        ``"float16"``, ``"float32"`` or a
        :class:`~singa_tpu_torch.precision.Policy`; see the module
        docstring) and attach it to the optimizer.  Drops the captured
        steps: the step changes."""
        self.precision_policy = _precision.get_policy(policy)
        if self.optimizer is not None and self.precision_policy is not None:
            self.optimizer.attach_precision_policy(self.precision_policy)
        self._drop_graphs()

    def train(self, mode: bool = True):
        self.training = mode
        autograd.training = mode

    def eval(self):
        self.train(False)

    def __call__(self, *xs, **kw):
        # reference semantics: in training mode ``model(...)`` runs the
        # user's train_one_batch; eval mode -> forward
        if self.training and hasattr(self, "train_one_batch"):
            return self.train_one_batch(*xs, **kw)
        return super().__call__(*xs, **kw)

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def _as_input(self, x):
        if isinstance(x, Tensor):
            return x
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return Tensor(data=x, device=self.device, requires_grad=False)
        return x

    def _placeholder_pass(self, inputs):
        """One forward pass under ``torch.no_grad()`` (autograd off) so
        the lazy params materialise; then every state takes its dotted
        attribute path as name and moves to ``self.device``."""
        prev = autograd.training
        autograd.training = False
        try:
            with torch.no_grad():
                out = self.forward(*inputs)
        finally:
            autograd.training = prev
        self._initialized = True
        for name, t in self.get_states().items():
            t.name = name
            t.to_device(self.device)
        return out

    def compile(self, inputs, is_train: bool = True, use_graph: bool = False,
                sequential: bool = False, communicator=None,
                debug: bool = False, lint: bool = False, mesh=None,
                precision=None):
        """Materialise the lazy params with placeholder ``inputs`` (no
        labels), name and place the state, and wrap ``train_one_batch``
        (reference: ``Model.compile``).  The state follows the first
        input's device; numpy or torch inputs go to the model's device
        (the card when it has none).  ``use_graph=True`` captures the
        step on the card and keeps the step's boundary on the CPU (see
        the module docstring); ``sequential`` is ignored.
        ``precision``, when given, is installed by
        :meth:`set_precision_policy`.  Drops the captured steps.
        Returns the placeholder pass's output."""
        if communicator is not None:
            _not_ported("a communicator (DistOpt)", "item 12")
        if mesh is not None:
            _not_ported("a mesh", "item 12")
        if debug or lint:
            _not_ported("debug/lint", "item 12 (the analysis passes)")
        if not inputs:
            raise ValueError("compile needs at least one placeholder input")
        first = inputs[0]
        self.device = (first.device if isinstance(first, Tensor)
                       else get_device(self.device))
        self.graph_mode = use_graph
        if precision is not None:
            self.set_precision_policy(precision)
        xs = [self._as_input(x) for x in inputs]
        for t in self.get_states().values():   # eagerly created params
            t.to_device(self.device)
        self.train(is_train)
        out = self._placeholder_pass(xs)
        # intercept the subclass's train_one_batch with the wrapper
        # (instance attr shadows the class method); on a second compile
        # the instance attr already is the wrapper, so keep the original
        if hasattr(self, "train_one_batch"):
            if self._user_tob is None or \
                    self.train_one_batch != self._dispatch_tob:
                self._user_tob = self.train_one_batch
            object.__setattr__(self, "train_one_batch", self._dispatch_tob)
        self._drop_graphs()
        return out

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _on_card(self) -> bool:
        return self.device is not None and self.device.lang == "cuda"

    def _dispatch_tob(self, *xs):
        if self.graph_mode and self._on_card():
            return self._graph_call("train", self._graph_step,
                                    _raw_inputs(xs), self._registry)
        return self._step([self._as_input(x) for x in xs], self.graph_mode)

    def _graph_step(self, xs):
        return self._step(xs, True)

    def _step(self, xs, cut: bool):
        """The user's step on Tensor inputs, under the policy's master
        swap and casts when one is active; ``cut``: inputs enter and
        outputs leave as fresh Tensors (always so under a policy, as in
        the reference)."""
        pol = self.precision_policy
        if pol is None or not pol.active:
            if not cut:
                return self._user_tob(*xs)
            return _cut(self._user_tob(*[_cut(x) for x in xs]))
        token = pol.begin_step(self.get_states().values(), self.optimizer)
        try:
            out = self._user_tob(*[_cut(x, pol.cast_input) for x in xs])
        finally:
            pol.end_step(token, self.optimizer)
        return _cut(out, pol.cast_output)

    def run_k_steps(self, k: int, *xs):
        """``k`` training steps on the same batch; returns the last
        step's outputs (reference ``Model.run_k_steps``).  On the card, k
        replays of the captured step with no host sync between them (the
        graph of the input signature, whatever ``use_graph`` says, as the
        reference compiles it); on the CPU, k eager steps.  Equal to k
        ``train_one_batch`` calls."""
        k = int(k)
        if k <= 0:
            raise ValueError(f"run_k_steps needs k > 0, got {k}")
        if self._user_tob is None:
            raise RuntimeError("run_k_steps needs a compiled model with a "
                               "train_one_batch")
        if self._on_card():
            return self._graph_call("train", self._graph_step,
                                    _raw_inputs(xs), self._registry, k)
        for _ in range(k):
            out = self._step([self._as_input(x) for x in xs], True)
        return out

    def _registry(self) -> list:
        """Every state tensor of the step: params, buffers and the
        optimizer's state (the loss scale, the counter, the norm)."""
        tensors = list(self.get_states().values())
        if self.optimizer is not None:
            tensors.extend(self.optimizer.state_tensors())
        seen, out = set(), []
        for t in tensors:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def _eval_registry(self) -> list:
        return list(self.get_states().values())

    # ------------------------------------------------------------------
    # CUDA graphs
    # ------------------------------------------------------------------
    def _drop_graphs(self):
        self._graphs = {}
        self._warm = {}

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device.torch_device)
        return self._stream

    def _graph_call(self, kind, fn, raw, registry_fn, k=1):
        """``fn`` on ``raw`` through the graph of its signature, ``k``
        times (see the module docstring): the first call of a signature,
        or of a new set of state tensors, runs eagerly on the side
        stream; a graph whose state storage moved is captured again."""
        key = (kind,) + _signature(raw)
        reg = registry_fn()
        entry = self._graphs.get(key)
        if entry is None or entry.state != _addresses(reg):
            self._graphs.pop(key, None)
            if self._warm.get(key) != _ids(reg):
                out = self._first_call(fn, raw)
                reg = registry_fn()
                self._warm[key] = _ids(reg)
                k -= 1
                if k == 0:
                    return out
            entry = self._capture(key, fn, raw, reg, registry_fn)
        entry.load(raw)
        for _ in range(k):
            entry.replay()
        self.graph_replays[kind] = self.graph_replays.get(kind, 0) + k
        return _fresh(entry.outputs)

    def _first_call(self, fn, raw):
        side = self._side_stream()
        cur = torch.cuda.current_stream(self.device.torch_device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(_wrap(raw, self.device))
        cur.wait_stream(side)
        for t in _tensors(out):
            t.data.record_stream(cur)
        return out

    def _capture(self, key, fn, raw, reg, registry_fn):
        dev = self.device.torch_device
        bufs = [torch.empty(r.shape, dtype=r.dtype, device=dev)
                if isinstance(r, torch.Tensor) else r for r in raw]
        state = _addresses(reg)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        try:
            with torch.cuda.graph(graph, stream=self._side_stream()):
                out = fn(_wrap(bufs, self.device))
        finally:
            after = _launch_counts()
            for (mod, name), n in before.items():   # nothing ran yet
                setattr(mod, name, n)
        if _addresses(registry_fn()) != state:
            raise RuntimeError(
                "state was created or rebound while the step was captured: "
                "the graph would hold storage the model does not")
        entry = _Graph(graph, bufs, out, state,
                       {c: after[c] - n for c, n in before.items()
                        if after.get(c, n) != n})
        self._graphs[key] = entry
        kind = key[0]
        self.graph_captures[kind] = self.graph_captures.get(kind, 0) + 1
        return entry

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def predict(self, *xs):
        """The forward in eval mode under ``torch.no_grad()`` (reference
        ``Model.predict``): captured per input signature on the card,
        eager on the CPU (see the module docstring)."""
        if self.device is None:
            self.device = next((x.device for x in xs
                                if isinstance(x, Tensor)), None) \
                or get_device(None)
        raw = _raw_inputs(xs)
        if self._on_card():
            return self._graph_call("predict", self._forward_eval, raw,
                                    self._eval_registry)
        return self._forward_eval(_wrap(raw, self.device))

    def _forward_eval(self, xs):
        pol = self.precision_policy
        if pol is not None and not pol.mixed:
            pol = None
        prev = autograd.training
        autograd.training = False
        swapped = []
        try:
            with torch.no_grad():
                if pol is not None:
                    for t in self.get_states().values():
                        if t.stores_grad and t.data.dtype == pol.param_dtype:
                            swapped.append((t, t.data))
                            t.data = t.data.to(pol.compute_dtype)
                    xs = [_cut(x, pol.cast_input) for x in xs]
                out = self.forward(*xs)
        finally:
            for t, data in swapped:
                t.data = data
            autograd.training = prev
        return _cut(out, pol.cast_output if pol is not None else None)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _gather_states(self) -> dict:
        states = {k: t.numpy() for k, t in self.get_states().items()}
        if self.optimizer is not None:
            for name, arr in self.optimizer.get_states().items():
                states[f"opt{Layer.sep}{name}"] = np.asarray(arr)
        return states

    def save_states(self, fpath: str, aux_states: dict | None = None,
                    format: str = "zip"):
        """Checkpoint params, buffers and optimizer state as the
        reference's zip of npz members (see the module docstring)."""
        if format not in ("zip", "snapshot", "orbax"):
            raise ValueError(f"unknown checkpoint format {format!r} "
                             f"(zip | snapshot | orbax)")
        if format != "zip":
            _not_ported(f"the {format} checkpoint format",
                        "item 12 (snapshot.py and its codec)")
        states = self._gather_states()
        aux = {k: v.numpy() if isinstance(v, Tensor) else np.asarray(v)
               for k, v in (aux_states or {}).items()}
        os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
        tmp = fpath + ".tmp"
        with zipfile.ZipFile(tmp, "w") as zf:
            for name, payload in ((self.TENSOR_DICT, states),
                                  (self.STATES_ATTR, aux)):
                buf = io.BytesIO()
                np.savez(buf, **payload)
                zf.writestr(name, buf.getvalue())
        _atomic_publish(tmp, fpath)

    def load_states(self, fpath: str) -> dict:
        """Restore a zip checkpoint in place, by name (the port's or the
        JAX package's); returns the aux states."""
        # a snapshot is named by its prefix and stored as prefix + ".bin",
        # as the reference resolves it (Snapshot.SUFFIX)
        path = fpath if os.path.exists(fpath) else fpath + ".bin"
        if not os.path.exists(path):
            raise FileNotFoundError(fpath)
        if os.path.isdir(path) or not zipfile.is_zipfile(path):
            _not_ported(f"{fpath!r}: only the zip checkpoint format is "
                        f"read; the snapshot and orbax formats",
                        "item 12 (snapshot.py and its codec)")
        with zipfile.ZipFile(path, "r") as zf:
            states = dict(np.load(io.BytesIO(zf.read(self.TENSOR_DICT)),
                                  allow_pickle=False))
            aux = dict(np.load(io.BytesIO(zf.read(self.STATES_ATTR)),
                               allow_pickle=False))
        self.set_states(states)
        if self.optimizer is not None:
            prefix = f"opt{Layer.sep}"
            self.optimizer.set_states({k[len(prefix):]: v
                                       for k, v in states.items()
                                       if k.startswith(prefix)})
        return aux


def _cut(x, cast=None):
    """The compiled step's boundary: a Tensor becomes a fresh Tensor on
    the same data (through ``cast`` when given: a policy's input or
    output cast), detached, with no creator; tuples and lists are cut
    item by item; anything else passes as it is."""
    if isinstance(x, Tensor):
        data = x.data.detach()
        return Tensor(data=cast(data) if cast else data, device=x.device,
                      requires_grad=False)
    if isinstance(x, (tuple, list)):
        return type(x)(_cut(v, cast) for v in x)
    return x


def _fresh(x):
    """Outputs cloned out of a graph's buffers."""
    if isinstance(x, Tensor):
        return Tensor(data=x.data.clone(), device=x.device,
                      requires_grad=False)
    if isinstance(x, (tuple, list)):
        return type(x)(_fresh(v) for v in x)
    return x


def _tensors(x):
    if isinstance(x, Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _raw_inputs(xs) -> list:
    """Each argument as a step takes it: a Tensor's data, a torch tensor
    as it is, a numpy array as a host tensor (64-bit types narrowed as
    :class:`Tensor` narrows them), anything else as it is."""
    out = []
    for x in xs:
        if isinstance(x, Tensor):
            x = x.data
        elif isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(
                x.astype(_NARROW.get(x.dtype, x.dtype), copy=False)))
        out.append(x)
    return out


def _wrap(raw, device) -> list:
    return [Tensor(data=r, device=device, requires_grad=False)
            if isinstance(r, torch.Tensor) else r for r in raw]


def _signature(raw) -> tuple:
    """A step's input signature (reference ``_split_args``): shapes and
    dtypes of the tensors, values of the rest, and the training flag."""
    key = [autograd.training]
    for i, r in enumerate(raw):
        if isinstance(r, torch.Tensor):
            key.append((i, tuple(r.shape), r.dtype))
        elif isinstance(r, (int, float, bool, str, bytes, type(None))):
            key.append((i, type(r).__name__, r))
        else:
            raise TypeError(
                f"step argument {r!r} is neither array data nor a hashable "
                f"scalar or string: it cannot be captured")
    return tuple(key)


def _ids(reg) -> tuple:
    return tuple(id(t) for t in reg)


def _addresses(reg) -> tuple:
    return tuple((id(t), t.data.data_ptr()) for t in reg)
