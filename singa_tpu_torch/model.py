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
  the counters still count the kernels the card ran.  A step that draws
  random numbers (``Dropout``, attention dropout) draws them from the
  generator of the model's device, which every captured training step
  registers with its graph: a replay draws at the generator's offset as
  it stands and advances it as the eager step would, so each replay
  takes fresh masks and a captured run equals its eager twin.  The step
  must not synchronise with the host, and nothing outside it may hold an
  autograd graph over the parameters (a clone of one that was not
  detached): its backward would meet a gradient accumulator made on
  another stream, and the capture fails.
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
``opt.``, the optimizer's) and ``states_attr.npz`` (aux states), or with
``format="snapshot"`` its BinFile of TensorProto records
(:mod:`~singa_tpu_torch.snapshot`; aux states under ``__aux__``, the
file at the prefix + ``.bin``), so a checkpoint crosses between the two
packages by name; every write is staged, fsynced and renamed into place,
and ``load_states`` tells the formats apart by the file's magic word.
Both restore through ``_apply_states``: in place, by name, into the
tensors a captured step reads; ``reset_caches=True`` (a load) also drops
the captured steps, as a fresh process would start, and
``reset_caches=False`` (the resilience rollback) keeps them, so the
next replay runs on the restored values with no new capture.  The orbax
format raises ``NotImplementedError``.
``sequential`` is accepted and ignored, as in the reference, which stores
it and reads it nowhere.

``on_device(device)`` (reference :123) moves every state and the
optimizer's state to ``device`` and drops the captured steps and the
banked signatures: a move makes fresh leaves at new addresses, so the
next step on the card is a first call again, then a capture.
``graph(mode, sequential)`` (:129) sets ``graph_mode`` (``sequential``
is stored and ignored).

Profiling (reference :344-357): while the model's device is at
``SetVerbosity(>= 1)``, every ``train_one_batch`` is timed, blocking,
from before its dispatch to after ``Device.Sync()``, on the eager and
the captured path alike (``Device.record_step_time``), and once per
input signature an eager call (never a capture) runs under
``torch.utils.flop_counter.FlopCounterMode``: its flops by op, and the
kernel launches the call made, go to ``Device.record_cost_analysis``.
The reference banks XLA's cost analysis there.  The hand-written
kernels, launched through ``ctypes``, are not in the flop count; their
launch counters stand for them.

Telemetry (reference :310-362): with a process-global tracer installed
(``telemetry.tracer.install``), every ``train_one_batch`` records a
``dispatch`` span (at verbosity >= 1, ``dispatch`` up to the
``Device.Sync()`` and ``block`` over it), and each new input signature
under ``use_graph=True`` one ``trace_compile`` span: on the CPU over
its first eager call, on the card over the graph cache's miss (the
warm-up call and the capture).  The spans are host time around the
step; none is inside the captured step.

Mixed precision (``compile(precision=...)`` or
:meth:`Model.set_precision_policy`; reference model.py:108, :288-310,
:626-651): under an active policy every ``train_one_batch`` call runs
``Policy.begin_step`` (compute-dtype leaves for the float32 masters),
casts float32 batch inputs to the compute dtype, runs the user's step,
then ``end_step`` and casts the step's outputs to the output dtype, in
eager and in graph mode alike; the parameters, the optimizer's state
and the checkpoints stay float32.
Data parallelism (``compile(communicator=...)``, a
:class:`~singa_tpu_torch.parallel.Communicator`; reference model.py:
652-700, where the step is wrapped in ``shard_map``).  The port runs one
process a rank, each with a full replica of the model:

* every rank's ``train_one_batch`` receives the **global** batch, as
  the reference's callers pass it, and takes its rows
  ``[r * b, (r + 1) * b)`` of every array argument (a numpy array is
  sliced before its upload, a tensor by a view); a batch that does not
  divide by the world size raises ``ValueError``, as ``shard_map``
  does;
* scalar outputs (the loss) leave as the group's mean, all-reduced
  inside the step (captured with it on the card); array outputs are the
  rank's rows;
* the state is each rank's own, as the reference's per-device shards:
  ``DistOpt`` keeps the replicas equal where the reference's replicated
  state is equal, the BatchNorm running statistics are each rank's
  (the reference's host read gives device 0's), and so are the
  unsynced parameters of ``partial``, the sparse residuals and the
  ZeRO-1 shards.  "The model's state" is rank 0's;
* ``save_states`` gathers on every rank (the ZeRO-1 state is a
  collective: every rank calls it) and rank 0 writes; every rank
  ``load_states`` the file;
* a random step draws from each rank's own device generator (the
  reference folds the rank into its key): seed them differently for
  different dropout masks;
* eager (``use_graph=False``) and captured steps alike take the rows and
  issue the collectives; a step captured on the card holds its
  collectives (its eager first call brings the NCCL communicator up
  first), and a capture that fails raises.

A ``mesh``, ``debug`` and ``lint`` raise ``NotImplementedError`` naming
their slice.
"""

from __future__ import annotations

import io
import os
import time
import zipfile

import numpy as np
import torch

from . import autograd
from . import precision as _precision
from .device import get_device
from .layer import Layer
from . import _graphs
from ._graphs import GraphCache, launch_counts as _launch_counts
from .parallel.communicator import Communicator
from .snapshot import (FILE_MAGIC, CorruptCheckpointError, Snapshot,
                       atomic_publish, read_records, write_records)
from .telemetry import tracer as _tracer
from .tensor import _NARROW, Tensor

__all__ = ["Model"]


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} belongs to a later slice of the "
                              f"port (ROADMAP.md queue 1, {where})")


class Model(Layer):
    TENSOR_DICT = "tensor_dict.npz"
    STATES_ATTR = "states_attr.npz"
    AUX_PREFIX = "__aux__"

    def __init__(self, name=None):
        super().__init__(name)
        self.training = True
        self.optimizer = None
        self.device = None
        self.graph_mode = False
        self._user_tob = None
        self.precision_policy = None   # a precision.Policy or None
        self.communicator = None       # a parallel.Communicator or None
        self.sequential = False
        # input signatures whose flop table is banked (verbosity >= 1)
        self._cost_keys: set = set()
        # (kind, signature) -> graph; the keys' eager first calls (state
        # ids after call 1); the side stream; captures and replays by
        # kind ("train", "predict")
        self._gc = GraphCache()

    @property
    def _graphs(self) -> dict:
        return self._gc.graphs

    @property
    def graph_captures(self) -> dict:
        return self._gc.captures

    @property
    def graph_replays(self) -> dict:
        return self._gc.replays

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

    def on_device(self, device):
        """Move every state, and the optimizer's, to ``device`` (see the
        module docstring); returns ``self``."""
        dev = get_device(device)
        self.device = dev
        tensors = list(self.get_states().values())
        if self.optimizer is not None:
            tensors += self.optimizer.state_tensors()
        for t in tensors:
            t.to_device(dev)
        self._drop_graphs()
        return self

    def graph(self, mode: bool = True, sequential: bool = False):
        self.graph_mode = mode
        self.sequential = sequential

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
        :meth:`set_precision_policy`.  ``communicator``: the data-parallel
        group this rank trains in (see the module docstring).  Drops the
        captured steps.  Returns the placeholder pass's output."""
        if communicator is not None and \
                not isinstance(communicator, Communicator):
            raise TypeError(f"communicator must be a singa_tpu_torch."
                            f"parallel.Communicator, not "
                            f"{type(communicator).__name__}")
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
        self.communicator = communicator
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
        """One training step; with a tracer installed, a ``dispatch``
        span over it (at verbosity >= 1: ``dispatch`` up to the
        ``Device.Sync()``, then ``block`` over the sync)."""
        dev = self.device
        tr = _tracer.current()      # telemetry spans; None costs nothing
        timed = dev is not None and dev.verbosity >= 1
        if tr is None and not timed:
            return self._run_tob(xs)
        t0 = time.perf_counter()
        out = self._run_tob(xs)
        t1 = time.perf_counter()
        if timed:
            dev.Sync()
            t2 = time.perf_counter()
            dev.record_step_time((t2 - t0) * 1e3)
        if tr is not None:
            tr.span("dispatch", t0, t1, cat="train")
            if timed:
                tr.span("block", t1, t2, cat="train")
        return out

    def _run_tob(self, xs):
        if self.communicator is not None:
            xs = self._rank_rows(xs)
        if self.graph_mode and self._on_card():
            return self._graph_call("train", self._graph_step,
                                    _raw_inputs(xs), self._registry,
                                    generators=self._generators(),
                                    on_built=_trace_compile)
        if not self.graph_mode:
            return self._step([self._as_input(x) for x in xs], False)
        # the CPU runs graph mode eagerly: a signature's first call is its
        # build, and ``warm`` the record of the signatures that ran
        key = ("train",) + _signature(_raw_inputs(xs))
        t0 = time.perf_counter()
        out = self._step([self._as_input(x) for x in xs], True)
        if key not in self._gc.warm:
            self._gc.warm[key] = None
            _trace_compile(t0)
        return out

    def _graph_step(self, xs):
        return self._step(xs, True)

    def _rank_rows(self, xs) -> list:
        """This rank's rows of every array argument (numpy: a slice
        before the upload; a tensor or Tensor: a view)."""
        n, r = self.communicator.world_size, self.communicator.global_rank
        out = []
        for x in xs:
            arr = x.data if isinstance(x, Tensor) else x
            if isinstance(arr, (np.ndarray, torch.Tensor)):
                if arr.ndim == 0 or arr.shape[0] % n:
                    raise ValueError(
                        f"a batch of shape {tuple(arr.shape)} does not split"
                        f" over {n} ranks on its first axis")
                b = arr.shape[0] // n
                arr = arr[r * b:(r + 1) * b]
                x = (Tensor(data=arr, device=x.device, requires_grad=False)
                     if isinstance(x, Tensor) else arr)
            out.append(x)
        return out

    def _group_mean(self, out):
        """Scalar Tensor outputs as the group's mean (a collective);
        anything else as it is."""
        if isinstance(out, Tensor) and out.data.dim() == 0:
            return Tensor(data=self.communicator.all_reduce_mean(
                out.data.detach()), device=out.device, requires_grad=False)
        if isinstance(out, (tuple, list)):
            return type(out)(self._group_mean(v) for v in out)
        return out

    def _step(self, xs, cut: bool):
        """The user's step on Tensor inputs, under the policy's master
        swap and casts when one is active; ``cut``: inputs enter and
        outputs leave as fresh Tensors (always so under a policy, as in
        the reference)."""
        dev = self.device
        if dev is not None and dev.verbosity >= 1 and not (
                self._on_card() and torch.cuda.is_current_stream_capturing()):
            key = _signature(_raw_inputs(xs))
            if key not in self._cost_keys:     # once per input signature
                return self._bank_cost(key, lambda: self._step_body(xs, cut))
        return self._step_body(xs, cut)

    def _bank_cost(self, key, step):
        """``step()`` under ``FlopCounterMode``; its flops by op and the
        kernel launches it made go to the device's cost tables."""
        from torch.utils.flop_counter import FlopCounterMode
        before = _launch_counts()
        with FlopCounterMode(display=False) as counter:
            out = step()
        cost = {"flops": counter.get_total_flops()}
        for op, n in counter.get_flop_counts().get("Global", {}).items():
            cost[f"flops {op}"] = n
        for (mod, name), n in _launch_counts().items():
            if n != before.get((mod, name), 0):
                cost[f"launches {mod.__name__.rsplit('.', 1)[-1]}.{name}"] \
                    = n - before.get((mod, name), 0)
        self._cost_keys.add(key)
        shapes = ", ".join(f"{tuple(k[1])} {str(k[2]).replace('torch.', '')}"
                           for k in key[1:] if len(k) == 3
                           and isinstance(k[1], tuple))
        self.device.record_cost_analysis(
            f"{type(self).__name__}.train_one_batch[{shapes}]", cost)
        return out

    def _step_body(self, xs, cut: bool):
        pol = self.precision_policy
        if pol is None or not pol.active:
            if not cut:
                out = self._user_tob(*xs)
            else:
                out = _cut(self._user_tob(*[_cut(x) for x in xs]))
        else:
            token = pol.begin_step(self.get_states().values(),
                                   self.optimizer)
            try:
                out = self._user_tob(*[_cut(x, pol.cast_input) for x in xs])
            finally:
                pol.end_step(token, self.optimizer)
            out = _cut(out, pol.cast_output)
        if self.communicator is not None:
            out = self._group_mean(out)
        return out

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
        if self.communicator is not None:
            xs = self._rank_rows(xs)
        if self._on_card():
            return self._graph_call("train", self._graph_step,
                                    _raw_inputs(xs), self._registry, k,
                                    self._generators())
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
        self._gc.drop()
        self._cost_keys = set()

    def _generators(self) -> tuple:
        """The generators a training step may draw from: the device's,
        which ``autograd.dropout`` draws from (the step's Tensors are
        all on the model's device)."""
        return (self.device.generator,)

    def _graph_call(self, kind, fn, raw, registry_fn, k=1, generators=(),
                    on_built=None):
        """``fn`` on ``raw`` through the graph of its signature, ``k``
        times (see the module docstring): the first call of a signature,
        or of a new set of state tensors, runs eagerly on the side
        stream; a graph whose state storage moved is captured again,
        with ``generators`` registered; ``on_built`` as
        :meth:`GraphCache.call`'s.  The outputs are fresh tensors."""
        return _fresh(self._gc.call(
            (kind,) + _signature(raw), self.device.torch_device,
            lambda *r: fn(_wrap(r, self.device)), raw,
            lambda: _graphs.addresses(registry_fn()), generators=generators,
            k=k, own_inputs=True, warm_id=lambda: _ids(registry_fn()),
            on_built=on_built))

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
        reference's zip of npz members or, with ``format="snapshot"``,
        its BinFile at ``fpath`` (a prefix; ``.bin`` added) (see the
        module docstring)."""
        if format not in ("zip", "snapshot", "orbax"):
            raise ValueError(f"unknown checkpoint format {format!r} "
                             f"(zip | snapshot | orbax)")
        if format == "orbax":
            _not_ported("the orbax checkpoint format", "item 12")
        states = self._gather_states()
        comm = self.communicator
        if comm is not None and comm.global_rank != 0:
            comm.barrier()            # rank 0 writes; the rest wait for it
            return
        aux = {k: v.numpy() if isinstance(v, Tensor) else np.asarray(v)
               for k, v in (aux_states or {}).items()}
        if format == "snapshot" and not fpath.endswith(Snapshot.SUFFIX):
            fpath += Snapshot.SUFFIX
        self._write_states_file(fpath, format, states, aux)
        if comm is not None:
            comm.barrier()

    def load_states(self, fpath: str) -> dict:
        """Restore a zip or snapshot checkpoint (the port's or the JAX
        package's; the format from the file's magic word) in place, by
        name; returns the aux states.  Drops the captured steps."""
        # a snapshot is named by its prefix and stored as prefix + ".bin",
        # as the reference resolves it (Snapshot.SUFFIX)
        path = fpath if os.path.exists(fpath) else fpath + Snapshot.SUFFIX
        if not os.path.exists(path):
            raise FileNotFoundError(fpath)
        if os.path.isdir(path):
            _not_ported(f"{fpath!r}: the orbax checkpoint format (a "
                        f"directory)", "item 12")
        states, aux = self._read_states_file(path)
        return self._apply_states(states, aux)

    @classmethod
    def _write_states_file(cls, path: str, fmt: str, states: dict,
                           aux: dict) -> None:
        """The one writer of the checkpoint layout (``save_states`` and
        ``resilience.CheckpointManager``): ``states`` and ``aux`` (name
        -> array) as a zip of the two npz members or, with ``fmt ==
        "snapshot"``, one BinFile with the aux records under
        ``AUX_PREFIX``; staged and published atomically at ``path``."""
        if fmt == "snapshot":
            records = dict(states)
            records.update((cls.AUX_PREFIX + k, v) for k, v in aux.items())
            write_records(path, records)
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with zipfile.ZipFile(tmp, "w") as zf:
            for name, payload in ((cls.TENSOR_DICT, states),
                                  (cls.STATES_ATTR, aux)):
                buf = io.BytesIO()
                np.savez(buf, **payload)
                zf.writestr(name, buf.getvalue())
        atomic_publish(tmp, path)

    @classmethod
    def _read_states_file(cls, path: str) -> tuple:
        """``(states, aux)`` from a file of :meth:`_write_states_file`'s
        layout (the port's or the JAX package's), the format from its
        magic word; :class:`CorruptCheckpointError` when it does not
        decode."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == FILE_MAGIC:
            states, aux = {}, {}
            for k, v in read_records(path).items():
                if k.startswith(cls.AUX_PREFIX):
                    aux[k[len(cls.AUX_PREFIX):]] = v
                else:
                    states[k] = v
            return states, aux
        try:
            with zipfile.ZipFile(path, "r") as zf:
                return tuple(dict(np.load(io.BytesIO(zf.read(member)),
                                          allow_pickle=False))
                             for member in (cls.TENSOR_DICT,
                                            cls.STATES_ATTR))
        except (zipfile.BadZipFile, KeyError, ValueError) as e:
            raise CorruptCheckpointError(path, f"unreadable zip "
                                         f"checkpoint ({e})") from e

    def _apply_states(self, states: dict, aux: dict,
                      reset_caches: bool = True) -> dict:
        """The restore tail of every format (reference model.py:879):
        copy each state by name in place (the optimizer's under
        ``opt.``); ``reset_caches`` drops the captured steps, while
        without it a captured step replays on the restored values (see
        the module docstring).  Returns ``aux``."""
        self.set_states(states)
        if self.optimizer is not None:
            prefix = f"opt{Layer.sep}"
            self.optimizer.set_states({k[len(prefix):]: v
                                       for k, v in states.items()
                                       if k.startswith(prefix)})
        if reset_caches:
            self._drop_graphs()
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


def _trace_compile(t0: float):
    """A ``trace_compile`` span from ``t0`` to now on the installed
    tracer, if any."""
    tr = _tracer.current()
    if tr is not None:
        tr.span("trace_compile", t0, time.perf_counter(), cat="train")


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
