"""Model API of the port.  Counterpart: ``singa_tpu/model.py`` ``Model``
(:78).

A :class:`Model` is a :class:`~singa_tpu_torch.layer.Layer` with
``set_optimizer``, ``train`` / ``eval``, ``get_states`` / ``set_states``
and ``compile``.  ``compile(inputs, ...)`` runs one forward pass on the
placeholder inputs under ``torch.no_grad()`` so the lazy parameters
materialise, names every state by its dotted attribute path (model.py:226;
optimizer state names derive from these), places the state on the
inputs' device and wraps the subclass's ``train_one_batch`` so that
numpy or torch batches arrive as :class:`Tensor` on that device.

Graph mode: the reference traces the whole step into one XLA program
under ``use_graph=True``.  PyTorch runs eagerly and needs no ``jit``, so
``use_graph=True`` runs the same eager step, with the compiled step's
boundary kept: every Tensor input enters as a fresh ``Tensor`` that
requires no gradient (reference model.py:570-572) and every Tensor output
leaves without a creator (:389), detached from this step's graph.  So an
output fed back as the next step's input (an RNN's carried state, the
char-RNN's truncated BPTT) cuts the gradient there, as a traced step's
argument does.  Capturing the step in a CUDA graph is later work
(``ROADMAP.md`` queue 1, item 4).  ``use_graph=False`` passes inputs and
outputs through as they are.
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

import numpy as np
import torch

from . import autograd
from . import precision as _precision
from .device import get_device
from .layer import Layer
from .tensor import Tensor

__all__ = ["Model"]


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} belongs to a later slice of the "
                              f"port (ROADMAP.md queue 1, {where})")


class Model(Layer):
    def __init__(self, name=None):
        super().__init__(name)
        self.training = True
        self.optimizer = None
        self.device = None
        self.graph_mode = False
        self._user_tob = None
        self.precision_policy = None   # a precision.Policy or None

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
        docstring) and attach it to the optimizer."""
        self.precision_policy = _precision.get_policy(policy)
        if self.optimizer is not None and self.precision_policy is not None:
            self.optimizer.attach_precision_policy(self.precision_policy)

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
        (the card when it has none).  ``use_graph=True`` runs the same
        eager step, cut from the graph at its inputs and outputs, and
        ``sequential`` is ignored (see the module docstring).
        ``precision``, when given, is installed by
        :meth:`set_precision_policy`.  Returns the placeholder pass's
        output."""
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
        return out

    def _dispatch_tob(self, *xs):
        xs = [self._as_input(x) for x in xs]
        pol = self.precision_policy
        if pol is None or not pol.active:
            if not self.graph_mode:
                return self._user_tob(*xs)
            return _cut(self._user_tob(*[_cut(x) for x in xs]))
        # the master swap around the user's step; inputs enter and outputs
        # leave as fresh Tensors in either mode, as in the reference
        token = pol.begin_step(self.get_states().values(), self.optimizer)
        try:
            out = self._user_tob(*[_cut(x, pol.cast_input) for x in xs])
        finally:
            pol.end_step(token, self.optimizer)
        return _cut(out, pol.cast_output)


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
